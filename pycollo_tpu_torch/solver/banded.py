"""Block-tridiagonal + arrowhead + low-rank KKT factorization, batch-first.

PyTorch port of ``pycollo_tpu/solver/banded.py``, the replacement for the
sparse symmetric-indefinite factorization the reference gets from MUMPS
inside IPOPT (``pycollo/backend.py:1695-1711``; the time-banded block
pattern is the reference's Hessian sparsity, ``pycollo/iteration.py:1039-
1052``).

The condensed-space KKT matrix of a direct-collocation NLP has the shape

    K_full = M + G D_ib^{-1} G^T,      M = [[T, C^T],
                                            [C, B ]]

with ``T`` block tridiagonal over mesh sections (adjacent sections share
one boundary node, so the off-diagonal blocks are nonzero only in its
``nz`` columns), ``B`` a small dense border (endpoint nodes, integrals,
phase times, parameters) coupled to the band by ``C``, and ``G`` the
rank-``nr`` columns of the condensed integral constraints.

Factorization is nested Schur layers, each a Cholesky with a
positive-definiteness certificate (non-finite or non-positive pivots, or
``cholesky_ex``'s ``info``): a block-tridiagonal Cholesky of ``T`` by a
loop over the K sections (O(K MB^3), not O((K MB)^3)), then a signed
two-block Cholesky of the quasi-definite bordered Schur complement.  Every
inner solve is backward-stable triangular SUBSTITUTION (explicit block
inverses were measured to lose ~6 digits at the block condition numbers
the condensed KKT reaches near a solution), in the working dtype (f64).

Every function takes arbitrary leading axes ``(...)`` on its tensors —
instances, and speculative regularization levels — and reduces only over
the trailing ones, so one call factors a (B, levels) stack and each
instance gets its own certificate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BTDFactors(NamedTuple):
    """Cholesky factors of a block-tridiagonal SPD matrix.

    ``L[..., k, :, :]`` is the k-th diagonal Cholesky block, applied by
    substitution; ``F[..., k, :, :]`` the off-diagonal factor block (rows
    of group k, last-nz columns of group k-1; ``F[..., 0, :, :]`` is zero).
    """

    L: torch.Tensor        # (..., K, MB, MB)
    F: torch.Tensor        # (..., K, MB, nz)
    ok: torch.Tensor       # (...) bool — positive definite everywhere


def _tri_solve(L, b, trans=False):
    """L^-1 b (or L^-T b) for lower-triangular L, by substitution."""
    if trans:
        return torch.linalg.solve_triangular(L.mT, b, upper=True)
    return torch.linalg.solve_triangular(L, b, upper=False)


def _chol(A):
    """(L, ok) of a stack of SPD blocks; ``ok`` (the leading axes) holds
    where ``cholesky_ex`` reports success and every pivot is finite and
    positive (a failed factorization's partial factor never passes)."""
    L, info = torch.linalg.cholesky_ex(A)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (info == 0) & torch.isfinite(L).flatten(-2).all(-1) \
        & (diag > 0.0).all(-1)
    return L, ok


def btd_factor(Dblk, Ublk) -> BTDFactors:
    """Factor a block-tridiagonal SPD matrix T = L L^T.

    ``Dblk``: (..., K, MB, MB) diagonal blocks.  ``Ublk``: (..., K, MB, nz)
    sub-diagonal blocks; ``Ublk[..., k, :, :]`` couples group k's rows to
    the last nz columns of group k-1 (the shared mesh node); ``k = 0`` is
    ignored.  Uses the corner identity ``(L^-T)[a:, a:] = (L[a:, a:])^-T``,
    so each section needs only the (nz, nz) corner of the previous factor.
    """
    K, MB = Dblk.shape[-3], Dblk.shape[-1]
    nz = Ublk.shape[-1]
    Ls, Fs, oks = [], [], []
    corner = None
    for k in range(K):
        D_k = Dblk[..., k, :, :]
        if k == 0:
            F_k = torch.zeros_like(Ublk[..., 0, :, :])
            S_k = D_k
        else:
            # F_k = U_k corner^-T  <=>  F_k^T = corner^-1 U_k^T.
            F_k = _tri_solve(corner, Ublk[..., k, :, :].mT).mT
            S_k = D_k - F_k @ F_k.mT
        L_k, ok_k = _chol(S_k)
        corner = L_k[..., MB - nz:, MB - nz:]
        Ls.append(L_k)
        Fs.append(F_k)
        oks.append(ok_k)
    ok = torch.stack(oks, dim=-1).all(-1)
    return BTDFactors(L=torch.stack(Ls, dim=-3), F=torch.stack(Fs, dim=-3),
                      ok=ok)


def btd_half_fwd(factors: BTDFactors, rhs):
    """The half-solve ``y = L^-1 rhs`` of the banded factor, for ``rhs``
    (..., K, MB, c).

    Downstream Schur complements are formed from HALF-solved panels
    (``W = L^-1 C^T``, bounded by ``W^T W = C T^-1 C^T <= B`` for a PD
    system), never from the full solve ``T^-1 C^T``, whose norm grows with
    the condition number of ``T`` and whose products cancel.
    """
    L, F = factors.L, factors.F
    K, MB = L.shape[-3], L.shape[-1]
    nz = F.shape[-1]
    ys = []
    for k in range(K):
        r_k = rhs[..., k, :, :]
        if k:
            r_k = r_k - F[..., k, :, :] @ ys[-1][..., MB - nz:, :]
        ys.append(_tri_solve(L[..., k, :, :], r_k))
    return torch.stack(ys, dim=-3)


def btd_half_bwd(factors: BTDFactors, y):
    """The half-solve ``x = L^-T y`` of the banded factor, for ``y``
    (..., K, MB, c); the sections run last to first."""
    L, F = factors.L, factors.F
    K, MB = L.shape[-3], L.shape[-1]
    nz = F.shape[-1]
    xs = [None] * K
    contrib = None      # F_{k+1}^T x_{k+1}: hits the last nz rows of block k
    for k in reversed(range(K)):
        y_k = y[..., k, :, :]
        if contrib is not None:
            y_k = torch.cat([y_k[..., :MB - nz, :],
                             y_k[..., MB - nz:, :] - contrib], dim=-2)
        xs[k] = _tri_solve(L[..., k, :, :], y_k, trans=True)
        if k:
            contrib = F[..., k, :, :].mT @ xs[k]
    return torch.stack(xs, dim=-3)


def btd_solve(factors: BTDFactors, rhs):
    """Solve T x = rhs for ``rhs`` (..., K, MB, c)."""
    return btd_half_bwd(factors, btd_half_fwd(factors, rhs))


class PhaseBand(NamedTuple):
    """Banded data of one phase: T blocks, border coupling, G columns."""

    Dblk: torch.Tensor     # (..., K, MB, MB)
    Ublk: torch.Tensor     # (..., K, MB, nz)
    Cblk: torch.Tensor     # (..., K, nw, MB)  border rows x group cols
    Gz: torch.Tensor       # (..., K, MB, nr)  low-rank z-columns


class ArrowBlocks(NamedTuple):
    """Assembled (unregularized, unequilibrated) KKT blocks."""

    phases: tuple          # tuple[PhaseBand]
    B: torch.Tensor        # (..., nw, nw) border diagonal block
    Gw: torch.Tensor       # (..., nw, nr) low-rank border rows
    d_ib: torch.Tensor     # (..., nr) dual regularization of the G rows
    #: per-variable free mask in banded layout (1 = real variable, 0 =
    #: structural pad / pinned variable -> identity row); static, no
    #: leading axes
    zmask: tuple           # tuple[(K, MB)]
    wmask: torch.Tensor    # (nw,)


class ArrowFactors(NamedTuple):
    """Factors of the bordered (augmented) arrowhead system.

    The integral-row duals ``y`` stay explicit unknowns of an augmented
    border (no Woodbury capacitance, which cancels catastrophically near a
    solution)::

        [[T,  C^T,  Gz],     [dz]    [rz]
         [C,  B,    Gw],  x  [dw]  = [rw]
         [Gz^T, Gw^T, -D]]   [y]     [0]

    After the banded interior is eliminated the bordered Schur complement
    is quasi-definite (w-block PD, y-block negative definite), so a signed
    two-block Cholesky factors it without pivoting.
    """

    btd: tuple             # tuple[BTDFactors]
    W: tuple               # tuple[(..., K, MB, nw+nr)] = L_T^-1 [C^T | Gz]
    L11: torch.Tensor      # (..., nw, nw) Cholesky of the w-Schur after
    #                        eliminating the band AND the dual rows
    S12: torch.Tensor      # (..., nw, nr) Schur coupling block
    L22: torch.Tensor      # (..., nr, nr) Cholesky of I + Gram
    dz: tuple              # tuple[(..., K, MB)] equilibration scales (z)
    dwq: torch.Tensor      # (..., nw) equilibration scales (border)
    dy: torch.Tensor       # (..., nr) equilibration scales (dual rows)
    ok: torch.Tensor       # (...) bool


def _cho_apply(L, b):
    """(L L^T)^-1 b for vectors b (..., n), by two substitutions."""
    return _tri_solve(L, _tri_solve(L, b[..., None]), trans=True)[..., 0]


def _mv(M, v):
    """(..., p, q) @ (..., q) -> (..., p)."""
    return (M @ v[..., None])[..., 0]


def arrow_factor(blocks: ArrowBlocks, dw) -> ArrowFactors:
    """Factor the augmented arrowhead system with regularization ``dw``
    (a tensor of the blocks' leading shape).

    ``dw`` is added to every real (non-pad) primal diagonal entry, as the
    dense path's ``K + dw*I`` (the dual rows get none).  Jacobi
    equilibration by the CONDENSED diagonal — each variable's scale
    includes its integral-column mass ``sum_r G_ir^2 / d_ib_r`` — bounds
    every scaled G entry by 1; scaling by the bare block diagonal explodes
    for variables whose mass lives in the integral coupling.  ``ok``
    certifies the inertia a descent direction needs: banded interior PD,
    w-Schur PD, y-Schur negative definite.
    """
    eps = 1e-30
    nr = blocks.Gw.shape[-1]
    dib_inv = 1.0 / torch.clamp(blocks.d_ib, min=eps) if nr else None
    phases = []
    for pb, zm in zip(blocks.phases, blocks.zmask):
        MB = pb.Dblk.shape[-1]
        nz = pb.Ublk.shape[-1]
        Dreg = pb.Dblk + torch.diag_embed(dw[..., None, None] * zm)
        diag = torch.diagonal(Dreg, dim1=-2, dim2=-1)
        if nr:
            diag = diag + (pb.Gz * dib_inv[..., None, None, :]
                           * pb.Gz).sum(-1)
        d = 1.0 / torch.sqrt(torch.clamp(diag, min=eps))
        Ds = Dreg * d[..., :, None] * d[..., None, :]
        # U couples group k rows to group k-1's last-nz cols.
        d_prev_tail = torch.cat([torch.ones_like(d[..., :1, :]),
                                 d[..., :-1, :]], dim=-2)[..., MB - nz:]
        Us = pb.Ublk * d[..., :, None] * d_prev_tail[..., None, :]
        phases.append((Ds, Us, d))
    Breg = blocks.B + torch.diag_embed(dw[..., None] * blocks.wmask)
    bdiag = torch.diagonal(Breg, dim1=-2, dim2=-1)
    if nr:
        bdiag = bdiag + (blocks.Gw * dib_inv[..., None, :]
                         * blocks.Gw).sum(-1)
    dwq = 1.0 / torch.sqrt(torch.clamp(bdiag, min=eps))
    Bs = Breg * dwq[..., :, None] * dwq[..., None, :]
    # Dual-row scales: |diagonal| = d_ib > 0 (additive regularization).
    dy = 1.0 / torch.sqrt(torch.clamp(blocks.d_ib, min=eps)) if nr \
        else blocks.d_ib

    nw = Bs.shape[-1]
    btd_factors, Ws = [], []
    S_ww = Bs
    S_wy = blocks.Gw * dwq[..., :, None] * (dy[..., None, :] if nr else 1.0)
    # -d_ib scaled by dy^2
    S_yy = -torch.eye(nr, dtype=Bs.dtype, device=Bs.device)
    ok = None
    for (Ds, Us, d), pb in zip(phases, blocks.phases):
        fac = btd_factor(Ds, Us)
        ok = fac.ok if ok is None else ok & fac.ok
        Cs = pb.Cblk * dwq[..., None, :, None] * d[..., :, None, :]
        Gs = pb.Gz * d[..., :, :, None] \
            * (dy[..., None, None, :] if nr else 1.0)
        # Augmented coupling rows [C; Gz^T] -> panel (..., K, MB, nw+nr);
        # its HALF solve W = L_T^-1 C_aug^T gives the Schur update W^T W.
        W = btd_half_fwd(fac, torch.cat([Cs.mT, Gs], dim=-1))
        S_update = torch.einsum("...kma,...kmb->...ab", W, W)
        S_ww = S_ww - S_update[..., :nw, :nw]
        S_wy = S_wy - S_update[..., :nw, nw:]
        S_yy = S_yy - S_update[..., nw:, nw:]
        btd_factors.append(fac)
        Ws.append(W)
    # Eliminate the DUAL rows first: their scaled diagonal is exactly -1,
    # -S_yy = I + Gram is PD by construction, and the w-Schur update
    # S_ww + P P^T is additive (no cancellation).
    if nr:
        L22, okc = _chol(-S_yy)
        P12 = _tri_solve(L22, S_wy.mT).mT          # S_wy L22^-T
        L11, okb = _chol(S_ww + P12 @ P12.mT)
        ok = ok & okb & okc
    else:
        L22 = S_yy.expand(S_ww.shape[:-2] + (0, 0))
        L11, okb = _chol(S_ww)
        ok = ok & okb
    return ArrowFactors(btd=tuple(btd_factors), W=tuple(Ws), L11=L11,
                        S12=S_wy, L22=L22, dz=tuple(p[2] for p in phases),
                        dwq=dwq, dy=dy, ok=ok)


def arrow_solve(factors: ArrowFactors, rz_list, rw):
    """Solve the augmented system for ``rz_list`` (per phase (..., K, MB))
    and ``rw`` (..., nw).  The dual rows' right-hand side is structurally
    zero (they come from the exact elimination ``y = D^-1 G^T dx``); all
    coupling data comes from the stored half-solved panels."""
    nr = factors.dy.shape[-1]
    nw = rw.shape[-1]
    # Equilibration: K = D^-1 Ks D^-1 -> x = d * Ks^-1 (d * r).
    rz_s = [rz * d for rz, d in zip(rz_list, factors.dz)]
    rw_s = rw * factors.dwq

    # Forward pass: y1 = L_T^-1 rz, border residual via the panels W.
    y1 = [btd_half_fwd(f, rz[..., None])[..., 0]
          for f, rz in zip(factors.btd, rz_s)]
    raug = torch.cat([rw_s, rw_s.new_zeros(rw_s.shape[:-1] + (nr,))], -1)
    for W, y in zip(factors.W, y1):
        raug = raug - torch.einsum("...kma,...km->...a", W, y)
    r1 = raug[..., :nw]
    r2 = raug[..., nw:]
    # y-first quasi-definite 2-block solve: S = [[S11, S12], [S12^T, S22]]
    # with S22 = -(L22 L22^T) and S11 - S12 S22^-1 S12^T = L11 L11^T.
    if nr:
        t2 = -_cho_apply(factors.L22, r2)             # S22^-1 r2
        u1 = _cho_apply(factors.L11, r1 - _mv(factors.S12, t2))
        u2 = -_cho_apply(factors.L22, r2 - _mv(factors.S12.mT, u1))
        uaug = torch.cat([u1, u2], dim=-1)
    else:
        u1 = _cho_apply(factors.L11, r1)
        uaug = u1
    # Backward pass: uz = L_T^-T (y1 - W u).
    uz = [btd_half_bwd(f, (y - _mv(W, uaug[..., None, :]))[..., None])
          [..., 0] for f, y, W in zip(factors.btd, y1, factors.W)]
    dz = [u * d for u, d in zip(uz, factors.dz)]
    return dz, u1 * factors.dwq
