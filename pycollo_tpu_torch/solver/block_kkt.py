"""Structured (block-banded arrowhead) condensed KKT operator, batch-first.

PyTorch port of ``pycollo_tpu/solver/block_kkt.py``: assembles the
condensed-space KKT matrix of a collocation NLP directly in banded form
from per-node derivative blocks — the equivalent of the sparse-AD + MUMPS
pipeline in the reference (hSAD block assembly ``pycollo/compiled.py:213-
539``; MUMPS factorization ``pycollo/backend.py:1695-1711``).

Structure exploited (see ``solver/banded.py`` for the factorization):

* **Defect constraints** couple only the nodes of one mesh section;
  adjacent sections share a boundary node, so the node-variable block of K
  is block tridiagonal over sections with off-diagonal blocks supported on
  the shared node's ``nz`` columns.
* **Path constraints** and the barrier/Hessian node blocks are
  node-diagonal.
* **Border** variables — the endpoint nodes ``z0``/``zend``, integrals
  ``q``, phase times ``t0/tF`` and parameters ``s`` — form a small dense
  arrowhead border.
* **Integral constraints** touch every node through the quadrature
  weights: rank-``nq`` columns.
* **Endpoint constraints** touch only border variables: folded into the
  border block.

The per-node Jacobian and Hessian blocks come from the transcription's own
evaluators (``MeshIteration.node_jacobians``, ``node_hessians``,
``endpoint_jacobian``, ``endpoint_hessian``: one ``torch.func.vmap`` over
the B*N nodes of a batch); everything else is gathers and einsums with
static index maps built once from the mesh, with a leading instance axis B
on every tensor.  No (m, n) Jacobian and no (n, n) Hessian is formed.

Pinned variables (equal bounds, moved to ``theta``) keep the layout: their
column scales are 0 and their diagonal 1, so they solve to zero.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from ..utils import DeviceConstants
from .banded import (ArrowBlocks, PhaseBand, _mv, arrow_factor, arrow_solve)


class _PhaseStatic(NamedTuple):
    """Static sizes and border offsets of one phase (its index tables live
    in the operator's ``DeviceConstants``)."""

    nz: int                  # node variables (states + controls)
    n_max: int               # most nodes in a section
    mb: int                  # node slots per group (n_max - 1)
    MB: int                  # group block size (mb * nz)
    Kg: int                  # sections = groups
    # border positions (global border layout offsets)
    z0_off: int
    zend_off: int
    q_off: int
    t_off: int


def _psd_clip(H):
    """Project a stack of symmetric blocks onto the PSD cone.

    Eigenvalue clipping per small block: the convexified Lagrangian Hessian
    keeps the positive curvature and drops the negative part — a targeted
    modified-Newton fallback that keeps the banded KKT factorizable at
    dw ~ 0 where the exact-Hessian banded block is indefinite."""
    w_, V_ = torch.linalg.eigh(H)
    w_ = torch.clamp(w_, min=0.0)
    return torch.einsum("...ab,...b,...cb->...ac", V_, w_, V_)


def _add_block(T, rows, cols, val):
    """T[:, rows, cols] += val for the block of distinct row and column
    index tensors ``rows``, ``cols``."""
    T[:, rows[:, None], cols[None, :]] += val


class BlockKKT:
    """Banded-arrowhead KKT operator for one :class:`MeshIteration`.

    Batch-first: every method takes and returns tensors with a leading
    instance axis B.

    * ``assemble(x_full, eta, sig_free, dinv_rows) -> (ArrowBlocks exact,
      ArrowBlocks convexified)``
    * ``factor(blocks, dw) -> ArrowFactors`` (any leading axes, e.g.
      (B, levels))
    * ``solve(blocks, factors, rhs_free) -> dx_free``
    * ``kmul(blocks, dw, dx_free) -> K @ dx`` (exact, for the Krylov solve)
    """

    def __init__(self, iteration):
        self.it = iteration
        iteration._build_structured_derivatives()
        lay = iteration.layout
        self.lay = lay
        self.exact = iteration.settings.derivative_level == 2

        # Column scales: V for free variables, 0 for pinned (their rows
        # become identity; displacement forced to zero).
        Vcol = np.where(iteration.free_mask, iteration.V_full, 0.0)
        self.Vcol = Vcol
        consts = DeviceConstants()
        self._c = consts

        # ---- border layout ------------------------------------------
        border_idx: List[int] = []
        self.phase_static: List[_PhaseStatic] = []
        group_maps = []
        for pl, t in zip(lay.phases, iteration.tables):
            nz = pl.ny + pl.nu
            node_var = np.empty((pl.N, nz), dtype=np.int64)
            for l in range(pl.ny):
                node_var[:, l] = pl.y_off + l * pl.N + np.arange(pl.N)
            for l in range(pl.nu):
                node_var[:, pl.ny + l] = pl.u_off + l * pl.N \
                    + np.arange(pl.N)
            z0_off = len(border_idx)
            border_idx.extend(node_var[0])
            zend_off = len(border_idx)
            border_idx.extend(node_var[-1])
            q_off = len(border_idx)
            border_idx.extend(range(pl.q_off, pl.q_off + pl.nq))
            t_off = len(border_idx)
            border_idx.extend([pl.t_off, pl.t_off + 1])

            K = t.K
            n_max = int(t.section_nodes.max())
            mb = n_max - 1
            nd = len(pl.defect_states)
            o_idx = (n_max - t.section_nodes).astype(np.int64)
            sec_node = np.full((K, n_max), -1, dtype=np.int64)
            I_sec = np.zeros((K, n_max - 1, n_max))
            E_sec = np.zeros((K, n_max - 1, n_max))
            W_d = np.zeros((K, n_max - 1, nd))
            d_rows = np.full((K, n_max - 1, nd), lay.m_total,
                             dtype=np.int64)   # pad rows -> sentinel
            first_mask = np.ones((K, n_max))
            row = 0
            for k in range(K):
                n_k = int(t.section_nodes[k])
                o = int(o_idx[k])
                start = int(t.section_starts[k])
                sec_node[k, o:] = start + np.arange(n_k)
                # Slice the per-section operators out of the global
                # tables built by mesh.build_phase_tables.
                I_sec[k, o:, o:] = t.I[row:row + n_k - 1,
                                       start:start + n_k]
                E_sec[k, o:, o:] = t.E[row:row + n_k - 1,
                                       start:start + n_k]
                for li, l in enumerate(pl.defect_states):
                    rows = pl.c_defect_off + li * pl.num_defect \
                        + row + np.arange(n_k - 1)
                    W_d[k, o:, li] = iteration.W_c[rows]
                    d_rows[k, o:, li] = rows
                first_mask[k, o] = 0.0
                row += n_k - 1
            # Group slot g holds node slot g+1 of section k; the last
            # group's final real slot is the phase end node -> border.  A
            # section's FIRST node (slot o_k) belongs to the previous group
            # (its last slot), so it must not appear in group k.
            group_node = sec_node[:, 1:].copy()
            for k in range(K):
                if o_idx[k] >= 1:
                    group_node[k, o_idx[k] - 1] = -1
            group_node[K - 1, n_max - 2] = -1
            Vz_node = Vcol[node_var]
            Vz_sec = np.where(sec_node[..., None] >= 0,
                              Vz_node[np.clip(sec_node, 0, None)], 0.0)
            ps = _PhaseStatic(nz=nz, n_max=n_max, mb=mb, MB=mb * nz, Kg=K,
                              z0_off=z0_off, zend_off=zend_off, q_off=q_off,
                              t_off=t_off)
            self.phase_static.append(ps)
            group_maps.append((group_node, node_var))

            # Device tables of the phase (DeviceConstants keys "<name><i>").
            i = len(self.phase_static) - 1
            eye_y = np.zeros((nd, nz))
            eye_y[np.arange(nd), pl.defect_states] = 1.0
            last_mask = np.ones((K, n_max))
            last_mask[K - 1, n_max - 1] = 0.0
            Vb = np.concatenate([[Vcol[pl.t_off], Vcol[pl.t_off + 1]],
                                 Vcol[lay.s_off:lay.s_off + lay.ns]])
            gidx = np.where(group_node >= 0, group_node, pl.N)
            consts.add(**{
                f"sec{i}": np.clip(sec_node, 0, None),
                f"sec_valid{i}": (sec_node >= 0).astype(float),
                f"I_sec{i}": I_sec,
                f"E_term{i}": np.einsum("krj,lb->krljb", E_sec, eye_y),
                f"W_d{i}": W_d, f"Vz_sec{i}": Vz_sec,
                f"d_rows{i}": d_rows, f"o_idx{i}": o_idx,
                f"first_mask{i}": first_mask, f"last_mask{i}": last_mask,
                f"Vb{i}": Vb, f"Vz_node{i}": Vz_node, f"gidx{i}": gidx,
                f"Vext{i}": np.concatenate(
                    [Vz_node, np.broadcast_to(Vb, (pl.N, len(Vb)))], 1),
                f"ds{i}": pl.defect_states,
                f"z0_r{i}": np.arange(z0_off, z0_off + nz),
                f"zend_r{i}": np.arange(zend_off, zend_off + nz),
            })
            if pl.npc:
                consts.add(**{
                    f"Wp{i}": iteration.W_c[
                        pl.c_path_off:pl.c_integral_off].reshape(
                            pl.npc, pl.N).T,
                    f"p_rows{i}": np.arange(pl.c_path_off,
                                            pl.c_integral_off).reshape(
                                                pl.npc, pl.N).T})
            if pl.nq:
                consts.add(**{
                    f"Wi{i}": iteration.W_c[pl.c_integral_off:
                                            pl.c_integral_off + pl.nq],
                    f"W_g{i}": t.W,
                    f"qV{i}": Vcol[pl.q_off:pl.q_off + pl.nq]})
        self.s_off_border = len(border_idx)
        border_idx.extend(range(lay.s_off, lay.s_off + lay.ns))
        self.border_idx = np.asarray(border_idx, dtype=np.int64)
        self.nw = len(border_idx)
        self.Vw = Vcol[self.border_idx]
        self.wmask = (self.Vw != 0.0).astype(float)
        # border columns t0, tF, s of each phase
        for i, ps in enumerate(self.phase_static):
            consts.add(**{f"tws{i}": np.concatenate(
                [[ps.t_off, ps.t_off + 1],
                 np.arange(self.s_off_border, self.s_off_border + lay.ns)])})
        consts.add(Vs=Vcol[lay.s_off:lay.s_off + lay.ns])

        # ---- free-space <-> structured-space static maps ---------------
        # z gather maps in the full layout (pad/pinned -> sentinel n_full).
        self.zmaps = []
        self.zmasks = []
        for ps, (group_node, node_var) in zip(self.phase_static,
                                              group_maps):
            gm = np.where(group_node[..., None] >= 0,
                          node_var[np.clip(group_node, 0, None)],
                          lay.n_full)
            gm = gm.reshape(ps.Kg, ps.MB)
            vz = np.where(gm < lay.n_full,
                          Vcol[np.clip(gm, 0, lay.n_full - 1)], 0.0)
            zmask = (vz != 0.0).astype(float)
            # pinned/pad entries read the sentinel too (their rhs and
            # solution entries must be exactly zero).
            self.zmaps.append(np.where(zmask > 0, gm, lay.n_full))
            self.zmasks.append(zmask)
        self.border_map = np.where(self.wmask > 0, self.border_idx,
                                   lay.n_full)
        # Every free variable is exactly one real entry of the structured
        # layout [z_0, ..., z_P, w], so both directions are gathers: the
        # free position of each structured entry (n_free for pads and pins,
        # a zero column), and the structured position of each free variable.
        n_free = len(iteration.free_idx)
        free_pos = np.full(lay.n_full + 1, n_free, dtype=np.int64)
        free_pos[iteration.free_idx] = np.arange(n_free)
        struct_full = np.concatenate([zm.ravel() for zm in self.zmaps]
                                     + [self.border_map])
        real = struct_full < lay.n_full
        struct_pos = np.full(lay.n_full, -1, dtype=np.int64)
        struct_pos[struct_full[real]] = np.flatnonzero(real)
        counts = np.bincount(struct_full[real], minlength=lay.n_full)
        if (counts[iteration.free_idx] != 1).any() \
                or real.sum() != n_free:
            raise RuntimeError("block-banded layout does not cover every "
                               "free variable exactly once")
        consts.add(free_idx=iteration.free_idx,
                   struct_pos=struct_pos[iteration.free_idx],
                   border_free_pos=free_pos[self.border_map],
                   wmask=self.wmask, Vw=self.Vw)
        for i, zm in enumerate(self.zmaps):
            consts.add(**{f"zmask{i}": self.zmasks[i],
                          f"z_free_pos{i}": free_pos[zm]})

        # endpoint variables (the transcription's ep_idx) -> border slots
        border_of_full = np.full(lay.n_full, -1, dtype=np.int64)
        border_of_full[self.border_idx] = np.arange(self.nw)
        self.ep_border = border_of_full[iteration.ep_idx]
        if (self.ep_border < 0).any():
            raise RuntimeError("an endpoint variable is not a border "
                               "variable")
        consts.add(ep_border=self.ep_border)

        # low-rank (integral-row) column count and rows
        self.nr = sum(pl.nq for pl in lay.phases)
        consts.add(i_rows=np.concatenate(
            [np.arange(pl.c_integral_off, pl.c_integral_off + pl.nq)
             for pl in lay.phases]).astype(np.int64),
            W_b=iteration.W_c[lay.c_endpoint_off:])

    # ------------------------------------------------------------------
    def assemble(self, x_full, eta, sig_free, dinv_rows):
        """Assemble the banded KKT blocks of every instance.

        ``x_full`` (B, n_full); ``eta`` (B, m): unscaled-space constraint
        multipliers (W_c * lam); ``sig_free`` (B, n_free): barrier diagonal
        over the free (scaled) variables; ``dinv_rows`` (B, m): per-row 1/D
        (slack-eliminated dual regularization; equality rows 1/dc).

        Returns ``(blocks_exact, blocks_convex)``: the same banded KKT with
        the exact Lagrangian Hessian and with the per-node PSD-clipped one,
        which is positive definite at dw ~ 0 by construction and serves as
        the solver's last speculative inertia level.
        """
        c = self._c
        lay, it = self.lay, self.it
        Bn = x_full.shape[0]
        like = x_full
        kw = dict(dtype=x_full.dtype, device=x_full.device)
        nw, nr = self.nw, self.nr

        Bm = torch.zeros((Bn, nw, nw), **kw)
        BH = {"e": torch.zeros((Bn, nw, nw), **kw),
              "c": torch.zeros((Bn, nw, nw), **kw)}
        Gw = torch.zeros((Bn, nw, nr), **kw)
        sig_ext = torch.cat([sig_free, sig_free.new_zeros((Bn, 1))], dim=1)
        dinv_ext = torch.cat([dinv_rows, dinv_rows.new_zeros((Bn, 1))], 1)

        phases = []
        phases_H = []
        nr_off = 0
        for i, (pl, ps) in enumerate(zip(lay.phases, self.phase_static)):
            nz, n_max, mb, MB, Kg = ps.nz, ps.n_max, ps.mb, ps.MB, ps.Kg
            tws_t = c(f"tws{i}", like)
            nbc = 2 + lay.ns          # border cols: t0, tF, s
            t0 = x_full[:, pl.t_off]
            tF = x_full[:, pl.t_off + 1]
            stretch = 0.5 * (tF - t0)
            st5 = stretch[:, None, None, None, None, None]

            Fv, Jw, Jt0, JtF, Js = it.node_jacobians(x_full, i)

            sec = c(f"sec{i}", like)
            sec_valid = c(f"sec_valid{i}", like)
            I_sec = c(f"I_sec{i}", like)
            W_dj = c(f"W_d{i}", like)
            Vb = c(f"Vb{i}", like)
            dstates = c(f"ds{i}", like)
            z0_r, zend_r = c(f"z0_r{i}", like), c(f"zend_r{i}", like)

            # ---- defect rows (section-local) ------------------------
            nd = len(pl.defect_states)
            Jw_sec = Jw[:, sec] * sec_valid[:, :, None, None]  # (B,K,n,nf,nz)
            Jf_sec = Jw_sec[:, :, :, dstates, :]               # (B,K,n,nd,nz)
            Ad = st5 * torch.einsum("krj,xkjlb->xkrljb", I_sec, Jf_sec)
            # E pattern hits the y_l column of z directly.
            Ad = Ad + c(f"E_term{i}", like)
            # scale rows (W_c) and z-columns (V, pinned -> 0)
            Ad = Ad * W_dj[:, :, :, None, None] \
                * c(f"Vz_sec{i}", like)[:, None, None, :, :]
            Rn = (n_max - 1) * nd
            Ad = Ad.reshape(Bn, Kg, Rn, n_max, nz)

            # border (t0, tF, s) columns of the defect rows
            def sec_int(Y):
                """I_sec applied to per-node values Y (B, N, ...) of the
                defect states, per section."""
                Ys = Y[:, sec][:, :, :, dstates]
                Ys = Ys * sec_valid.reshape(sec_valid.shape
                                            + (1,) * (Ys.dim() - 3))
                return torch.einsum("krj,xkj...->xkr...", I_sec, Ys)

            IF = sec_int(Fv)
            st3 = stretch[:, None, None, None]
            col_t0 = -0.5 * IF + st3 * sec_int(Jt0)
            col_tF = 0.5 * IF + st3 * sec_int(JtF)
            parts = [col_t0[..., None], col_tF[..., None]]
            if lay.ns:
                parts.append(st3[..., None] * sec_int(Js))
            Abord = torch.cat(parts, dim=-1)     # (B, K, n-1, nd, nbc)
            Abord = Abord * W_dj[..., None] * Vb
            Abord = Abord.reshape(Bn, Kg, Rn, nbc)

            rwgt = dinv_ext[:, c(f"d_rows{i}", like)].reshape(Bn, Kg, Rn)

            # split first-node / last-node(final section) / rest columns
            o_bc = c(f"o_idx{i}", like).view(1, Kg, 1, 1, 1).expand(
                Bn, Kg, Rn, 1, nz)
            Af = Ad.gather(3, o_bc)[:, :, :, 0, :]          # (B, K, Rn, nz)
            Ar = Ad * c(f"first_mask{i}", like)[None, :, None, :, None]
            Ab = Ar[:, Kg - 1, :, n_max - 1, :]             # (B, Rn, nz)
            Ar = Ar * c(f"last_mask{i}", like)[None, :, None, :, None]
            Ar = Ar[:, :, :, 1:, :].reshape(Bn, Kg, Rn, MB)

            ArD = Ar * rwgt[..., None]
            Dblk = torch.einsum("xkra,xkrb->xkab", ArD, Ar)
            Ublk = torch.einsum("xkra,xkrb->xkab", ArD, Af)  # (B, K, MB, nz)
            corner = torch.einsum("xkra,xkr,xkrb->xkab", Af, rwgt, Af)
            Dblk[:, :-1, MB - nz:, MB - nz:] += corner[:, 1:]
            Cb_rows = torch.einsum("xkrw,xkra->xkwa",
                                   Abord * rwgt[..., None], Ar)
            Cblk = torch.zeros((Bn, Kg, nw, MB), **kw)
            Cblk.index_add_(2, tws_t, Cb_rows)
            # border diag: t/s x t/s from all defect rows
            _add_block(Bm, tws_t, tws_t, torch.einsum(
                "xkrw,xkr,xkrv->xwv", Abord, rwgt, Abord))
            # first node of section 0 -> z0 border rows
            z0_sl = slice(ps.z0_off, ps.z0_off + nz)
            zend_sl = slice(ps.zend_off, ps.zend_off + nz)
            Af0, rw0, Ar0, Abord0 = Af[:, 0], rwgt[:, 0], Ar[:, 0], Abord[:, 0]
            Bm[:, z0_sl, z0_sl] += torch.einsum("xra,xr,xrb->xab",
                                                Af0, rw0, Af0)
            cross0 = torch.einsum("xrw,xr,xra->xwa", Abord0, rw0, Af0)
            _add_block(Bm, tws_t, z0_r, cross0)
            _add_block(Bm, z0_r, tws_t, cross0.mT)
            Cblk[:, 0, z0_sl, :] += torch.einsum("xra,xr,xrm->xam",
                                                 Af0, rw0, Ar0)
            # shared-node coupling of sections k>=1 lives in group k-1's
            # last slot; handled via Ublk (k>=1).  Zero the k=0 entry.
            Ublk[:, 0] = 0.0
            # border (t/s) x shared-node cross terms for sections k>=1
            # land in group k-1's last-node columns.
            if Kg >= 2:
                crossAf = torch.einsum("xkrw,xkr,xkra->xkwa", Abord, rwgt,
                                       Af)
                Cblk[:, :Kg - 1, :, MB - nz:].index_add_(
                    2, tws_t, crossAf[:, 1:])
            # final-section end node -> zend border rows
            rwl = rwgt[:, Kg - 1]
            Bm[:, zend_sl, zend_sl] += torch.einsum("xra,xr,xrb->xab",
                                                    Ab, rwl, Ab)
            crossE = torch.einsum("xrw,xr,xra->xwa", Abord[:, Kg - 1], rwl,
                                  Ab)
            _add_block(Bm, tws_t, zend_r, crossE)
            _add_block(Bm, zend_r, tws_t, crossE.mT)
            Cblk[:, Kg - 1, zend_sl, :] += torch.einsum(
                "xra,xr,xrm->xam", Ab, rwl, Ar[:, Kg - 1])
            if Kg >= 2:
                # zend x shared-node (the last group's first node sits in
                # group Kg-2's last slot) cross term via Af[Kg-1]
                crossZ = torch.einsum("xra,xr,xrb->xab", Ab, rwl,
                                      Af[:, Kg - 1])
                Cblk[:, Kg - 2, zend_sl, MB - nz:] += crossZ
            else:
                # single-section phase: first node is z0 border
                crossZ = torch.einsum("xra,xr,xrb->xab", Ab, rwl, Af0)
                Bm[:, zend_sl, z0_sl] += crossZ
                Bm[:, z0_sl, zend_sl] += crossZ.mT

            # ---- path rows (node-diagonal) --------------------------
            if pl.npc:
                Wp = c(f"Wp{i}", like)                        # (N, npc)
                dinv_p = dinv_rows[:, c(f"p_rows{i}", like)]  # (B, N, npc)
                Vzn = c(f"Vz_node{i}", like)
                Pz = Jw[:, :, pl.ny:pl.ny + pl.npc, :] * Wp[:, :, None] \
                    * Vzn[:, None, :]                         # (B,N,npc,nz)
                Pb = torch.stack([Jt0[:, :, pl.ny:pl.ny + pl.npc],
                                  JtF[:, :, pl.ny:pl.ny + pl.npc]], dim=-1)
                if lay.ns:
                    Pb = torch.cat(
                        [Pb, Js[:, :, pl.ny:pl.ny + pl.npc, :]], dim=-1)
                Pb = Pb * Wp[:, :, None] * Vb                 # (B,N,npc,nbc)
                PzD = Pz * dinv_p[..., None]
                NBlk = torch.einsum("xjpa,xjpb->xjab", PzD, Pz)
                CBlk = torch.einsum("xjpw,xjpa->xjwa",
                                    Pb * dinv_p[..., None], Pz)
                _add_block(Bm, tws_t, tws_t, torch.einsum(
                    "xjpw,xjp,xjpv->xwv", Pb, dinv_p, Pb))
                Dblk, Cblk = self._scatter_node_blocks(
                    i, ps, pl, NBlk, CBlk, Dblk, Cblk, Bm, like)

            # ---- Hessian node blocks (exact + convexified) ----------
            DblkH = {"e": torch.zeros_like(Dblk), "c": torch.zeros_like(Dblk)}
            CblkH = {"e": torch.zeros_like(Cblk), "c": torch.zeros_like(Cblk)}
            if self.exact:
                Vext = c(f"Vext{i}", like)
                Hn = it.node_hessians(x_full, eta, i) \
                    * Vext[:, :, None] * Vext[:, None, :]    # (B, N, D, D)
                for key, Hv in (("e", Hn), ("c", _psd_clip(Hn))):
                    _add_block(BH[key], tws_t, tws_t,
                               Hv[:, :, nz:, nz:].sum(1))
                    DblkH[key], CblkH[key] = self._scatter_node_blocks(
                        i, ps, pl, Hv[:, :, :nz, :nz], Hv[:, :, nz:, :nz],
                        DblkH[key], CblkH[key], BH[key], like)

            # ---- integral rows (low-rank columns) -------------------
            Gz = torch.zeros((Bn, Kg, MB, nr), **kw)
            if pl.nq:
                Wi = c(f"Wi{i}", like)
                W_g = c(f"W_g{i}", like)                      # (N,)
                Vzn = c(f"Vz_node{i}", like)
                iq0 = pl.ny + pl.npc
                qs = slice(nr_off, nr_off + pl.nq)
                # z columns: -stretch * W_j * d rho_l / dz_j
                Gnode = -st3 * W_g[:, None, None] \
                    * Jw[:, :, iq0:iq0 + pl.nq, :] * Wi[:, None] \
                    * Vzn[:, None, :]                          # (B,N,nq,nz)
                Gg = torch.cat([Gnode, torch.zeros_like(Gnode[:, :1])],
                               dim=1)[:, c(f"gidx{i}", like)]
                Gz[..., qs] = Gg.transpose(3, 4).reshape(Bn, Kg, MB, pl.nq)
                # border rows: q, t0/tF/s, z0, zend
                Wr = torch.einsum("j,xjl->xl", W_g, Fv[:, :, iq0:iq0 + pl.nq])
                gt0 = (0.5 * Wr - stretch[:, None] * torch.einsum(
                    "j,xjl->xl", W_g, Jt0[:, :, iq0:iq0 + pl.nq])) * Wi \
                    * self.Vcol[pl.t_off]
                gtF = (-0.5 * Wr - stretch[:, None] * torch.einsum(
                    "j,xjl->xl", W_g, JtF[:, :, iq0:iq0 + pl.nq])) * Wi \
                    * self.Vcol[pl.t_off + 1]
                Gw[:, ps.t_off, qs] += gt0
                Gw[:, ps.t_off + 1, qs] += gtF
                if lay.ns:
                    gs = -stretch[:, None, None] * torch.einsum(
                        "j,xjls->xsl", W_g, Js[:, :, iq0:iq0 + pl.nq, :]) \
                        * Wi[None, :] * c("Vs", like)[:, None]
                    Gw[:, self.s_off_border:self.s_off_border + lay.ns,
                       qs] += gs
                # q column: d rho_l / d q_l = 1
                qr = torch.arange(pl.nq, device=like.device)
                Gw[:, ps.q_off + qr, nr_off + qr] += Wi * c(f"qV{i}", like)
                # endpoint-node z columns
                Gw[:, ps.z0_off:ps.z0_off + nz, qs] += Gnode[:, 0].mT
                Gw[:, ps.zend_off:ps.zend_off + nz, qs] += \
                    Gnode[:, pl.N - 1].mT
            nr_off += pl.nq

            # ---- barrier diagonal + identity for pinned/pads --------
            zmask = c(f"zmask{i}", like)
            sig_z = sig_ext[:, c(f"z_free_pos{i}", like)] * zmask
            torch.diagonal(Dblk, dim1=-2, dim2=-1).add_(
                sig_z + (1.0 - zmask))

            phases.append(PhaseBand(Dblk=Dblk, Ublk=Ublk, Cblk=Cblk, Gz=Gz))
            phases_H.append((DblkH, CblkH))

        # ---- endpoint rows + objective Hessian over the border -------
        Vw = c("Vw", like)
        ep_b = c("ep_border", like)
        Hep = torch.zeros((Bn, nw, nw), **kw)
        Hep[:, ep_b[:, None], ep_b[None, :]] = it.endpoint_hessian(
            x_full, eta)
        Hep = Hep * Vw[:, None] * Vw[None, :]
        BH["e"] = BH["e"] + Hep
        BH["c"] = BH["c"] + _psd_clip(Hep)
        if lay.nb:
            Jb = torch.zeros((Bn, lay.nb, nw), **kw)
            Jb[:, :, ep_b] = c("W_b", like)[:, None] \
                * it.endpoint_jacobian(x_full)
            Jb = Jb * Vw[None, :]
            dinv_b = dinv_rows[:, lay.c_endpoint_off:lay.m_total]
            Bm = Bm + torch.einsum("xrw,xr,xrv->xwv", Jb, dinv_b, Jb)
        # barrier diag + identity pins on the border
        wmask = c("wmask", like)
        sig_w = sig_ext[:, c("border_free_pos", like)] * wmask
        Bm = Bm + torch.diag_embed(sig_w + (1.0 - wmask))

        # integral-row dual regularization values (D = 1/dinv)
        d_ib = 1.0 / torch.clamp(dinv_rows[:, c("i_rows", like)],
                                 min=1e-300)

        zmask_t = tuple(c(f"zmask{i}", like)
                        for i in range(len(self.phase_static)))

        def variant(key):
            ph = tuple(PhaseBand(Dblk=pb.Dblk + dh[key], Ublk=pb.Ublk,
                                 Cblk=pb.Cblk + ch[key], Gz=pb.Gz)
                       for pb, (dh, ch) in zip(phases, phases_H))
            return ArrowBlocks(phases=ph, B=Bm + BH[key], Gw=Gw, d_ib=d_ib,
                               zmask=zmask_t, wmask=wmask)

        return variant("e"), variant("c")

    def _scatter_node_blocks(self, i, ps, pl, NBlk, CBlk, Dblk, Cblk, Bm,
                             like):
        """Scatter per-node (B, N, nz, nz) / (B, N, nbc, nz) blocks into the
        band (returned) and the border ``Bm`` (in place)."""
        c = self._c
        nz, mb, MB, Kg = ps.nz, ps.mb, ps.MB, ps.Kg
        Bn = NBlk.shape[0]
        tws = c(f"tws{i}", like)
        z0_r, zend_r = c(f"z0_r{i}", like), c(f"zend_r{i}", like)
        gidx = c(f"gidx{i}", like)
        # interior nodes -> group block-diagonal
        NB_g = torch.cat([NBlk, torch.zeros_like(NBlk[:, :1])],
                         dim=1)[:, gidx]                   # (B, K, mb, nz, nz)
        slots = torch.arange(mb, device=like.device)
        Dexp = NBlk.new_zeros((Bn, Kg, mb, nz, mb, nz))
        # two index arrays split by a slice: the indexed axis goes first
        Dexp[:, :, slots, :, slots, :] = NB_g.permute(2, 0, 1, 3, 4)
        Dblk = Dblk + Dexp.reshape(Bn, Kg, MB, MB)
        # interior nodes -> border coupling rows
        CB_g = torch.cat([CBlk, torch.zeros_like(CBlk[:, :1])],
                         dim=1)[:, gidx]                  # (B, K, mb, nbc, nz)
        CB_g = CB_g.movedim(3, 2).reshape(Bn, Kg, -1, MB)
        Cblk = Cblk.index_add(2, tws, CB_g)
        # endpoint nodes -> border
        z0_sl = slice(ps.z0_off, ps.z0_off + nz)
        zend_sl = slice(ps.zend_off, ps.zend_off + nz)
        Bm[:, z0_sl, z0_sl] += NBlk[:, 0]
        Bm[:, zend_sl, zend_sl] += NBlk[:, pl.N - 1]
        _add_block(Bm, tws, z0_r, CBlk[:, 0])
        _add_block(Bm, z0_r, tws, CBlk[:, 0].mT)
        _add_block(Bm, tws, zend_r, CBlk[:, pl.N - 1])
        _add_block(Bm, zend_r, tws, CBlk[:, pl.N - 1].mT)
        return Dblk, Cblk

    # ------------------------------------------------------------------
    def factor(self, blocks, dw):
        return arrow_factor(blocks, dw)

    def _rhs_to_struct(self, rhs_free):
        """(B, n_free) -> per-phase (B, K, MB) and border (B, nw); pads and
        pinned entries read 0."""
        c = self._c
        ext = torch.cat([rhs_free, rhs_free.new_zeros(
            (rhs_free.shape[0], 1))], dim=1)
        rz = [ext[:, c(f"z_free_pos{i}", rhs_free)]
              for i in range(len(self.zmaps))]
        return rz, ext[:, c("border_free_pos", rhs_free)]

    def _struct_to_free(self, dz_list, dw_vec):
        """Per-phase (B, K, MB) and border (B, nw) -> (B, n_free)."""
        flat = torch.cat([dz.reshape(dz.shape[0], -1) for dz in dz_list]
                         + [dw_vec], dim=1)
        return flat[:, self._c("struct_pos", flat)]

    def solve(self, blocks, factors, rhs_free):
        rz, rw = self._rhs_to_struct(rhs_free)
        dz, dw_vec = arrow_solve(factors, rz, rw)
        return self._struct_to_free(dz, dw_vec)

    def kmul(self, blocks, dw, dx_free):
        """K @ dx in free space (B, n_free), exact; ``dw`` (B,)."""
        rz, rw = self._rhs_to_struct(dx_free)
        out_z = []
        out_w = torch.zeros_like(rw)
        gsum = rw.new_zeros(rw.shape[:1] + blocks.d_ib.shape[-1:])
        for pb, z, zm in zip(blocks.phases, rz, blocks.zmask):
            MB = pb.Dblk.shape[-1]
            nz = pb.Ublk.shape[-1]
            oz = _mv(pb.Dblk, z)
            # sub-diagonal couplings
            z_prev_tail = torch.cat([torch.zeros_like(z[:, :1, :nz]),
                                     z[:, :-1, MB - nz:]], dim=1)
            oz = oz + _mv(pb.Ublk, z_prev_tail)
            up = _mv(pb.Ublk.mT, z)                        # (B, K, nz)
            oz[:, :-1, MB - nz:] += up[:, 1:]
            oz = oz + torch.einsum("xkwa,xw->xka", pb.Cblk, rw)
            oz = oz + dw[:, None, None] * zm * z
            out_w = out_w + torch.einsum("xkwa,xka->xw", pb.Cblk, z)
            gsum = gsum + torch.einsum("xkar,xka->xr", pb.Gz, z)
            out_z.append(oz)
        out_w = out_w + _mv(blocks.B, rw) + dw[:, None] * blocks.wmask * rw
        gsum = gsum + _mv(blocks.Gw.mT, rw)
        coef = gsum / torch.clamp(blocks.d_ib, min=1e-300)
        out_z = [oz + _mv(pb.Gz, coef[:, None, :])
                 for oz, pb in zip(out_z, blocks.phases)]
        out_w = out_w + _mv(blocks.Gw, coef)
        return self._struct_to_free(out_z, out_w)
