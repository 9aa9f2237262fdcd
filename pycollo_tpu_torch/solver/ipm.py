"""Batch-first primal-dual interior-point NLP solver (dense condensed path).

PyTorch port of ``pycollo_tpu/solver/ipm.py``, the replacement for the
reference's IPOPT+MUMPS process boundary (``pycollo/backend.py:1681-1711``).
Every tensor carries a leading instance axis B: the solver advances all
instances together, holds an ``active`` mask, and freezes finished
instances with ``torch.where`` on every state field — what a batched
``while_loop`` does — so each instance of a batch gives the result it gives
when solved alone.

Problem form (IPOPT-style, matching the reference NLP callback contract in
``pycollo/nlp.py:36-77``)::

    min  f(x)   s.t.  cl <= c(x) <= cu,   xl <= x <= xu

Rows with ``cl == cu`` are equalities; the rest get slack variables.  The
KKT system is solved in *condensed* form, ``K = W + J^T J / dc`` with
``W = H + Sigma + dw*I``, factored by Cholesky at a speculative ladder of
``dw`` levels in one batched call; a failed factorization shows up as a
NaN or sub-floor pivot and selects a higher level.  With
``kkt_precision="mixed"`` the factorization is float32 (on CUDA through the
hand-written kernel of :mod:`pycollo_tpu_torch.ops.block_chol`) and the step
is refined by GMRES on the unregularized coupled KKT system against the
f64 residual.

Ported: the dense path with the Wächter–Biegler filter line search and the
l1-merit Armijo line search, speculative and sequential ("loop") inertia
correction, feasibility restoration, both barrier strategies, generic
``torch.func`` derivatives for NLPs given without structured ones, and the
block-banded structured path (``linear_solver="block-banded"``,
``compute_step_structured``): slacks eliminated analytically, the
condensed system factored in banded-arrowhead form (``solver/banded.py``)
at a speculative ladder of ``dw`` levels whose last level is the
convexified Hessian, and the step solved by GMRES with the exact banded
matvec, matrix-free (J^T lam from one VJP, J dx from one JVP; no dense
Jacobian).  The banded path runs in the working dtype (f64).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev, jvp, vjp, vmap
from torch.profiler import record_function

from ..utils import DeviceConstants
from .banded import ArrowBlocks, PhaseBand, _mv
from .krylov import gmres_right


@dataclass(frozen=True)
class IPMOptions:
    tol: float = 1e-8
    max_iter: int = 200
    mu_init: float = 1e-1
    mu_min: float = 1e-11
    #: barrier update strategy: "adaptive" follows IPOPT's LOQO-style
    #: centrality rule (the reference's explicit IPOPT override,
    #: ``pycollo/backend.py:1707``); "monotone" is the Fiacco-McCormick
    #: staircase.
    mu_strategy: str = "adaptive"
    #: barrier decrease: mu <- max(tol/10, min(kappa_mu*mu, mu^theta_mu))
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    #: barrier error threshold: advance mu when E_mu <= kappa_eps * mu
    kappa_eps: float = 10.0
    tau_min: float = 0.99
    #: Armijo constant and number of backtracking halvings (evaluated as one
    #: batched trial-point sweep)
    eta_armijo: float = 1e-4
    max_ls: int = 12
    #: globalization: "filter" is the Wächter–Biegler filter line search
    #: (what IPOPT runs); "merit" is the l1-merit Armijo line search.
    line_search: str = "filter"
    #: filter constants (IPOPT eq. 18-20 defaults)
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-8
    delta_sw: float = 1.0
    s_theta: float = 1.1
    s_phi: float = 2.3
    #: maximum retained filter entries (oldest overwritten beyond this)
    filter_size: int = 64
    #: primal (dw) and dual (dc) regularization management
    delta_w_init: float = 0.0
    delta_w_min: float = 1e-20
    delta_w_first: float = 1e-4
    delta_w_up: float = 8.0
    delta_w_max: float = 1e10
    #: floor for the dual regularization dc = max(1e-8 * mu^(1/4),
    #: dc_floor).  The mixed-precision path raises it (e.g. 1e-7): a larger
    #: dc caps the condition number of the condensed matrix at ~1/dc, which
    #: is what makes an f32 factorization converge.
    dc_floor: float = 1e-12
    #: dual-regularization floor for the block-banded path, capped at
    #: 0.1 * tol.  Its factorization carries the low-rank integral columns
    #: amplified by 1/D ~ 1/dc; with the dense path's negligible floor that
    #: term dominates the band by ~1e12 at small mu and the Newton step is
    #: lost (measured on cart-pole: converges to 1e-4, then diverges).  The
    #: floor must sit below the tolerance (the reachable KKT residual is
    #: O(dc)-limited) but high enough to cap the amplification; the GMRES
    #: refinement recovers the accuracy the regularization gives up.
    dc_floor_banded: float = 3e-7
    #: feasibility restoration (IPOPT section 3.3 analogue): when the
    #: filter line search keeps failing with significant constraint
    #: violation, minimize the violation itself until it drops by
    #: kappa_resto, with the reference's guard rails (entry after
    #: ``resto_entry_fails`` consecutive failures, exit after
    #: ``resto_stall_patience`` stalled iterations, at most
    #: ``resto_max_entries`` entries per solve).
    restoration: bool = True
    kappa_resto: float = 0.1
    resto_entry_fails: int = 2
    resto_stall_patience: int = 5
    resto_min_decrease: float = 1e-3
    resto_max_entries: int = 3
    #: inertia correction: "speculative" factors the condensed matrix at
    #: several regularization levels in one batched call and keeps the
    #: first positive-definite level per instance; "loop" is the IPOPT-style
    #: sequential escalation (dw = 0 first, then up until positive definite).
    inertia: str = "speculative"
    #: speculative regularization levels as multipliers of 0.3*dw_last
    #: (level 0 is always dw = 0); instances not positive definite at any
    #: level fall back to an escalation loop above the top level.
    spec_levels: tuple = (1.0, 32.0, 1024.0, 32768.0, 1048576.0)
    #: append a delta_w_max capstone level to the speculative stack
    spec_capstone: bool = False
    #: bound-multiplier safeguard (IPOPT's kappa_Sigma)
    kappa_sigma: float = 1e10
    #: interior projection margins for the initial point
    kappa_1: float = 1e-2
    kappa_2: float = 1e-2
    s_max: float = 100.0
    #: KKT factorization precision: "f64" or "mixed" (factor the
    #: equilibrated condensed matrix in f32 — on CUDA through the
    #: hand-written Cholesky kernel — and refine against the f64 residual)
    kkt_precision: str = "f64"
    #: rounds of iterative refinement per KKT solve ("ir" refinement)
    ir_rounds: int = 2
    #: dense step refinement: "ir" refines against the regularized KKT
    #: system; "gmres" runs right-preconditioned GMRES on the unregularized
    #: coupled KKT system with the factored condensed matrix as
    #: preconditioner.  "auto" = gmres when mixed, ir for f64.
    dense_refine: str = "auto"
    #: GMRES iterations for the coupled-KKT refinement
    dense_gmres_iters: int = 6
    #: evaluation dtype for derivative ASSEMBLY: "f64" or "f32".  In "f32"
    #: mode the assembled Jacobian/Hessian feed only the factorization and
    #: the GMRES operator; the step rhs uses an exact f64 J^T lam from one
    #: VJP, and the state, residuals, line search and reported KKT error
    #: stay f64.  Requires kkt_precision="mixed".
    eval_dtype: str = "f64"
    #: Krylov iterations for the structured (block-banded) step solve.  The
    #: banded factorization's nested Schur layers cancel in a few
    #: border/low-rank directions near a solution (iteration-matrix spectral
    #: radius ~150: plain iterative refinement diverges), so the step is
    #: solved by GMRES with the factorization as right preconditioner; the
    #: few bad directions contract in as many iterations.
    gmres_iters: int = 10


class IPMResult(NamedTuple):
    x: torch.Tensor          # (B, n) primal solution (no slacks)
    slack: torch.Tensor      # (B, ns) slack values for inequality rows
    lam: torch.Tensor        # (B, m) constraint multipliers
    zl: torch.Tensor         # (B, nv) lower bound multipliers (on [x; slack])
    zu: torch.Tensor         # (B, nv) upper bound multipliers
    f: torch.Tensor          # (B,) objective value at solution
    kkt_error: torch.Tensor  # (B,) final scaled KKT error E_0
    mu: torch.Tensor         # (B,) final barrier parameter
    iterations: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool


class _State(NamedTuple):
    """Solver state; every field has the leading instance axis."""
    v: torch.Tensor
    lam: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    dw: torch.Tensor
    dw_last: torch.Tensor
    it: torch.Tensor
    e0: torch.Tensor
    done: torch.Tensor
    #: Wächter–Biegler filter (fixed-capacity arrays; entries store the
    #: already-reduced pair ((1-gamma_theta) theta, phi - gamma_phi theta))
    fth: torch.Tensor
    fph: torch.Tensor
    fcnt: torch.Tensor
    th_min: torch.Tensor
    th_max: torch.Tensor
    mu_f: torch.Tensor
    #: feasibility-restoration mode flag + the violation at entry
    rmode: torch.Tensor
    th_enter: torch.Tensor
    #: consecutive line-search failures, consecutive restoration stalls,
    #: and total restoration entries
    ls_fail: torch.Tensor
    r_stall: torch.Tensor
    r_ent: torch.Tensor
    #: best-KKT-error safeguard: the iterate with the smallest scaled KKT
    #: error seen so far (returned instead of the last iterate)
    be0: torch.Tensor
    bv: torch.Tensor
    blam: torch.Tensor
    bzl: torch.Tensor
    bzu: torch.Tensor


def _where(cond, a, b):
    """``torch.where`` with a per-instance (B,) condition."""
    if not torch.is_tensor(a):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    nd = max(a.dim(), b.dim() if torch.is_tensor(b) else 0)
    return torch.where(cond.reshape(cond.shape + (1,) * (nd - cond.dim())),
                       a, b)


def _first_true(mask):
    """Index of the first True along the last axis (0 when none is)."""
    return mask.to(torch.int32).argmax(dim=-1)


def _take(a, idx):
    """a[b, idx[b]] for a (B, L, ...) and idx (B,)."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def _interior_init(x0, xl, xu, k1, k2):
    """Project the start point strictly inside the bounds (IPOPT sec 3.6)."""
    has_l = xl > -math.inf
    has_u = xu < math.inf
    both = has_l & has_u
    one = torch.ones_like(xl)
    pl = torch.where(both, torch.minimum(k1 * torch.maximum(one, xl.abs()),
                                         k2 * (xu - xl)),
                     k1 * torch.maximum(one, xl.abs()))
    pu = torch.where(both, torch.minimum(k1 * torch.maximum(one, xu.abs()),
                                         k2 * (xu - xl)),
                     k1 * torch.maximum(one, xu.abs()))
    x = torch.where(has_l, torch.maximum(x0, xl + pl), x0)
    x = torch.where(has_u, torch.minimum(x, xu - pu), x)
    return x


def build_ipm_solver(f_fn: Callable, c_fn: Callable,
                     xl: np.ndarray, xu: np.ndarray,
                     cl: np.ndarray, cu: np.ndarray,
                     options: IPMOptions = IPMOptions(),
                     derivatives: dict = None):
    """Build a batched IPM solver for one NLP family.

    ``f_fn(x, theta) -> (B,)`` and ``c_fn(x, theta) -> (B, m)`` take
    batch-first ``x`` (B, n) and ``theta`` (B, p), treat instances
    independently, and must be differentiable by ``torch.func``.  Bounds are
    numpy arrays (they define the slack layout and masks).
    ``derivatives`` optionally supplies structured evaluators
    ``{"grad_f": (x, theta) -> (B, n), "jac_c": (x, theta) -> (B, m, n),
    "hess_lag": (x, lam, theta) -> (B, n, n)}`` (e.g. the transcription's
    per-node block assembly); those missing come from ``torch.func``,
    batched over the instance axis with ``vmap``.  J^T lam always comes
    from one VJP.  Returns ``solve(x0, theta) -> IPMResult`` for ``x0``
    (B, n) and ``theta`` (B, p); the dtype of ``theta`` is the working
    dtype and its device the device of the solve.
    """
    opt = options
    if opt.line_search not in ("filter", "merit"):
        raise ValueError(f"line_search={opt.line_search!r}: expected "
                         f"'filter' or 'merit'.")
    if opt.inertia not in ("speculative", "loop"):
        raise ValueError(f"inertia={opt.inertia!r}: expected "
                         f"'speculative' or 'loop'.")
    xl = np.asarray(xl, dtype=float)
    xu = np.asarray(xu, dtype=float)
    cl = np.asarray(cl, dtype=float)
    cu = np.asarray(cu, dtype=float)
    n = xl.shape[0]
    m = cl.shape[0]
    eq_mask_np = np.isclose(cl, cu)
    ineq_idx = np.nonzero(~eq_mask_np)[0]
    ns = len(ineq_idx)
    nv = n + ns

    # Bounds on v = [x; slack].
    vl = np.concatenate([xl, cl[ineq_idx]])
    vu = np.concatenate([xu, cu[ineq_idx]])
    has_l = vl > -1e18
    has_u = vu < 1e18
    vl_f = np.where(has_l, vl, -1.0)   # placeholder values where infinite
    vu_f = np.where(has_u, vu, 1.0)
    rhs_eq = np.where(eq_mask_np, cl, 0.0)
    # Constant slack block of the constraint Jacobian: J_v = [J_c | J_s].
    J_s = np.zeros((m, ns))
    J_s[ineq_idx, np.arange(ns)] = -1.0
    consts = DeviceConstants(vl=vl_f, vu=vu_f, has_l=has_l, has_u=has_u,
                             Js=J_s, rhs_eq=rhs_eq, ineq_idx=ineq_idx,
                             eq_mask=eq_mask_np,
                             xl=xl, xu=xu, cl_in=cl[ineq_idx],
                             cu_in=cu[ineq_idx])

    from .linalg import make_spd_solver
    mixed = opt.kkt_precision == "mixed"
    # Mixed: float32 blocked Cholesky inverse (the CUDA kernel on CUDA
    # tensors, its plain PyTorch version on CPU tensors).
    spd_factor, spd_solve, spd_diag = make_spd_solver(kernel=mixed)
    fac_dtype = torch.float32 if mixed else None
    use_gmres_dense = (opt.dense_refine == "gmres"
                       or (opt.dense_refine == "auto" and mixed))
    ev32 = opt.eval_dtype == "f32"
    if ev32 and not mixed:
        raise ValueError(
            'eval_dtype="f32" requires kkt_precision="mixed" (the f64 '
            'factorization path would promote the f32 blocks back).')

    derivatives = derivatives or {}

    # Per-instance views of the batch-first functions for the generic
    # torch.func derivatives (the instance keeps a singleton batch axis).
    def f_one(x, theta):
        return f_fn(x[None], theta[None])[0]

    def c_one(x, theta):
        return c_fn(x[None], theta[None])[0]

    def lagrangian(x, lam, theta):
        return f_one(x, theta) + c_one(x, theta) @ lam

    def grad_f_ad(x, theta):
        # instances are independent: the gradient of the batch sum is the
        # stack of the per-instance gradients
        return grad(lambda xx: f_fn(xx, theta).sum())(x)

    def jac_c_ad(x, theta):
        jac = jacfwd(c_one) if n <= 4 * m else jacrev(c_one)
        return vmap(jac)(x, theta)

    def hess_lag_ad(x, lam, theta):
        return vmap(hessian(lagrangian))(x, lam, theta)

    grad_f = derivatives.get("grad_f") or grad_f_ad
    jac_c = derivatives.get("jac_c") or jac_c_ad
    hess_lag = derivatives.get("hess_lag") or hess_lag_ad

    def jt_lam(x, lam, theta):
        """Exact J^T lam (B, n) from one VJP of the batched constraints."""
        _, c_vjp = vjp(lambda xx: c_fn(xx, theta), x)
        return c_vjp(lam)[0]

    def g_fn(v, theta):
        """Equality-form residual g(v) = c(x) - slack/rhs, (B, m).

        Dtype-polymorphic: theta's dtype governs."""
        dt = theta.dtype
        v = v.to(dt)
        cx = c_fn(v[:, :n], theta)
        if ns:
            slack_full = torch.zeros_like(cx).index_copy(
                1, consts("ineq_idx", v), v[:, n:])
            cx = cx - slack_full
        return cx - consts("rhs_eq", cx)

    def dists(v):
        dl = torch.where(consts("has_l", v), v - consts("vl", v), 1.0)
        du = torch.where(consts("has_u", v), consts("vu", v) - v, 1.0)
        return dl, du

    def barrier(v, mu):
        hl, hu = consts("has_l", v), consts("has_u", v)
        dl, du = dists(v)
        bl = torch.where(hl, torch.log(torch.clamp(dl, min=1e-300)), 0.0)
        bu = torch.where(hu, torch.log(torch.clamp(du, min=1e-300)), 0.0)
        feas = (torch.where(hl, dl, 1.0) > 0.0).all(-1) \
            & (torch.where(hu, du, 1.0) > 0.0).all(-1)
        val = -mu * (bl.sum(-1) + bu.sum(-1))
        return torch.where(feas, val, math.inf)

    def merit(v, mu, nu, theta):
        """l1 merit function f + barrier + nu * |g|_1, (B,)."""
        v = v.to(theta.dtype)
        return f_fn(v[:, :n], theta) + barrier(v, mu) \
            + nu * g_fn(v, theta).abs().sum(-1)

    def kkt_error_pre(gf, Jtlam, rg, v, lam, zl, zu, mu):
        """Scaled KKT error (IPOPT eq. 5) from precomputed derivatives,
        (B,); ``mu`` is (B,) or a number."""
        rd_x = gf + Jtlam
        rd_s = -lam[:, consts("ineq_idx", v)]
        rd = torch.cat([rd_x, rd_s], dim=-1) - zl + zu
        mu_c = mu[:, None] if torch.is_tensor(mu) else mu
        dl, du = dists(v)
        compl_l = torch.where(consts("has_l", v), dl * zl - mu_c, 0.0)
        compl_u = torch.where(consts("has_u", v), du * zu - mu_c, 0.0)
        zsum = zl.abs().sum(-1) + zu.abs().sum(-1)
        lsum = lam.abs().sum(-1)
        sd = torch.clamp((lsum + zsum) / max(m + 2 * nv, 1),
                         min=opt.s_max) / opt.s_max
        sc = torch.clamp(zsum / max(2 * nv, 1), min=opt.s_max) / opt.s_max
        e = rd.abs().amax(-1) / sd
        if m:
            e = torch.maximum(e, rg.abs().amax(-1))
        if nv:
            e = torch.maximum(e, torch.maximum(compl_l.abs().amax(-1) / sc,
                                               compl_u.abs().amax(-1) / sc))
        return e

    def kkt_error(v, lam, zl, zu, mu, theta):
        """KKT error with fresh f64 derivative evaluation."""
        x = v[:, :n]
        return kkt_error_pre(grad_f(x, theta), jt_lam(x, lam, theta),
                             g_fn(v, theta), v, lam, zl, zu, mu)

    def compute_step(v, lam, zl, zu, mu, dw_last, theta, gf, Jc, rg,
                     restore, Jtlam64=None):
        """Condensed-space Newton step for every instance.

        Factors the equilibrated condensed matrix at a speculative ladder
        of ``dw`` levels in one batched call and keeps, per instance, the
        first positive-definite level; instances with none escalate above
        the top level in a loop that updates only them.  ``restore``
        (B,) bool: feasibility-restoration mode (the caller passes
        ``gf = 0`` for those instances and the Hessian becomes a proximal
        identity).  Returns (dv, dlam, dzl, dzu, step_dir, dw_used, ok,
        corrector).
        """
        B = v.shape[0]
        dev = v.device
        x = v[:, :n]
        hl, hu = consts("has_l", v), consts("has_u", v)
        if ev32:
            H = hess_lag(x.float(), lam.float(), theta.float())
            H = _where(restore, torch.eye(n, dtype=torch.float32,
                                          device=dev), H)
        else:
            H = hess_lag(x, lam, theta)
            H = _where(restore, torch.eye(n, dtype=v.dtype, device=dev), H)
        dl, du = dists(v)
        mu_c = mu[:, None]
        sig_l = torch.where(hl, zl / dl, 0.0)
        sig_u = torch.where(hu, zu / du, 0.0)
        mu_dl = torch.where(hl, mu_c / dl, 0.0)
        mu_du = torch.where(hu, mu_c / du, 0.0)

        W0 = torch.zeros((B, nv, nv), dtype=v.dtype, device=dev)
        W0[:, :n, :n] = H
        W0 = W0 + torch.diag_embed(sig_l + sig_u)
        # In eval_dtype="f32" mode Jc arrives f32 and is only the OPERATOR
        # (factorization + GMRES matvecs); the step rhs uses the exact f64
        # J^T lam from a VJP (Jtlam64) so the Newton fixed point is the
        # true KKT point.
        Jc64 = Jc.to(v.dtype)
        J = torch.cat([Jc64, consts("Js", v).expand(B, m, ns)], dim=2)
        Jt = J.transpose(1, 2)

        rd_x = gf + (_mv(Jc64.transpose(1, 2), lam) if Jtlam64 is None
                     else Jtlam64)
        rd_s = -lam[:, consts("ineq_idx", v)]
        rd = torch.cat([rd_x, rd_s], dim=-1) - mu_dl + mu_du

        # Dual regularization: relaxes equality rows so the condensed
        # matrix K = W + J^T J / dc is positive definite under SOSC
        # (MadNLP-style "LDL-free" condensed-space KKT; see PAPERS.md).
        dc = torch.clamp(1e-8 * torch.sqrt(torch.sqrt(mu)), min=opt.dc_floor)
        dc_c = dc[:, None]
        # K is only ever factored: every residual below is computed from
        # W0/J/dc directly.  In mixed mode the JtJ product and the
        # factorization run in f32.
        if mixed:
            J_fc = J.to(fac_dtype)
            W0_fc = W0.to(fac_dtype)
            piv_floor = 1e-16
        else:
            J_fc = J
            W0_fc = W0
            piv_floor = 1e-100
        Jt_fc = J_fc.transpose(1, 2)
        eye_f = torch.eye(nv, dtype=J_fc.dtype, device=dev)
        K0_f = W0_fc + (Jt_fc @ J_fc) / dc.to(J_fc.dtype)[:, None, None]

        def equil_factor(Kmat):
            """Jacobi-equilibrated Cholesky of a (B, ..., nv, nv) stack.

            K' = D K D with D = diag(K)^-1/2 bounds factor growth by the
            scaled condition number (the role pivoting plays in MUMPS)."""
            dK = torch.sqrt(torch.clamp(
                torch.diagonal(Kmat, dim1=-2, dim2=-1), min=1e-30))
            Ks = Kmat / dK[..., :, None] / dK[..., None, :]
            factors_ = spd_factor(Ks)
            # Indefiniteness: NaN or sub-floor pivots (a healthy pivot of
            # the equilibrated matrix is O(1)).
            diag = spd_diag(factors_)
            lvl_ok = torch.isfinite(diag).all(-1) \
                & ~(diag < piv_floor).any(-1)
            return factors_, dK, lvl_ok

        def ksolve(factors_, dK64, rhs):
            z = spd_solve(factors_, (rhs / dK64).to(fac_dtype or v.dtype))
            return z.to(v.dtype) / dK64

        def gmres_solve(factors_, dK64, dw, rhs, iters):
            """Coupled-KKT GMRES in the factorization dtype: the f64 rhs
            pins the outer fixed point; the refinement only needs accuracy
            relative to the step."""
            fdt = fac_dtype or v.dtype
            dK_f = dK64.to(fdt)
            dc_f = dc_c.to(fdt)
            dw_f = dw.to(fdt)[:, None]

            def prec(r):
                r1 = r[:, :nv]
                r2 = r[:, nv:]
                dv_ = spd_solve(factors_, (r1 + _mv(Jt_fc, r2 / dc_f))
                                / dK_f) / dK_f
                return torch.cat([dv_, (_mv(J_fc, dv_) - r2) / dc_f], dim=-1)

            def amul(wv):
                dv_ = wv[:, :nv]
                dl_ = wv[:, nv:]
                return torch.cat([_mv(W0_fc, dv_) + dw_f * dv_
                                  + _mv(Jt_fc, dl_), _mv(J_fc, dv_)], dim=-1)

            sol = gmres_right(amul, prec, rhs.to(fdt), iters)
            return sol[:, :nv].to(v.dtype), sol[:, nv:].to(v.dtype)

        def solve_with(factors_, dK64, dw):
            """KKT solve + refinement on given factors."""
            if use_gmres_dense:
                dv, dlam = gmres_solve(factors_, dK64, dw,
                                       torch.cat([-rd, -rg], dim=-1),
                                       opt.dense_gmres_iters)
            else:
                dv = ksolve(factors_, dK64, -(rd + _mv(Jt, rg / dc_c)))
                dlam = (_mv(J, dv) + rg) / dc_c
                # Iterative refinement on the regularized KKT residual
                # (always f64).
                for _ in range(opt.ir_rounds):
                    res1 = -rd - (_mv(W0, dv) + dw[:, None] * dv
                                  + _mv(Jt, dlam))
                    res2 = -rg - (_mv(J, dv) - dc_c * dlam)
                    ev = ksolve(factors_, dK64, res1 + _mv(Jt, res2 / dc_c))
                    dv = dv + ev
                    dlam = dlam + (_mv(J, ev) - res2) / dc_c
            solved_ok = ~(torch.isnan(dv).any(-1) | torch.isinf(dv).any(-1)
                          | torch.isnan(dlam).any(-1))
            return dv, dlam, solved_ok

        def attempt(dw):
            K = K0_f + dw.to(K0_f.dtype)[:, None, None] * eye_f
            factors_, dK, lvl_ok = equil_factor(K)
            dK64 = dK.to(v.dtype)
            dv, dlam, solved_ok = solve_with(factors_, dK64, dw)
            return dv, dlam, lvl_ok & solved_ok, (factors_, dK64)

        if opt.inertia == "speculative":
            # Speculative multi-level inertia correction: factor K at
            # dw in {0, spec_levels * 0.3*dw_last (, delta_w_max)} in ONE
            # batched call and keep the first positive-definite level.
            dw1 = torch.clamp(0.3 * dw_last, min=opt.delta_w_min)
            dws = torch.stack(
                [torch.zeros_like(dw1)]
                + [torch.clamp(m_ * dw1, max=opt.delta_w_max)
                   for m_ in opt.spec_levels]
                + ([torch.full_like(dw1, opt.delta_w_max)]
                   if opt.spec_capstone else []), dim=1)          # (B, L)
            K_all = K0_f[:, None] \
                + dws.to(K0_f.dtype)[:, :, None, None] * eye_f
            fac_all, dK_all, lvl_ok = equil_factor(K_all)
            lvl = _first_true(lvl_ok)
            any_lvl = lvl_ok.any(-1)
            factors_sel = tuple(_take(a, lvl) for a in fac_all) \
                if isinstance(fac_all, tuple) else _take(fac_all, lvl)
            dK64 = _take(dK_all, lvl).to(v.dtype)
            dw_spec = _take(dws, lvl)
            dv, dlam, solved_ok = solve_with(factors_sel, dK64, dw_spec)
            ok0 = any_lvl & solved_ok
            # Escalation above the top level for the instances still
            # indefinite (a batched while_loop: instances whose condition is
            # false keep their values); zero trips when all are satisfied.
            dw_esc = dws[:, -1]
            ok = ok0
            k = torch.ones(B, dtype=torch.int32, device=dev)
            factors = (factors_sel, dK64)
            while True:
                esc = (~ok) & (k < 30)
                if not bool(esc.any()):
                    break
                dw_next = torch.where(
                    dw_esc == 0.0, torch.clamp(0.3 * dw_last,
                                               min=opt.delta_w_min),
                    dw_esc * opt.delta_w_up)
                dw_next = torch.clamp(dw_next, max=opt.delta_w_max)
                dv_n, dlam_n, ok_n, fac_n = attempt(dw_next)
                dw_esc = _where(esc, dw_next, dw_esc)
                dv = _where(esc, dv_n, dv)
                dlam = _where(esc, dlam_n, dlam)
                ok = _where(esc, ok_n, ok)
                factors = _tree_map(lambda a, b: _where(esc, a, b), fac_n,
                                    factors)
                k = k + esc.to(torch.int32)
            # dw of the SELECTED factors (fed to the corrector's exact KKT
            # operator) vs the value reported to the dw_last heuristic: the
            # capstone level must not ratchet dw_last to delta_w_max.
            dw_op = torch.where(ok0, dw_spec, dw_esc)
            dw_rep = dw_spec
            if opt.spec_capstone:
                dw_rep = torch.where(
                    lvl == dws.shape[1] - 1,
                    torch.clamp(opt.delta_w_up * dws[:, -2],
                                max=opt.delta_w_max), dw_spec)
            dw_used = torch.where(ok0, dw_rep, dw_esc)
        else:
            # IPOPT-style sequential escalation: dw = 0 first, then
            # 0.3 * dw_last, then up by delta_w_up until the factorization
            # succeeds; an instance stops escalating once it has (a batched
            # do-while: the others keep their values).
            dw_op = torch.zeros(B, dtype=v.dtype, device=dev)
            dv = torch.zeros((B, nv), dtype=v.dtype, device=dev)
            dlam = torch.zeros((B, m), dtype=v.dtype, device=dev)
            ok = torch.zeros(B, dtype=torch.bool, device=dev)
            k = torch.zeros(B, dtype=torch.int32, device=dev)
            factors = None
            while True:
                esc = (~ok) & (k < 30)
                if not bool(esc.any()):
                    break
                dw_next = torch.where(
                    k == 0, 0.0,
                    torch.where(dw_op == 0.0,
                                torch.clamp(0.3 * dw_last,
                                            min=opt.delta_w_min),
                                dw_op * opt.delta_w_up))
                dw_next = torch.clamp(dw_next, max=opt.delta_w_max)
                dv_n, dlam_n, ok_n, fac_n = attempt(dw_next)
                dw_op = _where(esc, dw_next, dw_op)
                dv = _where(esc, dv_n, dv)
                dlam = _where(esc, dlam_n, dlam)
                ok = _where(esc, ok_n, ok)
                factors = fac_n if factors is None else _tree_map(
                    lambda a, b: _where(esc, a, b), fac_n, factors)
                k = k + esc.to(torch.int32)
            dw_used = dw_op

        dzl = torch.where(hl, mu_dl - zl - sig_l * dv, 0.0)
        dzu = torch.where(hu, mu_du - zu + sig_u * dv, 0.0)
        # Sigma can overflow for near-boundary iterates even when dv is
        # finite; a non-finite dual displacement marks the step failed.
        ok = ok & torch.isfinite(dzl).all(-1) & torch.isfinite(dzu).all(-1)
        # Directional derivative of the barrier objective along dv.
        step_dir = (gf * dv[:, :n]).sum(-1) - (mu_dl * dv).sum(-1) \
            + (mu_du * dv).sum(-1)

        def corrector(rg_soc):
            """Solve the KKT system with rhs (0, rg_soc) on the existing
            factorization (second-order corrections)."""
            fac, dK64_ = factors
            if use_gmres_dense:
                return gmres_solve(
                    fac, dK64_, dw_op,
                    torch.cat([torch.zeros_like(rd), -rg_soc], dim=-1),
                    max(3, opt.dense_gmres_iters // 2))
            dv_c = ksolve(fac, dK64_, -_mv(Jt, rg_soc / dc_c))
            dlam_c = (_mv(J, dv_c) + rg_soc) / dc_c
            return dv_c, dlam_c

        return dv, dlam, dzl, dzu, step_dir, dw_used, ok, corrector

    kkt = derivatives.get("kkt")

    def compute_step_structured(v, lam, zl, zu, mu, dw_last, theta, gf, rg,
                                Jtlam, c_vjp, restore):
        """Newton step of every instance via the block-banded arrowhead KKT
        factorization (the ``linear_solver="block-banded"`` path).

        Matrix-free counterpart of ``compute_step``: slacks are eliminated
        analytically (per-row dual regularization ``D_i = dc +
        1/sigma_s_i``), the condensed system over the original variables is
        assembled and factored in banded-arrowhead form by ``kkt``, and
        every residual uses the VJP ``c_vjp`` or a JVP of the constraints —
        no dense Jacobian or Hessian.  ``gf`` is zero and the Hessian
        multipliers are dropped for instances in restoration (``restore``,
        (B,) bool), with a proximal identity through the barrier diagonal.
        Returns what ``compute_step`` returns.
        """
        B = v.shape[0]
        x = v[:, :n]
        hl, hu = consts("has_l", v), consts("has_u", v)
        ineq = consts("ineq_idx", v)
        dl, du = dists(v)
        mu_c = mu[:, None]
        sig_l = torch.where(hl, zl / dl, 0.0)
        sig_u = torch.where(hu, zu / du, 0.0)
        sig = sig_l + sig_u
        mu_dl = torch.where(hl, mu_c / dl, 0.0)
        mu_du = torch.where(hu, mu_c / du, 0.0)
        sig_x = sig[:, :n]
        sig_s = torch.clamp(sig[:, n:], min=1e-300)
        rd_x = gf + Jtlam - mu_dl[:, :n] + mu_du[:, :n]
        rd_s = -lam[:, ineq] - mu_dl[:, n:] + mu_du[:, n:]
        # The reachable KKT residual is O(dc)-limited through the relaxed
        # equality rows, so the banded floor is capped at 0.1 * tol.
        floor_b = min(opt.dc_floor_banded, 0.1 * opt.tol)
        dc = torch.clamp(1e-8 * torch.sqrt(torch.sqrt(mu)),
                         min=max(opt.dc_floor, floor_b))
        dc_c = dc[:, None]
        # Slack elimination: row i gets D_i = dc (+ 1/sigma_s_i on
        # inequality rows) and the residual g~ = rg + rd_s / sigma_s.
        if ns:
            Dinv = torch.where(consts("eq_mask", v), 1.0 / dc_c,
                               torch.zeros_like(rg).index_copy(
                                   1, ineq, 1.0 / (dc_c + 1.0 / sig_s)))
            gtil = rg + torch.zeros_like(rg).index_copy(1, ineq,
                                                        rd_s / sig_s)
        else:
            Dinv = torch.ones_like(rg) / dc_c
            gtil = rg
        # Restoration: zero the Hessian multipliers (the per-node blocks
        # vanish) and add a proximal identity through the barrier diagonal:
        # damped Gauss-Newton on the violation.
        rst = restore.to(v.dtype)[:, None]
        with record_function("banded.assemble"):
            blocks_e, blocks_c = kkt.assemble(x, theta, lam * (1.0 - rst),
                                              sig_x + rst, Dinv)
        rhs = -(rd_x + c_vjp(Dinv * gtil)[0])

        def c_jvp(dxx):
            return jvp(lambda xx: c_fn(xx, theta), (x,), (dxx,))[1]

        def solve_refine(blocks, fac, dw, rhs_v, iters):
            """GMRES with the exact banded matvec ``kkt.kmul`` and the
            factored solve as right preconditioner: the factorization alone
            is off in a few border/low-rank directions near a solution, and
            the ``Dinv ~ 1/dc``-amplified dual recovery needs an f64-grade
            dx."""
            dxx = gmres_right(lambda z: kkt.kmul(blocks, dw, z),
                              lambda r: kkt.solve(blocks, fac, r), rhs_v,
                              iters)
            return dxx, Dinv * (c_jvp(dxx) + gtil)

        # Speculative multi-level inertia correction: factor at every dw
        # level of every instance in one batched call and keep, per
        # instance, the first positive-definite level.  The LAST level swaps
        # the exact Lagrangian Hessian for its per-node PSD projection at
        # dw ~ 0 (modified Newton): the banded M-block must be PD, strictly
        # stronger than the dense path's K > 0.
        dw1 = torch.clamp(0.3 * dw_last, min=opt.delta_w_min)
        dws = torch.stack([torch.zeros_like(dw1)]
                          + [torch.clamp(m_ * dw1, max=opt.delta_w_max)
                             for m_ in opt.spec_levels]
                          + [torch.full_like(dw1, 1e-10)], dim=1)  # (B, L)
        n_exact = 1 + len(opt.spec_levels)

        def levels(e, c):
            """(B, L, ...) stack: the exact blocks at the first n_exact
            levels, the convexified ones at the last; a tensor both variants
            share broadcasts over the levels."""
            if e is c:
                return e[:, None]
            return torch.cat([e[:, None].expand(B, n_exact, *e.shape[1:]),
                              c[:, None]], dim=1)

        blocks_lv = _map_blocks(levels, blocks_e, blocks_c)
        with record_function("banded.factor"):
            facs = kkt.factor(blocks_lv, dws)
        lvl = _first_true(facs.ok)
        any_lvl = facs.ok.any(-1)

        def pick(a):
            return a[:, 0] if a.shape[1] == 1 else _take(a, lvl)

        fac_sel = _tree_map(pick, facs)
        blocks_sel = _map_blocks(pick, blocks_lv)
        dw_spec = _take(dws, lvl)
        with record_function("banded.gmres"):
            dx, dlam = solve_refine(blocks_sel, fac_sel, dw_spec, rhs,
                                    opt.gmres_iters)
        ok0 = any_lvl & torch.isfinite(dx).all(-1) \
            & torch.isfinite(dlam).all(-1)
        # Only exact-level successes feed the dw heuristic.
        dw_heur = torch.where(lvl < n_exact, dw_spec, 0.0)

        # Escalation of the CONVEXIFIED blocks above the top exact level
        # for the instances with no usable level (a batched while_loop:
        # the others keep their values); zero trips when all are served.
        dw_esc = torch.clamp(dws[:, n_exact - 1], min=1e-8)
        ok = ok0
        k = torch.ones(B, dtype=torch.int32, device=v.device)
        fac_fin = fac_sel
        while True:
            esc = (~ok) & (k < 30)
            if not bool(esc.any()):
                break
            dw_next = torch.clamp(torch.clamp(dw_esc * opt.delta_w_up,
                                              min=opt.delta_w_min),
                                  max=opt.delta_w_max)
            with record_function("banded.escalation"):
                fac = kkt.factor(blocks_c, dw_next)
                dxn, dln = solve_refine(blocks_c, fac, dw_next, rhs,
                                        opt.gmres_iters)
            okn = fac.ok & torch.isfinite(dxn).all(-1) \
                & torch.isfinite(dln).all(-1)
            dw_esc = torch.where(esc, dw_next, dw_esc)
            dx = _where(esc, dxn, dx)
            dlam = _where(esc, dln, dlam)
            ok = torch.where(esc, okn, ok)
            fac_fin = _tree_map(lambda a, b: _where(esc, a, b), fac, fac_fin)
            k = k + esc.to(torch.int32)
        esc_taken = ~ok0
        # dw of the factors in use (the corrector's exact operator) vs the
        # value fed to the dw_last heuristic.
        dw_op = torch.where(ok0, dw_spec, dw_esc)
        dw_used = torch.where(ok0, dw_heur, dw_esc)
        blocks_fin = _map_blocks(lambda s_, c_: _where(esc_taken, c_, s_),
                                 blocks_sel, blocks_c)

        ds = (dlam[:, ineq] - rd_s) / sig_s
        dv = torch.cat([dx, ds], dim=-1)
        dzl = torch.where(hl, mu_dl - zl - sig_l * dv, 0.0)
        dzu = torch.where(hu, mu_du - zu + sig_u * dv, 0.0)
        ok = ok & torch.isfinite(dzl).all(-1) & torch.isfinite(dzu).all(-1)
        step_dir = (gf * dx).sum(-1) - (mu_dl * dv).sum(-1) \
            + (mu_du * dv).sum(-1)

        def corrector(rg_soc):
            """Second-order correction on the selected factors, with the
            same Krylov treatment as the step."""
            with record_function("banded.corrector"):
                dx_c = gmres_right(
                    lambda z: kkt.kmul(blocks_fin, dw_op, z),
                    lambda r: kkt.solve(blocks_fin, fac_fin, r),
                    -c_vjp(Dinv * rg_soc)[0], max(4, opt.gmres_iters // 2))
                dlam_c = Dinv * (c_jvp(dx_c) + rg_soc)
            return torch.cat([dx_c, dlam_c[:, ineq] / sig_s], dim=-1), dlam_c

        return dv, dlam, dzl, dzu, step_dir, dw_used, ok, corrector

    def ftb_primal(v, disp, mu):
        """Largest step fraction keeping v + a*disp interior (tau rule)."""
        tau = torch.clamp(1.0 - mu, min=opt.tau_min)[:, None]
        dl, du = dists(v)
        a_l = torch.where(consts("has_l", v) & (disp < 0),
                          -tau * dl / torch.clamp(disp, max=-1e-300),
                          math.inf)
        a_u = torch.where(consts("has_u", v) & (disp > 0),
                          tau * du / torch.clamp(disp, min=1e-300), math.inf)
        return torch.clamp(torch.minimum(a_l.amin(-1), a_u.amin(-1)),
                           max=1.0)

    def ftb_dual(zl, zu, dzl, dzu, mu):
        tau = torch.clamp(1.0 - mu, min=opt.tau_min)[:, None]
        b_l = torch.where(consts("has_l", zl) & (dzl < 0),
                          -tau * zl / torch.clamp(dzl, max=-1e-300),
                          math.inf)
        b_u = torch.where(consts("has_u", zu) & (dzu < 0),
                          -tau * zu / torch.clamp(dzu, max=-1e-300),
                          math.inf)
        return torch.clamp(torch.minimum(b_l.amin(-1), b_u.amin(-1)),
                           max=1.0)

    def line_search(v, dv, dlam, mu, nu, alpha_max, gf_dv, corrector,
                    theta, g0, f0):
        """l1-merit Armijo backtracking as one batched trial sweep, plus a
        second-order-correction candidate at the full step.

        Returns (dv_eff, dlam_eff, alpha, ls_ok)."""
        g1 = g0.abs().sum(-1)
        phi0 = f0 + barrier(v, mu) + nu * g1
        dphi = torch.clamp(gf_dv - nu * g1, max=0.0)
        alphas = alpha_max[:, None] * 0.5 ** torch.arange(
            opt.max_ls, dtype=alpha_max.dtype, device=v.device)
        (phis,) = sweep(v, dv, alphas, lambda pts, row: [
            merit(pts, row(mu), row(nu), row(theta))])
        ok = phis <= phi0[:, None] + opt.eta_armijo * alphas * dphi[:, None]
        any_ok = ok.any(-1)
        alpha_plain = torch.where(any_ok, _take(alphas, _first_true(ok)),
                                  alphas[:, -1])

        # SOC candidate from the full-step constraint residual.
        g_trial = g_fn(v + alpha_max[:, None] * dv, theta)
        dv_c, dlam_c = corrector(alpha_max[:, None] * g0 + g_trial)
        soc_bad = torch.isnan(dv_c).any(-1)
        dv_c = _where(soc_bad, 0.0, dv_c)
        dlam_c = _where(soc_bad, 0.0, dlam_c)
        disp = alpha_max[:, None] * dv + dv_c
        beta = ftb_primal(v, disp, mu)
        phi_soc = merit(v + beta[:, None] * disp, mu, nu, theta)
        soc_ok = (phi_soc <= phi0 + opt.eta_armijo * beta * alpha_max
                  * dphi) & (~soc_bad)
        use_soc = soc_ok & (beta * alpha_max > alpha_plain) & (~ok[:, 0])
        dv_eff = _where(use_soc, beta[:, None] * disp,
                        alpha_plain[:, None] * dv)
        dlam_eff = _where(use_soc,
                          beta[:, None] * (alpha_max[:, None] * dlam + dlam_c),
                          alpha_plain[:, None] * dlam)
        alpha_rep = torch.where(use_soc, beta * alpha_max, alpha_plain)
        return dv_eff, dlam_eff, alpha_rep, any_ok | soc_ok

    def update_nu(nu, g0, gf_dv):
        """Merit penalty update (IPOPT eq. 3.5 with rho = 0.1)."""
        g1 = g0.abs().sum(-1)
        nu_trial = gf_dv / torch.clamp(0.9 * g1, min=1e-12) + 1.0
        return torch.clamp(torch.maximum(nu, nu_trial), 0.0, 1e10)

    FSZ = max(1, min(opt.filter_size, opt.max_iter + 1))

    def theta_phi(v_t, mu, theta):
        """(constraint violation, barrier objective) of trial points."""
        v_t = v_t.to(theta.dtype)
        th = g_fn(v_t, theta).abs().sum(-1)
        ph = f_fn(v_t[:, :n], theta) + barrier(v_t, mu)
        return th, ph

    def sweep(v, dv, alphas, fn):
        """``fn(v + a*dv, row)`` for every trial step a of alphas (B, K):
        the trial points are flattened into one (B*K,) batch; ``row``
        repeats an instance's per-instance tensors K times."""
        B, K = alphas.shape
        pts = (v[:, None] + alphas[..., None] * dv[:, None]).reshape(B * K, -1)

        def row(t):
            return t.repeat_interleave(K, dim=0)

        return [r.reshape(B, K) for r in fn(pts, row)]

    def filter_line_search(state: _State, dv, dlam, alpha_max, dphi,
                           corrector, theta, g0, f0):
        """Wächter–Biegler filter backtracking (IPOPT Algorithm A) as one
        batched trial sweep plus a second-order-correction candidate.

        Returns (dv_eff, dlam_eff, alpha, ls_ok, fth, fph, fcnt)."""
        B = dv.shape[0]
        v, mu = state.v, state.mu
        fth, fph, fcnt = state.fth, state.fph, state.fcnt
        th0 = g0.abs().sum(-1)
        ph0 = f0 + barrier(v, mu)
        dphi = torch.clamp(dphi, max=0.0)
        valid = torch.arange(FSZ, device=v.device)[None] < fcnt[:, None]

        def acceptable(th_t, ph_t, alpha_t):
            """(filter-and-point acceptable, phi-type) for (B, K) trials."""
            blocked = ((th_t[..., None] >= fth[:, None])
                       & (ph_t[..., None] >= fph[:, None])
                       & valid[:, None]).any(-1)
            sw = ((th0 <= state.th_min) & (dphi < 0.0))[:, None] \
                & (alpha_t * ((-dphi) ** opt.s_phi)[:, None]
                   > (opt.delta_sw * th0 ** opt.s_theta)[:, None])
            armijo = ph_t <= (ph0[:, None]
                              + opt.eta_armijo * alpha_t * dphi[:, None])
            suff = (th_t <= ((1.0 - opt.gamma_theta) * th0)[:, None]) \
                | (ph_t <= (ph0 - opt.gamma_phi * th0)[:, None])
            point_ok = torch.where(sw, armijo, suff)
            return (~blocked) & point_ok, sw & armijo

        alphas = alpha_max[:, None] * 0.5 ** torch.arange(
            opt.max_ls, dtype=alpha_max.dtype, device=v.device)
        th_k, ph_k = sweep(v, dv, alphas, lambda pts, row: theta_phi(
            pts, row(mu), row(theta)))
        ok_k, phi_k = acceptable(th_k, ph_k, alphas)
        any_ok = ok_k.any(-1)
        first = _first_true(ok_k)
        alpha_plain = _take(alphas, first)
        phi_type_plain = _take(phi_k, first)

        # SOC candidate from the full-step constraint residual.
        g_trial = g_fn(v + alpha_max[:, None] * dv, theta)
        dv_c, dlam_c = corrector(alpha_max[:, None] * g0 + g_trial)
        soc_bad = torch.isnan(dv_c).any(-1)
        dv_c = _where(soc_bad, 0.0, dv_c)
        dlam_c = _where(soc_bad, 0.0, dlam_c)
        disp = alpha_max[:, None] * dv + dv_c
        beta = ftb_primal(v, disp, mu)
        th_soc, ph_soc = theta_phi(v + beta[:, None] * disp, mu, theta)
        soc_ok, soc_phi_type = (r[:, 0] for r in acceptable(
            th_soc[:, None], ph_soc[:, None], (beta * alpha_max)[:, None]))
        use_soc = soc_ok & (~soc_bad) & (~ok_k[:, 0]) \
            & (beta * alpha_max > torch.where(any_ok, alpha_plain, 0.0))

        # Emergency fallback when nothing is acceptable: the trial with
        # the smallest constraint violation.
        k_feas = torch.where(torch.isnan(th_k), math.inf, th_k).argmin(-1)
        alpha_fall = _take(alphas, k_feas)

        alpha_eff = torch.where(any_ok, alpha_plain, alpha_fall)
        dv_eff = _where(use_soc, beta[:, None] * disp,
                        alpha_eff[:, None] * dv)
        dlam_eff = _where(use_soc,
                          beta[:, None] * (alpha_max[:, None] * dlam + dlam_c),
                          alpha_eff[:, None] * dlam)
        alpha_rep = torch.where(use_soc, beta * alpha_max, alpha_eff)
        ls_ok = any_ok | use_soc

        # Filter augmentation on theta-type (non-Armijo) accepted steps
        # (IPOPT eq. 22); ring-buffer overwrite beyond capacity.
        phi_type = torch.where(use_soc, soc_phi_type, phi_type_plain)
        augment = ls_ok & (~phi_type)
        if FSZ > 1:
            slot = torch.where(fcnt < FSZ, fcnt, 1 + state.it % (FSZ - 1))
        else:
            slot = torch.zeros_like(fcnt)
        slot = slot.to(torch.int64)[:, None]
        fth_n = _where(augment, fth.scatter(
            1, slot, ((1.0 - opt.gamma_theta) * th0)[:, None]), fth)
        fph_n = _where(augment, fph.scatter(
            1, slot, (ph0 - opt.gamma_phi * th0)[:, None]), fph)
        fcnt_n = torch.where(augment, torch.clamp(fcnt + 1, max=FSZ), fcnt)
        return dv_eff, dlam_eff, alpha_rep, ls_ok, fth_n, fph_n, fcnt_n

    #: internal stop threshold: the running KKT error is exact f64 in
    #: every mode (eval_dtype="f32" uses an exact f64 VJP for J^T lam).
    tol_stop = opt.tol

    def _stop_rule(e_0, be0):
        """Converged, or the tail has exploded beyond recovery (only once
        a near-solution iterate was seen)."""
        diverged = (be0 <= 1e-4) & (e_0 >= 1e4 * be0) & (e_0 > tol_stop)
        return (e_0 <= tol_stop) | diverged

    def body(state: _State, theta):
        """One interior-point iteration for every instance."""
        v, lam, zl, zu, mu, nu = (state.v, state.lam, state.zl, state.zu,
                                  state.mu, state.nu)
        dw_last, it = state.dw_last, state.it
        hl, hu = consts("has_l", v), consts("has_u", v)
        # One derivative evaluation per iterate, shared by the KKT error,
        # the Newton step, and the line search.
        x = v[:, :n]
        gf = grad_f(x, theta)
        rg = g_fn(v, theta)
        f0 = f_fn(x, theta)
        restore = state.rmode if opt.restoration \
            else torch.zeros_like(state.rmode)
        gf_eff = _where(restore, 0.0, gf)
        if kkt is not None:
            # Structured (block-banded) path: matrix-free — the dense
            # Jacobian is never formed; J^T lam comes from one VJP.
            _, c_vjp = vjp(lambda xx: c_fn(xx, theta), x)
            Jtlam = c_vjp(lam)[0]
        elif ev32:
            # f32 assembly for the factorization/GMRES operator; exact
            # f64 J^T lam from one VJP for the KKT error and the step rhs.
            Jc = jac_c(x.float(), theta.float())
            Jtlam = jt_lam(x, lam, theta)
        else:
            Jc = jac_c(x, theta)
            Jtlam = _mv(Jc.transpose(1, 2), lam)
        e_0 = kkt_error_pre(gf, Jtlam, rg, v, lam, zl, zu, 0.0)
        done_now = _stop_rule(e_0, state.be0)
        if kkt is not None:
            step = compute_step_structured(v, lam, zl, zu, mu, dw_last,
                                           theta, gf_eff, rg, Jtlam, c_vjp,
                                           restore)
        else:
            step = compute_step(v, lam, zl, zu, mu, dw_last, theta, gf_eff,
                                Jc, rg, restore,
                                Jtlam64=Jtlam if ev32 else None)
        dv, dlam, dzl, dzu, gf_dv, dw_used, ok, corrector = step
        # Best-iterate tracking: e_0 is the error of the INCOMING iterate.
        better = e_0 < state.be0
        be0_n = torch.where(better, e_0, state.be0)
        bv_n = _where(better, v, state.bv)
        blam_n = _where(better, lam, state.blam)
        bzl_n = _where(better, zl, state.bzl)
        bzu_n = _where(better, zu, state.bzu)
        bad = (~ok) | done_now
        # A totally failed factorization must not contaminate the state.
        dv = _where(bad, 0.0, dv)
        dlam = _where(bad, 0.0, dlam)
        dzl = _where(bad, 0.0, dzl)
        dzu = _where(bad, 0.0, dzu)
        gf_dv = torch.where(bad, 0.0, gf_dv)
        nu_new = update_nu(nu, rg, gf_dv)
        alpha_max = ftb_primal(v, dv, mu)
        alpha_dual = ftb_dual(zl, zu, dzl, dzu, mu)
        # Line-search trial evaluations stay f64 even in ev32 mode.
        if opt.line_search == "filter":
            (dv_eff, dlam_eff, alpha, ls_ok, fth_n, fph_n,
             fcnt_n) = filter_line_search(state, dv, dlam, alpha_max, gf_dv,
                                          corrector, theta, rg, f0)
        else:
            dv_eff, dlam_eff, alpha, ls_ok = line_search(
                v, dv, dlam, mu, nu_new, alpha_max, gf_dv, corrector, theta,
                rg, f0)
            fth_n, fph_n, fcnt_n = state.fth, state.fph, state.fcnt
        th0 = rg.abs().sum(-1)
        if opt.restoration:
            # Restoration acceptance: Armijo decrease on the violation
            # itself; overrides the filter result in that mode.
            alphas_r = alpha_max[:, None] * 0.5 ** torch.arange(
                opt.max_ls, dtype=alpha_max.dtype, device=v.device)
            (th_tr,) = sweep(v, dv, alphas_r, lambda pts, row: [
                g_fn(pts, row(theta)).abs().sum(-1)])
            ok_r = th_tr <= th0[:, None] * (1.0 - opt.eta_armijo * alphas_r)
            any_r = ok_r.any(-1)
            k_r = torch.where(any_r, _first_true(ok_r), torch.where(
                torch.isnan(th_tr), math.inf, th_tr).argmin(-1))
            alpha_r = _take(alphas_r, k_r)
            dv_eff = _where(restore, alpha_r[:, None] * dv, dv_eff)
            # Multipliers freeze during restoration.
            dlam_eff = _where(restore, 0.0, dlam_eff)
            alpha = torch.where(restore, alpha_r, alpha)
            ls_ok = torch.where(restore, any_r, ls_ok)
            fth_n = _where(restore, state.fth, fth_n)
            fph_n = _where(restore, state.fph, fph_n)
            fcnt_n = torch.where(restore, state.fcnt, fcnt_n)
        fth_n = _where(bad, state.fth, fth_n)
        fph_n = _where(bad, state.fph, fph_n)
        fcnt_n = torch.where(bad, state.fcnt, fcnt_n)
        dv_eff = _where(bad, 0.0, dv_eff)
        dlam_eff = _where(bad, 0.0, dlam_eff)
        alpha_dual = torch.where(bad, 0.0, alpha_dual)
        v_n = v + dv_eff
        # Interior repair: v + dv can round ONTO a bound in f64 (IPOPT's
        # slack correction, section 3.5).
        vl_t, vu_t = consts("vl", v), consts("vu", v)
        margin_l = 1e-14 * torch.clamp(vl_t.abs(), min=1.0)
        margin_u = 1e-14 * torch.clamp(vu_t.abs(), min=1.0)
        v_n = torch.where(hl, torch.maximum(v_n, vl_t + margin_l), v_n)
        v_n = torch.where(hu, torch.minimum(v_n, vu_t - margin_u), v_n)
        lam_n = lam + dlam_eff
        zl_n = zl + alpha_dual[:, None] * dzl
        zu_n = zu + alpha_dual[:, None] * dzu
        # kappa_Sigma safeguard keeps z consistent with mu/d (distances
        # floored: an iterate can land exactly on a bound).
        dl, du = dists(v_n)
        dl_s = torch.clamp(dl, min=1e-40)
        du_s = torch.clamp(du, min=1e-40)
        mu_c = mu[:, None]
        zl_n = torch.where(hl, torch.clamp(
            zl_n, mu_c / (opt.kappa_sigma * dl_s),
            opt.kappa_sigma * mu_c / dl_s), 0.0)
        zu_n = torch.where(hu, torch.clamp(
            zu_n, mu_c / (opt.kappa_sigma * du_s),
            opt.kappa_sigma * mu_c / du_s), 0.0)
        dw_last_n = torch.where(dw_used > 0.0,
                                torch.clamp(dw_used, min=opt.delta_w_min),
                                dw_last)

        if opt.mu_strategy == "adaptive":
            # LOQO-style centrality rule (IPOPT's adaptive mode).
            dl_n, du_n = dists(v_n)
            prods = torch.cat([torch.where(hl, dl_n * zl_n, math.nan),
                               torch.where(hu, du_n * zu_n, math.nan)], -1)
            isn = torch.isnan(prods)
            num = (~isn).sum(-1)
            avg = torch.nansum(prods, dim=-1) / torch.clamp(num, min=1)
            min_p = torch.where(isn, math.inf, prods).amin(-1)
            xi = min_p / torch.clamp(avg, min=1e-300)
            sigma = 0.1 * torch.clamp(0.05 * (1.0 - xi)
                                      / torch.clamp(xi, min=1e-8),
                                      max=2.0) ** 3
            mu_n = torch.clamp(sigma * avg, opt.mu_min, opt.mu_init)
            mu_n = torch.where(num > 0, mu_n, torch.clamp(
                opt.kappa_mu * mu, min=opt.tol / 10.0))
        else:
            e_mu = kkt_error(v_n, lam_n, zl_n, zu_n, mu, theta)
            advance = e_mu <= opt.kappa_eps * mu
            mu_n = torch.where(
                advance,
                torch.clamp(torch.minimum(opt.kappa_mu * mu,
                                          mu ** opt.theta_mu),
                            min=opt.tol / 10.0),
                mu)
            mu_n = torch.clamp(mu_n, min=opt.mu_min)
        # Filter reset when the barrier parameter moves substantially.
        reset = (torch.log(torch.clamp(mu_n, min=1e-300))
                 - torch.log(torch.clamp(state.mu_f, min=1e-300))).abs() \
            > math.log(5.0)
        fcnt_n = torch.where(reset, torch.ones_like(fcnt_n), fcnt_n)
        mu_f_n = torch.where(reset, mu_n, state.mu_f)
        # Restoration mode transitions (entry after consecutive line-search
        # exhaustions, bounded by an entry budget; exit on sufficient
        # decrease or on stall).
        if opt.restoration:
            th_new = g_fn(v_n, theta).abs().sum(-1)
            stall = restore \
                & (th_new > (1.0 - opt.resto_min_decrease) * th0)
            r_stall_n = torch.where(stall, state.r_stall + 1,
                                    torch.zeros_like(state.r_stall))
            exit_stall = r_stall_n >= opt.resto_stall_patience
            exit_r = (th_new <= torch.maximum(
                state.th_min, opt.kappa_resto * state.th_enter)) \
                | exit_stall
            ls_fail_n = torch.where((~restore) & (~ls_ok) & (~bad),
                                    state.ls_fail + 1,
                                    torch.zeros_like(state.ls_fail))
            enter_r = (~restore) & (th0 > state.th_min) & (~bad) \
                & (ls_fail_n >= opt.resto_entry_fails) \
                & (state.r_ent < opt.resto_max_entries)
            r_ent_n = state.r_ent + enter_r.to(state.r_ent.dtype)
            rmode_n = torch.where(restore, ~exit_r, enter_r)
            th_enter_n = torch.where(enter_r, th0, state.th_enter)
            fcnt_n = torch.where(restore & exit_r, torch.ones_like(fcnt_n),
                                 fcnt_n)
            # The restoration phase runs its own barrier: bump on entry,
            # hold while restoring.
            mu_n = torch.where(enter_r,
                               torch.clamp(mu, min=0.1 * opt.mu_init),
                               torch.where(restore & ~exit_r, mu, mu_n))
        else:
            rmode_n = state.rmode
            th_enter_n = state.th_enter
            ls_fail_n = state.ls_fail
            r_stall_n = state.r_stall
            r_ent_n = state.r_ent
        return _State(v_n, lam_n, zl_n, zu_n, mu_n, nu_new, dw_used,
                      dw_last_n, it + 1, e_0, done_now,
                      fth_n, fph_n, fcnt_n, state.th_min, state.th_max,
                      mu_f_n, rmode_n, th_enter_n,
                      ls_fail_n, r_stall_n, r_ent_n,
                      be0_n, bv_n, blam_n, bzl_n, bzu_n)

    def init_state(x0, theta, lam0=None, zl0=None, zu0=None, mu0=None):
        """Initial state for x0 (B, n), theta (B, p); optionally
        warm-started with multipliers ``lam0`` (B, m), ``zl0``/``zu0``
        (B, n) and ``mu0`` (B,)."""
        dt, dev = theta.dtype, theta.device
        B = theta.shape[0]
        x0 = x0.to(dtype=dt, device=dev)
        like = x0
        x_init = _interior_init(x0, consts("xl", like), consts("xu", like),
                                opt.kappa_1, opt.kappa_2)
        if ns:
            c0 = c_fn(x_init, theta)
            s_init = _interior_init(c0[:, consts("ineq_idx", like)],
                                    consts("cl_in", like),
                                    consts("cu_in", like),
                                    opt.kappa_1, opt.kappa_2)
            v0 = torch.cat([x_init, s_init], dim=-1)
        else:
            v0 = x_init
        hl, hu = consts("has_l", v0), consts("has_u", v0)
        mu0 = torch.full((B,), opt.mu_init, dtype=dt, device=dev) \
            if mu0 is None else mu0.to(dtype=dt, device=dev)
        dl0, du0 = dists(v0)
        zl_def = torch.where(hl, mu0[:, None] / dl0, 0.0)
        zu_def = torch.where(hu, mu0[:, None] / du0, 0.0)
        if zl0 is not None:
            zl_x = torch.clamp(zl0.to(dtype=dt, device=dev), 1e-6, 1e6)
            zl_init = torch.where(hl, torch.cat([zl_x, zl_def[:, n:]], -1),
                                  0.0)
        else:
            zl_init = zl_def
        if zu0 is not None:
            zu_x = torch.clamp(zu0.to(dtype=dt, device=dev), 1e-6, 1e6)
            zu_init = torch.where(hu, torch.cat([zu_x, zu_def[:, n:]], -1),
                                  0.0)
        else:
            zu_init = zu_def
        lam_init = torch.zeros((B, m), dtype=dt, device=dev) if lam0 is None \
            else lam0.to(dtype=dt, device=dev)
        # Filter initialisation (IPOPT sec. 3.7): a single guard entry
        # blocking any point with violation >= theta_max.
        th0 = g_fn(v0, theta).abs().sum(-1)
        th_ref = torch.clamp(th0, min=1.0)
        th_min = 1e-4 * th_ref
        th_max = 1e4 * th_ref
        fth0 = torch.full((B, FSZ), math.inf, dtype=dt, device=dev)
        fth0[:, 0] = th_max
        fph0 = torch.full((B, FSZ), math.inf, dtype=dt, device=dev)
        fph0[:, 0] = -math.inf

        def full(val, dtype=dt):
            return torch.full((B,), val, dtype=dtype, device=dev)

        zero_i = full(0, torch.int32)
        false = full(False, torch.bool)
        return _State(v0, lam_init, zl_init, zu_init, mu0,
                      full(1.0), full(opt.delta_w_init),
                      full(opt.delta_w_first), zero_i, full(math.inf),
                      false, fth0, fph0, full(1, torch.int32),
                      th_min, th_max, mu0.clone(), false, full(0.0),
                      zero_i, zero_i, zero_i, full(math.inf),
                      v0, lam_init, zl_init, zu_init)

    def _run(state0, theta):
        if mixed and theta.device.type == "cuda":
            # The f32 factorization of the 1/dc-conditioned condensed
            # matrix needs exact f32 products: TF32 keeps ~10 bits.
            if (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"
                    or torch.backends.cudnn.allow_tf32):
                raise RuntimeError(
                    "kkt_precision='mixed' on CUDA needs TF32 off: set "
                    "torch.backends.cuda.matmul.allow_tf32 = False, "
                    "torch.backends.cudnn.allow_tf32 = False and "
                    "torch.set_float32_matmul_precision('highest').")
        state = state0
        active = (~state.done) & (state.it < opt.max_iter)
        while bool(active.any()):
            new = body(state, theta)
            state = _State(*(_where(active, a, b)
                             for a, b in zip(new, state)))
            active = (~state.done) & (state.it < opt.max_iter)
        final = state
        # Return the best-KKT iterate seen when a near-solution iterate
        # was reached (a late noise-amplified step can destroy a
        # near-converged iterate); otherwise the LAST iterate.
        use_best = final.be0 <= max(opt.tol, 1e-4)
        v_out = _where(use_best, final.bv, final.v)
        lam_out = _where(use_best, final.blam, final.lam)
        zl_out = _where(use_best, final.bzl, final.zl)
        zu_out = _where(use_best, final.bzu, final.zu)
        e_out = torch.where(use_best, final.be0, final.e0)
        conv_out = final.be0 <= opt.tol
        if ev32:
            # Certify the returned iterate with one fresh full-f64
            # evaluation (the running error read the f32 Jacobian).
            e_out = kkt_error(v_out, lam_out, zl_out, zu_out, 0.0, theta)
            conv_out = e_out <= opt.tol
        x = v_out[:, :n]
        return IPMResult(x=x, slack=v_out[:, n:], lam=lam_out,
                         zl=zl_out, zu=zu_out,
                         f=f_fn(x, theta).detach(), kkt_error=e_out,
                         mu=final.mu, iterations=final.it,
                         converged=conv_out)

    def solve(x0, theta):
        return _run(init_state(x0, theta), theta)

    def solve_warm(x0, theta, lam0, zl0, zu0, mu0):
        return _run(init_state(x0, theta, lam0, zl0, zu0, mu0), theta)

    solve.warm = solve_warm
    solve.dims = dict(n=n, m=m, ns=ns, nv=nv)
    # Introspection hooks (used by tests to drive single steps).
    solve._body = body
    solve._init_state = init_state
    solve._compute_step = compute_step
    solve._compute_step_structured = compute_step_structured \
        if kkt is not None else None
    solve._g = g_fn
    return solve


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested (named) tuples of like structure."""
    first = trees[0]
    if isinstance(first, tuple):
        out = [_tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") \
            else tuple(out)
    return fn(*trees)


def _map_blocks(fn, *blocks):
    """``fn`` over the batched tensors of ``ArrowBlocks`` of like layout;
    the static masks (no instance axis) are kept from the first."""
    first = blocks[0]
    return ArrowBlocks(
        phases=tuple(PhaseBand(*(fn(*t) for t in zip(*pbs)))
                     for pbs in zip(*(b.phases for b in blocks))),
        B=fn(*(b.B for b in blocks)), Gw=fn(*(b.Gw for b in blocks)),
        d_ib=fn(*(b.d_ib for b in blocks)), zmask=first.zmask,
        wmask=first.wmask)
