"""Fixed-iteration right-preconditioned GMRES, batched over instances.

The dense mixed-precision path refines each Newton step by GMRES on the
unregularized coupled KKT system, with the factored condensed matrix as a
right preconditioner (``solver/ipm.py``): the few directions in which the
f32 factorization is poor contract in as many iterations, and the step
reaches the accuracy the f64 residual asks for.

Every instance of the batch runs the same fixed number of Arnoldi steps,
so there is no data-dependent control flow; the Hessenberg least-squares
problem is solved once at the end by ridge-regularized normal equations
with a Cholesky factorization, as in the reference.
"""

from __future__ import annotations

import torch

from .graphs import eager


def gmres_right(matvec, precond, rhs, iters: int):
    """Solve ``A x = rhs`` for a batch by right-preconditioned GMRES(iters).

    ``rhs``: (B, n).  ``matvec(z) -> A @ z`` must be the EXACT operator and
    ``precond(r)`` an approximate solve (applied on the right:
    A M^-1 y = rhs, x = M^-1 y), both on (B, n).  Runs exactly ``iters``
    Arnoldi steps (no early exit).  A breakdown (happy or otherwise)
    produces zero Krylov vectors, which the final least-squares solve
    ignores.  Returns ``x`` (B, n); a failed solve gives NaN.
    """
    B, n = rhs.shape
    dt, dev = rhs.dtype, rhs.device
    beta = torch.linalg.vector_norm(rhs, dim=-1)
    scale = torch.where(beta > 0.0, beta, torch.ones_like(beta))
    V = torch.zeros((B, iters + 1, n), dtype=dt, device=dev)
    H = torch.zeros((B, iters + 1, iters), dtype=dt, device=dev)
    V[:, 0] = rhs / scale[:, None]
    # the reference's breakdown floor, rounded to the working dtype
    # (1e-300 in f64, 0 in f32)
    floor = float(torch.tensor(1e-300, dtype=dt))
    for k in range(iters):
        w = matvec(precond(V[:, k]))
        # Modified Gram-Schmidt against the basis so far, plus one
        # re-orthogonalization pass (cheap, fixes MGS drift).
        Vk = V[:, :k + 1]
        h = (Vk @ w[:, :, None])[..., 0]
        w = w - (Vk.transpose(1, 2) @ h[:, :, None])[..., 0]
        h2 = (Vk @ w[:, :, None])[..., 0]
        w = w - (Vk.transpose(1, 2) @ h2[:, :, None])[..., 0]
        nrm = torch.linalg.vector_norm(w, dim=-1)
        H[:, :k + 1, k] = h + h2
        H[:, k + 1, k] = nrm
        V[:, k + 1] = torch.where(
            (nrm > floor)[:, None], w / torch.clamp(nrm, min=floor)[:, None],
            torch.zeros_like(w))

    # Ridge-regularized normal equations (the reference's choice, kept so
    # the two agree); zero columns from a breakdown are handled by the
    # ridge, which then selects the minimum-norm coefficients.
    Ht = H.transpose(1, 2)
    HtH = Ht @ H
    eps = torch.finfo(dt).eps
    ridge = 100.0 * eps ** 2 * (1.0 + torch.diagonal(HtH, dim1=1, dim2=2)
                                .sum(-1))
    eye = torch.eye(iters, dtype=dt, device=dev)
    L, info = torch.linalg.cholesky_ex(HtH + ridge[:, None, None] * eye)
    # H^T e1 is the first row of H.  On a card the batched solve is
    # MAGMA's, which allocates device memory: a replayed trip runs it
    # eagerly between two graphs.
    y = eager(torch.cholesky_solve, H[:, 0, :, None], L)[..., 0]
    y = torch.where((info == 0)[:, None], y, torch.full_like(y, float("nan")))
    # No finiteness guard here: callers check isfinite on the step.
    x = (V[:, :iters].transpose(1, 2) @ y[:, :, None])[..., 0]
    return precond(x) * scale[:, None]
