"""Batched dense SPD factorizations for the condensed-space KKT solves.

The dense-KKT workhorse of the condensed-space interior point solver — the
replacement for the reference's MUMPS factorization inside IPOPT
(``pycollo/backend.py:1695-1711``).  Two implementations, both taking any
leading batch axes:

* ``kernel=True`` (the ``kkt_precision="mixed"`` path): float32 blocked
  Cholesky with the full triangular inverse,
  :func:`pycollo_tpu_torch.ops.block_chol.blocked_chol_linv`, whose
  diagonal blocks run the hand-written CUDA kernel for CUDA tensors and the
  plain PyTorch version for CPU tensors.  A solve is two matrix products.
* otherwise: ``torch.linalg.cholesky_ex`` in the input dtype, with
  ``cholesky_solve``.

Both keep the failure contract the solver relies on: a matrix that is not
positive definite gives a NaN (or sub-floor) pivot in the factor diagonal.
"""

from __future__ import annotations

import torch

from .graphs import eager


def make_spd_solver(kernel: bool = False):
    """Return (factor, solve, diag) callables for (..., n, n) SPD stacks.

    ``solve(factors, rhs)`` takes ``rhs`` (..., n) or (..., n, k);
    ``diag(factors)`` is the factor diagonal (..., n).
    """
    if kernel:
        from ..ops.block_chol import blocked_chol_linv

        def factor(A):
            return blocked_chol_linv(A)

        def solve(factors, rhs):
            _, Linv = factors
            vec = rhs.dim() == Linv.dim() - 1
            r = rhs[..., None] if vec else rhs
            y = Linv.transpose(-1, -2) @ (Linv @ r)
            return y[..., 0] if vec else y

        def diag_of_factor(factors):
            return factors[0]

        return factor, solve, diag_of_factor

    def factor(A):
        L, info = torch.linalg.cholesky_ex(A)
        # A failed factorization (info != 0) is reported as NaN, the
        # pivot-check contract of the kernel path.
        return torch.where((info == 0)[..., None, None], L,
                           torch.full_like(L, float("nan")))

    def solve(L, rhs):
        vec = rhs.dim() == L.dim() - 1
        r = rhs[..., None] if vec else rhs
        # On a card a batched solve is MAGMA's, which allocates device
        # memory: a replayed trip runs it eagerly between two graphs.
        y = eager(torch.cholesky_solve, r, L)
        return y[..., 0] if vec else y

    def diag_of_factor(L):
        return torch.diagonal(L, dim1=-2, dim2=-1)

    return factor, solve, diag_of_factor
