"""Batched Cholesky inverse: CUDA kernel, plain version, blocked extension.

:func:`chol_inv` returns ``L^{-1}`` (and optionally ``diag(L)``) of the
Cholesky factors of a stack of SPD matrices, n <= :data:`MAX_BLOCK_N`.  On
a CUDA tensor it launches the hand-written Hopper kernel
``csrc/chol_linv.cu`` (the counterpart of the Pallas kernel
``batched_chol_inv`` in ``pycollo_tpu/ops/block_chol.py``), one thread
block per matrix with the whole matrix in shared memory; on a CPU tensor it
runs :func:`chol_inv_reference`, the plain PyTorch version.
:func:`blocked_chol_linv` extends it to any n: a matrix of at most
:data:`MAX_BLOCK_N` is one kernel launch, a larger one is split into the
fewest equal blocks, whose diagonal blocks run the kernel while plain f32
batched matmuls do the panels, trailing updates and block triangular
inversion.  It is the factorization of the interior-point solver's
``kkt_precision="mixed"`` path (``solver/linalg.py``), where a non-PD
instance must show up as a NaN or non-positive pivot in ``diag_L`` and
never as a silently wrong factor.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

#: largest matrix the kernel takes: its shared memory (at most 112 KB, so
#: two blocks share an SM) and its one-row-per-thread phases (256 threads)
#: are sized for it
MAX_BLOCK_N = 160

#: guards the read-modify-write of the counters below: the blocks of
#: distinct devices in a batch solve call the wrappers from several threads
#: at once
_count_lock = threading.Lock()


def _check_stack(A: torch.Tensor) -> None:
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected a (B, n, n) stack, got {tuple(A.shape)}")
    if not 1 <= A.shape[-1] <= MAX_BLOCK_N:
        raise ValueError(f"block size n={A.shape[-1]} outside 1..{MAX_BLOCK_N}")
    if not A.is_floating_point():
        raise TypeError(f"expected a floating tensor, got {A.dtype}")


def _kernel_fn():
    lib = _build.load("chol_linv.cu")
    fn = lib.pycollo_chol_linv_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chol_inv(A: torch.Tensor, return_diag: bool = False):
    """``L^{-1}`` for ``A = L L^T``, A a (B, n, n) SPD stack, n <= 160.

    Returns a (B, n, n) float32 lower-triangular stack with exact zeros
    above the diagonal, and with ``return_diag`` also ``diag(L)`` (B, n);
    the input is cast to float32 and only its lower triangle is read.  An
    instance that is not positive definite gives NaN (or inf) in that
    instance only.  A CUDA tensor launches the kernel once (and counts the
    launch in ``chol_inv.launches``); a CPU tensor runs
    :func:`chol_inv_reference`.
    """
    _check_stack(A)
    if A.device.type == "cpu":
        return chol_inv_reference(A, return_diag)
    if A.device.type != "cuda":
        raise ValueError(f"chol_inv takes CPU or CUDA tensors, got {A.device}")
    if not A.is_contiguous():
        raise ValueError("chol_inv needs a contiguous stack")
    A32 = A.to(torch.float32)
    B, n = A32.shape[0], A32.shape[-1]
    out = torch.empty_like(A32)
    diag = (torch.empty((B, n), dtype=torch.float32, device=A32.device)
            if return_diag else None)
    if B > 0:
        fn = _kernel_fn()
        with torch.cuda.device(A32.device):
            stream = torch.cuda.current_stream(A32.device).cuda_stream
            err = fn(A32.data_ptr(), out.data_ptr(),
                     diag.data_ptr() if return_diag else None, B, n, stream)
        if err != 0:
            raise RuntimeError(f"chol_linv kernel launch failed: CUDA error "
                               f"{err} (B={B}, n={n})")
        with _count_lock:
            chol_inv.launches += 1
    return (out, diag) if return_diag else out


#: kernel launches since the last reset (a counter, set to 0 by callers that
#: want to prove a run went through the kernel; counted under a lock)
chol_inv.launches = 0


def chol_inv_reference(A: torch.Tensor, return_diag: bool = False):
    """Plain version of :func:`chol_inv`: ``cholesky_ex`` + triangular solve
    in float32.  Instances whose factorization fails (``info != 0``) come out
    all NaN, which keeps the kernel's failure contract."""
    _check_stack(A)
    A32 = A.to(torch.float32)
    L, info = torch.linalg.cholesky_ex(A32)
    eye = torch.eye(A32.shape[-1], dtype=torch.float32,
                    device=A32.device).expand_as(A32)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    ok = (info == 0)[:, None, None]
    Linv = torch.where(ok, Linv, torch.full_like(Linv, float("nan")))
    if not return_diag:
        return Linv
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    nan = torch.full_like(diag, float("nan"))
    return Linv, torch.where(ok[:, 0], diag, nan)


def blocked_chol_linv(A: torch.Tensor, block: int | None = None):
    """Cholesky factor diagonal and full triangular inverse of a SPD stack.

    ``A``: (..., n, n), any n.  Returns ``(diag_L, Linv)`` with
    ``A = L L^T``: ``diag_L`` (..., n), the factor diagonal (for the caller's
    positive-pivot check), and ``Linv`` (..., n, n) lower-triangular float32,
    so a solve is two matrix products ``x = Linv^T (Linv b)``.

    The blocks are ``block`` wide (default: the fewest blocks of at most
    :data:`MAX_BLOCK_N`, so n <= 160 is one block and n = 628 four of
    157); the last is padded with the identity.  One block of n is one
    kernel launch, whose outputs are returned as they are.  All leading
    axes are folded into the kernel's batch.  A non-PD instance yields NaN
    in its diagonal-block inverse, which propagates through every later
    product of that instance.  Each call counts one in
    ``blocked_chol_linv.calls``.
    """
    *batch, n, n2 = A.shape
    if n != n2:
        raise ValueError(f"expected square matrices, got {tuple(A.shape)}")
    if block is None:
        nb = max(1, -(-n // MAX_BLOCK_N))
        block = -(-n // nb)
    else:
        nb = -(-n // block)
    n_pad = nb * block
    B = 1
    for d in batch:
        B *= d
    dev = A.device
    Af = A.reshape(B, n, n).to(torch.float32)
    with _count_lock:
        blocked_chol_linv.calls += 1
    if n_pad == n == block:
        Linv, diag_L = chol_inv(Af.contiguous(), return_diag=True)
        return diag_L.reshape(*batch, n), Linv.reshape(*batch, n, n)
    if n_pad != n:
        P = torch.zeros((B, n_pad, n_pad), dtype=torch.float32, device=dev)
        P[:, :n, :n] = Af
        idx = torch.arange(n, n_pad, device=dev)
        P[:, idx, idx] = 1.0
        Af = P
    b = block

    def blk(i, j):
        return Af[:, i * b:(i + 1) * b, j * b:(j + 1) * b]

    work = {(i, j): blk(i, j) for i in range(nb) for j in range(i + 1)}
    L = [[None] * nb for _ in range(nb)]
    Dinv = [None] * nb
    for j in range(nb):
        Dinv[j] = chol_inv(work[(j, j)].contiguous())
        for i in range(j + 1, nb):
            # L_ij = A'_ij @ L_jj^{-T}
            L[i][j] = work[(i, j)] @ Dinv[j].transpose(-1, -2)
        for i in range(j + 1, nb):
            for k in range(j + 1, i + 1):
                work[(i, k)] = work[(i, k)] - L[i][j] @ L[k][j].transpose(-1, -2)

    # Block triangular inversion:
    # Linv_jj = Dinv_j;  Linv_ij = -Dinv_i (sum_{k=j}^{i-1} L_ik Linv_kj)
    Linv_blocks = [[None] * nb for _ in range(nb)]
    for j in range(nb):
        Linv_blocks[j][j] = Dinv[j]
        for i in range(j + 1, nb):
            acc = L[i][j] @ Linv_blocks[j][j]
            for k in range(j + 1, i):
                acc = acc + L[i][k] @ Linv_blocks[k][j]
            Linv_blocks[i][j] = -(Dinv[i] @ acc)

    Linv = torch.zeros((B, n_pad, n_pad), dtype=torch.float32, device=dev)
    for i in range(nb):
        for j in range(i + 1):
            Linv[:, i * b:(i + 1) * b, j * b:(j + 1) * b] = Linv_blocks[i][j]
    Linv = Linv[:, :n, :n]
    # diag(L_jj) = 1 / diag(L_jj^{-1})
    dinv_diag = torch.cat([torch.diagonal(Dinv[j], dim1=-2, dim2=-1)
                           for j in range(nb)], dim=-1)[:, :n]
    diag_L = 1.0 / dinv_diag
    return (diag_L.reshape(*batch, n),
            Linv.reshape(*batch, n, n))


#: calls since the last reset (a counter, counted under a lock: with
#: ``chol_inv.launches`` it gives the kernel launches per factorization)
blocked_chol_linv.calls = 0
