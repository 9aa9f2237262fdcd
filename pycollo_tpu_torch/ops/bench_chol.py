"""Microbenchmark of the Cholesky-inverse kernel on one CUDA card.

The counterpart of ``pycollo_tpu/ops/bench_chol.py``.  Run from the root
of a checkout, on a machine with an NVIDIA GPU::

    python -m pycollo_tpu_torch.ops.bench_chol [--batch 1536 4096] [--seed 0]

For each batch B and block size n it prints the kernel's time
(``chol_inv``), the library route's (``torch.linalg.cholesky_ex`` +
``solve_triangular``: the yardstick, which the package never calls), the
plain version's (``chol_inv_reference``), the bound (the larger of the
bytes moved over the card's memory rate, the lower triangle of each input
read once and each output written once, and 2 n^3 / 3 flops per matrix
over its f32 rate), the
share of the bound the kernel reaches, and the kernel's largest difference
from the plain version.  Then it times the solver's factorization,
``blocked_chol_linv``, at its two shapes: (1536, 148, 148) with the default
blocking (one launch) against ``block=37`` and the library route, and
(1536, 628, 628) with the default blocking (four blocks of 157) against
``block=45`` and the library route.  Times are medians of CUDA-event
windows over fresh inputs made on the card from ``--seed``.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

from .block_chol import blocked_chol_linv, chol_inv, chol_inv_reference

#: published peaks of one H100 SXM at its full 700 W power limit: HBM3
#: bytes per second and f32 flops per second outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: block sizes of the sweep: those of the JAX package's sweep, the solver's
#: blocks (37 and 45 of the earlier blocking, 148 and 157), the TPU
#: kernel's limit 48 and this kernel's 160
SWEEP_N = (8, 16, 24, 32, 37, 45, 48, 64, 96, 128, 148, 157, 160)
#: (n, the earlier blocking) of the solver's two factorization shapes, at
#: the main path's batch of 256 instances x 6 ladder levels
BLOCKED_SHAPES = ((148, 37), (628, 45))
BLOCKED_BATCH = 1536


def spd_stacks(B, n, count, gen, device="cuda"):
    """``count`` fresh (B, n, n) f32 SPD stacks made on the card:
    ``M M^T / n + 0.5 I`` with standard normal M (eigenvalues in about
    [0.5, 4.5], as for the solver's Jacobi-equilibrated matrices)."""
    out = []
    for _ in range(count):
        M = torch.randn((B, n, n), generator=gen, device=device,
                        dtype=torch.float32)
        A = M @ M.transpose(-1, -2) / n
        A.diagonal(dim1=-2, dim2=-1).add_(0.5)
        out.append(A)
    return out


def median_ms(fn, inputs, samples=10, inner=20):
    """Milliseconds per call: the median over ``samples`` CUDA-event
    windows, each of ``inner`` back-to-back calls cycling fresh inputs."""
    for A in inputs[:2]:
        fn(A)
    torch.cuda.synchronize()
    times = []
    for s in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(inner):
            fn(inputs[(s * inner + r) % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(B, n, diag=False):
    """``(ms, "bytes" or "operations")``: the least time the card could
    take to compute ``L^{-1}`` (and ``diag(L)``) of a (B, n, n) f32 stack:
    the function reads only the lower triangle of A, n (n + 1) / 2 floats
    per matrix, and writes n^2 (and n)."""
    nbytes = 4 * B * (n * (n + 1) // 2 + n * n + (n if diag else 0))
    flops = B * 2 * n ** 3 / 3
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def library_linv(A):
    """The library route to ``L^{-1}``: cuSOLVER Cholesky + triangular
    solve in f32 (a yardstick only)."""
    L, _ = torch.linalg.cholesky_ex(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(A), upper=False)


def kernel_row(B, n, gen):
    """The kernel against its plain version and the library route at one
    (B, n, n) shape, over four fresh inputs."""
    inputs = spd_stacks(B, n, 4, gen)
    err = float((chol_inv(inputs[0]) - chol_inv_reference(inputs[0]))
                .abs().max())
    ms = median_ms(chol_inv, inputs)
    plain = median_ms(chol_inv_reference, inputs)
    lib = median_ms(library_linv, inputs)
    bms, by = bound_ms(B, n)
    return dict(B=B, n=n, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, share=bms / ms, max_abs_err=err)


def blocked_rows(gen):
    """``blocked_chol_linv`` at :data:`BLOCKED_SHAPES` with the default
    blocking against the earlier blocking and the library route, with the
    kernel launches of one call of each blocking."""
    B = BLOCKED_BATCH
    rows = []
    for n, old in BLOCKED_SHAPES:
        inputs = spd_stacks(B, n, 3, gen)
        kw = dict(samples=5, inner=3) if n > 300 else dict(samples=6, inner=5)
        row = dict(B=B, n=n, old_block=old)
        for key, block in (("default", None), ("old", old)):
            before = chol_inv.launches
            diag_L, Linv = blocked_chol_linv(inputs[0], block=block)
            row[f"{key}_launches"] = chol_inv.launches - before
            if key == "default":
                ref = library_linv(inputs[0])
                row["max_abs_err"] = float((Linv - ref).abs().max())
            row[f"{key}_ms"] = median_ms(
                lambda A, b=block: blocked_chol_linv(A, block=b), inputs, **kw)
        row["library_ms"] = median_ms(library_linv, inputs, **kw)
        row["bound_ms"], row["bound_by"] = bound_ms(B, n, diag=True)
        rows.append(row)
        del inputs
        torch.cuda.empty_cache()
    return rows


def format_kernel_row(r):
    return (f"B={r['B']:5d} n={r['n']:4d}  chol_inv {r['ms']:.4f} ms  "
            f"library {r['library_ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
            f"bound {1e3 * r['bound_ms']:.2f} us ({r['bound_by']})  "
            f"share {100 * r['share']:.1f} %  max|kernel-plain| "
            f"{r['max_abs_err']:.2e}")


def format_blocked_row(r):
    return (f"blocked_chol_linv B={r['B']} n={r['n']}: default "
            f"{r['default_ms']:.4f} ms ({r['default_launches']} kernel "
            f"launches), block={r['old_block']} {r['old_ms']:.4f} ms "
            f"({r['old_launches']} launches), library {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"max|default-library| {r['max_abs_err']:.2e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[1536, 4096])
    parser.add_argument("--n", type=int, nargs="+", default=list(SWEEP_N))
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_chol needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name(0)}",
          flush=True)
    for B in args.batch:
        for n in args.n:
            print(format_kernel_row(kernel_row(B, n, gen)), flush=True)
    for r in blocked_rows(gen):
        print(format_blocked_row(r), flush=True)


if __name__ == "__main__":
    main()
