"""The table of peaks and the kernel's least time, kept with the benchmark.

Copied from ``pycollo_tpu_torch/ops/bench_chol.py`` (``PEAK_BYTES_PER_S``,
``PEAK_F32_FLOPS``, ``bound_ms``) so that a later change to the program
cannot change the yardstick.
"""

from __future__ import annotations

#: published peaks of one H100 SXM at its full 700 W power limit (NVIDIA's
#: data sheet): HBM3 bytes per second and f32 flops per second outside the
#: tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_s(B: int, n: int) -> float:
    """The least time the card could take to compute ``L^{-1}`` and
    ``diag(L)`` of a (B, n, n) f32 stack: the lower triangle of A read
    once, n (n + 1) / 2 floats a matrix, n^2 + n written, or 2 n^3 / 3
    flops a matrix, whichever takes longer."""
    nbytes = 4 * B * (n * (n + 1) // 2 + n * n + n)
    flops = B * 2 * n ** 3 / 3
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)
