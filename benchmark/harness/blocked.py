"""Readers of the multi-block factorization (``ops/block_chol.py``).

A matrix wider than the kernel's one launch (``readers.ONE_LAUNCH_MAX_N``)
is factored in blocks: ``blocked_chol_linv`` splits it into the fewest
equal blocks of at most that width, factors each diagonal block with one
launch of the kernel, and does the rest of the block algebra in batched
matrix products.  The program counts both in counters beside
``blocked_chol_linv.calls``: ``blocked_chol_linv.blocks`` (diagonal blocks
factored) and ``blocked_chol_linv.products`` (batched products), each
counted once per replay of a graph that holds the call.  A program without
those counters gives these readers nothing to read, and they return None.

The counters add up over the whole process (the warm-up, the window and
the traced call); every call of one cell factors matrices of one width,
so the counters' ratio to ``.calls`` is each call's, and it scales the
window's factorization calls.
"""

from __future__ import annotations

import sys

from .readers import ONE_LAUNCH_MAX_N, factor_calls_per_iter
from .yardstick import bound_s

#: the program's module that holds the counters
MODULE = "pycollo_tpu_torch.ops.block_chol"


def _per_call(counter: str):
    """``counter`` of ``blocked_chol_linv`` per call of it, or None."""
    mod = sys.modules.get(MODULE)
    fn = getattr(mod, "blocked_chol_linv", None)
    total = getattr(fn, counter, None)
    calls = getattr(fn, "calls", None)
    if total is None or not calls:
        return None
    return total / calls


def _per_iter(ctx, counter: str):
    per_call = _per_call(counter)
    calls = factor_calls_per_iter(ctx)
    if per_call is None or calls is None:
        return None
    return per_call * calls


def factor_blocks_per_iter(ctx):
    """Diagonal blocks factored (one kernel launch each) per IPM loop
    trip: the factorization calls per trip times each call's blocks."""
    return _per_iter(ctx, "blocks")


def block_products_per_iter(ctx):
    """Batched matrix products of the block algebra per IPM loop trip;
    0 where every matrix is one block."""
    return _per_iter(ctx, "products")


def block_width(n: int) -> int:
    """The block width ``blocked_chol_linv`` takes for an n-wide matrix:
    the fewest equal blocks of at most ``ONE_LAUNCH_MAX_N``."""
    nb = max(1, -(-n // ONE_LAUNCH_MAX_N))
    return -(-n // nb)


def roofline_at(ctx, width):
    """The kernel's share of its least time in the traced call, in per
    cent: the bound of every launch, an (M, w, w) stack with w =
    ``width(ctx.nv)`` and M the launch's grid, over the launches' device
    time.  ``readers.chol_linv_roofline`` is this loop at ``w = nv``.
    Nothing where a launch lacks its grid or an M is no whole multiple of
    the call's batch."""
    t = ctx.trace
    if t is None:
        return None
    w = width(ctx.nv)
    bound = spent = 0.0
    for name, seconds, grid in t["kernels"]:
        if "chol_linv" not in name:
            continue
        if grid is None:
            return None
        m = grid[0] * grid[1] * grid[2]
        if m % ctx.batch:
            return None
        bound += bound_s(m, w)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None


def chol_linv_roofline(ctx):
    """:func:`roofline_at` the width of the blocks the kernel factors,
    :func:`block_width` of nv.  Nothing where nv is one block
    (``readers.chol_linv_roofline`` reads that)."""
    if ctx.nv <= ONE_LAUNCH_MAX_N:
        return None
    return roofline_at(ctx, block_width)
