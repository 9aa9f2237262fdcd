"""What the metric readers under ``metrics/`` compute.

Each reader takes the run's :class:`Context` (``run.py``) and returns a
number, or None where the run holds nothing to read, in which case the
harness leaves the metric out of the result line.  The metric files name
one of these; a metric of another group (``.sweep``, and those of later cells) reads the
same quantity in the cells that report its end-to-end metric.
"""

from __future__ import annotations

from .yardstick import bound_s

#: the widest matrix that the Cholesky-inverse kernel factors whole, one
#: thread block a matrix; a wider one is factored in blocks of widths that
#: the roofline's reader does not know
ONE_LAUNCH_MAX_N = 160


def _trips(ctx):
    return sum(c.iter_max for c in ctx.calls)


# ------------------------------------------------------------ end to end
def setup_s(ctx):
    return ctx.setup_s


def solves_per_s(ctx):
    """Instances certified (converged and accepted by the reference) over
    the window's calls, per second of the window."""
    return ctx.certified / ctx.window_s if ctx.calls else None



# ------------------------------------------------------------ counters
def ipm_iters_max(ctx):
    """The IPM loop's trips per call (the batch's largest iteration
    count), averaged over the window's calls."""
    return _trips(ctx) / len(ctx.calls) if ctx.calls else None


def ipm_iter_ms(ctx):
    """Milliseconds of solve time per IPM loop trip over the window."""
    trips = _trips(ctx)
    return 1e3 * sum(c.solve_time for c in ctx.calls) / trips \
        if trips else None


def factor_calls_per_iter(ctx):
    """Factorization calls (``blocked_chol_linv.calls``) per IPM loop
    trip: 1 is the speculative ladder alone, more is escalation."""
    trips = _trips(ctx)
    return sum(c.factor_calls for c in ctx.calls) / trips if trips else None


# ------------------------------------------------------------ device trace
def device_idle(ctx):
    """Per cent of the traced call in which no device operation ran."""
    t = ctx.trace
    if t is None or not t["window_s"] or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches_per_iter(ctx):
    """Device kernels in the traced call per IPM loop trip."""
    t = ctx.trace
    if t is None or not t["kernels"] or not ctx.traced_trips:
        return None
    return len(t["kernels"]) / ctx.traced_trips


def chol_linv_roofline(ctx):
    """The Cholesky-inverse kernel's share of its least time: the bound of
    every launch in the traced call, an (M, nv, nv) stack with M the
    launch's grid (one block per matrix), over the launches' device time,
    in per cent.  Nothing where a launch's shape is not that: nv above
    :data:`ONE_LAUNCH_MAX_N`, a launch without its grid, or an M that is
    not a whole multiple of the call's batch."""
    t = ctx.trace
    if t is None or ctx.nv > ONE_LAUNCH_MAX_N:
        return None
    bound = spent = 0.0
    for name, seconds, grid in t["kernels"]:
        if "chol_linv" not in name:
            continue
        if grid is None:
            return None
        m = grid[0] * grid[1] * grid[2]
        if m % ctx.batch:
            return None
        bound += bound_s(m, ctx.nv)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None
