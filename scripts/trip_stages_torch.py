"""A benchmark cell's IPM trip split by stage, from the program's recorder.

Run from the root of a checkout, on the card::

    python3 scripts/trip_stages_torch.py [--workload cartpole-sweep-b1024] \
        [--calls 3] [--trace] [--out trip_stages.json]

and on the CPU at a small size::

    python3 scripts/trip_stages_torch.py --device cpu --mesh 2 4 --batch 4

It builds the cell's program as ``benchmark/run.py`` does (one CPU
thread, one warm-up call), then sends batch 0 of the cell's sequence (the
batch of a traced run's traced call):

1. ``--calls`` times with tracing off: ``solve_time`` per trip;
2. once inside ``profiling.recording()``: each span path's count, total and
   self host milliseconds per trip, the counters, and the quantities a
   trip splits into (derivatives, step self time, GMRES, line-search self
   time, waiting on the device, host reads a trip, active and escalating
   rows);
3. with ``--trace``, once under ``torch.profiler`` inside the harness's
   range, reduced by ``benchmark/harness/trace.py``: the device's idle
   time by the host event open when each gap began.

Last it times one span with tracing off and inside a recording, a count
off, and a ``record_function`` with no profiler running.  It prints one
JSON line and writes it to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

import run  # noqa: E402

#: stages whose per-trip host time a trip splits into: (name, "total" or
#: "self"); with the self times of the rest they add up to ``ipm.solve``.
#: On a card the trip's graphs are ``ipm.replay`` and the stages inside
#: them record only when the warm-up call captures them.
STAGES = (("ipm.replay", "total"),
          ("ipm.derivatives", "total"), ("ipm.step", "self"),
          ("ipm.gmres", "total"), ("ipm.line_search", "self"),
          ("ipm.wait", "total"), ("ipm.factor", "self"),
          ("ipm.escalation", "self"), ("ipm.restoration", "self"),
          ("ipm.trip", "self"), ("ipm.init", "self"),
          ("ipm.certify", "self"), ("ipm.solve", "self"))


def split(rec) -> dict:
    """The recorded call's trip split by stage, per trip, in ms."""
    c = rec.counters
    trips = c["ipm.trips"]
    by = rec.by_name()
    ms = {name: 1e3 * getattr(by[name], f"{kind}_s") / trips
          for name, kind in STAGES if name in by}
    esc = c.get("ipm.escalation_rows_factored", 0)
    return dict(
        trips=trips, stage_ms_per_trip=ms,
        stages_sum_ms=sum(ms.values()),
        solve_ms_per_trip=1e3 * by["ipm.solve"].total_s / trips,
        host_syncs_per_iter=c["ipm.syncs"] / trips,
        active_rows_pct=100.0 * c["ipm.active_rows"] / c["ipm.rows_computed"],
        escalation_rows_pct=(100.0 * c["ipm.escalation_rows"] / esc
                             if esc else None),
        counters=dict(c),
        spans={p: dict(count=s.count, total_ms=1e3 * s.total_s / trips,
                       self_ms=1e3 * s.self_s / trips)
               for p, s in sorted(rec.spans.items())})


def unit_costs(n: int = 200_000) -> dict:
    """Nanoseconds a use: a span off and recorded, a count off, and a
    ``record_function`` with no profiler running."""
    from torch.autograd.profiler import record_function

    from pycollo_tpu_torch import profiling

    def per(fn, k=n):
        fn()                                   # warm
        t = time.perf_counter_ns()
        for _ in range(k):
            fn()
        return (time.perf_counter_ns() - t) / k

    def span():
        with profiling.span("s"):
            pass

    def rf():
        with record_function("s"):
            pass

    out = dict(span_off_ns=per(span),
               count_off_ns=per(lambda: profiling.count("c")),
               record_function_ns=per(rf, n // 10),
               empty_loop_ns=per(lambda: None))
    with profiling.recording():
        out["span_recorded_ns"] = per(span, n // 10)
        out["count_recorded_ns"] = per(lambda: profiling.count("c"), n // 10)
    return out


def traced(prog, mix, nominal, top: int) -> dict:
    """One call under ``torch.profiler`` in the harness's range, as a
    traced run makes it, with the ``top`` largest idle gaps by label."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness.trace import events_of, reduce
    acts = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(run.CALL_RANGE):
            call = run.make_call(prog, mix, run.traffic.window_batch(mix, 0),
                                 nominal)
    run.CACHE.mkdir(parents=True, exist_ok=True)
    s = reduce(events_of(prof, run.CACHE / "trace_stages.json"),
               run.CALL_RANGE, top=top)
    idle = s["window_s"] - s["busy_s"]
    by_kind = {}
    for name, sec in s["idle_gaps"]:
        kind = name.split(".")[0] if "::" not in name else "aten"
        by_kind[kind] = by_kind.get(kind, 0.0) + sec
    return dict(trips=call.iter_max, solve_s=call.solve_time,
                window_s=s["window_s"], busy_s=s["busy_s"], idle_s=idle,
                launches_per_trip=len(s["kernels"]) / call.iter_max,
                idle_gaps=s["idle_gaps"], idle_by_kind_in_top=by_kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="cartpole-sweep-b1024")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("K", "N"))
    ap.add_argument("--batch", type=int)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    from pycollo_tpu_torch import profiling
    cell = run.load_cell(args.workload)
    cfg = cell.config
    mesh = run.Mesh(*(args.mesh or (int(cfg["mesh"]["sections"]),
                                    int(cfg["mesh"]["nodes_per_section"]))))
    mix = dict(cell.workload["mix"])
    if args.batch:
        mix["B"] = args.batch
    ocp = run.reference_problem(cell)
    nominal = {s: v for s, v in ocp.initial.items() if v is not None}
    run.torch_threads(run.WINDOW_THREADS)
    prog = run.Program(cell, args.device, mesh)
    run.make_call(prog, mix, run.traffic.warmup_batch(mix), nominal)

    def batch0():
        return run.make_call(prog, mix, run.traffic.window_batch(mix, 0),
                             nominal)

    off = [batch0() for _ in range(args.calls)]
    with profiling.recording() as rec:
        on = batch0()
    out = dict(
        workload=cell.name, device=str(prog.device),
        kind=(prog.torch.cuda.get_device_name(prog.device)
              if prog.device.type == "cuda" else "cpu"),
        B=int(mix["B"]), mesh=[mesh.K, mesh.n],
        off_ms_per_trip=[1e3 * c.solve_time / c.iter_max for c in off],
        recorded_ms_per_trip=1e3 * on.solve_time / on.iter_max,
        recorded_solve_s=on.solve_time,
        recorded_bitwise_equal=bool(
            all((c.x_full == on.x_full).all() for c in off)),
        recorded=split(rec))
    if args.trace:
        out["traced"] = traced(prog, mix, nominal, args.top)
    out["unit_costs"] = unit_costs()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
