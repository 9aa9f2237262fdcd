"""A benchmark cell's eight batches through the replayed trip and eagerly.

Run from the root of a checkout, on the card::

    python3 scripts/replay_check_torch.py [--workload cartpole-sweep-b1024] \
        [--out replay_check.json]

and on the CPU at a small size, through the replay's CPU stand-in::

    python3 scripts/replay_check_torch.py --device cpu --mesh 2 4 --batch 4

It builds the cell's program as ``benchmark/run.py`` does (one CPU thread,
one warm-up call, which captures the graphs), then solves each batch of the
cell's sequence through the replayed trip (``solver/graphs.py``) and again
through the eager trip, and compares the two answers instance by instance:
``x_full``, ``iterations``, ``converged`` and ``kkt_error`` bit for bit.
Per batch it reports both solve times, the loop's trips, the unconverged
instances, and the replayed call's graph counters; last the device's
memory peak.  It prints one JSON line and writes it to ``--out``.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "benchmark")]

import numpy as np  # noqa: E402

import run  # noqa: E402

FIELDS = ("x_full", "iterations", "converged", "kkt_error")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="cartpole-sweep-b1024")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", type=int, nargs=2, metavar=("K", "N"))
    ap.add_argument("--batch", type=int)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    from pycollo_tpu_torch import profiling
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver import ipm

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
    torch = prog.torch
    replays = ipm._replays_trip
    if prog.device.type == "cpu":
        # the CPU stand-in of the graphs
        def replays(device, kkt, opt):
            return kkt is None and opt.inertia == "speculative"

    def solve(theta, route):
        ipm._replays_trip = route
        try:
            with profiling.recording() as rec:
                res = solve_batched(prog.problem.backend, theta_batch=theta,
                                    devices=[prog.device])
            prog.sync()
        finally:
            ipm._replays_trip = replays
        return res, dict(rec.counters)

    ipm._replays_trip = replays
    run.make_call(prog, mix, run.traffic.warmup_batch(mix), nominal)
    if prog.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(prog.device)
    batches = []
    for k in range(int(mix["batches"])):
        theta = prog.theta(mix, run.traffic.batch(mix, k))
        graph, counters = solve(theta, replays)
        eager, _ = solve(theta, lambda device, kkt, opt: False)
        equal = {f: bool(np.array_equal(getattr(graph, f), getattr(eager, f)))
                 for f in FIELDS}
        batches.append(dict(
            batch=k, trips=int(graph.iterations.max()),
            trips_eager=int(eager.iterations.max()), equal=equal,
            unconverged=np.flatnonzero(~graph.converged).tolist(),
            unconverged_eager=np.flatnonzero(~eager.converged).tolist(),
            solve_s=graph.solve_time, solve_s_eager=eager.solve_time,
            graph_captures=counters.get("ipm.graph_captures", 0),
            graph_replays=counters.get("ipm.graph_replays", 0),
            trips_counted=counters.get("ipm.trips", 0)))
        print(json.dumps(batches[-1]), file=sys.stderr, flush=True)
    out = dict(
        workload=cell.name, device=str(prog.device),
        kind=(torch.cuda.get_device_name(prog.device)
              if prog.device.type == "cuda" else "cpu"),
        B=int(mix["B"]), mesh=[mesh.K, mesh.n],
        all_equal=all(all(b["equal"].values()) for b in batches),
        memory_peak_bytes=(int(torch.cuda.max_memory_allocated(prog.device))
                           if prog.device.type == "cuda" else None),
        batches=batches)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if out["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
