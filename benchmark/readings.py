"""Readings of the numbers compared, for setting a cell's limits.

Run from the root of a checkout, on the chip::

    python3 benchmark/readings.py --workload <cell> --calls <k> \
        --seeds <n> [<n> ...] [--route sound|f32|tol]

One process solves ``--calls`` batches of the cell's traffic, in the order
a run's window sends them (``harness/traffic.py``; ``--calls`` at the
sequence's length meets every batch a window can send), printing a line
per call, then judges the answers against the plain reference
(``run.judge``) once for each seed, printing one JSON line per seed with
the numbers compared and, as ``feas_all``, the worst ``feas`` of every
answer, converged or not.  The traffic does not depend on the seed, which
draws only the judge's sample, so one solve serves every seed.  Routes:

``sound``
    the program as the cell runs it: the lower readings;
``f32``
    the control: the program's own lower-precision path, the whole NLP in
    float32 (``settings.dtype = "float32"``, the factorization through the
    same kernel), in place of the float64 the configuration states;
``tol``
    the control of the configuration's other guarantee, the KKT
    tolerance: the program with ``tol`` loosened tenfold, to
    :data:`TOL_CONTROL`.

The benchmark's own runs never run this script.
"""

import argparse
import json
import sys
import time

import numpy as np

import run

#: the loosened tolerance of the ``tol`` control: ten times the stated 1e-6
TOL_CONTROL = 1e-5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--calls", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--route", choices=("sound", "f32", "tol"),
                    default="sound")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    cfg = cell.config
    mesh = run.Mesh(int(cfg["mesh"]["sections"]),
                    int(cfg["mesh"]["nodes_per_section"]))
    ocp = run.reference_problem(cell)
    nominal = {s: v for s, v in ocp.initial.items() if v is not None}
    dtype = "float32" if args.route == "f32" else None
    ipm = {"tol": TOL_CONTROL} if args.route == "tol" else None
    threads = run.torch_threads(run.WINDOW_THREADS)
    prog = run.Program(cell, "cuda", mesh, dtype=dtype, ipm=ipm)
    mix = cell.workload["mix"]
    run.make_call(prog, mix, run.traffic.warmup_batch(mix), nominal)
    calls = []
    for i in range(args.calls):
        t = time.perf_counter()
        c = run.make_call(prog, mix, run.traffic.window_batch(mix, i),
                          nominal)
        calls.append(c)
        print(json.dumps(dict(
            workload=cell.name, route=args.route, call=i,
            batch=run.traffic.window_batch(mix, i),
            wall_s=time.perf_counter() - t, solve_s=c.solve_time,
            iter_max=c.iter_max, factor_calls=c.factor_calls,
            converged=int(c.converged.sum()))), flush=True)
    del prog
    run.torch_threads(threads)
    tr = run.Transcription(ocp, mesh)
    # the infeasibility of every answer, converged or not: what the
    # control's answers would read had they claimed convergence
    every = run.judge_inputs(ocp, tr, calls)
    feas_all = float(np.max(np.maximum(
        tr.feasibility(every["x"], every["pins"]),
        tr.objective_gap(every["x"], every["reported"]))))
    for seed in args.seeds:
        t = time.perf_counter()
        verdict = run.judge(cell, mesh, calls, seed, ocp)
        print(json.dumps(dict(
            workload=cell.name, route=args.route, seed=seed,
            calls=len(calls), attempted=verdict["attempted"],
            converged=sum(int(c.converged.sum()) for c in calls),
            judged_stat=verdict["stat_count"],
            failed=int(verdict["failed"].sum()),
            judge_s=time.perf_counter() - t, feas_all=feas_all,
            **{k: c["value"] for k, c in verdict["checks"].items()})),
            flush=True)
    bad = run.forbidden_modules()
    if bad:
        print(f"loaded modules that a run may not load: {bad}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
