"""Measure the port's multi-process weak scaling on this host.

The counterpart of ``scripts/measure_multihost.py`` for
``pycollo_tpu_torch``: starts two local ranks of a ``torch.distributed``
process group, builds the cart-pole bench problem (default mesh,
``IPMOptions(tol=1e-6, max_iter=60)``) in each, and runs
``parallel.multihost.measure_multihost_scaling`` collectively over gloo
(NCCL refuses two ranks on one card; the collectives carry a few
numbers).  Rank 0's result is printed as JSON, and written to ``--out``
when given.

Two ranks on one machine share its cores (and, on the card, one GPU), so
the ideal two-rank rate EQUALS the one-rank rate, not twice it:
``shared_hardware_efficiency`` = multi/single measures what the process
group and the sharing cost, and the ``efficiency`` field, which divides by
twice the single rate, means something only with a card and a host per
rank (BASELINE.md's >= 80 % target).

Usage::

    python scripts/measure_multihost_torch.py                  # on the card
    python scripts/measure_multihost_torch.py --device cpu --per-host-batch 4
    python scripts/measure_multihost_torch.py --out scaling.json
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RANKS = 2
TIMEOUT = 1800


def _rank(device, per_host_batch, rank, world, address):
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "examples"))
    import torch
    from cart_pole_swing_up_torch import build_problem
    from pycollo_tpu_torch.parallel import multihost
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    dev = multihost.initialize(address, world, rank, backend="gloo",
                               device=device)
    try:
        problem = build_problem()
        problem.settings.console_out_progress = False
        problem.settings.nlp_tolerance = 1e-6
        problem.initialise()
        it = problem.backend.mesh_iterations[0]
        it.build_solver(IPMOptions(tol=1e-6, max_iter=60))
        rec = multihost.measure_multihost_scaling(
            it, per_host_batch=per_host_batch, devices=[dev])
        rec.update(device=str(dev),
                   device_name=(torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"))
        multihost.report(rec)
    finally:
        multihost.shutdown()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--per-host-batch", type=int, default=16)
    parser.add_argument("--out", help="also write the JSON to this file")
    parser.add_argument("--rank", nargs=3, metavar=("RANK", "WORLD", "ADDR"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank:
        _rank(args.device, args.per_host_batch,
              int(args.rank[0]), int(args.rank[1]), args.rank[2])
        return

    sys.path.insert(0, str(REPO))
    from pycollo_tpu_torch.parallel.multihost import run_local_ranks
    argv = [sys.executable, str(Path(__file__).resolve()), "--device",
            args.device, "--per-host-batch",
            str(args.per_host_batch), "--rank"]
    rec = dict(run_local_ranks(argv, RANKS, TIMEOUT)[0])
    rec["shared_hardware_efficiency"] = (
        rec["multi_host_solves_per_sec"]
        / max(rec["single_host_solves_per_sec"], 1e-12))
    rec["note"] = (
        "two local processes share one machine (and one card), so the "
        "ideal 2-process rate EQUALS the 1-process rate; "
        "shared_hardware_efficiency = multi/single measures the process "
        "group's and the sharing's cost. The 'efficiency' field divides by "
        "2x the single rate and is meaningful only with a card and a host "
        "per rank (BASELINE.md's >= 80% target).")
    text = json.dumps(rec, indent=1)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
