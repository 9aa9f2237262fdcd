"""Benchmark of the PyTorch port: batched cart-pole swing-up solves per second.

The counterpart of ``bench.py`` for ``pycollo_tpu_torch``, on the same
workload: cart-pole swing-up (Kelly 2017,
``examples/cart_pole_swing_up_torch.py``) transcribed on the default mesh
(K=10, n=4 -> N=31 nodes), solved in batches of instances with perturbed
initial states (MPC-style replanning) by the batch-first interior-point
solver on one device.

Run from the root of a checkout::

    python3 bench_torch.py [B] [linear_solver] [--device cuda|cpu]

``B`` is the chunk size (default 256); ``linear_solver`` is
``condensed-cholesky`` (default: the mixed configuration ``bench.py``
scores, whose f32 factorization runs the Cholesky-inverse kernel
``pycollo_tpu_torch/csrc/chol_linv.cu`` on the card) or ``block-banded``
(the structured f64 path, ``IPMOptions(tol=1e-6, max_iter=80)``).
``--device`` defaults to the CUDA card and fails without one; ``cpu``
names the CPU.

Measurement: one untimed warm-up chunk (seed 1000, not reused), then
``N_CHUNKS`` fresh chunks (seeds 0..3) solved back to back; the clock
stops after ``torch.cuda.synchronize()``.  Prints ONE JSON line with the
keys of ``bench.py``'s, ``detail.device`` the card's name (or ``cpu``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CHUNK = 256
N_CHUNKS = 4
#: the mixed configuration of ``bench.py``
MIXED_OPTIONS = dict(tol=1e-6, max_iter=80, kkt_precision="mixed",
                     dc_floor=1e-7, dense_gmres_iters=12, eval_dtype="f32")
BANDED_OPTIONS = dict(tol=1e-6, max_iter=80)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("B", nargs="?", type=int, default=CHUNK)
    parser.add_argument("linear_solver", nargs="?",
                        default="condensed-cholesky",
                        choices=("condensed-cholesky", "block-banded"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()

    sys.path[:0] = [str(ROOT), str(ROOT / "examples")]
    import torch

    from cart_pole_swing_up_torch import build_problem
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions
    from pycollo_tpu_torch.utils import solve_device

    device = solve_device(args.device)
    if device.type == "cuda":
        # the mixed path refuses TF32 (solver/ipm.py)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.settings.nlp_tolerance = 1e-6   # the metric's KKT tolerance
    problem.settings.linear_solver = args.linear_solver
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    it.build_solver(IPMOptions(**(BANDED_OPTIONS
                                  if args.linear_solver == "block-banded"
                                  else MIXED_OPTIONS)))

    B = args.B
    pl = it.layout.phases[0]

    def make_chunk(seed):
        # Perturbed initial states: q1_0 in [-0.25, 0.25], q2_0 in
        # [-0.3, 0.3] (pinned entries of theta -> per-instance).
        rng = np.random.default_rng(seed)
        theta = np.tile(it.theta_default, (B, 1))
        theta[:, pl.y_off + 0 * pl.N] = rng.uniform(-0.25, 0.25, B)
        theta[:, pl.y_off + 1 * pl.N] = rng.uniform(-0.3, 0.3, B)
        return theta

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def solve(theta):
        return solve_batched(problem.backend, theta_batch=theta,
                             devices=[device])

    t0 = time.perf_counter()
    solve(make_chunk(1000))
    sync()
    warm_up = time.perf_counter() - t0

    chunks = [make_chunk(k) for k in range(N_CHUNKS)]
    sync()
    t0 = time.perf_counter()
    results = [solve(th) for th in chunks]
    sync()
    elapsed = time.perf_counter() - t0

    conv = float(np.mean([r.converged.mean() for r in results]))
    iters = float(np.mean([r.iterations.mean() for r in results]))
    kkt99 = float(np.quantile(np.concatenate(
        [r.kkt_error for r in results]), 0.99))
    solves_per_sec = (N_CHUNKS * B) / elapsed

    print(json.dumps({
        "metric": "batched cart-pole swing-up solves/sec per chip "
                  "(KKT tol 1e-6)",
        "value": round(solves_per_sec, 2),
        "unit": "solves/sec",
        "vs_baseline": round(solves_per_sec / 1000.0, 4),
        "detail": {
            "chunk_size": B,
            "n_chunks": N_CHUNKS,
            "total_wall_s": round(elapsed, 4),
            "compile_s": round(warm_up, 2),
            "converged_fraction": round(conv, 4),
            "mean_ipm_iterations": round(iters, 2),
            "kkt_error_p99": kkt99,
            "linear_solver": args.linear_solver,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device)),
        },
    }))


if __name__ == "__main__":
    main()
