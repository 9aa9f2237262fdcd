"""The JAX package's first-mesh answers on the example families, as data.

Run from the root of a checkout, on the CPU::

    JAX_PLATFORMS=cpu python3 scripts/examples_reference_jax.py [FAMILY ...]

For each family (default: all of ``FAMILIES``; a name is a key such as
``tumour_anti_angiogenesis`` or ``path_follow:rate``) it builds the
example through the JAX package (``examples/<module>.py``), keeps its own
settings but for ``max_mesh_iterations = 1``, and solves the first mesh
in f64 with ``problem.solve()``.  It records the first mesh iteration's
``n_free`` and ``m_total``, the objective, ``converged``, the IPM
iteration count and KKT error, the seconds the solve took here and the
checkout's git commit, and merges them into
``tests/data/examples_first_mesh_jax.json`` (``--out``), one entry per
key.  The port's twins are held to this file on the CPU
(``tests/test_torch_examples_solve.py``) and on the card (the
``examples`` phase of ``chip_smoke.py``), where there is no JAX.
The space station and Delta III take minutes each here.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "examples")]
OUT = ROOT / "tests" / "data" / "examples_first_mesh_jax.json"

#: key -> (example module, ``build_problem`` argument or None); the nine
#: families that kinetic_batch_reactor (build only) leaves, and every
#: path-follow variant
FAMILIES = {
    "rocket_1d": ("rocket_1d", None),
    "tumour_anti_angiogenesis": ("tumour_anti_angiogenesis", None),
    "space_station_attitude_control": ("space_station_attitude_control",
                                       None),
    "free_flying_robot": ("free_flying_robot", None),
    "delta_iii_launch_vehicle": ("delta_iii_launch_vehicle", None),
    "double_pendulum": ("double_pendulum", None),
    "path_follow:directional": ("path_follow", "directional"),
    "path_follow:orthogonal": ("path_follow", "orthogonal"),
    "path_follow:rate": ("path_follow", "rate"),
    "cart_pole_swing_up_implicit": ("cart_pole_swing_up_implicit", None),
}


def first_mesh(module: str, variant):
    """Build the example through the JAX package and solve its first mesh."""
    example = importlib.import_module(module)
    problem = (example.build_problem() if variant is None
               else example.build_problem(variant))
    problem.settings.console_out_progress = False
    problem.settings.max_mesh_iterations = 1
    t0 = time.perf_counter()
    problem.solve()
    seconds = time.perf_counter() - t0
    r = problem.mesh_iterations[0]
    it = r.iteration
    return {"module": module, "variant": variant,
            "n_free": int(it.n_free), "m_total": int(it.layout.m_total),
            "objective": float(r.objective), "converged": bool(r.converged),
            "iterations": int(r.ipm_result.iterations),
            "kkt_error": float(r.ipm_result.kkt_error),
            "seconds": seconds}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("families", nargs="*", default=list(FAMILIES),
                        choices=list(FAMILIES), metavar="FAMILY")
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    for key in args.families:
        entry = dict(first_mesh(*FAMILIES[key]), commit=commit or None)
        print(json.dumps({key: entry}), flush=True)
        # Read the file again before each write, so runs over different
        # families may share it.
        data = json.loads(args.out.read_text()) if args.out.exists() else {}
        data[key] = entry
        args.out.write_text(json.dumps(dict(sorted(data.items())), indent=1)
                            + "\n")


if __name__ == "__main__":
    main()
