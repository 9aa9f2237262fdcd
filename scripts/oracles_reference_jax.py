"""The JAX package's mesh histories on the oracle problems, as data.

Run from the root of a checkout, on the CPU::

    JAX_PLATFORMS=cpu python3 scripts/oracles_reference_jax.py [KEY ...]

For each key (default: all of ``ENTRIES``) it builds the problem through
the JAX package (``examples/<module>.py``), keeps the example's own
settings but for those the entry names (the quadrature, the number of
mesh or IPM iterations), and solves it with ``problem.solve()`` in f64.  It
records, per mesh iteration, the nodes of every section of every phase,
``n_free``, ``m_total``, the convergence flag, the objective, the IPM
iterations and the KKT error; then the final objective, whether the mesh
tolerance was met, the seconds the solve took here and the checkout's git
commit.  The entries are merged into ``tests/data/oracles_jax.json``
(``--out``), one per key.  The port is held to this file on the CPU
(``tests/test_torch_oracles.py``, ``tests/test_torch_time_dependence.py``,
``tests/test_torch_trajectory_oracle.py``) and on the card (the
``oracles`` phase of ``chip_smoke.py``), where there is no JAX.  The
shuttle takes about 6 minutes here, cart-pole under Radau 4, Delta III's
50 IPM iterations 2-3; the rest about a minute together.
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
OUT = ROOT / "tests" / "data" / "oracles_jax.json"

#: key -> (example module, ``build_problem`` argument or None, settings
#: that differ from the example's own)
ENTRIES = {
    "rocket_1d": ("rocket_1d", None, {"max_mesh_iterations": 2}),
    "tumour_anti_angiogenesis": ("tumour_anti_angiogenesis", None,
                                 {"max_mesh_iterations": 2}),
    "space_shuttle_reentry_trajectory": ("space_shuttle_reentry_trajectory",
                                         None, {"max_mesh_iterations": 2}),
    "time_dependence:symbolic": ("time_dependence", "symbolic", {}),
    "time_dependence:dynamicsymbols": ("time_dependence", "dynamicsymbols",
                                       {}),
    "time_dependence:functional": ("time_dependence", "functional", {}),
    "time_dependence:state_named_t": ("time_dependence", "state_named_t",
                                      {}),
    "brachistochrone:lobatto": ("brachistochrone", None, {}),
    "brachistochrone:radau": ("brachistochrone", None,
                              {"quadrature_method": "radau"}),
    "cart_pole_swing_up:radau": ("cart_pole_swing_up", None,
                                 {"quadrature_method": "radau"}),
    # Delta III's first mesh, stopped after 50 IPM iterations (the full
    # first mesh, 200 iterations, is in examples_first_mesh_jax.json)
    "delta_iii_launch_vehicle:first_mesh_50": (
        "delta_iii_launch_vehicle", None,
        {"max_mesh_iterations": 1, "max_nlp_iterations": 50}),
}


def mesh_history(module: str, variant, settings: dict):
    """Build the example through the JAX package and solve it."""
    example = importlib.import_module(module)
    problem = (example.build_problem() if variant is None
               else example.build_problem(variant))
    problem.settings.console_out_progress = False
    for name, value in settings.items():
        setattr(problem.settings, name, value)
    t0 = time.perf_counter()
    solution = problem.solve()
    seconds = time.perf_counter() - t0
    meshes = [{
        "section_nodes": [[int(n) for n in t.section_nodes]
                          for t in r.iteration.tables],
        "n_free": int(r.iteration.n_free),
        "m_total": int(r.iteration.layout.m_total),
        "converged": bool(r.converged),
        "objective": float(r.objective),
        "iterations": int(r.ipm_result.iterations),
        "kkt_error": float(r.ipm_result.kkt_error),
    } for r in problem.mesh_iterations]
    return {"module": module, "variant": variant, "settings": settings,
            "meshes": meshes, "objective": float(solution.objective),
            "mesh_tolerance_met": bool(problem.mesh_tolerance_met),
            "seconds": seconds}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("keys", nargs="*", default=list(ENTRIES),
                        choices=list(ENTRIES), metavar="KEY")
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    for key in args.keys:
        entry = dict(mesh_history(*ENTRIES[key]), commit=commit or None)
        print(json.dumps({key: entry}), flush=True)
        # Read the file again before each write, so runs over different
        # keys may share it.
        data = json.loads(args.out.read_text()) if args.out.exists() else {}
        data[key] = entry
        args.out.write_text(json.dumps(dict(sorted(data.items())), indent=1)
                            + "\n")


if __name__ == "__main__":
    main()
