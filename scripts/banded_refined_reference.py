"""The JAX package's block-banded path on the refined cart-pole mesh.

Run from the root of a checkout, on the CPU::

    JAX_PLATFORMS=cpu python3 scripts/banded_refined_reference.py [--instances 8]

It refines cart-pole swing-up to its final mesh with the JAX package's
``problem.solve()`` (f64, dense path), then solves the first
``--instances`` of the perturbed batch that ``chip_smoke.py`` solves there
(``_theta_chunk(it, 256, 0)``: the ``bench.py`` recipe, seed 0) through
the block-banded path with ``IPMOptions(tol=1e-6, max_iter=80)``, as
``bench.py`` builds it, and through the dense f64 path for comparison.
It prints one JSON object: the mesh, and per path the converged flags,
iterations, objectives and KKT errors.  ``chip_smoke.py``'s banded phase
gates the port's refined-mesh banded batch on the card at the converged
count this gives, less one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "examples")]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--instances", type=int, default=8)
    args = parser.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from cart_pole_swing_up import build_problem
    from pycollo_tpu.solver.ipm import IPMOptions

    from chip_smoke import _theta_chunk

    problem = build_problem()
    problem.settings.console_out_progress = False
    t0 = time.perf_counter()
    problem.solve()
    refine_s = time.perf_counter() - t0
    it = problem.backend.mesh_iterations[-1]
    theta = _theta_chunk(it, 256, 0)[:args.instances]
    x0 = np.tile(it.xs_guess, (len(theta), 1))
    out = {"mesh": {"K": [int(t.K) for t in it.tables],
                    "N": [int(t.N) for t in it.tables],
                    "n_free": int(it.n_free)},
           "refine_s": refine_s, "instances": len(theta)}
    for name, linear_solver in (("banded", "block-banded"),
                                ("dense_f64", "condensed-cholesky")):
        problem.settings.linear_solver = linear_solver
        solver = it.build_solver(IPMOptions(tol=1e-6, max_iter=80))
        t0 = time.perf_counter()
        res = jax.jit(jax.vmap(solver))(jnp.asarray(x0), jnp.asarray(theta))
        res.x.block_until_ready()
        out[name] = {
            "seconds_with_compile": time.perf_counter() - t0,
            "converged": np.asarray(res.converged).tolist(),
            "n_converged": int(np.asarray(res.converged).sum()),
            "iterations": np.asarray(res.iterations).tolist(),
            "objective": (np.asarray(res.f) / it.w).tolist(),
            "kkt_error": np.asarray(res.kkt_error).tolist()}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
