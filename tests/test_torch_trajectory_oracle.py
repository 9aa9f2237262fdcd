"""Twin of ``tests/integration/test_trajectory_oracle.py`` for the port.

The stored float64 trajectories ``tests/data/trajectory_*.npz`` (the JAX
package's Lobatto solves, ``tests/data/generate_trajectory_oracles.py``)
against the port's ``problem.solve(device="cpu")``, normalised by each
signal's amplitude as the reference does:

1. regression: the port's Lobatto solve reproduces the stored trajectories
   to 1e-5 and the objective to 1e-6, but for the hypersensitive problem's
   trajectories, held at 1e-4: at n_free ~1,700 the final-mesh NLP's f64
   rounding moves its state near t = 9950 by up to 2.2e-5 between two
   solves that both reach KKT errors below 1e-8, and the JAX package's own
   CPU solve is 9.3e-6 off the stored oracle (``chip_smoke.py``'s
   ``REFINE_PROBLEMS``);
2. cross-scheme: an independent Radau solve reproduces the stored Lobatto
   trajectories to 1e-5 on the interior controls (Radau has no collocation
   node at tF, so u(tF) is extrapolated there), and the JAX package's Radau
   mesh history (``tests/data/oracles_jax.json``).
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import oracle_history  # noqa: E402

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
CASES = {
    "brachistochrone": "brachistochrone_torch",
    "cart_pole": "cart_pole_swing_up_torch",
    "hypersensitive": "hypersensitive_problem_torch",
}
#: key of the JAX package's Radau mesh history in oracles_jax.json
RADAU_HISTORY = {"brachistochrone": "brachistochrone:radau",
                 "cart_pole": "cart_pole_swing_up:radau"}
TRAJECTORY_TOL = {"brachistochrone": 1e-5, "cart_pole": 1e-5,
                  "hypersensitive": 1e-4}


def _solve(name, quadrature):
    problem = importlib.import_module(CASES[name]).build_problem()
    problem.settings.console_out_progress = False
    problem.settings.quadrature_method = quadrature
    solution = problem.solve(device="cpu")
    assert problem.mesh_tolerance_met
    return problem, solution


def _compare(solution, stored, tol, control_interior_only=False):
    y_q, u_q = solution.interpolate_phase(0, stored["tau"])
    for got, ref, label in ((y_q, stored["y"], "state"),
                            (u_q, stored["u"], "control")):
        if label == "control" and control_interior_only:
            got, ref = got[:, :-1], ref[:, :-1]
        scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1.0)
        err = np.abs(got - ref) / scale
        assert err.max() <= tol, (label, float(err.max()))
    assert abs(float(solution.initial_time[0]) - float(stored["t0"])) <= tol
    assert abs(float(solution.final_time[0]) - float(stored["tF"])) <= tol


@pytest.mark.slow
@pytest.mark.parametrize("name", ["brachistochrone", "cart_pole",
                                  "hypersensitive"])
def test_trajectory_regression(name):
    stored = np.load(DATA / f"trajectory_{name}.npz")
    _, sol = _solve(name, "lobatto")
    _compare(sol, stored, TRAJECTORY_TOL[name])
    np.testing.assert_allclose(sol.objective, float(stored["objective"]),
                               rtol=1e-6)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["brachistochrone", "cart_pole"])
def test_trajectory_cross_scheme(name):
    """Radau vs stored Lobatto: independent discretizations agree."""
    stored = np.load(DATA / f"trajectory_{name}.npz")
    problem, sol = _solve(name, "radau")
    _compare(sol, stored, 1e-5, control_interior_only=True)
    ref = oracle_history.load()[RADAU_HISTORY[name]]
    assert oracle_history.mismatches(problem, sol, ref) == []
