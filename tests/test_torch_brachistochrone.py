"""Twin of ``tests/integration/test_brachistochrone.py`` for the port.

The brachistochrone (``examples/brachistochrone_torch.py``) solved end to
end by ``problem.solve(device="cpu")``, once under Lobatto and once under
Radau collocation (each solve is shared by the tests that read it).  The
reference test's assertions: GPOPS-II's 0.82434 at rtol 1e-4 with the mesh
tolerance met, the solution accessors, the pinned endpoints (1e-9) and
energy conservation v(tF)^2 = 2 g y(tF) at 1e-5, under both schemes.  Each
solve is also held to the JAX package's mesh history
(``tests/data/oracles_jax.json``, ``tests/oracle_history.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import oracle_history  # noqa: E402
from brachistochrone_torch import build_problem  # noqa: E402

torch.set_num_threads(2)

GPOPS_BRACHISTOCHRONE = 0.82434


@pytest.fixture(scope="module", params=["lobatto", "radau"])
def solved(request):
    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.settings.quadrature_method = request.param
    problem.initialise()
    solution = problem.solve(device="cpu")
    return request.param, problem, solution


def test_brachistochrone_solves(solved):
    method, problem, solution = solved
    assert problem.settings.quadrature_method == method
    assert np.isclose(solution.objective, GPOPS_BRACHISTOCHRONE, rtol=1e-4)
    assert problem.mesh_tolerance_met is True
    for r in problem.mesh_iterations:
        assert r.ipm_result.x.device.type == "cpu"


def test_brachistochrone_solution_structure(solved):
    method, problem, solution = solved
    # Solution accessors (reference API parity).
    assert len(solution.state) == 1
    y = solution.state[0]
    assert y.shape[0] == 3
    t = solution.time[0]
    assert t[0] == pytest.approx(0.0)
    assert t[-1] == pytest.approx(solution.objective, rel=1e-10)
    # Endpoint states hit their pinned values.
    np.testing.assert_allclose(y[:, 0], [0.0, 0.0, 0.0], atol=1e-9)
    np.testing.assert_allclose(y[0, -1], 2.0, atol=1e-9)
    np.testing.assert_allclose(y[1, -1], 2.0, atol=1e-9)
    # Physics: v at final time satisfies energy conservation v^2 = 2 g y.
    v_final = y[2, -1]
    np.testing.assert_allclose(v_final, np.sqrt(2 * 9.81 * 2.0), rtol=1e-5)


def test_brachistochrone_mesh_history(solved):
    method, problem, solution = solved
    ref = oracle_history.load()[f"brachistochrone:{method}"]
    assert oracle_history.mismatches(problem, solution, ref) == []
