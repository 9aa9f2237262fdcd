"""Twins of the reference's oracle integration tests, for the port.

One file for ``tests/integration/test_rocket_1d.py``,
``test_tumour_anti_angiogenesis.py``, ``test_free_flying_robot.py``,
``test_space_shuttle_reentry.py``, ``test_space_station_attitude_control.py``
and ``test_hypersensitive_problem.py``.  Each problem is built from its
``examples/*_torch.py`` twin and solved by ``problem.solve()``; each test
keeps the reference test's assertions at its tolerances, and where the JAX
package's answer is stored, holds the port to it:

* rocket, tumour (default run) and shuttle (``slow``), two mesh iterations:
  the JAX package's mesh history in ``tests/data/oracles_jax.json``
  (``tests/oracle_history.py``: nodes, sizes, convergence exactly,
  objectives to 1e-8);
* the free-flying robot (default run) and the space station (``slow``),
  first mesh: the JAX package's first mesh in
  ``tests/data/examples_first_mesh_jax.json`` (sizes, verdict, objective to
  1e-8), the data ``tests/test_torch_examples_solve.py`` holds the same
  solve to (there the free-flying robot runs under ``slow`` only);
* hypersensitive (``slow``): GPOPS-II's 3.36206 at 1e-4, mesh tolerance met;
* the four full ph-refinements (``slow`` and ``heavy``; on the CPU and,
  marked ``cuda``, on the card): the reference's GPOPS-II gates with the
  mesh tolerance met.  Each prints one ``ORACLE {json}`` line (objective,
  mesh iterations, verdict, wall seconds), which
  ``scripts/run_heavy_oracles_torch.sh`` collects from the card's run.

Nothing here imports JAX, so the ``cuda`` cases collect on a machine
without it (``--noconftest``).
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import oracle_history  # noqa: E402

torch.set_num_threads(2)

FIRST_MESH = json.loads(
    (ROOT / "tests" / "data" / "examples_first_mesh_jax.json").read_text())
DEVICES = [pytest.param("cpu", id="cpu"),
           pytest.param("cuda", id="cuda", marks=pytest.mark.cuda)]


def _solve(module, device="cpu", **settings):
    import importlib
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem = importlib.import_module(module).build_problem()
    problem.settings.console_out_progress = False
    for name, value in settings.items():
        setattr(problem.settings, name, value)
    t0 = time.perf_counter()
    solution = problem.solve(device=device)
    wall = time.perf_counter() - t0
    for r in problem.mesh_iterations:
        assert r.ipm_result.x.device.type == device
    return problem, solution, wall


def _hold_history(key, problem, solution):
    ref = oracle_history.load()[key]
    assert oracle_history.mismatches(problem, solution, ref) == []


def _hold_first_mesh(key, problem, solution):
    ref = FIRST_MESH[key]
    (r,) = problem.mesh_iterations
    assert (r.iteration.n_free, r.iteration.layout.m_total) \
        == (ref["n_free"], ref["m_total"])
    assert r.converged == ref["converged"]
    assert r.objective == pytest.approx(ref["objective"],
                                        rel=oracle_history.OBJECTIVE_RTOL)


def _record(name, device, problem, solution, wall):
    """One ``ORACLE`` line for scripts/run_heavy_oracles_torch.sh."""
    print("ORACLE " + json.dumps({
        "oracle": name, "device": device,
        "objective": float(solution.objective),
        "mesh_iterations": len(problem.mesh_iterations),
        "mesh_tolerance_met": bool(problem.mesh_tolerance_met),
        "objectives": [float(r.objective) for r in problem.mesh_iterations],
        "wall_s": wall}), flush=True)


# -- tests/integration/test_rocket_1d.py ---------------------------------

def test_rocket_first_iterations():
    problem, solution, _ = _solve("rocket_1d_torch", max_mesh_iterations=2)
    results = problem.mesh_iterations
    assert len(results) == 2
    assert all(bool(r.ipm_result.converged) for r in results)
    obj1, obj2 = (r.objective for r in results)
    # Fuel burned ~ 198.7 t; refinement must not move the objective
    # by more than ~1% (bang-bang control limits the first-mesh error).
    assert 1.8e5 < obj2 < 2.1e5, obj2
    np.testing.assert_allclose(obj1, obj2, rtol=2e-2)
    _hold_history("rocket_1d", problem, solution)


# -- tests/integration/test_tumour_anti_angiogenesis.py -------------------

def test_tumour_anti_angiogenesis_two_iterations():
    problem, solution, _ = _solve("tumour_anti_angiogenesis_torch",
                                  max_mesh_iterations=2)
    assert np.isclose(solution.objective, 7.57166986e3, rtol=1e-3)
    _hold_history("tumour_anti_angiogenesis", problem, solution)


@pytest.mark.slow
@pytest.mark.heavy
@pytest.mark.parametrize("device", DEVICES)
def test_tumour_anti_angiogenesis_solves(device):
    problem, solution, wall = _solve("tumour_anti_angiogenesis_torch",
                                     device)
    _record("tumour_anti_angiogenesis", device, problem, solution, wall)
    assert np.isclose(solution.objective, 7.57166986e3, rtol=1e-4) \
        or np.isclose(solution.objective, 7.5716831e3, rtol=1e-4)
    assert problem.mesh_tolerance_met is True


# -- tests/integration/test_free_flying_robot.py --------------------------

def test_free_flying_robot_first_iteration():
    """The first-mesh NLP must converge, to the JAX package's objective."""
    problem, solution, _ = _solve("free_flying_robot_torch",
                                  max_mesh_iterations=1)
    assert solution.it_result.converged
    assert np.isfinite(solution.objective)
    _hold_first_mesh("free_flying_robot", problem, solution)


@pytest.mark.slow
@pytest.mark.heavy
@pytest.mark.parametrize("device", DEVICES)
def test_free_flying_robot_solves(device):
    """Full-refinement oracle, ported as the reference's test has it.

    This gate is looser than pycollo's upstream test, which holds the final
    objective to GPOPS-II's 7.9101902 at 1e-4: the L1-thrust objective is
    bang-bang, every re-mesh moves the switch points, and the final mesh
    chatters about +-1.5e-3 around the oracle.  So the reference requires
    the refinement history to reach the oracle at 1e-4 (at mesh tolerance
    2e-6, not upstream's 1e-5) and the final mesh to stay within 3e-3.
    """
    problem, solution, wall = _solve("free_flying_robot_torch", device,
                                     mesh_tolerance=2e-6,
                                     max_mesh_iterations=20)
    _record("free_flying_robot", device, problem, solution, wall)
    objs = np.array([r.objective for r in problem.mesh_iterations])
    assert np.isclose(objs, 7.9101902, rtol=1e-4).any() \
        or np.isclose(objs, 7.910154646, rtol=1e-4).any(), objs
    assert np.isclose(solution.objective, 7.9101902, rtol=3e-3), objs
    assert problem.mesh_tolerance_met is True


# -- tests/integration/test_space_shuttle_reentry.py ----------------------

@pytest.mark.slow
def test_space_shuttle_reentry_two_iterations():
    problem, solution, _ = _solve("space_shuttle_reentry_trajectory_torch",
                                  max_mesh_iterations=2)
    assert solution.it_result.converged
    assert np.isclose(solution.objective, -0.596, rtol=5e-3)
    _hold_history("space_shuttle_reentry_trajectory", problem, solution)


@pytest.mark.slow
@pytest.mark.heavy
@pytest.mark.parametrize("device", DEVICES)
def test_space_shuttle_reentry_solves(device):
    problem, solution, wall = _solve("space_shuttle_reentry_trajectory_torch",
                                     device, max_mesh_iterations=10)
    _record("space_shuttle_reentry", device, problem, solution, wall)
    # The published values (GPOPS-II -0.59628, SOS -0.59588) span the gate.
    assert -0.59634 <= solution.objective <= -0.59582
    assert problem.mesh_tolerance_met is True


# -- tests/integration/test_space_station_attitude_control.py -------------

@pytest.mark.slow
def test_space_station_attitude_control_first_iteration():
    problem, solution, _ = _solve("space_station_attitude_control_torch",
                                  max_mesh_iterations=1)
    assert solution.it_result.converged
    assert np.isfinite(solution.objective)
    assert 1.0 < solution.objective < 8.0
    _hold_first_mesh("space_station_attitude_control", problem, solution)


@pytest.mark.slow
@pytest.mark.heavy
@pytest.mark.parametrize("device", DEVICES)
def test_space_station_attitude_control_solves(device):
    problem, solution, wall = _solve("space_station_attitude_control_torch",
                                     device)
    _record("space_station_attitude_control", device, problem, solution,
            wall)
    assert np.isclose(solution.objective, 3.58675, rtol=1e-4) \
        or np.isclose(solution.objective, 3.58688, rtol=1e-4)
    assert problem.mesh_tolerance_met is True


# -- tests/integration/test_hypersensitive_problem.py ---------------------

@pytest.mark.slow
def test_hypersensitive_solves():
    problem, solution, _ = _solve("hypersensitive_problem_torch")
    assert np.isclose(solution.objective, 3.36206, rtol=1e-4)
    assert problem.mesh_tolerance_met is True
