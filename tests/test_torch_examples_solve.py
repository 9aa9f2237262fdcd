"""The example twins' first mesh, solved by the port on the CPU, against the
JAX package's answers stored in ``tests/data/examples_first_mesh_jax.json``.

Each family (and path-follow variant) is built from ``examples/*_torch.py``
with its own settings but ``max_mesh_iterations = 1`` and solved with
``problem.solve(device="cpu")`` in f64.  The first mesh iteration must have
the stored ``n_free`` and ``m_total`` and the stored convergence flag; a
converged solve must reach the stored objective to 1e-8 relative (the two
packages differ by at most 2.3e-13 here).  Where the JAX package does not
converge (Delta III, path_follow "rate": 200 IPM iterations, stalled) the
port must stop after the same iterations at a finite KKT error, with the
stored objective to 1e-6 relative; Delta III is also held after the 50 IPM
iterations ``chip_smoke.py`` runs it to (``tests/data/oracles_jax.json``).
The file is written by ``scripts/examples_reference_jax.py``; two cheap
families are initialised through the JAX package again so that stale data
fails.  Tumour, rocket and the implicit cart-pole (11-27 s each) run in
the default suite, the others are ``slow``.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))
REFERENCE = json.loads(
    (ROOT / "tests" / "data" / "examples_first_mesh_jax.json").read_text())

torch.set_num_threads(2)

#: objective tolerance against the JAX package, relative
OBJECTIVE_RTOL = 1e-8
#: the same, where neither package converges: 200 IPM iterations amplify the
#: rounding differences
UNCONVERGED_RTOL = 1e-6
FAST = ("tumour_anti_angiogenesis", "rocket_1d",
        "cart_pole_swing_up_implicit")
FAMILIES = ("rocket_1d", "tumour_anti_angiogenesis",
            "space_station_attitude_control", "free_flying_robot",
            "delta_iii_launch_vehicle", "double_pendulum",
            "path_follow:directional", "path_follow:orthogonal",
            "path_follow:rate", "cart_pole_swing_up_implicit")


def _build(module_name, variant):
    module = importlib.import_module(module_name)
    problem = (module.build_problem() if variant is None
               else module.build_problem(variant))
    problem.settings.console_out_progress = False
    return problem


def test_reference_covers_every_family():
    assert sorted(REFERENCE) == sorted(FAMILIES)
    for key, ref in REFERENCE.items():
        assert ref["n_free"] > 0 and ref["m_total"] > 0, key
        assert ref["iterations"] > 0, key


@pytest.mark.parametrize("key", [
    pytest.param(k, marks=() if k in FAST else pytest.mark.slow)
    for k in FAMILIES])
def test_first_mesh_matches_the_jax_package(key):
    ref = REFERENCE[key]
    problem = _build(ref["module"] + "_torch", ref["variant"])
    problem.settings.max_mesh_iterations = 1
    problem.solve(device="cpu")
    (r,) = problem.mesh_iterations
    assert r.ipm_result.x.device.type == "cpu"
    assert (r.iteration.n_free, r.iteration.layout.m_total) \
        == (ref["n_free"], ref["m_total"])
    assert r.converged == ref["converged"]
    rtol = OBJECTIVE_RTOL if ref["converged"] else UNCONVERGED_RTOL
    assert r.objective == pytest.approx(ref["objective"], rel=rtol)
    if not ref["converged"]:
        assert int(r.ipm_result.iterations) == ref["iterations"]
        assert np.isfinite(float(r.ipm_result.kkt_error))


@pytest.mark.parametrize("key", ["rocket_1d", "tumour_anti_angiogenesis"])
def test_reference_data_is_current(key):
    """The stored sizes are those of the JAX package's example today."""
    ref = REFERENCE[key]
    problem = _build(ref["module"], ref["variant"])
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    assert type(it).__module__ == "pycollo_tpu.transcription"
    assert (it.n_free, it.layout.m_total) == (ref["n_free"], ref["m_total"])


@pytest.mark.slow
def test_delta_iii_first_mesh_at_smaller_depth():
    """Delta III's first mesh stopped after 50 IPM iterations, the depth
    ``chip_smoke.py`` runs it at, against the JAX package's iterate there
    (``tests/data/oracles_jax.json``, ``tests/oracle_history.py``)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle_history
    ref = oracle_history.load()["delta_iii_launch_vehicle:first_mesh_50"]
    problem = _build("delta_iii_launch_vehicle_torch", None)
    for name, value in ref["settings"].items():
        setattr(problem.settings, name, value)
    solution = problem.solve(device="cpu")
    assert oracle_history.mismatches(problem, solution, ref) == []
