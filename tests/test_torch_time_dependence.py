"""Twin of ``tests/unit/test_time_dependence.py`` for the port.

The four problems (``examples/time_dependence_torch.py``): y' = u t with a
symbolic ``t``, with ``dynamicsymbols`` variables and through the
functional frontend, and a state literally named ``t``, each solved by
``problem.solve(device="cpu")`` over two mesh iterations at mesh tolerance
1e-6, as the reference test solves them.  Each is held to the analytic
objective at the reference's tolerance (-2 at 1e-4; -e at 1e-3) and to the
JAX package's mesh history in ``tests/data/oracles_jax.json``
(``tests/oracle_history.py``: nodes, sizes and convergence exactly,
objectives to 1e-8).  The ``cuda`` case solves the symbolic problem on the
card (skipped without one).  JAX is imported inside the CPU tests only.
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
from time_dependence_torch import (OBJECTIVES, VARIANTS,  # noqa: E402
                                   build_problem)

torch.set_num_threads(2)

REFERENCE = oracle_history.load()
#: the reference test's tolerances on the analytic objectives
ANALYTIC_TOL = {"symbolic": 1e-4, "dynamicsymbols": 1e-4,
                "functional": 1e-4, "state_named_t": 1e-3}


def _solve(variant, device):
    problem = build_problem(variant)
    problem.settings.console_out_progress = False
    solution = problem.solve(device=device)
    return problem, solution


def _hold(variant, problem, solution):
    assert abs(solution.objective - OBJECTIVES[variant]) \
        < ANALYTIC_TOL[variant]
    ref = REFERENCE[f"time_dependence:{variant}"]
    assert oracle_history.mismatches(problem, solution, ref) == []


@pytest.mark.parametrize("variant", VARIANTS)
def test_time_dependence(variant):
    problem, solution = _solve(variant, "cpu")
    for r in problem.mesh_iterations:
        assert r.ipm_result.x.device.type == "cpu"
    _hold(variant, problem, solution)


def test_reference_data_is_current():
    """The stored first-mesh sizes are those of the JAX package today."""
    import time_dependence
    for variant in VARIANTS:
        problem = time_dependence.build_problem(variant)
        problem.settings.console_out_progress = False
        problem.initialise()
        it = problem.backend.mesh_iterations[0]
        assert type(it).__module__ == "pycollo_tpu.transcription"
        first = REFERENCE[f"time_dependence:{variant}"]["meshes"][0]
        assert (it.n_free, it.layout.m_total) \
            == (first["n_free"], first["m_total"])


@pytest.mark.cuda
def test_time_dependence_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    problem, solution = _solve("symbolic", torch.device("cuda"))
    for r in problem.mesh_iterations:
        assert r.ipm_result.x.device.type == "cuda"
    _hold("symbolic", problem, solution)
