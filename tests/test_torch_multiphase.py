"""Multiphase sliding mass through the port's ``problem.solve()``.

Twin of ``tests/integration/test_multiphase.py``: a unit mass slides from
x=0 to x=1 in minimum time with v(t0)=v(tF)=0, split into phases joined by
endpoint constraints.  The analytic optimum is 2/sqrt(5) = 0.4472136; the
port must also give the JAX package's mesh history and objective (1e-8
relative) on the CPU in float64.
"""

import numpy as np
import pytest
import sympy as sym
import torch

import jax  # noqa: F401  (configured for the CPU by tests/conftest.py)

import pycollo_tpu
import pycollo_tpu_torch

torch.set_num_threads(2)

PHASE_NAMES = {0: "A", 1: "B", 2: "C", 3: "D"}
EXPECTED_SOLUTION = 0.4472136


def variable_phase_problem(pkg, num_phases):
    """``tests/integration/test_multiphase.py``'s problem, built with
    ``pkg`` (the JAX package or the port)."""
    x = sym.Symbol("x")
    v = sym.Symbol("v")
    f = sym.Symbol("f")

    MAX_T = 1.0
    MAX_V = 10.0
    MAX_F = 20.0

    problem = pkg.OptimalControlProblem(f"{num_phases}-phase Sliding Mass")
    problem.settings.console_out_progress = False

    for i in range(num_phases):
        start_x = i / num_phases
        end_x = (i + 1) / num_phases
        phase = problem.new_phase(PHASE_NAMES[i],
                                  state_variables=[x, v],
                                  control_variables=[f])
        phase.state_equations = {x: v, v: f}
        phase.bounds.initial_time = [0, MAX_T] if i else 0
        phase.bounds.final_time = [0, MAX_T]
        phase.bounds.initial_state_constraints = {
            x: start_x,
            v: [0, MAX_V] if i else 0,
        }
        phase.bounds.state_variables = {x: [start_x, end_x],
                                        v: [0, MAX_V]}
        phase.bounds.final_state_constraints = {
            x: end_x,
            v: [0, MAX_V] if ((i + 1) != num_phases) else 0,
        }
        phase.bounds.control_variables = {f: [-MAX_F, MAX_F]}
        phase.guess.time = [start_x * MAX_T, end_x * MAX_T]
        phase.guess.state_variables = [[start_x, end_x], [0, 0]]
        phase.guess.control_variables = [[0, 0]]

    if num_phases >= 2:
        endpoint_constraints = []
        for p1, p2 in zip(problem.phases[:-1], problem.phases[1:]):
            endpoint_constraints.append(p1.final_state_variables.v
                                        - p2.initial_state_variables.v)
            endpoint_constraints.append(p1.final_time_variable
                                        - p2.initial_time_variable)
        problem.endpoint_constraints = endpoint_constraints
        problem.bounds.endpoint_constraints = \
            [[0, 0]] * len(endpoint_constraints)

    problem.objective_function = problem.phases[-1].final_time_variable
    return problem


def _history(problem):
    return [[(t.K, t.N) for t in r.iteration.tables]
            for r in problem.mesh_iterations]


@pytest.mark.parametrize("num_phases", [1, 2])
def test_multiphase(num_phases):
    ref = variable_phase_problem(pycollo_tpu, num_phases)
    ref.solve()
    problem = variable_phase_problem(pycollo_tpu_torch, num_phases)
    problem.solve(device="cpu")
    assert np.isclose(problem.solution.objective, EXPECTED_SOLUTION)
    assert problem.mesh_tolerance_met is True
    assert _history(problem) == _history(ref)
    assert problem.solution.objective == pytest.approx(
        ref.solution.objective, rel=1e-8)
