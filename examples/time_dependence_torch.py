"""Time-dependent dynamics, four ways (the problems of
``tests/unit/test_time_dependence.py``).

Variants of ``build_problem(variant)``:

* ``"symbolic"``: y' = u t with the sympy symbol ``t`` bound to the
  collocation node times;
* ``"dynamicsymbols"``: the same with ``sympy.physics.mechanics``
  ``dynamicsymbols`` variables (functions of t);
* ``"functional"``: the same through the functional frontend;
* ``"state_named_t"``: a state literally named ``t`` keeps its variable
  meaning: y' = u y, y(0) = 1.

The first three maximise y(2) with u in [0, 1] on t in [0, 2]: u* = 1,
objective -2.  The last maximises y(1): objective -e.  Each problem is set
up as the reference test solves it: two mesh iterations at mesh tolerance
1e-6.  The port's twin of ``examples/time_dependence.py``; the functional
frontend stacks the component axis with ``torch.stack``.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import numpy as np  # noqa: E402
import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402

VARIANTS = ("symbolic", "dynamicsymbols", "functional", "state_named_t")
#: analytic objectives
OBJECTIVES = {"symbolic": -2.0, "dynamicsymbols": -2.0, "functional": -2.0,
              "state_named_t": -float(np.e)}


def _time_problem(name, state, control, t):
    problem = pycollo_tpu_torch.OptimalControlProblem(name=name)
    phase = problem.new_phase(name="A")
    phase.state_variables = [state]
    phase.control_variables = control
    phase.state_equations = [control * t]
    problem.objective_function = -phase.final_state_variables[0]
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = 2.0
    phase.bounds.state_variables = [[-10, 10]]
    phase.bounds.control_variables = [[0, 1]]
    phase.bounds.initial_state_constraints = {state: 0.0}
    phase.guess.time = np.array([0.0, 2.0])
    phase.guess.state_variables = np.array([[0.0, 1.0]])
    phase.guess.control_variables = np.array([[0.5, 0.5]])
    return problem


def _functional():
    problem = pycollo_tpu_torch.OptimalControlProblem(name="time-dep-fn")
    phase = problem.new_phase(name="A")
    phase.state_variables = ["y"]
    phase.control_variables = ["u"]
    phase.state_equations = lambda y, u, t, s: torch.stack([u[0] * t])
    problem.objective_function = lambda ep: -ep.phase[0].yF[0]
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = 2.0
    phase.bounds.state_variables = [[-10, 10]]
    phase.bounds.control_variables = [[0, 1]]
    phase.bounds.initial_state_constraints = {"y": 0.0}
    phase.guess.time = np.array([0.0, 2.0])
    phase.guess.state_variables = np.array([[0.0, 1.0]])
    phase.guess.control_variables = np.array([[0.5, 0.5]])
    return problem


def _state_named_t():
    t_state, u = sym.symbols("t u")
    problem = pycollo_tpu_torch.OptimalControlProblem(name="t-clash")
    phase = problem.new_phase(name="A")
    phase.state_variables = [t_state]
    phase.control_variables = u
    phase.state_equations = [u * t_state]
    problem.objective_function = -phase.final_state_variables[0]
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = 1.0
    phase.bounds.state_variables = [[0.5, 10]]
    phase.bounds.control_variables = [[0, 1]]
    phase.bounds.initial_state_constraints = {t_state: 1.0}
    phase.guess.time = np.array([0.0, 1.0])
    phase.guess.state_variables = np.array([[1.0, 2.0]])
    phase.guess.control_variables = np.array([[0.5, 0.5]])
    return problem


def build_problem(variant="symbolic"):
    if variant == "symbolic":
        y, u, t = sym.symbols("y u t")
        problem = _time_problem("time-dep", y, u, t)
    elif variant == "dynamicsymbols":
        from sympy.physics.mechanics import dynamicsymbols
        y, u = dynamicsymbols("y u")
        problem = _time_problem("dynsyms", y, u, dynamicsymbols._t)
    elif variant == "functional":
        problem = _functional()
    elif variant == "state_named_t":
        problem = _state_named_t()
    else:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    problem.settings.max_mesh_iterations = 2
    problem.settings.mesh_tolerance = 1e-6
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    for variant in VARIANTS:
        problem = build_problem(variant)
        solution = problem.solve(device=args.device)
        print(f"{variant}: objective {solution.objective:.8f} "
              f"(expected {OBJECTIVES[variant]:.8f})")
