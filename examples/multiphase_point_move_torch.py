"""Multiphase point move problem.

Move a point mass in the plane between three waypoints ([1,-2] -> [0,2] ->
[-1,-2]) while avoiding a unit-circle obstacle at the origin; demonstrates
two phases with endpoint linkage constraints and a static parameter (the
mass).  Capability parity with the reference example
(``examples/multiphase_point_move/multiphase_point_move.py``).
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402


def build_problem():
    x, y, dx, dy = sym.symbols("x y dx dy")
    Fx, Fy = sym.symbols("Fx Fy")
    m = sym.Symbol("m")
    ddx, ddy = sym.symbols("ddx ddy")
    r = 1.0

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Multiphase point move", parameter_variables=m)

    phase_A = problem.new_phase(name="A")
    phase_A.state_variables = [x, y, dx, dy]
    phase_A.control_variables = [Fx, Fy]
    phase_A.state_equations = {x: dx, y: dy, dx: ddx, dy: ddy}
    phase_A.path_constraints = [sym.sqrt(x ** 2 + y ** 2) - r]
    phase_A.integrand_functions = [Fx ** 2, Fy ** 2]

    phase_A.bounds.initial_time = 0
    phase_A.bounds.final_time = [0.5, 1.5]
    phase_A.bounds.state_variables = {x: [-3, 3], y: [-3, 3],
                                      dx: [-50, 50], dy: [-50, 50]}
    phase_A.bounds.control_variables = {Fx: [-50, 50], Fy: [-50, 50]}
    phase_A.bounds.integral_variables = [[0, 1000], [0, 1000]]
    phase_A.bounds.path_constraints = [[0, 10]]
    phase_A.bounds.initial_state_constraints = {x: 1, y: -2, dx: 0, dy: 0}
    phase_A.bounds.final_state_constraints = {x: 0, y: 2, dx: 0, dy: 0}

    phase_A.guess.time = np.array([0, 1])
    phase_A.guess.state_variables = np.array(
        [[1, 0], [-2, 2], [0, 0], [0, 0]])
    phase_A.guess.control_variables = np.array([[0, 0], [0, 0]])
    phase_A.guess.integral_variables = np.array([0, 0])

    phase_B = problem.new_phase_like(phase_for_copying=phase_A, name="B")
    phase_B.bounds.initial_time = [0.5, 1.5]
    phase_B.bounds.final_time = [1.5, 2.0]
    phase_B.bounds.initial_state_constraints = {x: 0, y: 2, dx: 0, dy: 0}
    phase_B.bounds.final_state_constraints = {x: -1, y: -2, dx: 0, dy: 0}
    phase_B.guess.time = np.array([1, 2])
    phase_B.guess.state_variables = np.array(
        [[0, -1], [2, -2], [0, 0], [0, 0]])
    phase_B.guess.integral_variables = np.array([0, 0])

    problem.objective_function = (
        phase_A.integral_variables[0] + phase_A.integral_variables[1]
        + phase_B.integral_variables[0] + phase_B.integral_variables[1])
    problem.auxiliary_data = {ddx: Fx / m, ddy: Fy / m}
    problem.endpoint_constraints = [
        phase_A.final_time_variable - phase_B.initial_time_variable,
        phase_A.final_state_variables.x - phase_B.initial_state_variables.x,
        phase_A.final_state_variables.y - phase_B.initial_state_variables.y,
        phase_A.final_state_variables.dx
        - phase_B.initial_state_variables.dx,
        phase_A.final_state_variables.dy
        - phase_B.initial_state_variables.dy,
    ]
    problem.bounds.parameter_variables = [[1, 2]]
    problem.bounds.endpoint_constraints = [0, 0, 0, 0, 0]
    problem.guess.parameter_variables = np.array([1.5])
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.6f}")
