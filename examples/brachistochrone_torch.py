"""Brachistochrone problem.

Example 4.10 from Betts, J. T. (2010). Practical Methods for Optimal
Control and Estimation Using Nonlinear Programming (2nd ed.), p215-216.
Capability parity with the reference example
(``examples/brachistochrone/brachistochrone.py``) using the symbolic
frontend; expected objective (minimum final time) is 0.82434.
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
    x, y, v, u = sym.symbols("x y v u")
    g = sym.Symbol("g")

    problem = pycollo_tpu_torch.OptimalControlProblem(name="Brachistochrone")
    phase = problem.new_phase(name="A")
    phase.state_variables = [x, y, v]
    phase.control_variables = u
    phase.state_equations = [v * sym.sin(u), v * sym.cos(u),
                             g * sym.cos(u)]
    problem.auxiliary_data = {g: 9.81}
    problem.objective_function = phase.final_time_variable

    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0, 10]
    phase.bounds.state_variables = [[0, 10], [0, 10], [-50, 50]]
    phase.bounds.control_variables = [[-np.pi / 2, np.pi / 2]]
    phase.bounds.initial_state_constraints = {x: 0, y: 0, v: 0}
    phase.bounds.final_state_constraints = {x: 2, y: 2}

    phase.guess.time = np.array([0, 10])
    phase.guess.state_variables = np.array([[0, 2], [0, 2], [0, 0]])
    phase.guess.control_variables = np.array([[0, np.pi / 2]])
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    problem.initialise()
    solution = problem.solve(device=args.device)
    print(f"Objective (tF): {solution.objective:.6f}  (expected 0.82434)")
