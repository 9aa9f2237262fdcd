"""Hypersensitive problem.

A classic stiff optimal control problem (Rao & Mease) with boundary layers
at both ends of a very long horizon (tF = 10000); stresses ph-adaptive
mesh refinement.  Capability parity with the reference example
(``examples/hypersensitive_problem/hypersensitive_problem.py``); expected
objective 3.36206 (GPOPS-II).
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402


def build_problem():
    y, u = sym.symbols("y u")
    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Hypersensitive problem")
    phase = problem.new_phase(name="A")
    phase.state_variables = y
    phase.control_variables = u
    phase.state_equations = [-y ** 3 + u]
    phase.integrand_functions = [0.5 * (y ** 2 + u ** 2)]
    problem.objective_function = phase.integral_variables[0]

    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = 10000.0
    phase.bounds.state_variables = [[0, 2]]
    phase.bounds.control_variables = [[-1, 8]]
    phase.bounds.integral_variables = [[0, 2000]]
    phase.bounds.initial_state_constraints = [[1.0, 1.0]]
    phase.bounds.final_state_constraints = [[1.5, 1.5]]

    phase.guess.time = [0.0, 10000.0]
    phase.guess.state_variables = [[1.0, 1.5]]
    phase.guess.control_variables = [[0.0, 0.0]]
    phase.guess.integral_variables = 4
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.6f}  (expected 3.36206)")
