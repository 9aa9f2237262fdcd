"""Cart-pole swing-up optimal control problem.

From Kelly, M. (2017). "An Introduction to Trajectory Optimization: How To
Do Your Own Direct Collocation", SIAM Review 59(4), 849-904.  Capability
parity with the reference example
(``examples/cart_pole_swing_up/cart_pole_swing_up_explicit.py``).
This is also the batched-MPC benchmark workload (see ``bench.py``).
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402


def build_problem(T: float = 2.0, d: float = 1.0):
    q1, q2, q1d, q2d = sym.symbols("q1 q2 q1d q2d")
    q1dd, q2dd = sym.symbols("q1dd q2dd")
    F = sym.Symbol("F")
    m1, m2, l, g = sym.symbols("m1 m2 l g")

    F_max = 20.0
    d_max = 2.0

    problem = pycollo_tpu_torch.OptimalControlProblem(name="Cart-Pole Swing-Up")
    phase = problem.new_phase(name="A")
    phase.state_variables = [q1, q2, q1d, q2d]
    phase.control_variables = F
    phase.state_equations = [q1d, q2d, q1dd, q2dd]
    phase.integrand_functions = [F ** 2]

    phase.bounds.initial_time = 0
    phase.bounds.final_time = T
    phase.bounds.state_variables = {q1: [-d_max, d_max], q2: [-10, 10],
                                    q1d: [-10, 10], q2d: [-10, 10]}
    phase.bounds.control_variables = {F: [-F_max, F_max]}
    phase.bounds.integral_variables = [[0, 100]]
    phase.bounds.initial_state_constraints = {q1: 0, q2: 0, q1d: 0, q2d: 0}
    phase.bounds.final_state_constraints = {q1: d, q2: np.pi,
                                            q1d: 0, q2d: 0}

    phase.guess.time = [0, T]
    phase.guess.state_variables = [[0, d], [0, np.pi], [0, 0], [0, 0]]
    phase.guess.control_variables = [[0, 0]]
    phase.guess.integral_variables = [0]

    q1dd_eqn = (l * m2 * sym.sin(q2) * q2d ** 2 + F
                + m2 * g * sym.cos(q2) * sym.sin(q2)) \
        / (m1 + m2 * (1 - sym.cos(q2) ** 2))
    q2dd_eqn = -(l * m2 * sym.cos(q2) * sym.sin(q2) * q2d ** 2
                 + F * sym.cos(q2) + (m1 + m2) * g * sym.sin(q2)) \
        / (l * m1 + l * m2 * (1 - sym.cos(q2) ** 2))

    problem.objective_function = phase.integral_variables[0]
    problem.auxiliary_data = {g: 9.81, l: 0.5, m1: 1.0, m2: 0.3,
                              q1dd: q1dd_eqn, q2dd: q2dd_eqn}
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
    print(f"Objective (integral of F^2): {solution.objective:.6f}")
