"""Free-Flying Robot problem.

Example 6.13 from Betts, J. T. (2010). Practical Methods for Optimal
Control and Estimation Using Nonlinear Programming (2nd ed.), p326-330.
Capability parity with the reference example
(``examples/free_flying_robot/free_flying_robot.py``); expected objective
7.9101902 (GPOPS-II) / 7.910154646 (SOS).
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
    r_x, r_y, theta = sym.symbols("r_x r_y theta")
    v_x, v_y, omega = sym.symbols("v_x v_y omega")
    u_x_pos, u_x_neg = sym.symbols("u_x_pos u_x_neg")
    u_y_pos, u_y_neg = sym.symbols("u_y_pos u_y_neg")
    T_x, T_y = sym.symbols("T_x T_y")
    I_xx, I_yy = sym.symbols("I_xx I_yy")

    problem = pycollo_tpu_torch.OptimalControlProblem(name="Free-Flying Robot")
    phase = problem.new_phase(
        name="A",
        state_variables=[r_x, r_y, theta, v_x, v_y, omega],
        control_variables=[u_x_pos, u_x_neg, u_y_pos, u_y_neg])

    phase.state_equations = {r_x: v_x,
                             r_y: v_y,
                             theta: omega,
                             v_x: (T_x + T_y) * sym.cos(theta),
                             v_y: (T_x + T_y) * sym.sin(theta),
                             omega: (I_xx * T_x) - (I_yy * T_y)}
    phase.integrand_functions = [u_x_pos + u_x_neg + u_y_pos + u_y_neg]
    phase.path_constraints = [(u_x_pos + u_x_neg), (u_y_pos + u_y_neg)]

    problem.objective_function = phase.integral_variables[0]
    problem.auxiliary_data = {I_xx: 0.2, I_yy: 0.2,
                              T_x: u_x_pos - u_x_neg,
                              T_y: u_y_pos - u_y_neg}

    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = 12.0
    phase.bounds.state_variables = {r_x: [-10, 10], r_y: [-10, 10],
                                    theta: [-np.pi, np.pi],
                                    v_x: [-2, 2], v_y: [-2, 2],
                                    omega: [-1, 1]}
    start = {r_x: -10, r_y: -10, theta: np.pi / 2, v_x: 0, v_y: 0,
             omega: 0}
    end = {r_x: 0, r_y: 0, theta: 0, v_x: 0, v_y: 0, omega: 0}
    phase.bounds.initial_state_constraints = start
    phase.bounds.final_state_constraints = end
    phase.bounds.control_variables = {u: [0, 1000] for u in
                                      (u_x_pos, u_x_neg, u_y_pos, u_y_neg)}
    phase.bounds.integral_variables = [[0, 100]]
    phase.bounds.path_constraints = [[-1000, 1], [-1000, 1]]

    phase.guess.time = [0.0, 12.0]
    phase.guess.state_variables = [[start[k], end[k]] for k in
                                   (r_x, r_y, theta, v_x, v_y, omega)]
    phase.guess.control_variables = [[0, 0]] * 4
    phase.guess.integral_variables = [0]

    problem.settings.mesh_tolerance = 1e-7
    problem.settings.max_mesh_iterations = 25
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.7f}  (expected 7.9101902)")
