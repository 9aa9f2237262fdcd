"""Space Shuttle Reentry Trajectory — maximum crossrange.

Example 6.1 from Betts, J. T. (2010). Practical Methods for Optimal
Control and Estimation Using Nonlinear Programming (2nd ed.), p247-251.
Capability parity with the reference example
(``examples/space_shuttle_reentry_trajectory/..._maximum_crossrange.py``);
expected objective -0.59628 (GPOPS-II, maximizing crossrange theta =
latitude in rad, posed as minimize -theta(tF)).
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
    h, phi, theta = sym.symbols("h phi theta")
    nu, gamma, psi = sym.symbols("nu gamma psi")
    alpha, beta = sym.symbols("alpha beta")
    D, L, g, r, rho = sym.symbols("D L g r rho")
    rho_0, h_r, c_L, c_D = sym.symbols("rho_0 h_r c_L c_D")
    Re, S = sym.symbols("Re S")
    c_lift_0, c_lift_1 = sym.symbols("c_lift_0 c_lift_1")
    mu_g = sym.Symbol("mu_g")
    c_drag_0, c_drag_1, c_drag_2 = sym.symbols("c_drag_0 c_drag_1 c_drag_2")
    m = sym.Symbol("m")

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Space shuttle reentry trajectory maximum crossrange")
    phase = problem.new_phase(name="A")
    phase.state_variables = [h, phi, theta, nu, gamma, psi]
    phase.control_variables = [alpha, beta]
    dgamma_1 = L * sym.cos(beta) / (m * nu)
    dgamma_2 = sym.cos(gamma) * ((nu / r) - (g / nu))
    dpsi_1 = L * sym.sin(beta) / (m * nu * sym.cos(gamma))
    dpsi_2 = nu * sym.cos(gamma) * sym.sin(psi) * sym.sin(theta)
    dpsi_3 = r * sym.cos(theta)
    phase.state_equations = {
        h: nu * sym.sin(gamma),
        phi: nu * sym.cos(gamma) * sym.sin(psi) / (r * sym.cos(theta)),
        theta: nu * sym.cos(gamma) * sym.cos(psi) / r,
        nu: -(D / m) - g * sym.sin(gamma),
        gamma: dgamma_1 + dgamma_2,
        psi: dpsi_1 + dpsi_2 / dpsi_3,
    }

    problem.objective_function = -phase.final_state_variables[2]
    problem.auxiliary_data = {
        rho_0: 1.225570827014494,
        h_r: 7254.24,
        Re: 6371203.92,
        S: 249.9091776,
        c_lift_0: -0.2070,
        c_lift_1: 1.6756,
        mu_g: 3.986031954093051e14,
        c_drag_0: 0.07854,
        c_drag_1: -0.3529,
        c_drag_2: 2.0400,
        D: 0.5 * c_D * S * rho * nu ** 2,
        L: 0.5 * c_L * S * rho * nu ** 2,
        g: mu_g / (r ** 2),
        r: Re + h,
        rho: rho_0 * sym.exp(-h / h_r),
        c_L: c_lift_0 + (c_lift_1 * alpha),
        c_D: c_drag_0 + (c_drag_1 * alpha) + (c_drag_2 * alpha ** 2),
        m: 92079.2525560557,
    }

    deg = np.pi / 180
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0.0, 3000.0]
    phase.bounds.state_variables = {h: [0, 300000],
                                    phi: [-np.pi, np.pi],
                                    theta: [-70 * deg, 70 * deg],
                                    nu: [10, 45000],
                                    gamma: [-80 * deg, 80 * deg],
                                    psi: [-np.pi, np.pi]}
    phase.bounds.control_variables = {alpha: [-np.pi / 2, np.pi / 2],
                                      beta: [-np.pi / 2, np.pi / 180]}
    phase.bounds.initial_state_constraints = {h: 79248, phi: 0, theta: 0,
                                              nu: 7802.88,
                                              gamma: -1 * deg,
                                              psi: 90 * deg}
    phase.bounds.final_state_constraints = {h: [24384, 24384],
                                            nu: [762, 762],
                                            gamma: [-5 * deg, -5 * deg]}

    phase.guess.time = np.array([0.0, 1000.0])
    phase.guess.state_variables = np.array(
        [[79248, 24384],
         [0, 10 * deg],
         [0, 10 * deg],
         [7802.88, 762],
         [-1 * deg, -5 * deg],
         [90 * deg, -90 * deg]])
    phase.guess.control_variables = np.array([[0, 0], [0, 0]])
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.5f}  (expected -0.59628)")
