"""Trajectory tracking (path following) problems.

A point mass in the plane is steered to follow a periodic sinusoidal path.
Three control parameterizations, mirroring the reference's
``examples/path_follow/`` family:

* ``directional``: a single point force with directly-controlled direction
  (``path_follow_point_mass_directional_point_force.py``);
* ``orthogonal``: two orthogonal point forces
  (``path_follow_point_mass_orthogonal_point_forces.py``);
* ``rate``: force direction controlled through its rate
  (``path_follow_point_mass_rate_directional_point_force.py``).

As the reference notes, pure tracking is ill-posed (controls can match the
path arbitrarily well), so the objective mixes the tracking error with a
small control-effort penalty.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402

TRACKING_WEIGHTING = 0.99999
CONTROL_WEIGHTING = 0.00001


def build_problem(variant: str = "directional"):
    x, y, dx, dy = sym.symbols("x y dx dy")
    m = sym.Symbol("m")
    ddx, ddy = sym.symbols("ddx ddy")

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name=f"Path follow point mass ({variant})")
    phase = problem.new_phase(name="A")

    if variant == "directional":
        F, theta = sym.symbols("F theta")
        phase.state_variables = [x, y, dx, dy]
        phase.control_variables = [F, theta]
        control_bounds = {F: [0, 100], theta: [-sym.pi, sym.pi]}
        control_guess = [[0, 0], [0, 0]]
        aux = {ddx: (F * sym.cos(theta)) / m,
               ddy: (F * sym.sin(theta)) / m}
        effort = F ** 2
        state_eqns = {x: dx, y: dy, dx: ddx, dy: ddy}
    elif variant == "orthogonal":
        Fx, Fy = sym.symbols("Fx Fy")
        phase.state_variables = [x, y, dx, dy]
        phase.control_variables = [Fx, Fy]
        control_bounds = {Fx: [-100, 100], Fy: [-100, 100]}
        control_guess = [[0, 0], [0, 0]]
        aux = {ddx: Fx / m, ddy: Fy / m}
        effort = Fx ** 2 + Fy ** 2
        state_eqns = {x: dx, y: dy, dx: ddx, dy: ddy}
    elif variant == "rate":
        F, theta, dtheta = sym.symbols("F theta dtheta")
        phase.state_variables = [x, y, dx, dy, theta]
        phase.control_variables = [F, dtheta]
        control_bounds = {F: [0, 100], dtheta: [-50, 50]}
        control_guess = [[0, 0], [0, 0]]
        aux = {ddx: (F * sym.cos(theta)) / m,
               ddy: (F * sym.sin(theta)) / m}
        effort = F ** 2 + dtheta ** 2
        state_eqns = {x: dx, y: dy, dx: ddx, dy: ddy, theta: dtheta}
    else:
        raise ValueError(variant)

    phase.state_equations = state_eqns
    phase.integrand_functions = [(sym.sin(x) - y) ** 2, effort]

    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = 1.0
    state_bounds = {x: [0, 2 * sym.pi], y: [-1, 1],
                    dx: [-50, 50], dy: [-50, 50]}
    if variant == "rate":
        state_bounds[sym.Symbol("theta")] = [-2 * np.pi, 2 * np.pi]
    phase.bounds.state_variables = state_bounds
    phase.bounds.control_variables = control_bounds
    phase.bounds.integral_variables = [[0, 0.01], [0, 1_000_000]]
    phase.bounds.initial_state_constraints = {x: 0.0}
    phase.bounds.final_state_constraints = {x: 2 * sym.pi}

    nt = phase.number_state_variables
    phase.guess.time = np.array([0, 1])
    state_guess = [[0, 2 * np.pi], [0, 0], [0, 0], [0, 0]]
    if variant == "rate":
        state_guess.append([0, 0])
    phase.guess.state_variables = np.array(state_guess)
    phase.guess.control_variables = np.array(control_guess)
    phase.guess.integral_variables = np.array([0, 0])

    problem.objective_function = (
        TRACKING_WEIGHTING * phase.integral_variables[0]
        + CONTROL_WEIGHTING * phase.integral_variables[1])
    aux[m] = 1.0
    problem.auxiliary_data = aux
    problem.endpoint_constraints = [
        phase.final_state_variables.y - phase.initial_state_variables.y,
        phase.final_state_variables.dx - phase.initial_state_variables.dx,
        phase.final_state_variables.dy - phase.initial_state_variables.dy,
    ]
    problem.bounds.endpoint_constraints = [0, 0, 0]
    problem.settings.mesh_tolerance = 1e-5
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem("directional")
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.6g}")
