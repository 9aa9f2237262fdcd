"""Space Station Attitude Control problem.

Example from Betts (2010) / Pietz: find the control moment gyroscope
momentum-dumping maneuver minimizing control effort subject to a momentum
path constraint and torque-equilibrium endpoint conditions.  Capability
parity with the reference example
(``examples/space_station_attitude_control/space_station_attitude_control.py``);
expected objective 3.58675 (GPOPS-II).
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402


def _skew(vec):
    return sym.Matrix([[0, -vec[2], vec[1]],
                       [vec[2], 0, -vec[0]],
                       [-vec[1], vec[0], 0]])


def build_problem():
    omega_x, omega_y, omega_z = sym.symbols("omega_x omega_y omega_z")
    r_x, r_y, r_z = sym.symbols("r_x r_y r_z")
    h_x, h_y, h_z = sym.symbols("h_x h_y h_z")
    u_x, u_y, u_z = sym.symbols("u_x u_y u_z")
    omega_orb, h_max = sym.symbols("omega_orb h_max")

    J_num = sym.Matrix([
        [2.80701911616e7, 4.822509936e5, -1.71675094448e7],
        [4.822509936e5, 9.5144639344e7, 6.02604448e4],
        [-1.71675094448e7, 6.02604448e4, 7.6594401336e7]])
    J_inv_num = J_num.inv()

    omega = sym.Matrix([omega_x, omega_y, omega_z])
    r = sym.Matrix([r_x, r_y, r_z])
    h = sym.Matrix([h_x, h_y, h_z])
    u = sym.Matrix([u_x, u_y, u_z])

    def attitude_rates(omega, r, h, include_u):
        """domega/dt and dr/dt for the given (symbolic) state vectors."""
        r_skew = _skew(r)
        eye = sym.eye(3)
        D = 2 / (1 + (r.T * r)[0, 0])
        C = eye + D * ((r_skew * r_skew) - r_skew)
        C2_skew = _skew(C[:, 2])
        tau_gg = 3 * omega_orb ** 2 * C2_skew * (J_num * C[:, 2])
        A = J_num * omega + h
        K = tau_gg - _skew(omega) * A
        if include_u:
            K = K - u
        domega = J_inv_num * K
        omega_0 = -omega_orb * C[:, 1]
        r_sqrd = r * r.T
        dr = sym.Rational(1, 2) * (r_sqrd + eye + r_skew) * (omega - omega_0)
        return domega, dr

    domega_dt, dr_dt = attitude_rates(omega, r, h, include_u=True)

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Space Station Attitude Control")
    phase = problem.new_phase(
        name="A",
        state_variables=[omega_x, omega_y, omega_z, r_x, r_y, r_z,
                         h_x, h_y, h_z],
        control_variables=[u_x, u_y, u_z])

    phase.state_equations = {
        omega_x: domega_dt[0, 0], omega_y: domega_dt[1, 0],
        omega_z: domega_dt[2, 0],
        r_x: dr_dt[0, 0], r_y: dr_dt[1, 0], r_z: dr_dt[2, 0],
        h_x: u_x, h_y: u_y, h_z: u_z}
    phase.path_constraints = [h_x ** 2 + h_y ** 2 + h_z ** 2]
    phase.integrand_functions = [1e-6 * (u_x ** 2 + u_y ** 2 + u_z ** 2)]
    problem.objective_function = phase.integral_variables[0]

    # Endpoint torque-equilibrium constraints: attitude rates vanish at tF.
    omega_tF = sym.Matrix(phase.final_state_variables[:3])
    r_tF = sym.Matrix(phase.final_state_variables[3:6])
    h_tF = sym.Matrix(phase.final_state_variables[6:])
    domega_tF, dr_tF = attitude_rates(omega_tF, r_tF, h_tF,
                                      include_u=False)
    problem.endpoint_constraints = [domega_tF[0, 0], domega_tF[1, 0],
                                    domega_tF[2, 0], dr_tF[0, 0],
                                    dr_tF[1, 0], dr_tF[2, 0]]

    y_t0 = {omega_x: -9.5380685844896e-6,
            omega_y: -1.1363312657036e-3,
            omega_z: 5.3472801108427e-6,
            r_x: 2.9963689649816e-3,
            r_y: 1.5334477761054e-1,
            r_z: 3.8359805613992e-3,
            h_x: 5000, h_y: 5000, h_z: 5000}

    phase.bounds.initial_time = 0
    phase.bounds.final_time = 1800
    phase.bounds.state_variables = {
        omega_x: [-2e-3, 2e-3], omega_y: [-2e-3, 2e-3],
        omega_z: [-2e-3, 2e-3],
        r_x: [-1, 1], r_y: [-1, 1], r_z: [-1, 1],
        h_x: [-15000, 15000], h_y: [-15000, 15000],
        h_z: [-15000, 15000]}
    phase.bounds.initial_state_constraints = dict(y_t0)
    phase.bounds.final_state_constraints = {h_x: 0, h_y: 0, h_z: 0}
    phase.bounds.control_variables = {u_x: [-150, 150], u_y: [-150, 150],
                                      u_z: [-150, 150]}
    phase.bounds.integral_variables = [[0, 10]]
    phase.bounds.path_constraints = [[0, h_max ** 2]]
    problem.bounds.endpoint_constraints = [[0, 0]] * 6

    phase.guess.time = np.array([0, 1800])
    phase.guess.state_variables = np.array(
        [[float(y_t0[k])] * 2 for k in (omega_x, omega_y, omega_z,
                                        r_x, r_y, r_z, h_x, h_y, h_z)])
    phase.guess.control_variables = np.array([[0, 0]] * 3)
    phase.guess.integral_variables = np.array([10])

    problem.auxiliary_data = {omega_orb: 0.06511 * np.pi / 180,
                              h_max: 10000}
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.5f}  (expected 3.58675)")
