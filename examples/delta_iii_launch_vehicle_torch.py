"""Delta III Launch Vehicle Ascent problem (4 phases).

Multistage launch-vehicle ascent (Benson 2004 / Betts): four phases with
different thrust/mass-flow configurations, stage-separation mass jumps
expressed through per-phase mass bounds, inter-phase position/velocity
continuity via endpoint constraints, a unit-thrust-direction path
constraint, and an above-Earth-radius path constraint.  Capability parity
with ``examples/delta_iii_launch_vehicle/delta_iii_launch_vehicle.py``
(including the "inf" string bound form and symbolic guesses).
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402

# Vehicle data (Benson 2004).
m_tot_S, m_prop_S, m_struct_S = 19290, 17010, 2280
m_tot_1, m_prop_1, m_struct_1 = 104380, 95550, 8830
m_tot_2, m_prop_2, m_struct_2 = 19300, 16820, 2480
T_eng_S, T_eng_1, T_eng_2 = 628500, 1083100, 110094
I_S, I_1, I_2 = 283.33364, 301.68776, 467.21311
tau_burn_S, tau_burn_1, tau_burn_2 = 75.2, 261, 700
m_payload = 4164

t_launch, t_sep_S, t_sep_1, t_sep_2, t_orbit = 0.0, 75.2, 150.4, 261, 961

m_t0_A = (9 * m_tot_S) + m_tot_1 + m_tot_2 + m_payload
m_tF_A = m_t0_A - (6 * m_prop_S) - ((tau_burn_S / tau_burn_1) * m_prop_1)
m_t0_B = m_tF_A - (6 * m_struct_S)
m_tF_B = m_t0_B - (3 * m_prop_S) - ((tau_burn_S / tau_burn_1) * m_prop_1)
m_t0_C = m_tF_B - (3 * m_struct_S)
m_tF_C = m_t0_C - ((1 - (2 * (tau_burn_S / tau_burn_1))) * m_prop_1)
m_t0_D = m_tF_C - m_struct_1
m_tF_D = m_payload


def build_problem():
    r_x, r_y, r_z = sym.symbols("r_x r_y r_z")
    v_x, v_y, v_z = sym.symbols("v_x v_y v_z")
    m = sym.Symbol("m")
    u_x, u_y, u_z = sym.symbols("u_x u_y u_z")
    D_x, D_y, D_z = sym.symbols("D_x D_y D_z")
    T, xi, C_D, S = sym.symbols("T xi C_D S")
    omega_E = sym.Symbol("omega_E")
    v_r_x, v_r_y, v_r_z = sym.symbols("v_r_x v_r_y v_r_z")
    oxr_x, oxr_y, oxr_z = sym.symbols("oxr_x oxr_y oxr_z")
    mu, R_E, psi_L, g_0, h_0 = sym.symbols("mu R_E psi_L g_0 h_0")
    h, rho, rho_0 = sym.symbols("h rho rho_0")
    r_vec_norm, u_vec_norm = sym.symbols("r_vec_norm u_vec_norm")
    v_r_vec_norm = sym.Symbol("v_r_vec_norm")
    T_over_m = sym.Symbol("T_over_m")

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Delta III Launch Vehicle Ascent Problem")

    phase_A = problem.new_phase("A")
    phase_A.state_variables = [r_x, r_y, r_z, v_x, v_y, v_z, m]
    phase_A.control_variables = [u_x, u_y, u_z]
    A = -mu / (r_vec_norm ** 3)
    phase_A.state_equations = {
        r_x: v_x, r_y: v_y, r_z: v_z,
        v_x: (A * r_x) + (T_over_m * u_x) + (D_x / m),
        v_y: (A * r_y) + (T_over_m * u_y) + (D_y / m),
        v_z: (A * r_z) + (T_over_m * u_z) + (D_z / m),
        m: -xi}
    phase_A.path_constraints = [u_vec_norm - 1, r_vec_norm - R_E]
    phase_A.auxiliary_data = {
        T: (6 * T_eng_S) + T_eng_1,
        xi: (1 / g_0) * (6 * (T_eng_S / I_S) + (T_eng_1 / I_1))}

    v_y_t0 = omega_E * R_E * sym.cos(psi_L)
    phase_A.bounds.initial_time = t_launch
    phase_A.bounds.final_time = t_sep_S
    phase_A.bounds.state_variables = {r_x: [-2 * R_E, 2 * R_E],
                                      r_y: [-2 * R_E, 2 * R_E],
                                      r_z: [-2 * R_E, 2 * R_E],
                                      v_x: [-10000, 10000],
                                      v_y: [-10000, 10000],
                                      v_z: [-10000, 10000],
                                      m: [m_tF_A, m_t0_A]}
    phase_A.bounds.control_variables = {u_x: [-1.1, 1.1],
                                       u_y: [-1.1, 1.1],
                                       u_z: [-1.1, 1.1]}
    phase_A.bounds.path_constraints = [[0, 0], [0, "inf"]]
    phase_A.bounds.initial_state_constraints = {
        r_x: R_E * sym.cos(psi_L), r_y: 0, r_z: R_E * sym.sin(psi_L),
        v_x: 0, v_y: v_y_t0, v_z: 0, m: m_t0_A}
    phase_A.bounds.final_state_constraints = {m: m_tF_A}

    def set_guess(phase, m_start, m_end, times):
        phase.guess.time = list(times)
        phase.guess.state_variables = [
            [R_E * sym.cos(psi_L), R_E * sym.cos(psi_L)],
            [0, 0],
            [R_E * sym.sin(psi_L), R_E * sym.sin(psi_L)],
            [0, 0],
            [v_y_t0, v_y_t0],
            [0, 0],
            [m_start, m_end]]
        phase.guess.control_variables = [[0.9, 0.9], [0.05, 0.05],
                                         [0.45, 0.45]]

    set_guess(phase_A, m_t0_A, m_tF_A, (t_launch, t_sep_S))

    phase_B, phase_C, phase_D = problem.new_phases_like(
        number=3, phase_for_copying=phase_A, names=["B", "C", "D"],
        copy_state_variables=True, copy_control_variables=True,
        copy_state_equations=True, copy_path_constraints=True,
        copy_integrand_functions=True,
        copy_state_endpoint_constraints=False,
        copy_bounds=True, copy_mesh=True)

    phase_B.auxiliary_data = {
        T: (3 * T_eng_S) + T_eng_1,
        xi: (1 / g_0) * ((3 * (T_eng_S / I_S)) + (T_eng_1 / I_1))}
    phase_B.bounds.initial_time = t_sep_S
    phase_B.bounds.final_time = t_sep_1
    phase_B.bounds.state_variables[m] = [m_tF_B, m_t0_B]
    phase_B.bounds.initial_state_constraints = {m: m_t0_B}
    phase_B.bounds.final_state_constraints = {m: m_tF_B}
    set_guess(phase_B, m_t0_B, m_tF_B, (t_sep_S, t_sep_1))

    phase_C.auxiliary_data = {T: T_eng_1, xi: T_eng_1 / (g_0 * I_1)}
    phase_C.bounds.initial_time = t_sep_1
    phase_C.bounds.final_time = t_sep_2
    phase_C.bounds.state_variables[m] = [m_tF_C, m_t0_C]
    phase_C.bounds.initial_state_constraints = {m: m_t0_C}
    phase_C.bounds.final_state_constraints = {m: m_tF_C}
    set_guess(phase_C, m_t0_C, m_tF_C, (t_sep_1, t_sep_2))

    phase_D.auxiliary_data = {T: T_eng_2, xi: T_eng_2 / (g_0 * I_2)}
    phase_D.bounds.initial_time = t_sep_2
    phase_D.bounds.final_time = t_orbit
    phase_D.bounds.state_variables[m] = [m_tF_D, m_t0_D]
    phase_D.bounds.initial_state_constraints = {m: m_t0_D}
    phase_D.bounds.final_state_constraints = {m: m_tF_D}
    set_guess(phase_D, m_t0_D, m_tF_D, (t_sep_2, t_orbit))

    problem.objective_function = -(sym.sqrt(
        phase_D.final_state_variables.r_x ** 2
        + phase_D.final_state_variables.r_y ** 2
        + phase_D.final_state_variables.r_z ** 2) - R_E)

    linkage = []
    for p1, p2 in ((phase_A, phase_B), (phase_B, phase_C),
                   (phase_C, phase_D)):
        for var in ("r_x", "r_y", "r_z", "v_x", "v_y", "v_z"):
            linkage.append(getattr(p1.final_state_variables, var)
                           - getattr(p2.initial_state_variables, var))
    problem.endpoint_constraints = linkage
    problem.bounds.endpoint_constraints = [0] * len(linkage)

    problem.auxiliary_data = {
        mu: 3.986012e14,
        R_E: 6378145,
        r_vec_norm: sym.sqrt(r_x ** 2 + r_y ** 2 + r_z ** 2),
        u_vec_norm: sym.sqrt(u_x ** 2 + u_y ** 2 + u_z ** 2),
        D_x: -0.5 * C_D * S * rho * v_r_vec_norm * v_r_x,
        D_y: -0.5 * C_D * S * rho * v_r_vec_norm * v_r_y,
        D_z: -0.5 * C_D * S * rho * v_r_vec_norm * v_r_z,
        C_D: 0.5,
        S: 4 * np.pi,
        v_r_vec_norm: sym.sqrt(v_r_x ** 2 + v_r_y ** 2 + v_r_z ** 2),
        v_r_x: v_x - oxr_x, v_r_y: v_y - oxr_y, v_r_z: v_z - oxr_z,
        oxr_x: -omega_E * r_y, oxr_y: omega_E * r_x, oxr_z: 0,
        g_0: 9.80665, h_0: 7200,
        h: r_vec_norm - R_E,
        rho: rho_0 * sym.exp(-h / h_0), rho_0: 1.225,
        omega_E: 7.29211585e-5,
        T_over_m: T / m,
        psi_L: (28.5 / 180) * np.pi,
    }
    problem.settings.quadrature_method = "lobatto"
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.6g}")
