"""Space Shuttle reentry, maximum crossrange, as the benchmark runs it
through pycollo_tpu_torch.

Frozen copy of
``examples/space_shuttle_reentry_trajectory_torch.py:build_problem``
(Betts, J. T. (2010). Practical Methods for Optimal Control and Estimation
Using Nonlinear Programming, 2nd ed., SIAM, Example 6.1, pp. 247-251),
taken so that a later change to the example cannot change the benchmark.
Two changes:

- the published constants, bounds and pins come from the configuration
  file (``configs/shuttle-reentry-betts61-k32.json``, ``constants``)
  instead of literals, so the program and the plain reference read one set
  of numbers;
- the guess is the nominal optimum on the configuration's mesh, read from
  :data:`NOMINAL` beside this file (time, states and controls at the
  mesh's 97 nodes), in place of the example's straight lines: each call of
  an entry-dispersion study starts from the nominal answer.  The file is
  the port's own answer, written by ``scripts/shuttle_nominal_torch.py``;
  ``build_problem(c, nominal=None)`` keeps the example's straight lines.
"""

import json
from pathlib import Path

#: the nominal optimum on the configuration's mesh
NOMINAL = Path(__file__).with_name("shuttle-reentry-betts61-k32.nominal.json")


def read_nominal(path=NOMINAL):
    """The nominal file: ``time`` (N,), ``states`` (6, N), ``controls``
    (2, N), ``objective`` and the mesh it was solved on."""
    with open(path) as fh:
        return json.load(fh)


def build_problem(c, nominal=NOMINAL):
    """The problem for the configuration's constants ``c``, its guess the
    nominal file ``nominal`` (None: the example's straight lines)."""
    import numpy as np
    import sympy as sym

    import pycollo_tpu_torch

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
        rho_0: c["rho_0"],
        h_r: c["h_r"],
        Re: c["Re"],
        S: c["S"],
        c_lift_0: c["c_lift_0"],
        c_lift_1: c["c_lift_1"],
        mu_g: c["mu_g"],
        c_drag_0: c["c_drag_0"],
        c_drag_1: c["c_drag_1"],
        c_drag_2: c["c_drag_2"],
        D: 0.5 * c_D * S * rho * nu ** 2,
        L: 0.5 * c_L * S * rho * nu ** 2,
        g: mu_g / (r ** 2),
        r: Re + h,
        rho: rho_0 * sym.exp(-h / h_r),
        c_L: c_lift_0 + (c_lift_1 * alpha),
        c_D: c_drag_0 + (c_drag_1 * alpha) + (c_drag_2 * alpha ** 2),
        m: c["m"],
    }

    deg = np.pi / 180
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0.0, c["tF_max"]]
    phase.bounds.state_variables = {
        h: [0, c["h_max"]],
        phi: [-np.pi, np.pi],
        theta: [-c["theta_max_deg"] * deg, c["theta_max_deg"] * deg],
        nu: [c["nu_min"], c["nu_max"]],
        gamma: [-c["gamma_max_deg"] * deg, c["gamma_max_deg"] * deg],
        psi: [-np.pi, np.pi]}
    phase.bounds.control_variables = {
        alpha: [-np.pi / 2, np.pi / 2],
        beta: [-np.pi / 2, c["beta_max_deg"] * deg]}
    phase.bounds.initial_state_constraints = {
        h: c["h_0"], phi: 0, theta: 0, nu: c["nu_0"],
        gamma: c["gamma_0_deg"] * deg, psi: c["psi_0_deg"] * deg}
    phase.bounds.final_state_constraints = {
        h: [c["h_f"], c["h_f"]],
        nu: [c["nu_f"], c["nu_f"]],
        gamma: [c["gamma_f_deg"] * deg, c["gamma_f_deg"] * deg]}

    if nominal is None:
        return linear_guess(problem, c)
    guess = read_nominal(nominal)
    phase.guess.time = np.array(guess["time"])
    phase.guess.state_variables = np.array(guess["states"])
    phase.guess.control_variables = np.array(guess["controls"])
    return problem


def linear_guess(problem, c):
    """Put the example's guess back: straight lines from the entry state
    to the terminal one over 1000 s, the controls at zero."""
    import numpy as np

    deg = np.pi / 180
    phase = problem.phases[0]
    phase.guess.time = np.array([0.0, 1000.0])
    phase.guess.state_variables = np.array(
        [[c["h_0"], c["h_f"]],
         [0, 10 * deg],
         [0, 10 * deg],
         [c["nu_0"], c["nu_f"]],
         [c["gamma_0_deg"] * deg, c["gamma_f_deg"] * deg],
         [c["psi_0_deg"] * deg, -90 * deg]])
    phase.guess.control_variables = np.array([[0, 0], [0, 0]])
    return problem
