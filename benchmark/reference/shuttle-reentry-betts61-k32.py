"""Plain reference of the Space Shuttle reentry, maximum crossrange
(Betts 2010, Example 6.1, pp. 247-251).

The problem written out in plain PyTorch from the published equations, for
the benchmark's judge (``harness/judge.py``).  It imports nothing of the
program and takes its numbers from the configuration's ``constants``.

States altitude h, longitude phi, latitude theta, speed nu, flight-path
angle gamma and azimuth psi; controls angle of attack alpha and bank angle
beta.  With r = Re + h, g = mu_g / r^2, rho = rho_0 exp(-h / h_r),
c_L = c_lift_0 + c_lift_1 alpha, c_D = c_drag_0 + c_drag_1 alpha +
c_drag_2 alpha^2, L = rho nu^2 S c_L / 2 and D = rho nu^2 S c_D / 2:

    h'     = nu sin(gamma)
    phi'   = nu cos(gamma) sin(psi) / (r cos(theta))
    theta' = nu cos(gamma) cos(psi) / r
    nu'    = -D / m - g sin(gamma)
    gamma' = L cos(beta) / (m nu) + cos(gamma) (nu / r - g / nu)
    psi'   = L sin(beta) / (m nu cos(gamma))
             + nu cos(gamma) sin(psi) sin(theta) / (r cos(theta))

from the pinned entry state to the pinned terminal h, nu and gamma, with a
free final time in [0, tF_max]; maximise the final latitude, posed as
minimise -theta(tF).  Departures from the book, all as the port's example
poses it: alpha and beta are in radians, so the aerodynamic coefficients
are the book's per-degree ones converted (c_lift_1 = 0.029244 * 180 / pi,
c_drag_1 and c_drag_2 likewise) and rounded as the example has them
(c_lift_0 -0.2070 for the book's -0.20704); the book's heating-rate path
constraint is left out (its first solution, without it); no integral
(nq = 0).
"""

import math

import numpy as np
import torch

from harness.judge import OCP

STATES = ("h", "phi", "theta", "nu", "gamma", "psi")


def problem(c):
    rho_0, h_r, Re, S, m = c["rho_0"], c["h_r"], c["Re"], c["S"], c["m"]
    mu_g = c["mu_g"]
    cl0, cl1 = c["c_lift_0"], c["c_lift_1"]
    cd0, cd1, cd2 = c["c_drag_0"], c["c_drag_1"], c["c_drag_2"]
    deg = math.pi / 180.0

    def dynamics(y, u):
        h, theta, nu = y[..., 0, :], y[..., 2, :], y[..., 3, :]
        gamma, psi = y[..., 4, :], y[..., 5, :]
        alpha, beta = u[..., 0, :], u[..., 1, :]
        r = Re + h
        g = mu_g / r ** 2
        rho = rho_0 * torch.exp(-h / h_r)
        q_S = 0.5 * rho * nu ** 2 * S
        lift = q_S * (cl0 + cl1 * alpha)
        drag = q_S * (cd0 + cd1 * alpha + cd2 * alpha ** 2)
        cg, sg = torch.cos(gamma), torch.sin(gamma)
        ct, st = torch.cos(theta), torch.sin(theta)
        cp, sp = torch.cos(psi), torch.sin(psi)
        dh = nu * sg
        dphi = nu * cg * sp / (r * ct)
        dtheta = nu * cg * cp / r
        dnu = -drag / m - g * sg
        dgamma = lift * torch.cos(beta) / (m * nu) + cg * (nu / r - g / nu)
        dpsi = lift * torch.sin(beta) / (m * nu * cg) \
            + nu * cg * sp * st / (r * ct)
        return torch.stack([dh, dphi, dtheta, dnu, dgamma, dpsi], dim=-2)

    def integrand(y, u):
        return y[..., :0, :]

    def objective(y, u, q, t0, tF):
        return -y[..., 2, -1]

    tm, gm = c["theta_max_deg"] * deg, c["gamma_max_deg"] * deg
    return OCP(
        states=STATES, controls=("alpha", "beta"),
        state_bounds=np.array([[0.0, c["h_max"]], [-math.pi, math.pi],
                               [-tm, tm], [c["nu_min"], c["nu_max"]],
                               [-gm, gm], [-math.pi, math.pi]]),
        control_bounds=np.array([[-math.pi / 2, math.pi / 2],
                                 [-math.pi / 2, c["beta_max_deg"] * deg]]),
        integral_bounds=np.zeros((0, 2)),
        t0_bounds=(0.0, 0.0), tF_bounds=(0.0, c["tF_max"]),
        initial={"h": c["h_0"], "phi": 0.0, "theta": 0.0, "nu": c["nu_0"],
                 "gamma": c["gamma_0_deg"] * deg,
                 "psi": c["psi_0_deg"] * deg},
        final={"h": c["h_f"], "phi": None, "theta": None, "nu": c["nu_f"],
               "gamma": c["gamma_f_deg"] * deg, "psi": None},
        dynamics=dynamics, integrand=integrand, objective=objective)
