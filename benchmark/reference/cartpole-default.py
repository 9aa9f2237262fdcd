"""Plain reference of the cart-pole swing-up (Kelly 2017, section 6).

The problem written out in plain PyTorch from the published equations, for
the benchmark's judge (``harness/judge.py``).  It imports nothing of the
program and takes its numbers from the configuration's ``constants``.

Cart of mass m1 on a track, pendulum of mass m2 and length l; states cart
position q1, pole angle q2 and their rates; control the force F.  The
swing-up moves the cart from rest at q1(0) with the pole at q2(0) (the
nominal 0, 0; the traffic perturbs both) to rest at q1 = d with the pole
upright (q2 = pi) at the fixed time T, minimising the integral of F^2.
"""

import math

import numpy as np
import torch

from harness.judge import OCP


def problem(c):
    m1, m2, l, g = c["m1"], c["m2"], c["l"], c["g"]

    def dynamics(y, u):
        q2, q1d, q2d = y[..., 1, :], y[..., 2, :], y[..., 3, :]
        F = u[..., 0, :]
        s, co = torch.sin(q2), torch.cos(q2)
        q1dd = (l * m2 * s * q2d ** 2 + F + m2 * g * co * s) \
            / (m1 + m2 * (1 - co ** 2))
        q2dd = -(l * m2 * co * s * q2d ** 2 + F * co + (m1 + m2) * g * s) \
            / (l * m1 + l * m2 * (1 - co ** 2))
        return torch.stack([q1d, q2d, q1dd, q2dd], dim=-2)

    def integrand(y, u):
        return u[..., 0:1, :] ** 2

    def objective(y, u, q, t0, tF):
        return q[..., 0]

    return OCP(
        states=("q1", "q2", "q1d", "q2d"), controls=("F",),
        state_bounds=np.array([[-c["d_max"], c["d_max"]], [-10.0, 10.0],
                               [-10.0, 10.0], [-10.0, 10.0]]),
        control_bounds=np.array([[-c["F_max"], c["F_max"]]]),
        integral_bounds=np.array([[0.0, 100.0]]),
        t0_bounds=(0.0, 0.0), tF_bounds=(c["T"], c["T"]),
        initial={"q1": 0.0, "q2": 0.0, "q1d": 0.0, "q2d": 0.0},
        final={"q1": c["d"], "q2": math.pi, "q1d": 0.0, "q2d": 0.0},
        dynamics=dynamics, integrand=integrand, objective=objective)
