"""Plain reference of tumour anti-angiogenesis (Ledzewicz & Schaettler).

The problem written out in plain PyTorch from the published equations, for
the benchmark's judge (``harness/judge.py``).  It imports nothing of the
program and takes its numbers from the configuration's ``constants``.

Tumour volume p and carrying capacity q under an anti-angiogenic dose u:

    p' = -xi p ln(p / q),   q' = q (b - mu - d p^(2/3) - G u),

0 <= u <= a, with the total dose (the integral of u) at most A and a free
final time in [tF_min, tF_max]; minimise p(tF).  The bounds are
p, q in [p_min, p_max] with p_max = ((b - mu) / d)^(3/2), and the nominal
initial state is p(0) = p_max / 2, q(0) = p_max / 4 (the traffic scales
both).
"""

import numpy as np
import torch

from harness.judge import OCP


def problem(c):
    xi, b, d, G, mu = c["xi"], c["b"], c["d"], c["G"], c["mu"]
    p_max = ((b - mu) / d) ** 1.5
    p_min = c["p_min"]

    def dynamics(y, u):
        p, q = y[..., 0, :], y[..., 1, :]
        dp = -xi * p * torch.log(p / q)
        dq = q * (b - (mu + d * p ** (2.0 / 3.0) + G * u[..., 0, :]))
        return torch.stack([dp, dq], dim=-2)

    def integrand(y, u):
        return u[..., 0:1, :]

    def objective(y, u, q, t0, tF):
        return y[..., 0, -1]

    return OCP(
        states=("p", "q"), controls=("u",),
        state_bounds=np.array([[p_min, p_max], [p_min, p_max]]),
        control_bounds=np.array([[0.0, c["a"]]]),
        integral_bounds=np.array([[0.0, c["A"]]]),
        t0_bounds=(0.0, 0.0), tF_bounds=(c["tF_min"], c["tF_max"]),
        initial={"p": p_max / 2, "q": p_max / 4},
        final={"p": None, "q": None},
        dynamics=dynamics, integrand=integrand, objective=objective)
