"""Kinetic Batch Reactor problem (incomplete).

Example 6.15 from Betts, J. T. (2010), p331-336.  NOTE: like the
reference's version (``examples/kinetic_batch_reactor/
kinetic_batch_reactor.py``, which is explicitly marked "INCOMPLETE AND NOT
CURRENTLY SOLVABLE"), this is a partial problem definition kept for
capability parity: it demonstrates static parameter variables combined
with path constraints and temperature-dependent Arrhenius rate laws, but
the multiphase structure and bounds needed to actually solve it are not
fully specified by the reference.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402


def build_problem():
    y0, y1, y2, y3, y4, y5 = sym.symbols("y0 y1 y2 y3 y4 y5")
    u0, u1, u2, u3, u4 = sym.symbols("u0 u1 u2 u3 u4")
    p = sym.Symbol("p")
    k0, k1, k2 = sym.symbols("k0 k1 k2")
    km1, km3 = sym.symbols("km1 km3")
    k0hat, k1hat, km1hat = sym.symbols("k0hat k1hat km1hat")
    beta0, beta1, betam1 = sym.symbols("beta0 beta1 betam1")
    K0, K1, K2 = sym.symbols("K0 K1 K2")

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Kinetic Batch Reactor Problem")
    problem.parameter_variables = [p]

    phase_A = problem.new_phase("A")
    phase_A.state_variables = [y0, y1, y2, y3, y4, y5]
    phase_A.control_variables = [u0, u1, u2, u3, u4]

    k0y1y5 = k0 * y1 * y5
    k1y1u1 = k1 * y1 * u1
    k2y3y5 = k2 * y3 * y5
    phase_A.state_equations = {
        y0: -k1y1u1,
        y1: -(k0 * y1 * y5) + (km1 * u3) - k1y1u1,
        y2: k1y1u1 + k2y3y5 - (km3 * u2),
        y3: -k2y3y5 + (km3 * u2),
        y4: k0y1y5 - (km1 * u3),
        y5: -k0y1y5 + (km1 * u3) - k2y3y5 - (km3 * u2)}
    phase_A.path_constraints = [p - y5 + (10 ** (-u0)) - u1 - u2 - u3]

    # Arrhenius rate laws (temperature control u4).
    problem.auxiliary_data = {
        k0hat: 1.3708e+12, k1hat: 5.2282e+12, km1hat: 1.6215e+20,
        beta0: 9.2984e+3, beta1: 9.5999e+3, betam1: 1.3108e+4,
        K0: 2.575e-16, K1: 4.876e-14, K2: 1.7884e-16,
        k0: k0hat * sym.exp(-beta0 / u4),
        k1: k1hat * sym.exp(-beta1 / u4),
        km1: km1hat * sym.exp(-betam1 / u4),
        k2: k1 / 2,
        km3: km1 / 2,
    }
    return problem


if __name__ == "__main__":
    problem = build_problem()
    print(f"Built (incomplete, parity with the reference): {problem}")
