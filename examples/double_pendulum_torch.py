"""Double Pendulum Swing-Up problem.

Torque-driven double pendulum swung between configurations, with the
first link's mass and CoM position as static parameter variables; the
manipulator dynamics are written through layered auxiliary data (mass
matrix entries, trig shorthands).  Capability parity with the reference's
double-pendulum fixture (``tests/unit/conftest.py:79-183``), including
per-phase auxiliary data overriding problem-level entries.
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
    a0, a1, v0, v1, T0, T1 = sym.symbols("a0 a1 v0 v1 T0 T1")
    g = sym.Symbol("g")
    m0, p0, d0, l0, k0, I0 = sym.symbols("m0 p0 d0 l0 k0 I0")
    m1, p1, d1, l1, k1, I1 = sym.symbols("m1 p1 d1 l1 k1 I1")
    c0, s0, c1, s1 = sym.symbols("c0 s0 c1 s1")
    M00, M01, M10, M11, K0, K1 = sym.symbols("M00 M01 M10 M11 K0 K1")
    detM = sym.Symbol("detM")

    K0_eqn = (T0 + g * (m0 * p0 + m1 * l0) * c0
              + m1 * p1 * l0 * (s1 * c0 - s0 * c1) * v1 ** 2)
    K1_eqn = (T1 + g * m1 * p1 * c1
              + m1 * p1 * l0 * (s0 * c1 - s1 * c0) * v0 ** 2)

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Double Pendulum Swing-Up")
    phase = problem.new_phase(name="A")
    phase.state_variables = [a0, a1, v0, v1]
    phase.control_variables = [T0, T1]
    phase.state_equations = [v0,
                             v1,
                             (M11 * K0 - M01 * K1) / detM,
                             (M00 * K1 - M10 * K0) / detM]
    phase.integrand_functions = [T0 ** 2 + T1 ** 2]
    # Phase-level aux data overrides the problem-level entries (parity
    # with the reference fixture's g override).
    phase.auxiliary_data = {g: -9.81}
    problem.parameter_variables = [m0, p0]
    problem.objective_function = phase.integral_variables[0]
    problem.auxiliary_data = {g: 0, d0: 0.5, k0: sym.Rational(1, 12),
                              k1: sym.Rational(1, 12),
                              m1: 1.0, p1: 0.5, d1: 0.5,
                              l0: p0 + d0, l1: p1 + d1,
                              I0: m0 * (k0 ** 2 + p0 ** 2),
                              I1: m1 * (k1 ** 2 + p1 ** 2),
                              c0: sym.cos(a0), s0: sym.sin(a0),
                              c1: sym.cos(a1), s1: sym.sin(a1),
                              M00: I0 + m1 * l0 ** 2,
                              M01: m1 * p1 * l0 * (s0 * s1 + c0 * c1),
                              M10: M01, M11: I1,
                              K0: K0_eqn, K1: K1_eqn,
                              detM: M00 * M11 - M01 * M10}

    phase.bounds.initial_time = 0
    phase.bounds.final_time = [1, 3]
    phase.bounds.state_variables = [[-np.pi, np.pi], [-np.pi, np.pi],
                                    [-10, 10], [-10, 10]]
    phase.bounds.control_variables = [[-15, 15], [-15, 15]]
    phase.bounds.integral_variables = [0, 1000]
    half_pi = 0.5 * np.pi
    phase.bounds.initial_state_constraints = [[-half_pi, -half_pi],
                                              [-half_pi, -half_pi],
                                              [0, 0], [0, 0]]
    phase.bounds.final_state_constraints = [[half_pi, half_pi],
                                            [half_pi, half_pi],
                                            [0, 0], [0, 0]]
    problem.bounds.parameter_variables = [[0.5, 1.5], [0.5, 1.5]]

    phase.guess.time = [0, 2]
    phase.guess.state_variables = [[-half_pi, half_pi],
                                   [-half_pi, half_pi], [0, 0], [0, 0]]
    phase.guess.control_variables = [[0, 0], [0, 0]]
    phase.guess.integral_variables = [100]
    problem.guess.parameter_variables = [1.0, 1.0]
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.6f}")
