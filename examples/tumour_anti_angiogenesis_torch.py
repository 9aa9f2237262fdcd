"""Tumour Anti-Angiogenesis problem.

Optimal scheduling of an anti-angiogenic agent (Ledzewicz & Schattler).
Capability parity with the reference example
(``examples/tumour_anti_angiogenesis/tumour_anti_angiogenesis.py``),
including *symbolic bounds and guesses* resolved through auxiliary data;
expected objective 7571.67 (GPOPS-II).
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402


def build_problem():
    p, q, u = sym.symbols("p q u")
    xi, b, d, G, mu, a, A = sym.symbols("xi b d G mu a A")
    p_max, p_min = sym.symbols("p_max p_min")
    q_max, q_min = sym.symbols("q_max q_min")
    u_max, u_min = sym.symbols("u_max u_min")
    p_t0, q_t0 = sym.symbols("p_t0 q_t0")

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Tumour Anti-Angiogenesis")
    phase = problem.new_phase(name="A", state_variables=[p, q],
                              control_variables=u)

    phase.state_equations = {
        p: -xi * p * sym.log(p / q),
        q: q * (b - (mu + (d * p ** sym.Rational(2, 3)) + (G * u)))}
    phase.integrand_functions = [u]

    problem.objective_function = phase.final_state_variables.p
    problem.auxiliary_data = {xi: 0.084, b: 5.85, d: 0.00873, G: 0.15,
                              mu: 0.02, a: 75, A: 15,
                              p_max: ((b - mu) / d) ** sym.Rational(3, 2),
                              p_min: 0.1,
                              q_max: p_max, q_min: p_min,
                              u_max: a, u_min: 0,
                              p_t0: p_max / 2, q_t0: q_max / 4}

    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0.1, 5.0]
    phase.bounds.state_variables = {p: [p_min, p_max], q: [q_min, q_max]}
    phase.bounds.control_variables = {u: [u_min, u_max]}
    phase.bounds.integral_variables = [[0, A]]
    phase.bounds.initial_state_constraints = {p: p_t0, q: q_t0}

    phase.guess.time = [0, 1]
    phase.guess.state_variables = [[p_t0, p_max], [q_t0, q_max]]
    phase.guess.control_variables = [[u_max, u_max]]
    phase.guess.integral_variables = [7.5]
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Objective: {solution.objective:.2f}  (expected 7571.67)")
