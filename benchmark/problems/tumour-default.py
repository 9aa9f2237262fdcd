"""Tumour anti-angiogenesis, as the benchmark runs it through
pycollo_tpu_torch.

Frozen copy of ``examples/tumour_anti_angiogenesis_torch.py:build_problem``
(Ledzewicz & Schaettler's optimal scheduling of an anti-angiogenic agent,
the GPOPS-II example; objective 7571.67 on a refined mesh), taken so that a
later change to the example cannot change the benchmark.  The only change:
the published constants come from the configuration file
(``configs/tumour-default.json``, ``constants``) instead of literals, so
the program and the plain reference read one set of numbers.
"""


def build_problem(c):
    """The problem for the configuration's constants ``c``."""
    import sympy as sym

    import pycollo_tpu_torch

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
    problem.auxiliary_data = {xi: c["xi"], b: c["b"], d: c["d"], G: c["G"],
                              mu: c["mu"], a: c["a"], A: c["A"],
                              p_max: ((b - mu) / d) ** sym.Rational(3, 2),
                              p_min: c["p_min"],
                              q_max: p_max, q_min: p_min,
                              u_max: a, u_min: 0,
                              p_t0: p_max / 2, q_t0: q_max / 4}

    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [c["tF_min"], c["tF_max"]]
    phase.bounds.state_variables = {p: [p_min, p_max], q: [q_min, q_max]}
    phase.bounds.control_variables = {u: [u_min, u_max]}
    phase.bounds.integral_variables = [[0, A]]
    phase.bounds.initial_state_constraints = {p: p_t0, q: q_t0}

    phase.guess.time = [0, 1]
    phase.guess.state_variables = [[p_t0, p_max], [q_t0, q_max]]
    phase.guess.control_variables = [[u_max, u_max]]
    phase.guess.integral_variables = [7.5]
    return problem
