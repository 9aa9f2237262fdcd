"""Cart-pole swing-up, as the benchmark runs it through pycollo_tpu_torch.

Frozen copy of ``examples/cart_pole_swing_up_torch.py:build_problem``
(Kelly, M. (2017). "An Introduction to Trajectory Optimization: How To Do
Your Own Direct Collocation", SIAM Review 59(4), 849-904, section 6),
taken so that a later change to the example cannot change the benchmark.
The only change: the published constants come from the configuration file
(``configs/cartpole-default.json``, ``constants``) instead of literals, so
the program and the plain reference read one set of numbers.
"""


def build_problem(c):
    """The problem for the configuration's constants ``c``."""
    import numpy as np
    import sympy as sym

    import pycollo_tpu_torch

    q1, q2, q1d, q2d = sym.symbols("q1 q2 q1d q2d")
    q1dd, q2dd = sym.symbols("q1dd q2dd")
    F = sym.Symbol("F")
    m1, m2, l, g = sym.symbols("m1 m2 l g")
    T, d = c["T"], c["d"]
    F_max, d_max = c["F_max"], c["d_max"]

    problem = pycollo_tpu_torch.OptimalControlProblem(
        name="Cart-Pole Swing-Up")
    phase = problem.new_phase(name="A")
    phase.state_variables = [q1, q2, q1d, q2d]
    phase.control_variables = F
    phase.state_equations = [q1d, q2d, q1dd, q2dd]
    phase.integrand_functions = [F ** 2]

    phase.bounds.initial_time = 0
    phase.bounds.final_time = T
    phase.bounds.state_variables = {q1: [-d_max, d_max], q2: [-10, 10],
                                    q1d: [-10, 10], q2d: [-10, 10]}
    phase.bounds.control_variables = {F: [-F_max, F_max]}
    phase.bounds.integral_variables = [[0, 100]]
    phase.bounds.initial_state_constraints = {q1: 0, q2: 0, q1d: 0, q2d: 0}
    phase.bounds.final_state_constraints = {q1: d, q2: np.pi,
                                            q1d: 0, q2d: 0}

    phase.guess.time = [0, T]
    phase.guess.state_variables = [[0, d], [0, np.pi], [0, 0], [0, 0]]
    phase.guess.control_variables = [[0, 0]]
    phase.guess.integral_variables = [0]

    q1dd_eqn = (l * m2 * sym.sin(q2) * q2d ** 2 + F
                + m2 * g * sym.cos(q2) * sym.sin(q2)) \
        / (m1 + m2 * (1 - sym.cos(q2) ** 2))
    q2dd_eqn = -(l * m2 * sym.cos(q2) * sym.sin(q2) * q2d ** 2
                 + F * sym.cos(q2) + (m1 + m2) * g * sym.sin(q2)) \
        / (l * m1 + l * m2 * (1 - sym.cos(q2) ** 2))

    problem.objective_function = phase.integral_variables[0]
    problem.auxiliary_data = {g: c["g"], l: c["l"], m1: c["m1"],
                              m2: c["m2"], q1dd: q1dd_eqn, q2dd: q2dd_eqn}
    return problem
