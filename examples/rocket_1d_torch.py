"""1D rocket ascent (minimum fuel) optimal control problem.

From the CasADi documentation's rocket example; capability parity with
the reference's ``tests/integration/test_rocket_1d.py`` (which builds
this problem and stops at ``initialise()`` — the solve there was left
as an xfail placeholder; here it solves).

A rocket climbs vertically against gravity; thrust ``T`` burns mass at
rate ``alpha * T``.  Minimize the fuel spent reaching 100 km.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    # run as a script from a checkout: the package sits beside examples/
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import sympy as sym  # noqa: E402

import pycollo_tpu_torch  # noqa: E402


def build_problem():
    h, v, m = sym.symbols("h v m")
    T = sym.Symbol("T")
    g, alpha = sym.symbols("g alpha")

    problem = pycollo_tpu_torch.OptimalControlProblem(name="Rocket")
    phase = problem.new_phase(name="A")
    phase.state_variables = (h, v, m)
    phase.control_variables = T
    phase.state_equations = (v, T / m - g, -alpha * T)

    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = 100.0
    phase.bounds.state_variables = [[0.0, 100000.0],
                                    [0.0, 10000.0],
                                    [0.0, 500000.0]]
    phase.bounds.control_variables = [[0.0, 10.0e8]]
    phase.bounds.initial_state_constraints = {h: 0.0, v: 0.0, m: 500000.0}
    phase.bounds.final_state_constraints = {h: 100000.0}

    phase.guess.time = [0.0, 100.0]
    phase.guess.state_variables = [[0.0, 100000.0],
                                   [0.0, 100.0],
                                   [500000.0, 250000.0]]
    phase.guess.control_variables = [[0.0, 0.0]]

    problem.objective_function = (phase.initial_state_variables.m
                                  - phase.final_state_variables.m)
    problem.auxiliary_data = {g: 9.81, alpha: 1 / (300 * 9.81)}

    phase.mesh.number_mesh_sections = 10
    return problem


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="device of the NLP solves: cuda (default) or cpu")
    args = parser.parse_args()
    problem = build_problem()
    solution = problem.solve(device=args.device)
    print(f"Fuel burned: {solution.objective:.2f} kg")
