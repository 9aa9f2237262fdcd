"""Every example twin builds and initialises as the JAX package's example.

The twin of ``tests/integration/test_examples_initialise.py`` over every
``examples/*_torch.py``: its twelve families, rocket_1d (initialised as
``tests/integration/test_rocket_1d.py`` does), the three path-follow
variants and the build-only kinetic batch reactor.  Each port's first mesh
iteration must have the same number of free variables (``n_free``) and
constraints (``layout.m_total``) as the JAX package's on the same example,
on the CPU; nothing is solved.

Delta III's guess puts the relative velocity ``v - omega x r`` at exactly 0
in torch's arithmetic, where a plain ``sqrt`` derivative is NaN; the port's
sym backend gives ``sqrt`` the derivative 0 there
(``sym_backend._sqrt``), so its constraint scales at the guess equal the
JAX package's.
"""

import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import sympy
import torch
from torch.func import hessian, jacfwd

from pycollo_tpu_torch.sym_backend import _MODULES, _sqrt

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

torch.set_num_threads(2)

#: (example module, ``build_problem`` argument or None)
EXAMPLES = [
    ("brachistochrone", None),
    ("hypersensitive_problem", None),
    ("cart_pole_swing_up", None),
    ("cart_pole_swing_up_implicit", None),
    ("double_pendulum", None),
    ("free_flying_robot", None),
    ("multiphase_point_move", None),
    ("path_follow", None),
    ("space_shuttle_reentry_trajectory", None),
    ("space_station_attitude_control", None),
    ("tumour_anti_angiogenesis", None),
    ("delta_iii_launch_vehicle", None),
    ("rocket_1d", None),
    ("path_follow", "orthogonal"),
    ("path_follow", "rate"),
]


@functools.lru_cache(maxsize=None)
def _first_mesh(module_name, variant):
    module = importlib.import_module(module_name)
    problem = (module.build_problem() if variant is None
               else module.build_problem(variant))
    problem.settings.console_out_progress = False
    problem.initialise()
    return problem.backend.mesh_iterations[0]


@pytest.mark.parametrize(
    "module_name, variant", EXAMPLES,
    ids=[m if v is None else f"{m}-{v}" for m, v in EXAMPLES])
def test_example_initialises_as_the_jax_package(module_name, variant):
    ref = _first_mesh(module_name, variant)
    it = _first_mesh(f"{module_name}_torch", variant)
    assert type(it).__module__ == "pycollo_tpu_torch.transcription"
    assert it.n_free > 0 and it.layout.m_total > 0
    assert (it.n_free, it.layout.m_total) == (ref.n_free, ref.layout.m_total)
    assert it.layout.n_full == ref.layout.n_full


def test_kinetic_batch_reactor_builds():
    """Parity with the reference: the problem definition constructs but is
    explicitly incomplete (cannot be initialised without bounds/guess)."""
    import kinetic_batch_reactor
    import kinetic_batch_reactor_torch
    problem = kinetic_batch_reactor_torch.build_problem()
    ref = kinetic_batch_reactor.build_problem()
    assert type(problem).__module__ == "pycollo_tpu_torch.ocp"
    assert problem.number_phases == ref.number_phases == 1
    assert (problem.number_parameter_variables
            == ref.number_parameter_variables == 1)


def test_delta_iii_scales_at_the_guess_equal_the_jax_package():
    """The constraint scales come from the Jacobian at the guess: finite,
    and the JAX package's (whose XLA leaves -2.28e-14 for the port's 0)."""
    ref = _first_mesh("delta_iii_launch_vehicle", None)
    it = _first_mesh("delta_iii_launch_vehicle_torch", None)
    assert np.isfinite(it.W_c).all()
    np.testing.assert_allclose(it.W_c, np.asarray(ref.W_c), rtol=1e-12,
                               atol=0)


def test_sqrt_derivatives_are_zero_at_zero_and_torch_elsewhere():
    """``|v| v`` lambdified by the port: value and derivatives 0 at v = 0
    (where ``torch.sqrt`` gives NaN), ``torch.sqrt``'s bit for bit off 0."""
    x, y = sympy.symbols("x y")
    fn = sympy.lambdify((x, y), sympy.sqrt(x ** 2 + y ** 2) * x,
                        modules=_MODULES)

    def port(v):
        return fn(v[0], v[1])

    def plain(v):
        return torch.sqrt(v[0] ** 2 + v[1] ** 2) * v[0]

    zero = torch.zeros(2, dtype=torch.float64)
    for f in (port, jacfwd(port), hessian(port)):
        out = f(zero)
        assert torch.isfinite(out).all() and not out.any()
    assert torch.isnan(jacfwd(plain)(zero)).any()
    v = torch.tensor([0.3, -0.4], dtype=torch.float64)
    for f, g in ((port, plain), (jacfwd(port), jacfwd(plain)),
                 (hessian(port), hessian(plain))):
        assert torch.equal(f(v), g(v))
    assert torch.isnan(_sqrt(torch.tensor(-1.0)))
