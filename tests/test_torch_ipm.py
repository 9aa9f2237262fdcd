"""The port's interior-point solver options against the JAX package's.

* The analytic NLPs of ``tests/unit/test_ipm.py``, given to both solvers
  without structured derivatives, so the port takes its generic
  ``torch.func`` route (``grad``, ``jacfwd``/``jacrev``, ``hessian``, batched
  with ``vmap``) and the reference its ``jax`` one: each keeps its own
  assertion, and the port must also take the reference's iteration count
  and reach its x to 1e-8.
* ``line_search="merit"`` (the l1-merit Armijo search) and
  ``inertia="loop"`` (the sequential inertia correction) on HS071, on the
  concave box problem and on cart-pole swing-up at 2 mesh sections x 4
  nodes (structured derivatives): the same iterations as the reference
  with the same options, and x to 1e-8.

Everything runs in float64 on the CPU.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from cart_pole_swing_up import build_problem as build_jax  # noqa: E402
from cart_pole_swing_up_torch import build_problem as build_torch  # noqa: E402
from pycollo_tpu.solver.ipm import IPMOptions as JaxOptions  # noqa: E402
from pycollo_tpu.solver.ipm import build_ipm_solver as jax_solver  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402
from pycollo_tpu_torch.solver.ipm import build_ipm_solver  # noqa: E402

torch.set_num_threads(2)

#: agreement of the two solvers' x: the same f64 iteration in both, the
#: derivatives from two AD systems (last-digit differences only)
X_TOL = 1e-8


def _hs071():
    def f_j(x, th):
        return x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2]

    def c_j(x, th):
        return jnp.array([x[0] * x[1] * x[2] * x[3],
                          x[0] ** 2 + x[1] ** 2 + x[2] ** 2 + x[3] ** 2])

    def f_t(x, th):
        return x[:, 0] * x[:, 3] * (x[:, 0] + x[:, 1] + x[:, 2]) + x[:, 2]

    def c_t(x, th):
        return torch.stack([x[:, 0] * x[:, 1] * x[:, 2] * x[:, 3],
                            (x ** 2).sum(-1)], dim=-1)

    def check(x, f, conv, iters):
        assert conv.all() and (iters < 30).all()
        np.testing.assert_allclose(
            x[0], [1.0, 4.74299963, 3.82114998, 1.37940829], rtol=1e-6)
        np.testing.assert_allclose(f[0], 17.0140173, rtol=1e-7)

    return dict(f=(f_j, f_t), c=(c_j, c_t),
                bounds=(np.ones(4), 5 * np.ones(4), np.array([25.0, 40.0]),
                        np.array([1e19, 40.0])),
                opts=dict(tol=1e-8, max_iter=100),
                x0=np.array([[1.0, 5.0, 5.0, 1.0]]), check=check)


def _equality_constrained_qp():
    n = 8

    def check(x, f, conv, iters):
        assert conv.all()
        np.testing.assert_allclose(x[0], np.full(n, 1.0 / n), atol=1e-8)

    return dict(f=(lambda x, th: jnp.sum(x ** 2),
                   lambda x, th: (x ** 2).sum(-1)),
                c=(lambda x, th: jnp.array([jnp.sum(x)]),
                   lambda x, th: x.sum(-1, keepdim=True)),
                bounds=(-10 * np.ones(n), 10 * np.ones(n), np.array([1.0]),
                        np.array([1.0])),
                opts=dict(tol=1e-9, max_iter=50), x0=np.zeros((1, n)),
                check=check)


def _bound_constrained():
    def check(x, f, conv, iters):
        assert conv.all()
        np.testing.assert_allclose(x[0, 0], 2.0, atol=1e-7)

    return dict(f=(lambda x, th: (x[0] - 3.0) ** 2,
                   lambda x, th: (x[:, 0] - 3.0) ** 2),
                c=(lambda x, th: jnp.zeros(0), lambda x, th: x[:, :0]),
                bounds=(np.array([-5.0]), np.array([2.0]), np.zeros(0),
                        np.zeros(0)),
                opts=dict(tol=1e-8, max_iter=50), x0=np.array([[0.0]]),
                check=check)


def _inequality_constraint_active():
    def check(x, f, conv, iters):
        assert conv.all()
        np.testing.assert_allclose(x[0], [-1.0, -1.0], atol=1e-6)

    return dict(f=(lambda x, th: x[0] + x[1],
                   lambda x, th: x[:, 0] + x[:, 1]),
                c=(lambda x, th: jnp.array([x[0] ** 2 + x[1] ** 2]),
                   lambda x, th: (x ** 2).sum(-1, keepdim=True)),
                bounds=(-10 * np.ones(2), 10 * np.ones(2),
                        np.array([-1e19]), np.array([2.0])),
                opts=dict(tol=1e-8, max_iter=60), x0=np.array([[0.5, 0.5]]),
                check=check)


def _theta_parameterization_and_vmap():
    n = 4
    thetas = np.linspace(0.5, 2.0, 16)[:, None]

    def check(x, f, conv, iters):
        assert conv.all()
        np.testing.assert_allclose(x, thetas / n * np.ones((1, n)),
                                   atol=1e-8)

    return dict(f=(lambda x, th: jnp.sum(x ** 2),
                   lambda x, th: (x ** 2).sum(-1)),
                c=(lambda x, th: jnp.array([jnp.sum(x) - th[0]]),
                   lambda x, th: x.sum(-1, keepdim=True) - th[:, :1]),
                bounds=(-10 * np.ones(n), 10 * np.ones(n), np.array([0.0]),
                        np.array([0.0])),
                opts=dict(tol=1e-9, max_iter=50), x0=np.zeros((16, n)),
                theta=thetas, check=check)


def _nonconvex_needs_regularization():
    def check(x, f, conv, iters):
        assert conv.all()
        assert np.all((x < 1e-6) | (x > 1 - 1e-6))

    return dict(f=(lambda x, th: -jnp.sum((x - 0.3) ** 2),
                   lambda x, th: -((x - 0.3) ** 2).sum(-1)),
                c=(lambda x, th: jnp.zeros(0), lambda x, th: x[:, :0]),
                bounds=(np.zeros(3), np.ones(3), np.zeros(0), np.zeros(0)),
                opts=dict(tol=1e-8, max_iter=80),
                x0=np.array([[0.4, 0.45, 0.55]]), check=check)


def _feasibility_restoration_mechanism():
    """The Wächter-Biegler counterexample: the locally minimal violation
    is 1.5 at x = (-1, 0, 0) (see tests/unit/test_ipm.py)."""
    def c_np(x):
        return np.array([x[0] ** 2 - x[1] - 1.0, x[0] - x[2] - 0.5])

    def check(x, f, conv, iters):
        assert np.abs(c_np(x[0])).sum() < 1.75
        assert abs(x[0, 0] - (-1.0)) < 0.35, x

    return dict(f=(lambda x, th: x[0], lambda x, th: x[:, 0]),
                c=(lambda x, th: jnp.array([x[0] ** 2 - x[1] - 1.0,
                                            x[0] - x[2] - 0.5]),
                   lambda x, th: torch.stack(
                       [x[:, 0] ** 2 - x[:, 1] - 1.0,
                        x[:, 0] - x[:, 2] - 0.5], dim=-1)),
                bounds=(np.array([-1e20, 0.0, 0.0]),
                        np.array([1e20, 1e20, 1e20]), np.zeros(2),
                        np.zeros(2)),
                opts=dict(tol=1e-8, max_iter=150, restoration=True),
                x0=np.array([[-2.0, 3.0, 1.0]]), check=check)


CASES = {
    "hs071": _hs071,
    "equality_constrained_qp": _equality_constrained_qp,
    "bound_constrained": _bound_constrained,
    "inequality_constraint_active": _inequality_constraint_active,
    "theta_parameterization_and_vmap": _theta_parameterization_and_vmap,
    "nonconvex_needs_regularization": _nonconvex_needs_regularization,
    "feasibility_restoration_mechanism": _feasibility_restoration_mechanism,
}


def _both(case, **extra):
    """Solve ``case`` with both solvers (generic derivatives); returns the
    reference's and the port's (x, f, converged, iterations) as numpy."""
    xl, xu, cl, cu = case["bounds"]
    opts = {**case["opts"], **extra}
    x0 = case["x0"]
    theta = case.get("theta", np.zeros((x0.shape[0], 0)))
    sj = jax_solver(case["f"][0], case["c"][0], xl, xu, cl, cu,
                    JaxOptions(**opts))
    rj = jax.jit(jax.vmap(sj))(jnp.asarray(x0), jnp.asarray(theta))
    st = build_ipm_solver(case["f"][1], case["c"][1], xl, xu, cl, cu,
                          IPMOptions(**opts))
    rt = st(torch.tensor(x0, dtype=torch.float64),
            torch.tensor(theta, dtype=torch.float64))
    ref = tuple(np.asarray(a) for a in (rj.x, rj.f, rj.converged,
                                        rj.iterations))
    out = tuple(a.detach().numpy() for a in (rt.x, rt.f, rt.converged,
                                             rt.iterations))
    return ref, out


@pytest.mark.parametrize("name", list(CASES))
def test_analytic_nlp_generic_derivatives(name):
    case = CASES[name]()
    ref, out = _both(case)
    case["check"](*out)
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=X_TOL)


OPTION_SETS = {"merit": dict(line_search="merit"),
               "loop": dict(inertia="loop")}


@pytest.mark.parametrize("which", list(OPTION_SETS))
@pytest.mark.parametrize("name", ["hs071", "nonconvex_needs_regularization"])
def test_options_on_analytic_nlp(name, which):
    """HS071, and the concave box problem, whose iterations need inertia
    correction (there the loop takes 11 iterations and the speculative
    ladder 13, in both packages)."""
    ref, out = _both(CASES[name](), **OPTION_SETS[which])
    np.testing.assert_array_equal(out[2], ref[2])
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=X_TOL)
    assert out[2].all()


def _tiny(build):
    problem = build()
    problem.settings.console_out_progress = False
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = 2
    phase.mesh.number_mesh_section_nodes = 4
    problem.initialise()
    return problem.backend.mesh_iterations[0]


@pytest.fixture(scope="module")
def cart_pole():
    return _tiny(build_jax), _tiny(build_torch)


@pytest.mark.parametrize("which", list(OPTION_SETS))
def test_options_on_cart_pole(cart_pole, which):
    itj, itt = cart_pole
    opts = dict(tol=1e-6, max_iter=80, **OPTION_SETS[which])
    sj = itj.build_solver(JaxOptions(**opts))
    rj = jax.jit(sj)(jnp.asarray(itj.xs_guess),
                     jnp.asarray(itj.theta_default))
    st = itt.build_solver(IPMOptions(**opts))
    rt = st(torch.tensor(itt.xs_guess)[None],
            torch.tensor(itt.theta_default)[None])
    assert bool(rt.converged[0]) == bool(rj.converged)
    assert bool(rt.converged[0])
    assert int(rt.iterations[0]) == int(rj.iterations)
    np.testing.assert_allclose(rt.x[0].numpy(), np.asarray(rj.x), rtol=0,
                               atol=X_TOL)


def test_generic_route_matches_structured_on_cart_pole(cart_pole):
    """``build_solver(use_structured=False)`` (the generic torch.func
    derivatives through the whole transcription) takes the structured
    solve's iterations to the same x."""
    _, itt = cart_pole
    x0 = torch.tensor(itt.xs_guess)[None]
    theta = torch.tensor(itt.theta_default)[None]
    opts = IPMOptions(tol=1e-6, max_iter=80)
    generic = itt.build_solver(opts, use_structured=False)(x0, theta)
    structured = itt.build_solver(opts)(x0, theta)
    assert bool(generic.converged[0]) and bool(structured.converged[0])
    assert int(generic.iterations[0]) == int(structured.iterations[0])
    np.testing.assert_allclose(generic.x.numpy(), structured.x.numpy(),
                               rtol=0, atol=X_TOL)
