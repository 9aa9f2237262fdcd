"""Port transcription against the JAX package on tiny problems.

Cart-pole swing-up (sympy frontend) on 2 mesh sections x 4 nodes is built
in both packages; the layout and mesh tables must agree exactly, the
numeric iteration arrays carried across by ``pycollo_tpu_torch.interop``
to 1e-12, and the scaled constraints, objective gradient, structured
Jacobian and Lagrangian Hessian to 1e-12 in f64 at the guess and at seeded
perturbations of it (evaluated as one batch in the port, one by one under
``jax.vmap`` in the reference).  The same derivative check runs on a
functional-frontend problem with a path constraint and a free final time
(``tests/unit/test_structured_derivatives.py``'s path problem).
"""

import subprocess
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
from pycollo_tpu_torch import interop  # noqa: E402

torch.set_num_threads(2)

#: f64 agreement of the two transcriptions (same formulas, summation
#: order differs only inside small matmuls)
TOL = 1e-12


def _tiny_iteration(build):
    problem = build()
    problem.settings.console_out_progress = False
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = 2
    phase.mesh.number_mesh_section_nodes = 4
    problem.initialise()
    return problem.backend.mesh_iterations[0]


def _path_problem(pkg, stack):
    """The functional path-constraint problem of
    tests/unit/test_structured_derivatives.py; ``stack`` builds the
    component axis (jnp.array per node in JAX, torch.stack of
    component-first tensors in the port)."""
    problem = pkg.OptimalControlProblem(name="PathTest")
    problem.settings.console_out_progress = False
    phase = problem.new_phase(name="A")
    phase.state_variables = ("x", "v")
    phase.control_variables = ("u",)
    phase.state_equations = lambda y, u, t, s: stack(
        [y[1], u[0] - 0.1 * y[1] ** 2])
    phase.path_constraints = lambda y, u, t, s: stack(
        [y[0] ** 2 + y[1] ** 2])
    phase.number_path_constraints = 1
    phase.integrand_functions = lambda y, u, t, s: stack([u[0] ** 2])
    phase.number_integrand_functions = 1
    problem.objective_function = lambda ep: ep.phase[0].q[0]
    phase.bounds.initial_time = 0.0
    phase.bounds.final_time = [0.5, 2.0]
    phase.bounds.state_variables = [[-2, 2], [-3, 3]]
    phase.bounds.control_variables = [[-5, 5]]
    phase.bounds.integral_variables = [[0, 50]]
    phase.bounds.path_constraints = [[0, 3.5]]
    phase.bounds.initial_state_constraints = [[0, 0], [1, 1]]
    phase.guess.time = [0.0, 1.0]
    phase.guess.state_variables = [[0, 0.5], [1, 0.5]]
    phase.guess.control_variables = [[0, 0]]
    phase.guess.integral_variables = [1.0]
    return problem


def _path_jax():
    import pycollo_tpu
    return _path_problem(pycollo_tpu, jnp.array)


def _path_torch():
    import pycollo_tpu_torch
    return _path_problem(pycollo_tpu_torch, torch.stack)


@pytest.fixture(scope="module")
def iterations():
    return _tiny_iteration(build_jax), _tiny_iteration(build_torch)


@pytest.fixture(scope="module")
def path_iterations():
    return _tiny_iteration(_path_jax), _tiny_iteration(_path_torch)


def test_layout_and_mesh_tables_exact(iterations):
    itj, itt = iterations
    assert itj.layout.n_full == itt.layout.n_full
    assert itj.layout.m_total == itt.layout.m_total
    for plj, plt in zip(itj.layout.phases, itt.layout.phases):
        for field in ("ny", "nu", "nq", "npc", "N", "num_defect", "y_off",
                      "u_off", "q_off", "t_off", "c_defect_off",
                      "c_path_off", "c_integral_off"):
            assert getattr(plj, field) == getattr(plt, field), field
        np.testing.assert_array_equal(plj.defect_states, plt.defect_states)
    for tj, tt in zip(itj.tables, itt.tables):
        for name in ("tau", "E", "I", "W"):
            np.testing.assert_array_equal(getattr(tj, name),
                                          getattr(tt, name))
    np.testing.assert_array_equal(itj.free_idx, itt.free_idx)
    np.testing.assert_array_equal(itj.cl_scaled, itt.cl_scaled)
    np.testing.assert_array_equal(itj.cu_scaled, itt.cu_scaled)


def test_interop_iteration_arrays(iterations):
    itj, itt = iterations
    exported = {name: [np.asarray(getattr(t, name)) for t in itj.tables]
                for name in interop.MESH_TABLES}
    exported.update({name: np.asarray(getattr(itj, name))
                     for name in interop.ITERATION_VECTORS})
    exported["w"] = itj.w
    arrays = interop.iteration_arrays_from_numpy(exported)
    for name in interop.MESH_TABLES:
        for a, t in zip(arrays[name], itt.tables):
            assert a.dtype == torch.float64
            np.testing.assert_allclose(a.numpy(), getattr(t, name),
                                       rtol=TOL, atol=TOL)
    for name in interop.ITERATION_VECTORS:
        np.testing.assert_allclose(arrays[name].numpy(), getattr(itt, name),
                                   rtol=TOL, atol=TOL)
    assert arrays["w"] == pytest.approx(itt.w, rel=TOL)


@pytest.mark.parametrize("which", ["iterations", "path_iterations"])
def test_nlp_functions_and_derivatives(which, request):
    itj, itt = request.getfixturevalue(which)
    rng = np.random.default_rng(0)
    B = 3
    xs = itj.xs_guess[None] + np.concatenate(
        [np.zeros((1, itj.n_free)),
         0.05 * rng.standard_normal((B - 1, itj.n_free))])
    theta = np.tile(itj.theta_default, (B, 1))
    theta[1:, 0] += 0.1 * rng.standard_normal(B - 1)
    lam = rng.standard_normal((B, itj.layout.m_total))

    dj = itj._build_structured_derivatives()
    xj, thj, lj = jnp.asarray(xs), jnp.asarray(theta), jnp.asarray(lam)
    ref = jax.jit(jax.vmap(lambda x, th, l: dict(
        f=itj.f_scaled(x, th), c=itj.c_scaled(x, th),
        g=jax.grad(itj.f_scaled)(x, th), J=dj["jac_c"](x, th),
        H=dj["hess_lag"](x, l, th))))(xj, thj, lj)

    dt = itt._build_structured_derivatives()
    xt, tht, lt = (torch.tensor(a, dtype=torch.float64)
                   for a in (xs, theta, lam))
    out = dict(
        f=itt.f_scaled(xt, tht),
        c=itt.c_scaled(xt, tht),
        g=torch.func.grad(lambda x: itt.f_scaled(x, tht).sum())(xt),
        J=dt["jac_c"](xt, tht),
        H=dt["hess_lag"](xt, lt, tht))
    for name, r in ref.items():
        assert out[name].dtype == torch.float64, name
        np.testing.assert_allclose(out[name].numpy(), np.asarray(r),
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_f32_assembly_follows_theta_dtype(iterations):
    """eval_dtype="f32": the structured blocks come out float32 (the
    per-node AD must not promote) and agree with f64 to f32 accuracy."""
    _, itt = iterations
    dt = itt._build_structured_derivatives()
    xs = torch.tensor(itt.xs_guess)[None]
    theta = torch.tensor(itt.theta_default)[None]
    lam = torch.ones((1, itt.layout.m_total), dtype=torch.float64)
    J32 = dt["jac_c"](xs.float(), theta.float())
    H32 = dt["hess_lag"](xs.float(), lam.float(), theta.float())
    assert J32.dtype == torch.float32 and H32.dtype == torch.float32
    torch.testing.assert_close(J32.double(), dt["jac_c"](xs, theta),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(H32.double(), dt["hess_lag"](xs, lam, theta),
                               rtol=1e-5, atol=1e-4)


def test_import_leaves_jax_out():
    """The port never imports jax, and imports matplotlib only when a plot
    is drawn (checked in a fresh interpreter: this test process has jax
    loaded by tests/conftest.py)."""
    code = ("import sys, pycollo_tpu_torch, pycollo_tpu_torch.solver.ipm, "
            "pycollo_tpu_torch.parallel.batch, pycollo_tpu_torch.interop, "
            "pycollo_tpu_torch.refinement, pycollo_tpu_torch.vis.plot; "
            "bad = [m for m in sys.modules if m in ('jax', 'matplotlib') or "
            "m.startswith(('jax.', 'pycollo_tpu.', 'matplotlib.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
