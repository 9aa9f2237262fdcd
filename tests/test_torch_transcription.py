"""Port transcription against the JAX package on tiny problems; twin of
``tests/unit/test_transcription.py`` and
``tests/unit/test_structured_derivatives.py``.

Cart-pole swing-up (sympy frontend) on 2 mesh sections x 4 nodes is built
in both packages; the layout and mesh tables must agree exactly, the
numeric iteration arrays carried across by ``pycollo_tpu_torch.interop``
to 1e-12, and the scaled constraints, objective gradient, structured
Jacobian and Lagrangian Hessian to 1e-12 in f64 at the guess and at seeded
perturbations of it (evaluated as one batch in the port, one by one under
``jax.vmap`` in the reference).  The same derivative check runs on a
functional-frontend problem with a path constraint and a free final time
(``tests/unit/test_structured_derivatives.py``'s path problem), and on that
test's three other problems at their own meshes: the brachistochrone and
cart-pole on the default mesh (10 x 4) and the two-phase sliding mass of
``tests/integration/test_multiphase.py``; there the structured blocks are
also held against ``torch.func`` AD of the whole scaled functions at the
reference test's tolerances.  The brachistochrone on the default mesh
carries the reference transcription tests: layout counts, the free mask,
variable and constraint scales, the interpolated guess, zero residuals on a
consistent trajectory and the endpoints, each equal to the JAX package's
(to 1e-12 where it is a float).
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

from brachistochrone import build_problem as brach_jax  # noqa: E402
from brachistochrone_torch import build_problem as brach_torch  # noqa: E402
from cart_pole_swing_up import build_problem as build_jax  # noqa: E402
from cart_pole_swing_up_torch import build_problem as build_torch  # noqa: E402
from pycollo_tpu_torch import interop  # noqa: E402
from test_torch_multiphase import variable_phase_problem  # noqa: E402

torch.set_num_threads(2)

#: f64 agreement of the two transcriptions (same formulas, summation
#: order differs only inside small matmuls)
TOL = 1e-12


#: the reference's structured-against-AD tolerances
#: (tests/unit/test_structured_derivatives.py)
AD_JAC_TOL = 1e-9
AD_HESS_TOL = 1e-8


def _tiny_iteration(build, tiny=True):
    problem = build()
    problem.settings.console_out_progress = False
    if tiny:
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


@pytest.fixture(scope="module")
def brach_iterations():
    """The brachistochrone on the default mesh (the reference's fixture)."""
    return (_tiny_iteration(brach_jax, tiny=False),
            _tiny_iteration(brach_torch, tiny=False))


@pytest.fixture(scope="module")
def cart_pole_iterations():
    return (_tiny_iteration(build_jax, tiny=False),
            _tiny_iteration(build_torch, tiny=False))


@pytest.fixture(scope="module")
def multiphase_iterations():
    import pycollo_tpu
    import pycollo_tpu_torch
    return tuple(_tiny_iteration(lambda: variable_phase_problem(pkg, 2),
                                 tiny=False)
                 for pkg in (pycollo_tpu, pycollo_tpu_torch))


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


@pytest.mark.parametrize("which", ["iterations", "path_iterations",
                                   "brach_iterations", "cart_pole_iterations",
                                   "multiphase_iterations"])
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
    if which in ("iterations", "path_iterations"):
        return
    # The reference test's own check, on the port: the structured blocks
    # equal AD of the whole scaled functions.
    for b in range(B):
        th, lb = tht[b:b + 1], lt[b]

        def c_one(x):
            return itt.c_scaled(x[None], th)[0]

        def lag(x):
            return (itt.f_scaled(x[None], th)[0]
                    + itt.c_scaled(x[None], th)[0] @ lb)

        np.testing.assert_allclose(
            out["J"][b].numpy(), torch.func.jacrev(c_one)(xt[b]).numpy(),
            atol=AD_JAC_TOL, rtol=AD_JAC_TOL)
        np.testing.assert_allclose(
            out["H"][b].numpy(), torch.func.hessian(lag)(xt[b]).numpy(),
            atol=AD_HESS_TOL, rtol=AD_HESS_TOL)


# -- tests/unit/test_transcription.py on the default-mesh brachistochrone --

def test_layout_counts(brach_iterations):
    itj, itt = brach_iterations
    lay = itt.layout
    pl = lay.phases[0]
    plj = itj.layout.phases[0]
    for field in ("ny", "nu", "nq", "N", "num_defect", "y_off", "u_off",
                  "t_off"):
        assert getattr(pl, field) == getattr(plj, field), field
    assert (lay.n_full, lay.m_total) == (itj.layout.n_full,
                                         itj.layout.m_total)
    assert pl.ny == 3 and pl.nu == 1 and pl.nq == 0
    assert pl.N == 31 and pl.num_defect == 30
    # Full vector: 3*31 y + 1*31 u + 0 q + 2 t = 126.
    assert lay.n_full == 126
    # Constraints: 3*30 defects + endpoint(0) = 90.
    assert lay.m_total == 90
    # Variable layout ordering: y then u then q then t.
    assert pl.y_off == 0
    assert pl.u_off == 93
    assert pl.t_off == 124


def test_free_mask_eliminates_fixed(brach_iterations):
    """t0 fixed at 0 and the pinned endpoint states leave the NLP."""
    itj, itt = brach_iterations
    pl = itt.layout.phases[0]
    free = itt.free_mask
    np.testing.assert_array_equal(free, itj.free_mask)
    # t0 fixed, tF free.
    assert not free[pl.t_off]
    assert free[pl.t_off + 1]
    # Initial nodes of x, y, v pinned by initial_state_constraints.
    for j in range(3):
        assert not free[pl.y_off + j * pl.N]
    # Final nodes of x, y pinned; v free.
    assert not free[pl.y_off + 0 * pl.N + pl.N - 1]
    assert not free[pl.y_off + 1 * pl.N + pl.N - 1]
    assert free[pl.y_off + 2 * pl.N + pl.N - 1]
    # 126 total - 6 fixed = 120 free.
    assert itt.n_free == itj.n_free == 120


def test_variable_scaling_maps_to_unit_box(brach_iterations):
    """Bounds scaling: x in [lb, ub] -> xs in [-0.5, 0.5]."""
    itj, itt = brach_iterations
    for name in ("xs_lb", "xs_ub", "V_full", "r_full"):
        np.testing.assert_allclose(getattr(itt, name), getattr(itj, name),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(itt.xs_lb.min(), -0.5)
    np.testing.assert_allclose(itt.xs_ub.max(), 0.5)


def test_constraint_scaling_defects(brach_iterations):
    """Defect rows scaled by 1/V_y."""
    itj, itt = brach_iterations
    pl = itt.layout.phases[0]
    np.testing.assert_allclose(itt.W_c, itj.W_c, rtol=TOL, atol=TOL)
    # V_y = [10, 10, 100] for x, y, v bounds.
    expected = np.repeat([1 / 10, 1 / 10, 1 / 100], pl.num_defect)
    np.testing.assert_allclose(
        itt.W_c[pl.c_defect_off:pl.c_path_off], expected)


def test_guess_interpolated_linearly(brach_iterations):
    itj, itt = brach_iterations
    pl = itt.layout.phases[0]
    t = itt.tables[0]
    np.testing.assert_allclose(itt.x_full_guess, itj.x_full_guess,
                               rtol=TOL, atol=TOL)
    y0_nodes = itt.x_full_guess[pl.y_off:pl.y_off + pl.N]
    # Linear guess from 0 to 2 over tau in [-1, 1].
    np.testing.assert_allclose(y0_nodes, (t.tau + 1.0), atol=1e-12)


def test_residuals_zero_for_consistent_trajectory(brach_iterations):
    """Constraint residuals vanish for an exactly-consistent trajectory."""
    itj, itt = brach_iterations
    pl = itt.layout.phases[0]
    t = itt.tables[0]
    # Constant control u = 0: dynamics y' = (0, v, g) in time.
    # Choose t0=0, tF=2 -> stretch=1, time = tau+1.
    x_full = np.array(itt.theta_default)
    time = t.tau + 1.0
    v = 9.81 * time
    yy = 9.81 * time ** 2 / 2.0
    xx = np.zeros_like(time)
    x_full[pl.y_slice] = np.concatenate([xx, yy, v])
    x_full[pl.u_slice] = 0.0
    x_full[pl.t_off] = 0.0
    x_full[pl.t_off + 1] = 2.0
    # The port evaluates constraints of (xs, theta): the free entries come
    # from xs, the fixed ones from theta.
    free = itt.free_idx
    xs = (x_full[free] - itt.r_full[free]) / itt.V_full[free]
    c = itt.c_unscaled(torch.tensor(xs)[None],
                       torch.tensor(x_full)[None])[0].numpy()
    ref = np.asarray(itj._constraints_raw(jnp.asarray(x_full)))
    np.testing.assert_allclose(c, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(c, 0.0, atol=1e-10)


def test_endpoints_extraction(brach_iterations):
    itj, itt = brach_iterations
    ep = itt.endpoints_of(torch.tensor(itt.x_full_guess)[None])
    epj = itj.endpoints_of(jnp.asarray(itj.x_full_guess))
    assert len(ep.phase) == len(epj.phase) == 1
    for name in ("y0", "yF", "t0", "tF"):
        np.testing.assert_allclose(
            getattr(ep.phase[0], name).numpy().reshape(-1),
            np.asarray(getattr(epj.phase[0], name)).reshape(-1),
            rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(ep.phase[0].y0[:, 0].numpy(), [0, 0, 0])
    np.testing.assert_allclose(ep.phase[0].yF[:, 0].numpy(), [2, 2, 0])
    assert float(ep.phase[0].tF[0]) == 10.0


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
    loaded by tests/conftest.py); nor do the time-dependence example twin
    and the stored-history helper that ``chip_smoke.py`` uses."""
    code = ("import sys; sys.path[:0] = ['examples', 'tests']; "
            "import pycollo_tpu_torch, pycollo_tpu_torch.solver.ipm, "
            "pycollo_tpu_torch.parallel.batch, pycollo_tpu_torch.interop, "
            "pycollo_tpu_torch.refinement, pycollo_tpu_torch.vis.plot, "
            "time_dependence_torch, oracle_history; "
            "bad = [m for m in sys.modules if m in ('jax', 'matplotlib') or "
            "m.startswith(('jax.', 'pycollo_tpu.', 'matplotlib.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
