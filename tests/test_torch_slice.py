"""The port's batched cart-pole solve against the JAX package.

Cart-pole swing-up on 2 mesh sections x 4 nodes, four instances with
perturbed initial states (the ``bench.py`` recipe), on the CPU:

* one dense Newton step from the same solver state, carried across by
  ``pycollo_tpu_torch.interop``, to 1e-10 in f64;
* the f64 path: the same convergence flags and iteration counts, x (the
  unscaled full vector) to 1e-8 and f to 1e-10;
* the mixed path (f32 factorization through the kernel's plain version,
  f32 derivative assembly): every instance converges and the objectives
  agree to 1e-4 relative;
* a batch of four gives, to 1e-12, what each instance gives solved alone.
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
from pycollo_tpu_torch import interop  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

F64 = dict(tol=1e-6, max_iter=80)
#: the port solves on the CUDA card unless the CPU is named
CPU = [torch.device("cpu")]
MIXED = dict(tol=1e-6, max_iter=80, kkt_precision="mixed", dc_floor=1e-7,
             dense_gmres_iters=12, eval_dtype="f32")


def _tiny(build):
    problem = build()
    problem.settings.console_out_progress = False
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = 2
    phase.mesh.number_mesh_section_nodes = 4
    problem.initialise()
    return problem


@pytest.fixture(scope="module")
def problems():
    return _tiny(build_jax), _tiny(build_torch)


@pytest.fixture(scope="module")
def batch(problems):
    it = problems[0].backend.mesh_iterations[0]
    B = 4
    rng = np.random.default_rng(0)
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (B, 1))
    theta[:, pl.y_off + 0 * pl.N] = rng.uniform(-0.25, 0.25, B)
    theta[:, pl.y_off + 1 * pl.N] = rng.uniform(-0.3, 0.3, B)
    return np.tile(it.xs_guess, (B, 1)), theta


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _jax_solve(problems, batch, kw):
    itj = problems[0].backend.mesh_iterations[0]
    solver = itj.build_solver(JaxOptions(**kw))
    x0, theta = batch
    return jax.jit(jax.vmap(solver))(jnp.asarray(x0), jnp.asarray(theta))


def test_compute_step_from_carried_state(problems, batch):
    itj = problems[0].backend.mesh_iterations[0]
    itt = problems[1].backend.mesh_iterations[0]
    sj = itj.build_solver(JaxOptions(**F64))
    st = itt.build_solver(IPMOptions(**F64))
    x0, theta = batch
    thj = jnp.asarray(theta)
    # Two reference iterations, so the state is away from the start.
    state = jax.jit(jax.vmap(sj._init_state))(jnp.asarray(x0), thj)
    body = jax.jit(jax.vmap(sj._body))
    for _ in range(2):
        state = body(state, thj)
    derivs = itj._build_structured_derivatives()
    n = sj.dims["n"]

    def jax_step(s, th):
        x = s.v[:n]
        out = sj._compute_step(s.v, s.lam, s.zl, s.zu, s.mu, s.dw_last, th,
                               jax.grad(itj.f_scaled)(x, th),
                               derivs["jac_c"](x, th), sj._g(s.v, th))
        return out[0], out[1], out[6]

    dv_j, dlam_j, ok_j = jax.jit(jax.vmap(jax_step))(state, thj)

    ps = interop.ipm_state_from_numpy(
        {f: np.asarray(getattr(state, f)) for f in state._fields})
    th = _t(theta)
    x = ps.v[:, :n]
    gf = torch.func.grad(lambda xx: itt.f_scaled(xx, th).sum())(x)
    out = st._compute_step(ps.v, ps.lam, ps.zl, ps.zu, ps.mu, ps.dw_last, th,
                           gf, itt.jac_c_scaled(x, th), st._g(ps.v, th),
                           ps.rmode)
    np.testing.assert_array_equal(out[6].numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(dv_j),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(dlam_j),
                               rtol=1e-10, atol=1e-10)


def test_f64_batch_matches_reference(problems, batch):
    rj = _jax_solve(problems, batch, F64)
    res = solve_batched(problems[1].backend, theta_batch=batch[1],
                        options=IPMOptions(**F64), devices=CPU)
    itt = problems[1].backend.mesh_iterations[0]
    np.testing.assert_array_equal(res.converged, np.asarray(rj.converged))
    np.testing.assert_array_equal(res.iterations, np.asarray(rj.iterations))
    assert res.converged.all()
    itj = problems[0].backend.mesh_iterations[0]
    x_full_j = jax.vmap(itj.assemble_full)(rj.x, jnp.asarray(batch[1]))
    np.testing.assert_allclose(res.x_full, np.asarray(x_full_j), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(res.objective * itt.w, np.asarray(rj.f),
                               rtol=1e-10, atol=0)


def test_mixed_batch_converges_and_agrees(problems, batch):
    rj = _jax_solve(problems, batch, MIXED)
    res = solve_batched(problems[1].backend, theta_batch=batch[1],
                        options=IPMOptions(**MIXED), devices=CPU)
    assert res.converged.all(), res.kkt_error
    assert np.asarray(rj.converged).all()
    itt = problems[1].backend.mesh_iterations[0]
    f_ref = np.asarray(rj.f) / itt.w
    np.testing.assert_allclose(res.objective, f_ref, rtol=1e-4, atol=0)


def test_batch_equals_instances_alone(problems, batch):
    itt = problems[1].backend.mesh_iterations[0]
    solver = itt.build_solver(IPMOptions(**F64))
    x0, theta = _t(batch[0]), _t(batch[1])
    together = solver(x0, theta)
    for b in range(theta.shape[0]):
        alone = solver(x0[b:b + 1], theta[b:b + 1])
        assert int(alone.iterations[0]) == int(together.iterations[b])
        np.testing.assert_allclose(alone.x[0].numpy(), together.x[b].numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(alone.f[0].numpy(), together.f[b].numpy(),
                                   rtol=1e-12, atol=0)


def test_mesh_iteration_solve_is_the_batch_of_one(problems, batch):
    """``MeshIteration.solve`` (one instance, CPU) gives the batched
    solve's answer for that instance."""
    itt = problems[1].backend.mesh_iterations[0]
    itt.build_solver(IPMOptions(**F64))
    theta = batch[1]
    res = solve_batched(problems[1].backend, theta_batch=theta, devices=CPU)
    one = itt.solve(theta=theta[2], device="cpu")
    assert one.converged and bool(res.converged[2])
    np.testing.assert_allclose(one.x_full, res.x_full[2], rtol=0, atol=1e-12)
    assert one.objective == pytest.approx(res.objective[2], rel=1e-12)
