"""The port's block-banded solve path against the JAX package.

Cart-pole swing-up on 2 mesh sections x 4 nodes with
``linear_solver="block-banded"``, four instances with perturbed initial
states (the ``bench.py`` recipe), ``IPMOptions(tol=1e-6, max_iter=80)`` as
``bench.py`` builds the banded path, f64 on the CPU:

* from the same solver state (two reference iterations in, carried across
  by ``pycollo_tpu_torch.interop``): the structured Newton step
  (``compute_step_structured``) gives the same ``ok`` flags and dv to
  1e-8, and one ``_body`` step the same next iterate to 1e-8.  dlam and
  the next lam are held to 1e-8 of Dinv |J dx|: dlam is recovered as
  Dinv (J dx + g~) with Dinv = 1/dc = 1e7, so the rounding of dx reaches
  it amplified 1e7-fold (measured ~1e-7 relative to max |dlam|);
* a whole batched solve: the same converged flags and iteration counts,
  and the objectives to 1e-8 relative;
* a batch of four gives what each instance gives solved alone: the same
  iterations, x to 1e-12 (scaled) and f to 1e-10;
* with every ladder level of one instance made to fail, only that
  instance escalates (the others' steps are unchanged, bit for bit) and
  it gets the escalated step it gets alone (dv to 1e-9 of its size, the
  same dw, dlam to 1e-8 of Dinv |J dx|);
* (``slow``) ``problem.solve()`` on the brachistochrone through the banded
  path ends on the JAX package's banded objective (1e-8 relative) and on
  GPOPS-II's 0.82434 (1e-4), with the mesh tolerance met.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vjp

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from cart_pole_swing_up import build_problem as build_jax  # noqa: E402
from cart_pole_swing_up_torch import build_problem as build_torch  # noqa: E402
from pycollo_tpu.solver.ipm import IPMOptions as JaxOptions  # noqa: E402
from pycollo_tpu_torch import interop  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.solver.ipm import (IPMOptions,  # noqa: E402
                                          build_ipm_solver)

torch.set_num_threads(2)

OPTS = dict(tol=1e-6, max_iter=80)
#: the port solves on the CUDA card unless the CPU is named
CPU = [torch.device("cpu")]


def _tiny(build):
    problem = build()
    problem.settings.console_out_progress = False
    problem.settings.linear_solver = "block-banded"
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


@pytest.fixture(scope="module")
def solvers(problems):
    itj = problems[0].backend.mesh_iterations[0]
    itt = problems[1].backend.mesh_iterations[0]
    return itj.build_solver(JaxOptions(**OPTS)), \
        itt.build_solver(IPMOptions(**OPTS))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol)


def _cancel_scale(itt, mu, x, theta, dx):
    """Dinv |J dx| per instance.  dlam is recovered as Dinv (J dx + g~)
    with Dinv = 1/dc (1e7 here): the two terms cancel, so dx's last-bit
    rounding reaches dlam times 1e7, and dlam is held to a fraction of the
    size of what cancels."""
    dc = torch.clamp(1e-8 * mu ** 0.25,
                     min=max(1e-12, min(3e-7, 0.1 * OPTS["tol"])))
    jdx = jvp(lambda xx: itt.c_scaled(xx, theta), (x,), (dx,))[1]
    return (jdx.abs().amax(-1) / dc).numpy()


def test_structured_step_and_body_from_carried_state(problems, batch,
                                                     solvers):
    itj = problems[0].backend.mesh_iterations[0]
    itt = problems[1].backend.mesh_iterations[0]
    sj, st = solvers
    assert sj._compute_step_structured is not None
    assert st._compute_step_structured is not None
    x0, theta = batch
    thj = jnp.asarray(theta)
    # Two reference iterations, so the state is away from the start.
    state = jax.jit(jax.vmap(sj._init_state))(jnp.asarray(x0), thj)
    body = jax.jit(jax.vmap(sj._body))
    for _ in range(2):
        state = body(state, thj)
    n = sj.dims["n"]

    def jax_step(s, th):
        x = s.v[:n]
        _, c_vjp = jax.vjp(lambda xx: itj.c_scaled(xx, th), x)
        out = sj._compute_step_structured(
            s.v, s.lam, s.zl, s.zu, s.mu, s.dw_last, th,
            jax.grad(itj.f_scaled)(x, th), sj._g(s.v, th), c_vjp(s.lam)[0],
            c_vjp, s.rmode)
        return out[0], out[1], out[6]

    dv_j, dlam_j, ok_j = jax.jit(jax.vmap(jax_step))(state, thj)
    next_j = body(state, thj)

    ps = interop.ipm_state_from_numpy(
        {f: np.asarray(getattr(state, f)) for f in state._fields})
    th = _t(theta)
    x = ps.v[:, :n]
    gf = grad(lambda xx: itt.f_scaled(xx, th).sum())(x)
    _, c_vjp = vjp(lambda xx: itt.c_scaled(xx, th), x)
    out = st._compute_step_structured(
        ps.v, ps.lam, ps.zl, ps.zu, ps.mu, ps.dw_last, th, gf,
        st._g(ps.v, th), c_vjp(ps.lam)[0], c_vjp, ps.rmode)
    np.testing.assert_array_equal(out[6].numpy(), np.asarray(ok_j))
    assert out[6].all()
    _close(out[0].numpy(), dv_j, 1e-8)
    cancel = _cancel_scale(itt, ps.mu, x, th, out[0][:, :n])
    assert np.all(np.abs(out[1].numpy() - np.asarray(dlam_j))
                  <= 1e-8 * cancel[:, None])

    nxt = st._body(ps, th)
    for f in ("v", "zl", "zu", "mu"):
        _close(getattr(nxt, f).numpy(), getattr(next_j, f), 1e-8)
    assert np.all(np.abs(nxt.lam.numpy() - np.asarray(next_j.lam))
                  <= 1e-8 * cancel[:, None])


def test_batch_matches_reference(problems, batch, solvers):
    sj, _ = solvers
    x0, theta = batch
    rj = jax.jit(jax.vmap(sj))(jnp.asarray(x0), jnp.asarray(theta))
    res = solve_batched(problems[1].backend, theta_batch=theta, devices=CPU)
    itt = problems[1].backend.mesh_iterations[0]
    np.testing.assert_array_equal(res.converged, np.asarray(rj.converged))
    np.testing.assert_array_equal(res.iterations, np.asarray(rj.iterations))
    assert res.converged.all()
    np.testing.assert_allclose(res.objective * itt.w, np.asarray(rj.f),
                               rtol=1e-8, atol=0)


def test_batch_equals_instances_alone(problems, batch, solvers):
    _, solver = solvers
    x0, theta = _t(batch[0]), _t(batch[1])
    together = solver(x0, theta)
    for b in range(theta.shape[0]):
        alone = solver(x0[b:b + 1], theta[b:b + 1])
        assert int(alone.iterations[0]) == int(together.iterations[b])
        assert bool(alone.converged[0]) == bool(together.converged[b])
        np.testing.assert_allclose(alone.x[0].numpy(), together.x[b].numpy(),
                                   rtol=0, atol=1e-12)
        # the objective is the integral q, whose scale V is 100: 1e-12 in
        # the scaled x is ~2e-12 of f
        np.testing.assert_allclose(alone.f[0].numpy(), together.f[b].numpy(),
                                   rtol=1e-10, atol=0)


def test_escalation_moves_only_the_failing_instance(problems, batch):
    itt = problems[1].backend.mesh_iterations[0]
    kkt = itt.build_kkt_operator()
    derivs = dict(itt._build_structured_derivatives(), kkt=kkt)
    solver = build_ipm_solver(itt.f_scaled, itt.c_scaled, itt.xs_lb,
                              itt.xs_ub, itt.cl_scaled, itt.cu_scaled,
                              IPMOptions(**OPTS), derivatives=derivs)
    x0, theta = _t(batch[0]), _t(batch[1])
    state = solver._init_state(x0, theta)
    for _ in range(2):
        state = solver._body(state, theta)
    n = solver.dims["n"]
    factor = kkt.factor
    fail = None

    def failing_factor(blocks, dw):
        fac = factor(blocks, dw)
        if fail is not None and dw.dim() == 2:      # the (B, levels) ladder
            fac = fac._replace(ok=fac.ok & ~fail[:, None])
        return fac

    kkt.factor = failing_factor

    def step(s, th, mask):
        nonlocal fail
        fail = mask
        x = s.v[:, :n]
        gf = grad(lambda xx: itt.f_scaled(xx, th).sum())(x)
        _, c_vjp = vjp(lambda xx: itt.c_scaled(xx, th), x)
        out = solver._compute_step_structured(
            s.v, s.lam, s.zl, s.zu, s.mu, s.dw_last, th, gf,
            solver._g(s.v, th), c_vjp(s.lam)[0], c_vjp, s.rmode)
        return out[0], out[1], out[5], out[6]

    B = theta.shape[0]
    plain = step(state, theta, None)
    forced = step(state, theta, torch.arange(B) == 1)
    assert forced[3].all() and plain[3].all()
    assert float(forced[2][1]) > 0.0 == float(plain[2][1])
    for b in (0, 2, 3):
        for got, want in zip(forced[:3], plain[:3]):
            np.testing.assert_array_equal(got[b].numpy(), want[b].numpy())
    # alone, the instance's batched BLAS calls round differently (~1e-10
    # of the step), as in the whole-solve comparison above
    one = type(state)(*(f[1:2] for f in state))
    alone = step(one, theta[1:2], torch.ones(1, dtype=torch.bool))
    dv1 = forced[0][1].numpy()
    np.testing.assert_allclose(alone[0][0].numpy(), dv1, rtol=0,
                               atol=1e-9 * max(1.0, np.abs(dv1).max()))
    assert float(alone[2][0]) == float(forced[2][1])
    cancel = _cancel_scale(itt, one.mu, one.v[:, :n], theta[1:2],
                           forced[0][1:2, :n])
    assert np.all(np.abs(alone[1][0].numpy() - forced[1][1].numpy())
                  <= 1e-8 * cancel[0])


@pytest.mark.slow
def test_brachistochrone_problem_solve_block_banded():
    from brachistochrone import build_problem as brach_jax
    from brachistochrone_torch import build_problem as brach_torch
    objs = {}
    for name, build, kw in (("jax", brach_jax, {}),
                            ("torch", brach_torch, dict(device="cpu"))):
        problem = build()
        problem.settings.console_out_progress = False
        problem.settings.linear_solver = "block-banded"
        objs[name] = problem.solve(**kw).objective
        assert problem.mesh_tolerance_met, name
    assert objs["torch"] == pytest.approx(objs["jax"], rel=1e-8)
    assert objs["torch"] == pytest.approx(0.82434, rel=1e-4)
