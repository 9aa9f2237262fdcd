"""Twin of ``tests/integration/test_mixed_precision.py`` for the port.

The reference's own mixed configuration, ``IPMOptions(tol=1e-6,
max_iter=80, kkt_precision="mixed", dc_floor=1e-7, ir_rounds=3)`` with
defaults for the rest (f64 derivative assembly; GMRES(6) refinement, which
``dense_refine="auto"`` picks on the mixed path), and its f64 path
(``dc_floor=1e-12``), on a batch of perturbed cart-pole instances.  The
port's mixed path must pass the reference's gates, converged >= 0.99, the
relative objective difference < 1e-4 on >= 0.85 of the batch and < 1e-2 at
most, against its own f64 path, and against the JAX package's mixed and
f64 paths on the same instances (solved live, ``jax.jit(jax.vmap(...))``):

* ``tiny``: 2 sections x 4 nodes, B = 4, in the default run;
* ``default``: the default mesh (10 x 4), B = 8, as the reference (``slow``);
* ``cuda``: the default mesh, B = 8, on the card, where the mixed path
  factors through the hand-written kernel (launches counted), held against
  the port's f64 path on the card (skipped without one).

JAX is imported inside the CPU tests only.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from cart_pole_swing_up_torch import build_problem  # noqa: E402
from pycollo_tpu_torch.ops.block_chol import chol_inv  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.solver import ipm as ipm_mod  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

#: the reference test's options, per precision
OPTIONS = {prec: dict(tol=1e-6, max_iter=80, kkt_precision=prec,
                      dc_floor=1e-7 if prec == "mixed" else 1e-12,
                      ir_rounds=3)
           for prec in ("f64", "mixed")}
#: the benchmark sweep's mixed route (f32 assembly, GMRES(12))
SWEEP = dict(tol=1e-6, max_iter=80, kkt_precision="mixed", dc_floor=1e-7,
             dense_gmres_iters=12, eval_dtype="f32")
#: mesh sections and batch size per case
CASES = {"tiny": (2, 4), "default": (10, 8), "cuda": (10, 8)}


def _build(build, sections):
    problem = build()
    problem.settings.console_out_progress = False
    problem.settings.nlp_tolerance = 1e-6
    problem.phases[0].mesh.number_mesh_sections = sections
    problem.phases[0].mesh.number_mesh_section_nodes = 4
    problem.initialise()
    return problem


def _theta(it, B):
    """The reference test's perturbed initial states."""
    rng = np.random.default_rng(0)
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (B, 1))
    theta[:, pl.y_off + 0 * pl.N] = rng.uniform(-0.25, 0.25, B)
    theta[:, pl.y_off + 1 * pl.N] = rng.uniform(-0.3, 0.3, B)
    return theta


def _gates(label, mixed, f64):
    """The reference's agreement gates (``:61-64``)."""
    rel = np.abs(mixed - f64) / np.abs(f64)
    assert (rel < 1e-4).mean() >= 0.85, (label, rel)
    assert rel.max() < 1e-2, (label, rel)


def _port(problem, theta, device):
    objs = {}
    for prec, kw in OPTIONS.items():
        res = solve_batched(problem.backend, theta_batch=theta,
                            options=IPMOptions(**kw),
                            devices=[torch.device(device)])
        assert res.converged.mean() >= 0.99, (prec, res.converged.mean())
        objs[prec] = res.objective
    return objs


def _jax(sections, theta):
    import jax
    import jax.numpy as jnp
    from cart_pole_swing_up import build_problem as build_jax
    from pycollo_tpu.solver.ipm import IPMOptions as JaxOptions

    it = _build(build_jax, sections).backend.mesh_iterations[0]
    x0 = np.tile(it.xs_guess, (len(theta), 1))
    objs = {}
    for prec, kw in OPTIONS.items():
        solver = it.build_solver(JaxOptions(**kw))
        res = jax.jit(jax.vmap(solver))(jnp.asarray(x0), jnp.asarray(theta))
        assert np.asarray(res.converged).mean() >= 0.99, prec
        objs[prec] = np.asarray(res.f) / it.w
    return objs


@pytest.mark.parametrize("case", [
    "tiny", pytest.param("default", marks=pytest.mark.slow)])
def test_cart_pole_mixed_precision_batch(case):
    sections, B = CASES[case]
    problem = _build(build_problem, sections)
    theta = _theta(problem.backend.mesh_iterations[0], B)
    port = _port(problem, theta, "cpu")
    ref = _jax(sections, theta)
    _gates("port f64", port["mixed"], port["f64"])
    _gates("JAX f64", port["mixed"], ref["f64"])
    _gates("JAX mixed", port["mixed"], ref["mixed"])
    # the two f64 paths take exact Newton steps from the same start
    np.testing.assert_allclose(port["f64"], ref["f64"], rtol=1e-8)


@pytest.mark.parametrize("route", ["sweep", "reference"])
def test_cart_pole_dc_stays_at_the_set_floor(route, monkeypatch):
    """The mixed route raises dc where J^T J / dc would outgrow W by more
    than ``F32_SCALE_SPREAD``; on cart-pole (default mesh) it never does:
    the solve with the raise capped at nothing is the same bit for bit."""
    kw = SWEEP if route == "sweep" else OPTIONS["mixed"]
    problem = _build(build_problem, 10)
    theta = _theta(problem.backend.mesh_iterations[0], 4)

    def solve():
        return solve_batched(problem.backend, theta_batch=theta,
                             options=IPMOptions(**kw),
                             devices=[torch.device("cpu")])

    res = solve()
    monkeypatch.setattr(ipm_mod, "DC_LIFT_MAX", 0.0)
    fixed = solve()
    assert np.asarray(res.converged).all()
    for k in ("x_full", "iterations", "converged", "kkt_error"):
        assert np.array_equal(np.asarray(getattr(res, k)),
                              np.asarray(getattr(fixed, k))), k


@pytest.mark.cuda
def test_cart_pole_mixed_precision_batch_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sections, B = CASES["cuda"]
    problem = _build(build_problem, sections)
    theta = _theta(problem.backend.mesh_iterations[0], B)
    chol_inv.launches = 0
    port = _port(problem, theta, "cuda")
    assert chol_inv.launches > 0
    _gates("port f64 on the card", port["mixed"], port["f64"])
