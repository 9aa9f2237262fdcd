"""The port's multi-device batched solving against the JAX package.

The twin of ``tests/integration/test_parallel.py``, on cart-pole swing-up
at 2 mesh sections x 4 nodes in both packages, on the CPU in f64:

* perturbed initial angles (``overrides``): the same convergence flags as
  the JAX package's ``solve_batched`` and objectives to 1e-8;
* a batch of 16 sharded over ``[cpu] * k``: what the unsharded solve gives,
  to 1e-12 (the same arithmetic per instance), in the original order, and
  the JAX package's solve sharded over its 8 virtual devices to 1e-8;
* the weak-scaling harness and the dry run over two CPU shards;
* a failing shard raises in the caller, naming the shard and its device;
  device lists that mix types, or outnumber the instances, raise;
* the kernel wrappers' counters count exactly under threads.

Two shards on one card: ``tests/test_torch_devices.py`` (``cuda`` marker)
and ``chip_smoke.py``'s ``multi`` phase.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from cart_pole_swing_up import build_problem as build_jax  # noqa: E402
from cart_pole_swing_up_torch import build_problem as build_torch  # noqa: E402
from pycollo_tpu.parallel.batch import solve_batched as jax_solve_batched  # noqa: E402
from pycollo_tpu.solver.ipm import IPMOptions as JaxOptions  # noqa: E402
from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from pycollo_tpu_torch.parallel.scaling import (  # noqa: E402
    measure_scaling_efficiency)
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
OPTIONS = dict(tol=1e-6, max_iter=60)


def _tiny(build, options):
    problem = build()
    problem.settings.console_out_progress = False
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = 2
    phase.mesh.number_mesh_section_nodes = 4
    problem.initialise()
    problem.backend.mesh_iterations[-1].build_solver(options)
    return problem.backend


@pytest.fixture(scope="module")
def backends():
    return (_tiny(build_jax, JaxOptions(**OPTIONS)),
            _tiny(build_torch, IPMOptions(**OPTIONS)))


@pytest.fixture(scope="module")
def theta16(backends):
    """16 instances with perturbed initial cart positions (the JAX test's
    batch)."""
    it = backends[1].mesh_iterations[-1]
    theta = np.tile(it.theta_default, (16, 1))
    theta[:, it.layout.phases[0].y_off] = np.linspace(-0.1, 0.1, 16)
    return theta


@pytest.fixture(scope="module")
def unsharded16(backends, theta16):
    return solve_batched(backends[1], theta_batch=theta16, devices=[CPU])


def test_batched_solve_perturbed_instances(backends):
    """Perturbed initial angles solve as the JAX package solves them."""
    q2_0 = np.linspace(-0.2, 0.2, 8)
    overrides = {(0, "y", 1, 0): q2_0}
    ref = jax_solve_batched(backends[0], overrides=overrides)
    res = solve_batched(backends[1], overrides=overrides, devices=[CPU])
    np.testing.assert_array_equal(res.converged, ref.converged)
    assert res.converged.sum() >= 7
    np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-8)
    assert res.objective.std() > 1e-3
    # The pinned initial angle is reproduced in each instance's solution.
    pl = backends[1].mesh_iterations[-1].layout.phases[0]
    np.testing.assert_allclose(res.x_full[:, pl.y_off + 1 * pl.N], q2_0,
                               atol=1e-12)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_sharded_solve_equals_unsharded(backends, theta16, unsharded16, k):
    """k shards of the 16 (3 shards: 6, 5, 5) give the unsharded answers in
    order."""
    res = solve_batched(backends[1], theta_batch=theta16, devices=[CPU] * k)
    assert res.converged.all()
    np.testing.assert_array_equal(res.iterations, unsharded16.iterations)
    np.testing.assert_allclose(res.x_full, unsharded16.x_full, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res.objective, unsharded16.objective,
                               rtol=1e-12, atol=0)
    assert res.solve_time > 0


def test_sharded_solve_matches_jax_on_eight_devices(backends, theta16):
    devices = jax.devices()
    assert len(devices) == 8, "conftest must provide 8 virtual devices"
    ref = jax_solve_batched(backends[0], theta_batch=theta16, devices=devices)
    res = solve_batched(backends[1], theta_batch=theta16, devices=[CPU] * 4)
    assert ref.converged.all() and res.converged.all()
    np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-8)
    np.testing.assert_allclose(res.x_full, ref.x_full, rtol=0, atol=1e-8)


def test_scaling_efficiency_harness(backends):
    result = measure_scaling_efficiency(
        backends[1].mesh_iterations[-1], per_device_batch=2,
        devices=[CPU] * 2, n_rep=1)
    assert result.n_devices == 2 and result.per_device_batch == 2
    assert result.single_device_solves_per_sec > 0
    assert result.all_devices_solves_per_sec > 0
    # Two shards share this host's cores: only a sanity range.
    assert 0.0 < result.efficiency <= 1.5


def test_dryrun_multichip_on_two_cpu_shards():
    out = dryrun_multichip(2, devices=[CPU] * 2)
    assert out["converged"] == out["batch"] == 4
    assert out["max_dx"] < 1e-9


def test_failing_shard_raises_in_the_caller(backends, theta16, monkeypatch):
    """The shard holding the marked instance fails; the caller sees which
    shard, on which device, and the shard's own exception as the cause."""
    it = backends[1].mesh_iterations[-1]
    solver = it._solver
    col = it.layout.phases[0].y_off
    theta = theta16[:6].copy()
    theta[3, col] = 99.0                       # shard 1 of 3: rows 2, 3

    def failing(x0, th):
        if bool((th[:, col] == 99.0).any()):
            raise FloatingPointError("marked instance")
        return solver(x0, th)

    monkeypatch.setattr(it, "_solver", failing)
    with pytest.raises(RuntimeError, match=r"shard 1 of 3 .* on cpu") as info:
        solve_batched(backends[1], theta_batch=theta, devices=[CPU] * 3)
    assert isinstance(info.value.__cause__, FloatingPointError)


@pytest.mark.parametrize("devices", [
    [CPU, torch.device("cuda")],
    [torch.device("cuda", 0), CPU],
    [CPU, torch.device("meta")],
])
def test_device_types_may_not_mix(backends, devices):
    with pytest.raises(ValueError, match="mixes device types"):
        solve_batched(backends[1], batch_size=4, devices=devices)


def test_more_shards_than_instances_raises(backends):
    with pytest.raises(ValueError, match="cannot fill 4 shards"):
        solve_batched(backends[1], batch_size=3, devices=[CPU] * 4)


class _YieldingCount(int):
    """A count whose ``+ 1`` hands the interpreter to another thread between
    the read of the counter and its write, so an unlocked ``calls += 1``
    run from several threads loses counts."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingCount(int(self) + other)


def test_counters_are_exact_under_threads():
    """8 threads call blocked_chol_linv at once, each yielding to the others
    inside every increment of the counter: no call is lost."""
    per_thread = 50
    A = torch.eye(3, dtype=torch.float64)[None] * 2.0
    blocked_chol_linv.calls = _YieldingCount(0)
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(per_thread):
            blocked_chol_linv(A)

    threads = [threading.Thread(target=work) for _ in range(8)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert blocked_chol_linv.calls == 8 * per_thread
    finally:
        blocked_chol_linv.calls = 0
