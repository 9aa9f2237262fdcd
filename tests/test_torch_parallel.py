"""The port's multi-device batched solving against the JAX package.

The twin of ``tests/integration/test_parallel.py``, on cart-pole swing-up
at 2 mesh sections x 4 nodes in both packages, on the CPU in f64:

* perturbed initial angles (``overrides``): the same convergence flags as
  the JAX package's ``solve_batched`` and objectives to 1e-8;
* entries that repeat a device are one block: a batch of 16 over
  ``[cpu] * k`` (k = 2, 3, 4) is one ``_solve_shard`` call in the calling
  thread, bit for bit the ``[cpu]`` solve, and over ``[cpu] * 4`` it
  matches the JAX package's solve sharded over its 8 virtual devices to
  1e-8; a list that mixes a repeated entry with a distinct one (``cpu:0``)
  keeps the instance order, to 1e-12;
* the weak-scaling harness and the dry run over two CPU shards;
* a failing block raises in the caller, naming the block and its device;
  device lists that mix types, or outnumber the instances, raise;
* the kernel wrappers' counters count exactly under threads.

Two entries of one card: ``tests/test_torch_devices.py`` (``cuda``
marker) and ``chip_smoke.py``'s ``multi`` phase.
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
from pycollo_tpu_torch.parallel import batch  # noqa: E402
from pycollo_tpu_torch.parallel.batch import (  # noqa: E402
    device_blocks, solve_batched)
from pycollo_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from pycollo_tpu_torch.parallel.scaling import (  # noqa: E402
    measure_scaling_efficiency)
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")
#: a CPU device that compares unequal to ``CPU``: a distinct entry
CPU0 = torch.device("cpu", 0)
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
def test_sharded_solve_equals_unsharded(backends, theta16, unsharded16, k,
                                        monkeypatch):
    """``[cpu] * k`` solves the 16 in one ``_solve_shard`` call, in the
    calling thread, with no thread started: bit for bit the ``[cpu]``
    solve, in order."""
    calls = []
    solve_shard = batch._solve_shard

    def counted(iteration, device, theta, x0):
        calls.append((device, len(theta),
                      threading.current_thread() is threading.main_thread(),
                      threading.active_count()))
        return solve_shard(iteration, device, theta, x0)

    monkeypatch.setattr(batch, "_solve_shard", counted)
    before = threading.active_count()
    res = solve_batched(backends[1], theta_batch=theta16, devices=[CPU] * k)
    assert calls == [(CPU, 16, True, before)]
    assert res.blocks == (("cpu", 16),)
    assert res.converged.all() and res.solve_time > 0
    for key in ("x_full", "objective", "converged", "iterations",
                "kkt_error"):
        np.testing.assert_array_equal(getattr(res, key),
                                      getattr(unsharded16, key))


@pytest.mark.parametrize("devices, blocks", [
    ([CPU, CPU, CPU0], (("cpu", 11), ("cpu:0", 5))),
    ([CPU0, CPU, CPU0], (("cpu:0", 11), ("cpu", 5))),
])
def test_repeated_and_distinct_entries_keep_instance_order(
        backends, theta16, unsharded16, devices, blocks):
    """The 16 split 6, 5, 5 over the entries; each device's entries pool
    into one contiguous block, in the order the device first appears, and
    the answers come back in the original order."""
    assert [(str(d), b - a) for d, a, b in device_blocks(devices, 16)] \
        == list(blocks)
    res = solve_batched(backends[1], theta_batch=theta16, devices=devices)
    assert res.blocks == blocks
    np.testing.assert_array_equal(res.iterations, unsharded16.iterations)
    np.testing.assert_allclose(res.x_full, unsharded16.x_full, rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res.objective, unsharded16.objective,
                               rtol=1e-12, atol=0)


def test_device_blocks_pool_the_tensor_split_shares():
    a, b, c = CPU, CPU0, torch.device("meta")
    assert device_blocks([a, a, b], 9) == [(a, 0, 6), (b, 6, 9)]
    # shares 3, 3, 2, 2
    assert device_blocks([a, b, a, c], 10) == [(a, 0, 5), (b, 5, 8),
                                               (c, 8, 10)]
    assert device_blocks([a] * 4, 7) == [(a, 0, 7)]


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
    # The two entries are one batch of 4 on the CPU: only a sanity range.
    assert result.blocks == (("cpu", 4),)
    assert 0.0 < result.efficiency <= 1.5


def test_dryrun_multichip_on_two_cpu_shards():
    out = dryrun_multichip(2, devices=[CPU] * 2)
    assert out["converged"] == out["batch"] == 4
    assert out["blocks"] == (("cpu", 4),)
    assert out["max_dx"] < 1e-9


def test_failing_shard_raises_in_the_caller(backends, theta16, monkeypatch):
    """The block holding the marked instance fails in its thread; the caller
    sees which block, on which device, and the block's own exception as the
    cause.  One block runs in the calling thread and raises as it is."""
    it = backends[1].mesh_iterations[-1]
    solver = it._solver
    col = it.layout.phases[0].y_off
    theta = theta16[:6].copy()
    theta[4, col] = 99.0                       # block 1 of 2: rows 4, 5

    def failing(x0, th):
        if bool((th[:, col] == 99.0).any()):
            raise FloatingPointError("marked instance")
        return solver(x0, th)

    monkeypatch.setattr(it, "_solver", failing)
    with pytest.raises(RuntimeError,
                       match=r"block 1 of 2 \(2 instances\) on cpu:0") as info:
        solve_batched(backends[1], theta_batch=theta,
                      devices=[CPU, CPU, CPU0])
    assert isinstance(info.value.__cause__, FloatingPointError)
    with pytest.raises(FloatingPointError, match="marked instance"):
        solve_batched(backends[1], theta_batch=theta, devices=[CPU] * 3)


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
