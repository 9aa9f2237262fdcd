"""The port's entry points solve on the CUDA card unless the CPU is named.

Without a CUDA device (``torch.cuda.is_available`` patched to False, so the
tests mean the same on any host) each entry point raises, and names
``device='cpu'`` in its message; with the CPU named it solves.  The
``cuda``-marked tests run on a card: there the default is the card, and two
shards of the card give the unsharded answers.

The problem is the brachistochrone on 4 mesh sections, one mesh iteration.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pycollo_tpu_torch.parallel import multihost
from pycollo_tpu_torch.parallel.batch import solve_batched
from pycollo_tpu_torch.parallel.dryrun import dryrun_multichip
from pycollo_tpu_torch.parallel.scaling import measure_scaling_efficiency
from pycollo_tpu_torch.refinement import run_mesh_refinement_loop

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))

from brachistochrone_torch import build_problem  # noqa: E402

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def problem():
    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.settings.max_mesh_iterations = 1
    problem.phases[0].mesh.number_mesh_sections = 4
    problem.initialise()
    return problem


def _last(problem):
    return problem.backend.mesh_iterations[-1]


def _in_cpu_group(call):
    """``call(device)`` as the one rank of a process group on the CPU, with
    the device that ``multihost.initialize`` returned."""
    device = multihost.initialize(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                  device="cpu")
    try:
        return call(device)
    finally:
        multihost.shutdown()


#: entry point -> (call without a device, call naming the CPU, check of
#: what the CPU call returned)
ENTRY_POINTS = {
    "OptimalControlProblem.solve": (
        lambda p: p.solve(),
        lambda p: p.solve(device="cpu"),
        lambda p, out: np.isfinite(out.objective)),
    "OptimalControlProblem.solve_batched": (
        lambda p: p.solve_batched(batch_size=2),
        lambda p: p.solve_batched(batch_size=2, devices=[CPU]),
        lambda p, out: out.converged.all()),
    "parallel.batch.solve_batched": (
        lambda p: solve_batched(p.backend, batch_size=2),
        lambda p: solve_batched(p.backend, batch_size=2, devices=[CPU]),
        lambda p, out: out.converged.all()),
    "MeshIteration.solve": (
        lambda p: _last(p).solve(),
        lambda p: _last(p).solve(device="cpu"),
        lambda p, out: out.converged),
    "run_mesh_refinement_loop": (
        lambda p: run_mesh_refinement_loop(p.backend, display=False),
        lambda p: run_mesh_refinement_loop(p.backend, display=False,
                                           device="cpu"),
        lambda p, out: out.iterations[0].converged),
    "parallel.scaling.measure_scaling_efficiency": (
        lambda p: measure_scaling_efficiency(_last(p), per_device_batch=2,
                                             n_rep=1),
        lambda p: measure_scaling_efficiency(_last(p), per_device_batch=2,
                                             devices=[CPU], n_rep=1),
        lambda p, out: out.single_device_solves_per_sec > 0),
    "parallel.multihost.initialize": (
        lambda p: multihost.initialize("127.0.0.1:29500", 1, 0),
        lambda p: _in_cpu_group(lambda dev: (dev, dist.get_backend())),
        lambda p, out: out == (CPU, "gloo")),
    "parallel.multihost.solve_batched_global": (
        lambda p: multihost.solve_batched_global(_last(p), per_host_batch=2),
        lambda p: _in_cpu_group(lambda dev: multihost.solve_batched_global(
            _last(p), per_host_batch=2, devices=[dev])),
        lambda p, out: out.global_converged == out.global_batch == 2),
    "parallel.dryrun.dryrun_multichip": (
        lambda p: dryrun_multichip(2),
        lambda p: dryrun_multichip(2, devices=[CPU, CPU]),
        lambda p, out: out["converged"] == 4),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_the_cpu_named_without_cuda(problem, monkeypatch,
                                                      entry):
    default_call, cpu_call, ok = ENTRY_POINTS[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_call(problem)
    assert ok(problem, cpu_call(problem))


def test_block_banded_builds_and_needs_the_cpu_named_without_cuda(
        problem, monkeypatch):
    """The block-banded path builds its structured solver, and its batched
    solve keeps the rule: without CUDA it raises unless the CPU is named."""
    problem.settings.linear_solver = "block-banded"
    solver = _last(problem).build_solver()
    assert solver._compute_step_structured is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_batched(problem.backend, batch_size=2)
    out = solve_batched(problem.backend, batch_size=2, devices=[CPU])
    assert out.converged.all()
    assert _last(problem)._solver is solver


@pytest.mark.cuda
def test_default_device_is_the_card(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = _last(problem).solve()
    assert result.ipm_result.x.device.type == "cuda" and result.converged


@pytest.mark.cuda
def test_two_shards_on_the_card_equal_unsharded(problem):
    """Two entries of one card (one batch on it) give the unsharded f64
    answers, and so does the dry run over two entries of the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    theta = np.tile(_last(problem).theta_default, (4, 1))
    one = solve_batched(problem.backend, theta_batch=theta, devices=[card])
    two = solve_batched(problem.backend, theta_batch=theta,
                        devices=[card, card])
    assert one.converged.all() and two.converged.all()
    np.testing.assert_allclose(two.objective, one.objective, rtol=1e-8)
    assert dryrun_multichip(2, devices=[card, card])["converged"] == 4
