"""The port's entry points solve on the CUDA card unless the CPU is named.

Without a CUDA device (``torch.cuda.is_available`` patched to False, so the
tests mean the same on any host) each entry point raises, and names
``device='cpu'`` in its message; with the CPU named it solves.  The
``cuda``-marked test runs on a card: there the default is the card.

The problem is the brachistochrone on 4 mesh sections, one mesh iteration.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pycollo_tpu_torch.parallel.batch import solve_batched
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
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_the_cpu_named_without_cuda(problem, monkeypatch,
                                                      entry):
    default_call, cpu_call, ok = ENTRY_POINTS[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_call(problem)
    assert ok(problem, cpu_call(problem))


@pytest.mark.cuda
def test_default_device_is_the_card(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = _last(problem).solve()
    assert result.ipm_result.x.device.type == "cuda" and result.converged
