"""Two-process ``torch.distributed`` harness of the port on the CPU.

The twin of ``tests/integration/test_multihost.py``: two local processes
join a gloo process group (``parallel/multihost.py``), each solves its
block of a global batch of brachistochrones whose pinned final x runs over
``linspace(1.8, 2.2, 4)`` (two per process), and the ranks reduce the
converged count and the slowest time.  Both ranks must report all 4
converged; rank 0's objectives must equal a single-process solve of its
block through the port, and every rank's the JAX package's
``solve_batched`` on the same targets, to 1e-8.  The workers import the
port alone (no jax, nothing of ``pycollo_tpu``), and each run is stopped
after 300 s.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "examples"))

from brachistochrone import build_problem as build_jax  # noqa: E402
from brachistochrone_torch import build_problem as build_torch  # noqa: E402
from pycollo_tpu.parallel.batch import solve_batched as jax_solve_batched  # noqa: E402
from pycollo_tpu.solver.ipm import IPMOptions as JaxOptions  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.parallel.multihost import run_local_ranks  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

WORLD = 2
B_LOCAL = 2
TARGETS = np.linspace(1.8, 2.2, B_LOCAL * WORLD)
OPTIONS = dict(tol=1e-8, max_iter=60)
TIMEOUT = 300

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
sys.path.insert(0, %(repo)r + "/examples")
from brachistochrone_torch import build_problem
from pycollo_tpu_torch.parallel import multihost
from pycollo_tpu_torch.solver.ipm import IPMOptions

rank, world, address = int(sys.argv[-3]), int(sys.argv[-2]), sys.argv[-1]
cpu = torch.device("cpu")
multihost.initialize(address, world, rank, device="cpu")
try:
    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    it.build_solver(IPMOptions(**%(options)r))
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (%(b_local)d, 1))
    targets = np.asarray(%(targets)r)
    theta[:, pl.y_off + pl.N - 1] = targets[rank * %(b_local)d:
                                            (rank + 1) * %(b_local)d]
    out = multihost.solve_batched_global(it, theta_local=theta,
                                         devices=[cpu])
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "pycollo_tpu"))
    multihost.report(dict(
        rank=rank, local_objective=out.local_objective.tolist(),
        local_converged=out.local_converged.tolist(),
        global_converged=out.global_converged,
        global_batch=out.global_batch, solve_time=out.solve_time,
        imported=imported))
finally:
    multihost.shutdown()
"""


def _theta(it, rows):
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (len(rows), 1))
    theta[:, pl.y_off + pl.N - 1] = TARGETS[rows]
    return theta


def _initialised(build):
    problem = build()
    problem.settings.console_out_progress = False
    problem.initialise()
    return problem.backend


def test_two_process_distributed_solve():
    code = _WORKER % dict(repo=str(REPO), options=OPTIONS, b_local=B_LOCAL,
                          targets=TARGETS.tolist())
    outs = run_local_ranks([sys.executable, "-c", code], WORLD, TIMEOUT)
    assert [o["rank"] for o in outs] == list(range(WORLD))
    for o in outs:
        assert o["imported"] == [], o["imported"]
        assert o["global_batch"] == B_LOCAL * WORLD
        assert o["global_converged"] == B_LOCAL * WORLD
        assert all(o["local_converged"])
        assert np.isfinite(o["local_objective"]).all()
    # The slowest rank's time, reduced: every rank reports the same.
    assert outs[0]["solve_time"] == outs[1]["solve_time"] > 0

    # Rank 0's block in one process, through the port.
    port = _initialised(build_torch)
    itt = port.mesh_iterations[0]
    itt.build_solver(IPMOptions(**OPTIONS))
    ref = solve_batched(port, theta_batch=_theta(itt, np.arange(B_LOCAL)),
                        devices=[torch.device("cpu")])
    assert ref.converged.all()
    np.testing.assert_allclose(outs[0]["local_objective"], ref.objective,
                               rtol=1e-8)

    # The whole batch through the JAX package, in this process.
    jax_backend = _initialised(build_jax)
    itj = jax_backend.mesh_iterations[0]
    itj.build_solver(JaxOptions(**OPTIONS))
    ref_j = jax_solve_batched(
        jax_backend, theta_batch=_theta(itj, np.arange(B_LOCAL * WORLD)))
    assert ref_j.converged.all()
    got = np.concatenate([o["local_objective"] for o in outs])
    np.testing.assert_allclose(got, ref_j.objective, rtol=1e-8)
    # Objectives grow with the target's distance (a farther final x takes
    # longer to reach).
    assert np.all(np.diff(got) > 0)


def test_ranks_that_fail_are_reported_with_their_output():
    """A rank that exits with an error fails the run, with its output."""
    code = ("import sys\n"
            "print('rank', sys.argv[-3], 'of', sys.argv[-2], flush=True)\n"
            "sys.exit(3 if sys.argv[-3] == '1' else 0)\n")
    with pytest.raises(RuntimeError, match=r"rank 1: exit 3") as info:
        run_local_ranks([sys.executable, "-c", code], WORLD, 60)
    assert "rank 1 of 2" in str(info.value)


def test_ranks_that_hang_are_stopped():
    code = "import time\ntime.sleep(60)\n"
    with pytest.raises(RuntimeError, match="stopped after 2 s"):
        run_local_ranks([sys.executable, "-c", code], WORLD, 2)
