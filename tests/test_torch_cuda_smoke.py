"""Twin of ``tests/integration/test_tpu_smoke.py`` for the port: a tiny
batched cart-pole solve on the card (``cuda`` marker; skipped without a
CUDA device).

The reference's batch: cart-pole swing-up on 4 sections x 4 nodes, B = 4
instances with q1(0) perturbed in [-0.1, 0.1], solved through
``solve_batched`` on the card in mode ``f64`` (``IPMOptions(tol=1e-6,
max_iter=60)``) and ``mixed`` (the scored bench configuration:
``kkt_precision="mixed"``, ``dc_floor=1e-7``, ``dense_gmres_iters=12``,
``eval_dtype="f32"``; the factorization through the hand-written kernel,
whose launches are counted).  The reference's gates: every instance
converges, and every objective lies in (40, 80) (the tiny mesh's value is
within a few percent of the converged 58.3 work integral).  Nothing here
imports JAX: run it on the card with
``python -m pytest tests/test_torch_cuda_smoke.py -m cuda --noconftest``.
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
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

MODES = {
    "f64": dict(tol=1e-6, max_iter=60),
    "mixed": dict(tol=1e-6, max_iter=60, kkt_precision="mixed",
                  dc_floor=1e-7, dense_gmres_iters=12, eval_dtype="f32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_batched_cart_pole_smoke(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    problem = build_problem()
    problem.settings.console_out_progress = False
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = 4
    phase.mesh.number_mesh_section_nodes = 4
    problem.initialise()
    it = problem.backend.mesh_iterations[0]

    B = 4
    rng = np.random.default_rng(0)
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (B, 1))
    theta[:, pl.y_off] = rng.uniform(-0.1, 0.1, B)
    chol_inv.launches = 0
    res = solve_batched(problem.backend, theta_batch=theta,
                        options=IPMOptions(**MODES[mode]),
                        devices=[torch.device("cuda")])
    if mode == "mixed":
        assert chol_inv.launches > 0
    else:
        assert chol_inv.launches == 0
    assert int(res.converged.sum()) == B, res.kkt_error
    for obj in res.objective:
        assert 40.0 < obj < 80.0, res.objective
