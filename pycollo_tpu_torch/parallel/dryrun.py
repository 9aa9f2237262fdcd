"""Multi-device dry run: a batched solve sharded over n devices, held
against the same batch unsharded.

The counterpart of ``__graft_entry__.dryrun_multichip``: cart-pole swing-up
on a tiny mesh (2 sections x 4 nodes), B = 2n instances with perturbed
initial cart positions, every one of which must converge, and the sharded
solution equal to the unsharded one to 1e-9.  It builds the problem from
``examples/cart_pole_swing_up_torch.py``, so it runs from a checkout.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict

import numpy as np

from .batch import shard_devices, solve_theta_batch
from .scaling import cuda_devices

#: the largest sharded/unsharded difference of a solution component
MAX_DX = 1e-9
EXAMPLE = (Path(__file__).resolve().parents[2] / "examples"
           / "cart_pole_swing_up_torch.py")


def tiny_cart_pole():
    """Cart-pole on 2 sections x 4 nodes, its solver built with
    ``IPMOptions(tol=1e-6, max_iter=60)``; returns the mesh iteration."""
    from ..solver.ipm import IPMOptions

    spec = importlib.util.spec_from_file_location("cart_pole_swing_up_torch",
                                                  EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    problem = example.build_problem()
    problem.settings.console_out_progress = False
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = 2
    phase.mesh.number_mesh_section_nodes = 4
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    it.build_solver(IPMOptions(tol=1e-6, max_iter=60))
    return it


def dryrun_multichip(n_devices: int, devices=None) -> Dict:
    """Shard a batch of 2 * ``n_devices`` instances over ``devices``
    (default: the first ``n_devices`` CUDA cards; raises if there are
    fewer) and hold it against the unsharded solve on ``devices[0]``.

    Raises ``RuntimeError`` unless every instance converges and the
    solutions agree to :data:`MAX_DX`; returns the counts and the largest
    difference.
    """
    if devices is None:
        cards = cuda_devices()
        if len(cards) < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} CUDA devices, this process has "
                               f"{len(cards)}")
        devices = cards[:n_devices]
    devices = shard_devices(devices)
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for n_devices = "
                         f"{n_devices}")
    it = tiny_cart_pole()
    B = 2 * n_devices
    theta = np.tile(it.theta_default, (B, 1))
    # Perturb a pinned initial state per instance (MPC-style batch).
    theta[:, it.layout.phases[0].y_off] = np.linspace(-0.1, 0.1, B)

    sharded = solve_theta_batch(it, theta, devices=devices)
    n_conv = int(sharded.converged.sum())
    if n_conv != B:
        raise RuntimeError(f"only {n_conv}/{B} sharded instances converged")
    ref = solve_theta_batch(it, theta, devices=devices[:1])
    err = float(np.max(np.abs(sharded.x_full - ref.x_full)))
    if not err < MAX_DX:
        raise RuntimeError(f"sharded/unsharded solutions differ by "
                           f"{err:.2e} (limit {MAX_DX:g})")
    print(f"dryrun_multichip: {n_devices} shards on "
          f"{[str(d) for d in devices]}, batch {B}, converged {n_conv}/{B}, "
          f"sharded==unsharded (max |dx| = {err:.1e})", flush=True)
    return dict(n_devices=n_devices, batch=B, converged=n_conv, max_dx=err,
                solve_time=sharded.solve_time)
