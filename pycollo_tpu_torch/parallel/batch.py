"""Batched solves of one OCP over many instances.

The compiled NLP of a mesh iteration is a function of
``(x0_scaled, theta)``, so many perturbed instances (different initial
states, endpoint targets, fixed times or parameters — any entry of
``theta``) solve simultaneously: the batch-first interior-point solver
advances all of them in one set of batched tensor operations on one
device.  Sharding the batch across devices is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..utils import solve_device


@dataclass
class BatchedSolveResult:
    """Results of a batched solve (leading axis = instance)."""

    x_full: np.ndarray          # (B, n_full) unscaled full variable vectors
    objective: np.ndarray       # (B,)
    converged: np.ndarray       # (B,) bool
    iterations: np.ndarray      # (B,)
    kkt_error: np.ndarray       # (B,)
    solve_time: float = 0.0


def make_theta_batch(iteration, overrides: Dict) -> np.ndarray:
    """Build a (B, n_full) theta batch from variable-reference overrides.

    ``overrides`` maps *full-vector indices* (or ``("phase", i, "y", j,
    "node", k)``-style tuples resolved by :func:`resolve_theta_index`) to
    (B,)-shaped arrays.
    """
    sizes = {np.asarray(v).shape[0] for v in overrides.values()}
    if len(sizes) != 1:
        raise ValueError("All override arrays must share the batch size.")
    B = sizes.pop()
    theta = np.tile(iteration.theta_default, (B, 1))
    for key, values in overrides.items():
        idx = resolve_theta_index(iteration, key)
        theta[:, idx] = np.asarray(values)
    return theta


def resolve_theta_index(iteration, key) -> int:
    """Resolve an override key to an index of the full variable vector.

    Accepted keys: plain integers (direct indices), or tuples
    ``(phase_index, kind, var_index, node_index)`` with kind in
    ``{"y", "u", "q", "t"}`` (node_index ignored for q/t; for t,
    var_index 0 = t0, 1 = tF), or ``("s", i)``.
    """
    if isinstance(key, (int, np.integer)):
        return int(key)
    lay = iteration.layout
    if key[0] == "s":
        return lay.s_off + int(key[1])
    p, kind, var = key[0], key[1], int(key[2])
    pl = lay.phases[int(p)]
    if kind == "y":
        node = int(key[3])
        return pl.y_off + var * pl.N + (node % pl.N)
    if kind == "u":
        node = int(key[3])
        return pl.u_off + var * pl.N + (node % pl.N)
    if kind == "q":
        return pl.q_off + var
    if kind == "t":
        return pl.t_off + var
    raise KeyError(key)


def solve_batched(backend, overrides=None, batch_size: Optional[int] = None,
                  devices=None, theta_batch: Optional[np.ndarray] = None,
                  x0_batch: Optional[np.ndarray] = None,
                  options=None) -> BatchedSolveResult:
    """Solve a batch of perturbed instances of the current mesh iteration.

    ``devices``: a sequence holding the one torch device to solve on
    (default: the CUDA card; ``[torch.device("cpu")]`` for the CPU, and
    without a CUDA device the CPU must be named).  More than one device is
    not supported yet.
    ``options``: build the iteration's solver with these ``IPMOptions``
    (default: reuse the iteration's solver, or build one from the
    problem settings).
    """
    import time

    devices = list(devices) if devices is not None else [torch.device("cuda")]
    if len(devices) != 1:
        raise NotImplementedError(
            "solve_batched runs on exactly one device; multi-device "
            "solves are not ported yet (ROADMAP A.10).")
    device = solve_device(devices[0])
    iteration = backend.mesh_iterations[-1]
    if theta_batch is None:
        if overrides:
            theta_batch = make_theta_batch(iteration, overrides)
        else:
            B = batch_size or 1
            theta_batch = np.tile(iteration.theta_default, (B, 1))
    theta_batch = np.asarray(theta_batch)
    B = theta_batch.shape[0]
    if x0_batch is None:
        x0_batch = np.tile(iteration.xs_guess, (B, 1))

    if iteration._solver is None or options is not None:
        iteration.build_solver(options)
    solver = iteration._solver

    kw = dict(dtype=iteration.dtype, device=device)
    theta_t = torch.as_tensor(theta_batch, **kw)
    x0_t = torch.as_tensor(x0_batch, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res = solver(x0_t, theta_t)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    x_full = iteration.assemble_full(res.x, theta_t).cpu().numpy()
    return BatchedSolveResult(
        x_full=x_full,
        objective=res.f.cpu().numpy() / iteration.w,
        converged=res.converged.cpu().numpy(),
        iterations=res.iterations.cpu().numpy(),
        kkt_error=res.kkt_error.cpu().numpy(),
        solve_time=dt)
