"""Batched and sharded solves of one OCP over many instances.

The compiled NLP of a mesh iteration is a function of
``(x0_scaled, theta)``, so many perturbed instances (different initial
states, endpoint targets, fixed times or parameters — any entry of
``theta``) solve simultaneously: the batch-first interior-point solver
advances all of them in one set of batched tensor operations on one
device.  Given several devices, :func:`solve_batched` splits the batch
into contiguous shards, one per device, and solves each shard on its own
device, in its own thread and CUDA stream.  The shards share no data but
the solver's constant tables, but they do share the interpreter lock and
``utils.FORWARD_AD_LOCK``, which every derivative evaluation takes: on
this host-bound solver they take turns at every IPM iteration and are not
expected to scale, on one card or across cards (``PERF.md``).
Throughput over several cards goes through
:mod:`~pycollo_tpu_torch.parallel.multihost`, one process per card.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

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

    Instances whose ``theta`` pins different values for fixed variables
    (initial conditions, parameters, endpoint targets) solve in one
    batched interior-point call; see :func:`solve_theta_batch` for
    ``devices`` and ``options``.
    """
    iteration = backend.mesh_iterations[-1]
    if theta_batch is None:
        if overrides:
            theta_batch = make_theta_batch(iteration, overrides)
        else:
            B = batch_size or 1
            theta_batch = np.tile(iteration.theta_default, (B, 1))
    return solve_theta_batch(iteration, theta_batch, x0_batch=x0_batch,
                             devices=devices, options=options)


def shard_devices(devices) -> List[torch.device]:
    """The torch devices of a ``devices`` argument (default: the CUDA card).

    Raises ``ValueError`` for an empty list or one that mixes device types,
    and ``RuntimeError`` when CUDA is asked for and none is available.  A
    CUDA device without an index becomes the current card.
    """
    devices = [torch.device(d) for d in devices] if devices is not None \
        else [torch.device("cuda")]
    if not devices:
        raise ValueError("devices is empty")
    types = sorted({d.type for d in devices})
    if len(types) > 1:
        raise ValueError(f"devices mixes device types {types}: every shard "
                         f"must run on the same kind of device")
    devices = [solve_device(d) for d in devices]
    if devices[0].type == "cuda":
        devices = [d if d.index is not None
                   else torch.device("cuda", torch.cuda.current_device())
                   for d in devices]
    return devices


def solve_theta_batch(iteration, theta_batch: np.ndarray,
                      x0_batch: Optional[np.ndarray] = None, devices=None,
                      options=None) -> BatchedSolveResult:
    """Solve the (B, n_full) ``theta_batch`` of ``iteration`` (from
    ``x0_batch``, default the iteration's guess for every instance).

    ``devices``: a sequence of torch devices (default: the CUDA card;
    ``[torch.device("cpu")]`` for the CPU, and without a CUDA device the
    CPU must be named).  With one device the batch is solved there in the
    calling thread.  With k devices it is split into k contiguous shards
    in order (``torch.tensor_split``: the first ``B % k`` shards take one
    instance more), and shard i is solved on ``devices[i]`` by a thread of
    its own, which copies its inputs to the device and, on a card, runs
    under ``torch.cuda.device`` and a CUDA stream of its own; the results
    are concatenated in the original order.  An entry may repeat: each
    entry is one shard, so ``[torch.device("cpu")] * 4`` runs four shards
    on the CPU and ``[torch.device("cuda:0")] * 2`` two on one card.  The
    device types may not mix (``ValueError``).  An exception in a shard is
    raised here, naming the shard and its device; no shard is solved
    again elsewhere.

    ``options``: build the iteration's solver with these ``IPMOptions``
    (default: reuse the iteration's solver, or build one from the problem
    settings); it is built once, before any shard starts.

    ``solve_time`` runs from the first shard's start (its inputs on its
    device) to the last shard's synchronisation with its stream.
    """
    devices = shard_devices(devices)
    theta_batch = np.asarray(theta_batch)
    B = theta_batch.shape[0]
    if x0_batch is None:
        x0_batch = np.tile(iteration.xs_guess, (B, 1))
    if B < len(devices):
        raise ValueError(f"a batch of {B} cannot fill {len(devices)} shards")
    if iteration._solver is None or options is not None:
        iteration.build_solver(options)

    if len(devices) == 1:
        parts = [_solve_shard(iteration, devices[0], theta_batch, x0_batch)]
    else:
        parts = _solve_shards(iteration, devices, theta_batch, x0_batch)
    cat = {k: np.concatenate([p[k] for p in parts])
           for k in ("x_full", "objective", "converged", "iterations",
                     "kkt_error")}
    return BatchedSolveResult(
        **cat, solve_time=max(p["t_end"] for p in parts)
        - min(p["t_start"] for p in parts))


def _stream_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _solve_shard(iteration, device, theta, x0) -> Dict:
    """Solve one shard on ``device`` (on its current stream): host arrays of
    the results and the wall-clock times the solve started and ended."""
    kw = dict(dtype=iteration.dtype, device=device)
    theta_t = torch.as_tensor(theta, **kw)
    x0_t = torch.as_tensor(x0, **kw)
    _stream_sync(device)
    t_start = time.perf_counter()
    res = iteration._solver(x0_t, theta_t)
    _stream_sync(device)
    t_end = time.perf_counter()
    return dict(
        x_full=iteration.assemble_full(res.x, theta_t).cpu().numpy(),
        objective=res.f.cpu().numpy() / iteration.w,
        converged=res.converged.cpu().numpy(),
        iterations=res.iterations.cpu().numpy(),
        kkt_error=res.kkt_error.cpu().numpy(),
        t_start=t_start, t_end=t_end)


def _solve_shards(iteration, devices: Sequence[torch.device], theta_batch,
                  x0_batch) -> List[Dict]:
    """One thread per shard, as ``torch.nn.parallel.parallel_apply`` runs
    its replicas; a shard's exception is raised after every thread ended."""
    k = len(devices)
    thetas = torch.tensor_split(torch.as_tensor(theta_batch), k)
    x0s = torch.tensor_split(torch.as_tensor(x0_batch), k)
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devices]
    results: List[Optional[Dict]] = [None] * k
    errors: List[Optional[BaseException]] = [None] * k

    def work(i):
        try:
            if streams[i] is None:
                results[i] = _solve_shard(iteration, devices[i], thetas[i],
                                          x0s[i])
                return
            with torch.cuda.device(devices[i]), torch.cuda.stream(streams[i]):
                results[i] = _solve_shard(iteration, devices[i], thetas[i],
                                          x0s[i])
        except Exception as exc:  # re-raised in the calling thread
            errors[i] = exc

    threads = [threading.Thread(target=work, args=(i,), daemon=True,
                                name=f"solve_batched shard {i}")
               for i in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, exc in enumerate(errors):
        if exc is not None:
            raise RuntimeError(f"shard {i} of {k} ({len(thetas[i])} "
                               f"instances) on {devices[i]} failed: "
                               f"{exc!r}") from exc
    return results
