"""Batched and sharded solves of one OCP over many instances.

The compiled NLP of a mesh iteration is a function of
``(x0_scaled, theta)``, so many perturbed instances (different initial
states, endpoint targets, fixed times or parameters — any entry of
``theta``) solve simultaneously: the batch-first interior-point solver
advances all of them in one set of batched tensor operations on one
device.  Given a list of devices, :func:`solve_batched` splits the batch
into contiguous blocks, one per distinct device, and solves each block as
one batch on its device.  Entries that repeat a device add to its block:
``[torch.device("cuda:0")] * 2`` is one batch on the card, run in the
calling thread, since two threads on one device only take turns on the
interpreter lock and on ``utils.FORWARD_AD_LOCK`` (``PERF.md``).
Distinct devices get a thread and a CUDA stream each; they share those
two locks as well, so throughput over several cards goes through
:mod:`~pycollo_tpu_torch.parallel.multihost`, one process per card.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..profiling import span
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
    #: what ran: (device, instances) of each block, in instance order
    blocks: Tuple[Tuple[str, int], ...] = ()


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


def device_blocks(devices: Sequence[torch.device],
                  B: int) -> List[Tuple[torch.device, int, int]]:
    """The contiguous blocks a batch of ``B`` is solved in over the device
    list ``devices``: ``(device, start, stop)`` per distinct device, in the
    order in which each first appears.

    Entry i of the list is given the ``torch.tensor_split`` share of the
    batch (the first ``B % k`` entries one instance more), and a device's
    block is the sum of its entries' shares, so ``[a, a, b]`` over 9
    instances gives ``a`` the first 6 and ``b`` the last 3.
    """
    k = len(devices)
    sizes: Dict[torch.device, int] = {}
    for i, d in enumerate(devices):
        sizes[d] = sizes.get(d, 0) + B // k + (i < B % k)
    blocks, start = [], 0
    for d, n in sizes.items():
        blocks.append((d, start, start + n))
        start += n
    return blocks


def solve_theta_batch(iteration, theta_batch: np.ndarray,
                      x0_batch: Optional[np.ndarray] = None, devices=None,
                      options=None) -> BatchedSolveResult:
    """Solve the (B, n_full) ``theta_batch`` of ``iteration`` (from
    ``x0_batch``, default the iteration's guess for every instance).

    ``devices``: a sequence of torch devices (default: the CUDA card;
    ``[torch.device("cpu")]`` for the CPU, and without a CUDA device the
    CPU must be named).  The batch is split into contiguous blocks, one per
    distinct device (:func:`device_blocks`): each entry takes its
    ``torch.tensor_split`` share, and the entries that name one device
    pool their shares into one block, which that device solves as one
    batch.  So ``[torch.device("cpu")] * 4`` and
    ``[torch.device("cuda:0")] * 2`` each solve the whole batch at once,
    in the calling thread, with no extra stream: the answers are those of
    the one-device solve, and an exception is raised as it is.  With
    several distinct devices, block i is
    solved on its device by a thread of its own, which copies its inputs
    there and, on a card, runs under ``torch.cuda.device`` and a CUDA
    stream of its own; an exception in a block is raised here, naming the
    block and its device, and no block is solved again elsewhere.  The
    results come back in the original instance order.  The device types
    may not mix (``ValueError``).

    ``options``: build the iteration's solver with these ``IPMOptions``
    (default: reuse the iteration's solver, or build one from the problem
    settings); it is built once, before any block starts.

    ``solve_time`` runs from the first block's start (its inputs on its
    device) to the last block's synchronisation with its stream; ``blocks``
    says what ran.
    """
    devices = shard_devices(devices)
    theta_batch = np.asarray(theta_batch)
    B = theta_batch.shape[0]
    x0_batch = (np.tile(iteration.xs_guess, (B, 1)) if x0_batch is None
                else np.asarray(x0_batch))
    if B < len(devices):
        raise ValueError(f"a batch of {B} cannot fill {len(devices)} shards")
    if iteration._solver is None or options is not None:
        iteration.build_solver(options)

    blocks = device_blocks(devices, B)
    if len(blocks) == 1:
        parts = [_solve_shard(iteration, devices[0], theta_batch, x0_batch)]
    else:
        parts = _solve_blocks(iteration, blocks, theta_batch, x0_batch)
    cat = {k: np.concatenate([p[k] for p in parts])
           for k in ("x_full", "objective", "converged", "iterations",
                     "kkt_error")}
    return BatchedSolveResult(
        **cat, solve_time=max(p["t_end"] for p in parts)
        - min(p["t_start"] for p in parts),
        blocks=tuple((str(d), b - a) for d, a, b in blocks))


def _stream_sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _solve_shard(iteration, device, theta, x0) -> Dict:
    """Solve one block on ``device`` (on its current stream): host arrays of
    the results and the wall-clock times the solve started and ended
    (spans ``batch.inputs``, ``ipm.solve`` and ``batch.outputs``)."""
    kw = dict(dtype=iteration.dtype, device=device)
    with span("batch.inputs"):
        theta_t = torch.as_tensor(theta, **kw)
        x0_t = torch.as_tensor(x0, **kw)
    _stream_sync(device)
    t_start = time.perf_counter()
    res = iteration._solver(x0_t, theta_t)
    _stream_sync(device)
    t_end = time.perf_counter()
    with span("batch.outputs"):
        return dict(
            x_full=iteration.assemble_full(res.x, theta_t).cpu().numpy(),
            objective=res.f.cpu().numpy() / iteration.w,
            converged=res.converged.cpu().numpy(),
            iterations=res.iterations.cpu().numpy(),
            kkt_error=res.kkt_error.cpu().numpy(),
            t_start=t_start, t_end=t_end)


def _solve_blocks(iteration, blocks, theta_batch, x0_batch) -> List[Dict]:
    """One thread per block of a distinct device, as
    ``torch.nn.parallel.parallel_apply`` runs its replicas; a block's
    exception is raised after every thread ended."""
    k = len(blocks)
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d, _, _ in blocks]
    results: List[Optional[Dict]] = [None] * k
    errors: List[Optional[BaseException]] = [None] * k

    def work(i):
        device, a, b = blocks[i]
        try:
            if streams[i] is None:
                results[i] = _solve_shard(iteration, device, theta_batch[a:b],
                                          x0_batch[a:b])
                return
            with torch.cuda.device(device), torch.cuda.stream(streams[i]):
                results[i] = _solve_shard(iteration, device, theta_batch[a:b],
                                          x0_batch[a:b])
        except Exception as exc:  # re-raised in the calling thread
            errors[i] = exc

    threads = [threading.Thread(target=work, args=(i,), daemon=True,
                                name=f"solve_batched block {i}")
               for i in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, exc in enumerate(errors):
        if exc is not None:
            device, a, b = blocks[i]
            raise RuntimeError(f"block {i} of {k} ({b - a} instances) on "
                               f"{device} failed: {exc!r}") from exc
    return results
