"""Multi-process batched solving with ``torch.distributed``.

Batched OCP solves spread across processes (one per card, on one host or
many; each with its own interpreter, unlike the threaded shards of
:func:`~pycollo_tpu_torch.parallel.batch.solve_theta_batch`, so this is
the path that can scale over cards, though that is not yet measured on a
machine with several): each process solves its own block of the global batch on its own
device with :func:`~pycollo_tpu_torch.parallel.batch.solve_theta_batch`,
and the only traffic between processes is a barrier and two reductions
per solve (the slowest rank's time, the converged count), over NCCL on
the cards or gloo on the CPU.

Usage (one call per process)::

    from pycollo_tpu_torch.parallel import multihost
    multihost.initialize("host0:29500", num_processes=N, process_id=i)
    out = multihost.solve_batched_global(iteration, per_host_batch=256)
    multihost.shutdown()

:func:`run_local_ranks` starts such processes on this host; the tests run
two gloo ranks on the CPU with it, and ``chip_smoke.py`` two gloo ranks on
one card and NCCL on every card.
"""

from __future__ import annotations

import json
import socket
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils import solve_device
from .batch import shard_devices, solve_theta_batch
from .scaling import measure_scaling_efficiency


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_ids=None,
               backend: Optional[str] = None,
               device="cuda") -> torch.device:
    """Join the process group (once per process) and return this rank's
    device.

    ``coordinator_address``: ``"host:port"`` (or a ``tcp://`` URL) of rank
    0's rendezvous.  On CUDA (``device``, the default; raises without a
    card unless ``device="cpu"``) the rank's card is
    ``local_device_ids[0]``, else ``process_id % device_count``, made the
    current device.  ``backend`` defaults to ``"nccl"`` on CUDA and
    ``"gloo"`` on the CPU; it is never switched otherwise, so ranks that
    share one card (which NCCL refuses) must name ``"gloo"``.
    """
    device = solve_device(device)
    if device.type == "cuda":
        index = (int(local_device_ids[0]) if local_device_ids
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id)
    return device


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclass
class MultihostSolveResult:
    """Per-host view of a global batched solve."""

    local_objective: np.ndarray     # objectives of this host's shard
    local_converged: np.ndarray     # convergence flags of the shard
    global_converged: int           # total converged across hosts
    global_batch: int
    solve_time: float


def _collective_device(devices: Sequence[torch.device]) -> torch.device:
    """NCCL reduces CUDA tensors, gloo CPU ones."""
    return devices[0] if dist.get_backend() == "nccl" \
        else torch.device("cpu")


def _barrier(coll: torch.device) -> None:
    if coll.type == "cuda":
        dist.barrier(device_ids=[coll.index])
    else:
        dist.barrier()


def solve_batched_global(iteration, theta_local: Optional[np.ndarray] = None,
                         per_host_batch: int = 32, options=None,
                         n_rep: int = 1, devices=None) -> MultihostSolveResult:
    """Solve this process's block of a global batch; every rank calls it.

    ``theta_local``: this rank's (B_local, n_full) block of the global theta
    batch (default: ``per_host_batch`` copies of ``theta_default``); the
    global batch is the concatenation over ranks.  ``devices``: the rank's
    devices (default: its current card, set by :func:`initialize`; the CPU
    must be named without CUDA).

    One untimed warm-up, a barrier, then ``n_rep`` timed solves, each from
    input tensors built anew from the host arrays and reusing nothing of an
    earlier solve (PyTorch caches no results, so equal inputs cost a full
    solve every time); the time of a rep is the slowest rank's, so every
    rank reports the same ``solve_time`` (the mean over reps) and the same
    global converged count.
    """
    devices = shard_devices(devices)
    if not dist.is_initialized():
        raise RuntimeError("solve_batched_global needs a process group: "
                           "call multihost.initialize() first")
    if iteration._solver is None or options is not None:
        iteration.build_solver(options)
    if theta_local is None:
        theta_local = np.tile(iteration.theta_default, (per_host_batch, 1))
    theta_local = np.asarray(theta_local)
    coll = _collective_device(devices)

    solve_theta_batch(iteration, theta_local.copy(), devices=devices)
    _barrier(coll)
    total = 0.0
    for _ in range(max(n_rep, 1)):
        res = solve_theta_batch(iteration, theta_local.copy(), devices=devices)
        t = torch.tensor([res.solve_time], dtype=torch.float64, device=coll)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        total += float(t)
    counts = torch.tensor([int(res.converged.sum()), len(theta_local)],
                          dtype=torch.int64, device=coll)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    return MultihostSolveResult(local_objective=res.objective,
                                local_converged=res.converged,
                                global_converged=int(counts[0]),
                                global_batch=int(counts[1]),
                                solve_time=total / max(n_rep, 1))


def measure_multihost_scaling(iteration, per_host_batch: int = 32,
                              options=None, n_rep: int = 3,
                              devices=None) -> Dict:
    """Weak-scaling measurement: solves/s of this rank's devices alone
    against the whole process group (>= 80 % target, BASELINE.md).

    Every rank must call it (it runs a global solve).  The single-host rate
    is measured on every rank at once, so ranks that share hardware
    understate both it and the efficiency.
    """
    devices = shard_devices(devices)
    full = solve_batched_global(iteration, per_host_batch=per_host_batch,
                                options=options, n_rep=n_rep, devices=devices)
    full_rate = full.global_batch / full.solve_time
    local = measure_scaling_efficiency(
        iteration, per_device_batch=max(1, per_host_batch // len(devices)),
        devices=devices, n_rep=n_rep)
    single_rate = local.all_devices_solves_per_sec
    n_dev = torch.tensor([len(devices)], dtype=torch.int64,
                         device=_collective_device(devices))
    dist.all_reduce(n_dev, op=dist.ReduceOp.SUM)
    world = dist.get_world_size()
    ideal = single_rate * world
    return dict(processes=world,
                global_devices=int(n_dev[0]),
                per_host_batch=per_host_batch,
                single_host_solves_per_sec=single_rate,
                multi_host_solves_per_sec=full_rate,
                efficiency=full_rate / ideal if ideal else float("nan"))


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def report(result: Dict) -> None:
    """Print a rank's result where :func:`run_local_ranks` finds it."""
    print("RESULT " + json.dumps(result), flush=True)


def run_local_ranks(argv: Sequence[str], world: int,
                    timeout: float) -> List[Dict]:
    """Run ``argv + [rank, world, address]`` in one process per rank on
    this host and return each rank's :func:`report`, in rank order.

    ``address`` is ``127.0.0.1:<free port>``, for :func:`initialize`.
    Raises, with the end of every rank's output, once a rank exits with
    another code than 0, when a rank reports nothing, or when a rank is
    still running ``timeout`` seconds after the start; every rank still
    running then is killed.
    """
    address = f"127.0.0.1:{free_port()}"
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(world)]
    procs = [subprocess.Popen([*argv, str(rank), str(world), address],
                              stdout=out, stderr=err, text=True)
             for rank, (out, err) in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(c not in (None, 0) for c in codes) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    results = []
    for stdout, _ in texts:
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        results.append(json.loads(lines[-1][len("RESULT "):])
                       if lines else None)
    if any(c != 0 for c in codes) or None in results:
        tails = "".join(
            f"\n--- rank {r}: exit {c if c is not None else 'killed'}, "
            f"{'a' if res is not None else 'no'} result ---\n"
            f"{so[-1500:]}{se[-3000:]}"
            for r, (c, res, (so, se)) in enumerate(zip(codes, results, texts)))
        raise RuntimeError(f"of {world} local ranks, one failed or was "
                           f"stopped after {timeout} s:{tails}")
    return results
