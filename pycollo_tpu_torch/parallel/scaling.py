"""Weak-scaling harness for batched solves across devices.

Measures solves/s for the same per-device batch on one device against all
n devices of a list (weak scaling, the regime of the BASELINE target: at
least 80 % solves/s efficiency from 1 to N devices), both through
:func:`~pycollo_tpu_torch.parallel.batch.solve_theta_batch`.  Its distinct
devices are threads of one process that share the interpreter lock and
``utils.FORWARD_AD_LOCK``, so on this host-bound solver the efficiency is
not expected to approach 1.0, even on cards of their own;
:func:`~pycollo_tpu_torch.parallel.multihost.measure_multihost_scaling`
measures one process per card, the path that can scale.  A list may
repeat a device (``[torch.device("cpu")] * 2``); the entries of one device
are solved there as one batch, so their efficiency says how the batch
size scales on that device.  ``blocks`` records what the all-devices run
solved: one (device, instances) block per distinct device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils import solve_device
from .batch import solve_theta_batch


@dataclass
class ScalingResult:
    n_devices: int
    per_device_batch: int
    single_device_solves_per_sec: float
    all_devices_solves_per_sec: float
    #: (device, instances) of each block of the all-devices run: one per
    #: distinct device
    blocks: tuple = ()

    @property
    def efficiency(self) -> float:
        ideal = self.single_device_solves_per_sec * self.n_devices
        return self.all_devices_solves_per_sec / ideal


def cuda_devices():
    """Every CUDA card of this process; raises without CUDA."""
    solve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def measure_scaling_efficiency(iteration, per_device_batch: int = 32,
                               devices=None, n_rep: int = 3,
                               options=None) -> ScalingResult:
    """Weak-scaling measurement of batched solves over ``devices``
    (default: every CUDA card; without CUDA a device list must be given).

    After one untimed warm-up on all the devices, B = ``per_device_batch``
    instances are solved on ``devices[:1]`` and B * n on all n, ``n_rep``
    times each, every rep from inputs built anew; a rate is the batch over
    the mean ``solve_time``.
    """
    devices = list(devices) if devices is not None else cuda_devices()
    n_dev = len(devices)
    if iteration._solver is None or options is not None:
        iteration.build_solver(options)

    def solve(dev_list, B):
        theta = np.tile(iteration.theta_default, (B, 1))
        return solve_theta_batch(iteration, theta, devices=dev_list)

    solve(devices, per_device_batch * n_dev)

    def rate(dev_list, B):
        runs = [solve(dev_list, B) for _ in range(max(n_rep, 1))]
        return B / float(np.mean([r.solve_time for r in runs])), runs[-1]

    single, _ = rate(devices[:1], per_device_batch)
    full, last = rate(devices, per_device_batch * n_dev)
    return ScalingResult(n_devices=n_dev,
                         per_device_batch=per_device_batch,
                         single_device_solves_per_sec=single,
                         all_devices_solves_per_sec=full, blocks=last.blocks)
