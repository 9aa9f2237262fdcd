"""The one generator of the benchmark's traffic: a fixed sequence of
batches of perturbed instances, the same in every run.

A cell's ``mix`` block (``workloads/<cell>.json``) gives the batch size
``B``, a ``design_seed``, the length ``batches`` of the sequence and a list
of perturbations, each of one state's initial value:

    {"state": "q1", "mode": "set",   "low": -0.25, "high": 0.25}
    {"state": "p",  "mode": "scale", "low": 0.95,  "high": 1.05}

``set`` draws the initial value itself from [low, high]; ``scale`` draws a
factor from [low, high] for the nominal initial value.  Batch ``k`` is a
Latin hypercube sample drawn from ``(design_seed, k)``: each
perturbation's B values fall one into each of B equal strata of its range.
The window's calls send batches 0, 1, ..., ``batches`` - 1 in that order,
and start again at 0; the warm-up sends batch ``batches``, which no call of
the window sends.  So every call meets fresh instances, drawn as a user's
sweep would draw them (a batch's slowest instance sets its iterations, one
instance can make the whole batch escalate), and every run meets the same
ones in the same order: instances drawn from the run's seed made the draw,
and not the program, set a run's rate (PERF.md, Findings).

The run's seed draws only the judge's sample of answers
(:func:`sample_rng`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

MODES = ("set", "scale")


def sample_rng(seed: int) -> np.random.Generator:
    """The generator of the run's seed that draws the judge's sample."""
    if seed < 0:
        raise ValueError(f"seed must be a whole number >= 0, got {seed}")
    return np.random.default_rng(np.random.SeedSequence([seed]))


def check(spec: Dict) -> None:
    """Raise ``ValueError`` for a traffic block the generator cannot read."""
    if int(spec["B"]) < 1:
        raise ValueError("traffic B must be at least 1")
    if int(spec["batches"]) < 1:
        raise ValueError("traffic batches must be at least 1")
    if int(spec["design_seed"]) < 0:
        raise ValueError("design_seed must be a whole number >= 0")
    for p in spec["perturb"]:
        if p["mode"] not in MODES:
            raise ValueError(f"perturbation mode {p['mode']!r} not in {MODES}")
        if not float(p["low"]) <= float(p["high"]):
            raise ValueError(f"perturbation of {p['state']}: low > high")


def window_batch(spec: Dict, call: int) -> int:
    """The batch that the window's ``call``-th call (from 0) sends."""
    return call % int(spec["batches"])


def warmup_batch(spec: Dict) -> int:
    """The batch of the warm-up call, which no call of the window sends."""
    return int(spec["batches"])


def batch(spec: Dict, k: int) -> Dict[str, np.ndarray]:
    """{state: (B,) draws} of batch ``k`` of the sequence: initial values
    for ``set``, factors for ``scale``.  The run's seed does not change
    it."""
    check(spec)
    B = int(spec["B"])
    g = np.random.default_rng(
        np.random.SeedSequence([int(spec["design_seed"]), int(k)]))
    out = {}
    for p in spec["perturb"]:
        u = (g.permutation(B) + g.random(B)) / B
        out[p["state"]] = float(p["low"]) + u * (float(p["high"])
                                                 - float(p["low"]))
    return out


def initial_values(spec: Dict, draws: Dict[str, np.ndarray],
                   nominal: Dict[str, float]) -> Dict[str, np.ndarray]:
    """{state: (B,) initial value} of the perturbed states, from the
    draws and each state's nominal initial value."""
    out = {}
    for p in spec["perturb"]:
        d = draws[p["state"]]
        out[p["state"]] = d if p["mode"] == "set" \
            else nominal[p["state"]] * d
    return out
