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
The window sends whole passes of the sequence (:func:`window`): a pass is
one call of each of batches 0, 1, ..., ``batches`` - 1, in that order; the
warm-up sends batch ``batches``, which no call of the window sends.  So
every call meets fresh instances, drawn as a user's sweep would draw them
(a batch's slowest instance sets its iterations, one instance can make the
whole batch escalate), and every run meets the same ones in the same order:
instances drawn from the run's seed made the draw, and not the program, set
a run's rate (PERF.md, Findings).  And every window holds each instance of
the sequence equally often, whatever the program's speed, so a faster
program meets the same instances, and the same hard ones, as a slower one.

The run's seed draws only the judge's sample of answers
(:func:`sample_rng`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

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


def another_pass(passes: Sequence[float], seconds: float) -> bool:
    """Whether the window starts another pass, from the durations of the
    passes so far: always a first one, then another only while the time
    elapsed (their sum) plus their mean is at most ``seconds``."""
    if not passes:
        return True
    elapsed = sum(passes)
    return elapsed + elapsed / len(passes) <= seconds


def window(spec: Dict, seconds: float, send: Callable[[int], object],
           clock: Callable[[], float]) -> Tuple[List, float]:
    """Send whole passes of the sequence, ``send(k)`` for each batch ``k``
    in the order of :func:`window_batch`, starting a pass as
    :func:`another_pass` says and never stopping inside one.  Returns what
    each call of ``send`` returned, in order, and the window's seconds by
    ``clock``: from the first call to the end of the last pass."""
    out: List = []
    passes: List[float] = []
    t_first = t = clock()
    while another_pass(passes, seconds):
        for _ in range(int(spec["batches"])):
            out.append(send(window_batch(spec, len(out))))
        now = clock()
        passes.append(now - t)
        t = now
    return out, t - t_first


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
