"""The harness's trace reduction against the program's stage ranges, on the
CPU at small sizes.

Run from the root of a checkout::

    python -m pytest benchmark/tests -q

A traced call's ``breakdown.idle_gaps`` names each idle gap on the device
by the innermost host event open when it began (``harness/trace.py``).
The program opens a ``record_function`` range for each stage of a solve
while a profiler runs (``pycollo_tpu_torch/profiling.py``), so a gap that
began in Python between ops is put down to its stage, not to the
harness's range ``bench.call``.  These tests check that on a synthetic
trace, and that a real traced call carries the ranges through
``trace.events_of`` inside ``bench.call``, on the thread of the call.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from harness import trace, traffic  # noqa: E402
from harness.collocation import Mesh  # noqa: E402

US = 1000


def _ev(name, kind, a, b, tid=1):
    return trace.Event(name, kind, a * US, b * US, tid, None)


def test_idle_gaps_are_named_by_the_stage():
    events = [
        _ev("bench.call", "user_annotation", 0, 1000),
        _ev("ipm.solve", "user_annotation", 100, 900),
        _ev("ipm.trip", "user_annotation", 150, 850),
        _ev("ipm.derivatives", "user_annotation", 150, 300),
        _ev("aten::mul", "cpu_op", 160, 170),
        _ev("ipm.step", "user_annotation", 300, 600),
        _ev("ipm.gmres", "user_annotation", 400, 600),
        _ev("ipm.line_search", "user_annotation", 600, 800),
        _ev("ipm.wait", "user_annotation", 800, 850),
        _ev("aten::item", "cpu_op", 805, 845),
        _ev("k1", "kernel", 165, 200, tid=9),
        _ev("k2", "kernel", 420, 450, tid=9),
        _ev("k3", "kernel", 610, 620, tid=9),
        _ev("k4", "kernel", 800, 840, tid=9),
    ]
    idle = dict(trace.reduce(events, "bench.call")["idle_gaps"])
    # [0, 165]: before ipm.solve opens, the harness's range
    assert idle["bench.call"] == pytest.approx(165e-6)
    # [200, 420]: from inside ipm.derivatives' Python, between its ops
    assert idle["ipm.derivatives"] == pytest.approx(220e-6)
    # [450, 610]: inside ipm.gmres; [620, 800]: inside ipm.line_search
    assert idle["ipm.gmres"] == pytest.approx(160e-6)
    assert idle["ipm.line_search"] == pytest.approx(180e-6)
    # [840, 1000]: inside the host read's aten op
    assert idle["aten::item"] == pytest.approx(160e-6)
    assert set(idle) == {"bench.call", "ipm.derivatives", "ipm.gmres",
                         "ipm.line_search", "aten::item"}


def test_a_traced_call_carries_the_stages():
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.set_num_threads(2)
    cell = run.load_cell("cartpole-sweep-b1024")
    prog = run.Program(cell, "cpu", Mesh(2, 4))
    mix = dict(cell.workload["mix"], B=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(run.CALL_RANGE):
            call = run.make_call(prog, mix, traffic.window_batch(mix, 0), {})
    events = trace.events_of(prof, run.CACHE / "stages_test_trace.json")
    call_range = [e for e in events if e.name == run.CALL_RANGE][0]
    stages = [e for e in events if e.kind == "user_annotation"
              and e.name.startswith(("ipm.", "batch."))]
    assert all(e.tid == call_range.tid
               and call_range.start_ns <= e.start_ns <= e.end_ns
               <= call_range.end_ns for e in stages)
    names = [e.name for e in stages]
    assert names.count("ipm.solve") == 1
    assert names.count("ipm.trip") == call.iter_max
    assert {"batch.inputs", "batch.outputs", "ipm.derivatives", "ipm.step",
            "ipm.factor", "ipm.gmres", "ipm.line_search",
            "ipm.wait"} <= set(names)
