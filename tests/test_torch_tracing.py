"""The port's spans and counters (``pycollo_tpu_torch/profiling.py``).

Cart-pole swing-up on 2 mesh sections x 4 nodes, four instances with
perturbed initial states (the ``bench.py`` recipe), through the mixed
route the benchmark's cell runs (f32 factorization through the kernel's
plain version, f32 derivative assembly), on the CPU:

* recording changes no answer, bit for bit;
* the counters hold their identities exactly, with and without escalation
  trips (``spec_levels=()`` leaves the ladder one level, so some trips
  escalate): trips, active rows, rows computed, factorization calls, and
  host reads of device values;
* every span path's self time and its children's totals add up to its
  total;
* off, no span builds a ``record_function``, no span or count adds a
  tensor op, and nothing is recorded;
* under ``torch.profiler`` alone the trace holds the ``ipm.*`` and
  ``batch.*`` ranges nested as ``profiling.py`` lists them, and the
  block-banded step's ``banded.*`` ranges;
* spans and counts from many threads into one recording lose nothing.
"""

import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from cart_pole_swing_up_torch import build_problem  # noqa: E402
from pycollo_tpu_torch import profiling  # noqa: E402
from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv  # noqa: E402
from pycollo_tpu_torch.parallel import batch as batch_mod  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.solver import ipm as ipm_mod  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

CPU = [torch.device("cpu")]
#: the benchmark cell's route (benchmark/workloads/cartpole-sweep-b1024.json)
MIXED = dict(tol=1e-6, max_iter=80, kkt_precision="mixed", dc_floor=1e-7,
             dense_gmres_iters=12, eval_dtype="f32")
#: the same with a one-level ladder: some trips escalate
ESCALATING = dict(MIXED, spec_levels=())
#: the nesting of the stages (profiling.py): each span name and the span
#: names that may directly enclose it in a dense solve
PARENTS = {
    "batch.inputs": {None},
    "batch.outputs": {None},
    "ipm.solve": {None},
    "ipm.init": {"ipm.solve"},
    "ipm.certify": {"ipm.solve"},
    "ipm.trip": {"ipm.solve"},
    "ipm.wait": {"ipm.solve", "ipm.trip", "ipm.escalation"},
    "ipm.derivatives": {"ipm.trip"},
    "ipm.step": {"ipm.trip"},
    "ipm.line_search": {"ipm.trip"},
    "ipm.restoration": {"ipm.trip"},
    "ipm.factor": {"ipm.step", "ipm.escalation"},
    "ipm.gmres": {"ipm.step", "ipm.escalation", "ipm.line_search"},
    "ipm.escalation": {"ipm.step"},
}


@pytest.fixture(scope="module")
def problem():
    problem = build_problem()
    problem.settings.console_out_progress = False
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = 2
    phase.mesh.number_mesh_section_nodes = 4
    problem.initialise()
    return problem


@pytest.fixture(scope="module")
def theta(problem):
    it = problem.backend.mesh_iterations[0]
    B = 4
    rng = np.random.default_rng(0)
    pl = it.layout.phases[0]
    th = np.tile(it.theta_default, (B, 1))
    th[:, pl.y_off + 0 * pl.N] = rng.uniform(-0.25, 0.25, B)
    th[:, pl.y_off + 1 * pl.N] = rng.uniform(-0.3, 0.3, B)
    return th


def _solve(problem, theta, opts):
    return solve_batched(problem.backend, theta_batch=theta, devices=CPU,
                         options=IPMOptions(**opts))


def _recorded(problem, theta, opts):
    """A solve inside a recording: the result, the record and the
    factorization calls it made."""
    problem.backend.mesh_iterations[0].build_solver(IPMOptions(**opts))
    calls = blocked_chol_linv.calls
    with profiling.recording() as rec:
        res = solve_batched(problem.backend, theta_batch=theta, devices=CPU)
    return res, rec, blocked_chol_linv.calls - calls


class _Ops(TorchDispatchMode):
    """Counts every tensor op, and the host reads of boolean tensors (the
    IPM loop's masks; the one other scalar read of a solve, GMRES's
    breakdown floor, reads a host constant it makes itself)."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()
        self.mask_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        if func is torch.ops.aten._local_scalar_dense.default \
                and args[0].dtype == torch.bool:
            self.mask_reads += 1
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------- answers
def test_recording_changes_no_answer(problem, theta):
    off = _solve(problem, theta, MIXED)
    on, rec, _ = _recorded(problem, theta, MIXED)
    assert rec.counters["ipm.trips"] > 0
    for k in ("x_full", "objective", "converged", "iterations", "kkt_error"):
        np.testing.assert_array_equal(getattr(on, k), getattr(off, k), k)


# ---------------------------------------------------------------- counters
@pytest.mark.parametrize("opts", [MIXED, ESCALATING],
                         ids=["ladder", "escalating"])
def test_counter_identities(problem, theta, opts):
    res, rec, factor_calls = _recorded(problem, theta, opts)
    c = Counter(rec.counters)
    B = theta.shape[0]
    trips = c["ipm.trips"]
    assert trips == int(res.iterations.max())
    assert c["ipm.active_rows"] == int(res.iterations.sum())
    assert c["ipm.rows_computed"] == B * trips
    # one factorization call a trip for the ladder, one per escalation
    # trip
    assert c["ipm.escalation_trips"] == factor_calls - trips
    assert c["ipm.escalation_rows_factored"] == B * c["ipm.escalation_trips"]
    assert 0 <= c["ipm.escalation_rows"] <= c["ipm.escalation_rows_factored"]
    # one read of `active` before the loop and after each trip; one of
    # `esc` a trip and one more per escalation trip
    assert c["ipm.syncs"] == 2 * trips + c["ipm.escalation_trips"] + 1
    if opts is ESCALATING:
        assert c["ipm.escalation_trips"] > 0 and c["ipm.escalation_rows"] > 0
    # the spans agree with the counters
    by = rec.by_name()
    assert by["ipm.trip"].count == trips
    assert by["ipm.wait"].count == c["ipm.syncs"]
    assert by["ipm.factor"].count == factor_calls


def test_syncs_count_every_host_read_of_a_mask(problem, theta):
    _, rec, _ = _recorded(problem, theta, ESCALATING)
    with _Ops() as ops:
        _solve(problem, theta, ESCALATING)
    assert ops.mask_reads == rec.counters["ipm.syncs"]


# ---------------------------------------------------------------- spans
def test_self_times_add_up(problem, theta):
    _, rec, _ = _recorded(problem, theta, ESCALATING)
    children = Counter()
    for path, s in rec.spans.items():
        if "/" in path:
            children[path.rsplit("/", 1)[0]] += s.total_ns
    assert rec.spans["ipm.solve/ipm.trip/ipm.step/ipm.escalation"].count > 0
    for path, s in rec.spans.items():
        assert 0 <= s.self_ns <= s.total_ns, path
        assert children[path] + s.self_ns == s.total_ns, path
    for path in rec.spans:
        name = path.rsplit("/", 1)[-1]
        parent = path.rsplit("/", 2)[-2] if "/" in path else None
        assert parent in PARENTS[name], path
    # the solve's stages cover it: its own time is only the calls between
    assert rec.spans["ipm.solve"].self_s < 0.05 * rec.spans["ipm.solve"].total_s


def test_off_builds_no_range_adds_no_op_and_records_nothing(
        problem, theta, monkeypatch):
    with _Ops() as plain:
        with monkeypatch.context() as m:
            # the program with its spans and counts taken out
            for mod in (ipm_mod, batch_mod):
                m.setattr(mod, "span", lambda name: profiling._OFF)
            m.setattr(ipm_mod, "count", lambda name, n=1: None)
            _solve(problem, theta, ESCALATING)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with _Ops() as off:
        res = _solve(problem, theta, ESCALATING)
    assert res.iterations.max() > 0
    assert off.ops == plain.ops
    assert profiling._record is None
    assert profiling._local.stack == []


def test_profiler_alone_sees_the_stages(problem, theta):
    opts = IPMOptions(**dict(ESCALATING, max_iter=4))
    problem.backend.mesh_iterations[0].build_solver(opts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solve_batched(problem.backend, theta_batch=theta, devices=CPU)
    ranges = [(e.time_range.start, e.time_range.end, e.name)
              for e in prof.events() if e.name in PARENTS]
    ranges.sort(key=lambda r: (r[0], -r[1]))
    seen, stack = Counter(), []
    for start, end, name in ranges:
        while stack and stack[-1][1] <= start:
            stack.pop()
        parent = stack[-1][2] if stack else None
        assert parent in PARENTS[name], (name, parent)
        seen[name] += 1
        stack.append((start, end, name))
    assert set(seen) == set(PARENTS)
    assert seen["ipm.trip"] == 4 and seen["ipm.solve"] == 1


def test_banded_ranges_are_spans(problem, theta):
    s = problem.settings
    dense, s.linear_solver = s.linear_solver, "block-banded"
    try:
        problem.backend.mesh_iterations[0].build_solver(
            IPMOptions(tol=1e-6, max_iter=2))
    finally:
        s.linear_solver = dense
    with profiling.recording() as rec:
        solve_batched(problem.backend, theta_batch=theta, devices=CPU)
    step = "ipm.solve/ipm.trip/ipm.step"
    for name in ("assemble", "factor", "gmres"):
        assert rec.spans[f"{step}/banded.{name}"].count == 2
    assert rec.spans[
        "ipm.solve/ipm.trip/ipm.line_search/banded.corrector"].count == 2


# ---------------------------------------------------------------- recorder
def test_recordings_do_not_nest_and_count_reads_tensors_at_close():
    profiling.count("x")                       # off: nothing to count into
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
        profiling.count("rows", torch.tensor([True, False, True]))
        profiling.count("rows", torch.tensor([True, True, True]))
        profiling.count("n", 3)
        assert "rows" not in rec.counters
    assert rec.counters == {"rows": 5, "n": 3}
    assert profiling._record is None


def test_profiler_spans_are_spans():
    p = profiling.Profiler()
    with profiling.recording() as rec:
        with p.span("scaling"):
            with profiling.span("inner"):
                pass
    p.add("NLP solve", 0.5)
    assert p.spans["scaling"].count == 1 and p.spans["NLP solve"].count == 1
    assert rec.spans["scaling"].count == 1
    assert rec.spans["scaling/inner"].count == 1


def test_threads_lose_nothing():
    threads, per, interval = 8, 400, sys.getswitchinterval()
    errors = []

    def work(i):
        try:
            for _ in range(per):
                with profiling.span(f"t{i}"):
                    with profiling.span("inner"):
                        profiling.count("n")
        except Exception as exc:  # reported below
            errors.append(exc)

    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording() as rec:
            ts = [threading.Thread(target=work, args=(i,))
                  for i in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert rec.counters == {"n": threads * per}
    assert set(rec.spans) == {f"t{i}" for i in range(threads)} \
        | {f"t{i}/inner" for i in range(threads)}
    assert all(s.count == per for s in rec.spans.values())
