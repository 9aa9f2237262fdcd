"""Tests of the benchmark's harness, on the CPU at small sizes.

Run from the root of a checkout::

    python -m pytest benchmark/tests -q

They check that every cell's files resolve, that the window sends whole
passes of the traffic's sequence and counts their answers alone, that a
rehearsal of each cell prints the result line the contract asks for, that
the plain reference
agrees with the program, that the control and the planted faults come out
not correct, that no run loads JAX or the JAX package and the reference
nothing of the program, and the trace arithmetic on a synthetic trace.
The test marked ``cuda`` runs a cell on the card and skips without one.
"""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from harness import readers, trace, traffic  # noqa: E402
from harness.collocation import Mesh  # noqa: E402
from harness.yardstick import bound_s  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
#: a seed above 32 signed bits, as the checks draw them
SEED = 2 ** 31 + 977


def _subprocess(code: str, timeout: float = 600) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


# ---------------------------------------------------------------- files
def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved), m["name"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        mine = [m for m in SPEC["end_to_end"] + SPEC["per_layer"]
                if w["name"] in m.get("workloads", CELLS)]
        assert {"setup_s"} < {m["name"] for m in mine
                              if m in SPEC["end_to_end"]}
        assert any(m in SPEC["per_layer"] for m in mine)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve(name):
    cell = run.load_cell(name)
    cfg = cell.config
    assert cfg["name"] == cell.workload["config"]
    for d, ext in (("problems", "py"), ("reference", "py")):
        assert (BENCH / d / f"{cfg['name']}.{ext}").is_file()
    entry = [c for c in SPEC["configs"] if c["name"] == cfg["name"]][0]
    assert entry["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert entry["reduced"] == cfg["reduced"] == []
    for m in cell.end_to_end + cell.per_layer:
        assert callable(run.load_module(
            BENCH / "metrics" / f"{m['name']}.py").read)
    traffic.check(cell.workload["mix"])
    ocp = run.reference_problem(cell)
    for p in cell.workload["mix"]["perturb"]:
        assert p["state"] in ocp.states
    limits = cell.workload["limits"]
    assert {"feas", "uncertified"} <= set(limits) <= \
        {"feas", "stat", "uncertified"}
    assert all(v is not None and v > 0 for v in limits.values())


def test_traffic_is_a_fixed_sequence_of_latin_hypercube_batches():
    mix = {"B": 8, "design_seed": 0, "batches": 3,
           "perturb": [{"state": "a", "mode": "set", "low": -1.0,
                        "high": 1.0},
                       {"state": "b", "mode": "scale", "low": 0.9,
                        "high": 1.1}]}
    a = traffic.batch(mix, 0)
    assert all(np.array_equal(a[k], traffic.batch(mix, 0)[k]) for k in a)
    other = traffic.batch(dict(mix, design_seed=1), 0)
    assert not np.array_equal(a["a"], other["a"])
    # every batch of the sequence, and the warm-up's, holds other instances
    seq = [traffic.batch(mix, k)["a"] for k in range(4)]
    assert len({tuple(x) for x in seq}) == 4
    # the window cycles through the sequence; the warm-up is not in it
    order = [traffic.window_batch(mix, i) for i in range(7)]
    assert order == [0, 1, 2, 0, 1, 2, 0]
    assert traffic.warmup_batch(mix) not in order
    # one instance in each of the B strata of each range
    assert sorted(np.floor((a["a"] + 1.0) / 2.0 * 8).astype(int)) == \
        list(range(8))
    assert sorted(np.floor((a["b"] - 0.9) / 0.2 * 8).astype(int)) == \
        list(range(8))
    v = traffic.initial_values(mix, a, {"a": 5.0, "b": 2.0})
    assert np.array_equal(v["a"], a["a"]) and np.allclose(v["b"], 2 * a["b"])


class FakeClock:
    """A clock that moves only when a call of the window is sent."""

    def __init__(self, per_call):
        self.now, self.per_call, self.sent = 100.0, per_call, []

    def __call__(self):
        return self.now

    def send(self, k):
        self.now += self.per_call(k, len(self.sent))
        self.sent.append(k)
        return k


# (seconds of each call by its batch and its index in the window, passes)
PASS_CASES = {
    # a pass longer than the window: one whole pass all the same
    "pass_longer_than_window": (lambda k, i: 6.0, 1),
    # passes of a quarter of the window: 4, the last ending at the window's
    # length
    "pass_of_a_quarter": (lambda k, i: 1.25, 4),
    # a first pass of 8 s, so a second is started, and a second of 40 s,
    # which crosses the window's length at its seventh call and is sent
    # whole
    "slower_second_pass": (lambda k, i: 1.0 if i < 8 else 5.0, 2),
}


@pytest.mark.parametrize("case", sorted(PASS_CASES))
def test_window_sends_whole_passes(case):
    per_call, passes = PASS_CASES[case]
    mix = {"batches": 8}
    clock = FakeClock(per_call)
    out, window_s = traffic.window(mix, 40.0, clock.send, clock)
    assert clock.sent == out == list(range(8)) * passes
    durations = [sum(per_call(k, 8 * p + k) for k in range(8))
                 for p in range(passes)]
    assert window_s == clock.now - 100.0 == sum(durations)
    # the rule reads only the passes' durations
    assert [traffic.another_pass(durations[:j], 40.0)
            for j in range(passes + 1)] == [True] * passes + [False]


def test_pass_rule():
    assert traffic.another_pass([], 1.0)
    assert not traffic.another_pass([3.0], 1.0)
    assert traffic.another_pass([0.25] * 3, 1.0)
    assert not traffic.another_pass([0.25] * 4, 1.0)
    # elapsed 0.9 and a mean of 0.3: 1.2 over the window of 1
    assert not traffic.another_pass([0.1, 0.5, 0.3], 1.0)
    assert traffic.another_pass([0.1, 0.5, 0.3], 1.2)


# ---------------------------------------------------------------- runs
REHEARSAL = """
import sys, json
sys.path.insert(0, 'benchmark')
import run
from harness.collocation import Mesh
cell = run.load_cell({name!r})
rc = run.emit(run.run_cell(cell, {seed}, 0.01, {trace}, device='cpu',
                           mesh=Mesh(2, 4),
                           B=min(2, cell.workload['mix']['B'])))
print(json.dumps({{'rc': rc, 'forbidden': run.forbidden_modules(),
                   'program': 'pycollo_tpu_torch' in sys.modules}}))
"""


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_prints_the_result_line(name):
    proc = _subprocess(REHEARSAL.format(name=name, seed=SEED, trace=True))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    assert tail == {"rc": 0, "forbidden": [], "program": True}
    out = json.loads(lines[-2])
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    cell = run.load_cell(name)
    # whole passes of the sequence at B = 2; the traced call is not counted
    per_pass = int(cell.workload["mix"]["batches"]) * 2
    assert out["attempted"] >= per_pass
    assert out["attempted"] % per_pass == 0
    compared = [k for k in ("feas", "stat", "uncertified")
                if k in cell.workload["limits"]]
    assert list(out["checks"]) == compared
    counted = {m["name"] for m in cell.per_layer
               if m["source"] != "device_trace"}
    assert counted <= set(out["metrics"])
    err = proc.stderr.strip().splitlines()
    assert [ln.split(":")[0] for ln in err[-len(compared):]] == \
        [f"check {k}" for k in compared]


def test_reference_loads_nothing_of_the_program():
    code = """
import sys, json
import numpy as np
sys.path.insert(0, 'benchmark')
from harness.collocation import Mesh
from harness.judge import Transcription
import run
out = {}
for cfg in ('cartpole-default', 'tumour-default'):
    cell = json.load(open(f'benchmark/configs/{cfg}.json'))
    ocp = run.load_module(run.BENCH / 'reference' / f'{cfg}.py').problem(
        cell['constants'])
    tr = Transcription(ocp, Mesh(2, 4))
    x = 0.5 * (tr.lo + tr.hi)[None].repeat(2, 0)
    init = np.array([[v if v is not None else np.nan
                      for v in ocp.initial.values()]] * 2)
    tr.feasibility(x, tr.pinned_values(init))
    tr.stationarity(x)
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""
    proc = _subprocess(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & {"pycollo_tpu_torch", "pycollo_tpu", "jax",
                         "jaxlib", "flax"}


@pytest.fixture(scope="module")
def cartpole():
    import torch
    torch.set_num_threads(2)
    cell = run.load_cell("cartpole-sweep-b1024")
    return cell, run.Program(cell, "cpu", Mesh(10, 4))


def _calls(cell, prog, n=1, B=2):
    mix = dict(cell.workload["mix"], B=B)
    ocp = run.reference_problem(cell)
    nominal = {s: v for s, v in ocp.initial.items() if v is not None}
    return [run.make_call(prog, mix, traffic.window_batch(mix, i), nominal)
            for i in range(n)]


def _copy(call, **changes):
    return dataclasses.replace(
        call, x_full=call.x_full.copy(), objective=call.objective.copy(),
        converged=call.converged.copy(), **changes)


@pytest.fixture(scope="module")
def sequence(cartpole):
    """One pass of the cart-pole cell's sequence at B = 2, every answer
    converged; and the same with one answer of the last batch planted
    unconverged."""
    cell, prog = cartpole
    calls = _calls(cell, prog, n=int(cell.workload["mix"]["batches"]))
    assert all(c.converged.all() for c in calls)
    last = _copy(calls[-1])
    last.converged[1] = False
    return cell, calls, calls[:-1] + [last]


def test_failed_share_is_the_same_for_one_pass_and_five(sequence):
    """An answer that fails in the sequence's last batch fails once a pass:
    a window of whole passes reads the same failed share at any number of
    passes, where a window cut after any call read fewer failures the more
    calls past the last whole pass it held."""
    cell, _, calls = sequence
    n = len(calls)

    def share(window):
        verdict = run.judge(cell, Mesh(10, 4), window, SEED)
        assert verdict["attempted"] == 2 * len(window)
        return int(verdict["failed"].sum()), verdict["attempted"], \
            verdict["checks"]["uncertified"]["value"]

    one, five = share(calls), share(calls * 5)
    assert one[:2] == (1, 2 * n) and five[:2] == (5, 10 * n)
    assert one[2] == five[2] == 1 / (2 * n)
    # the old cut: 11 calls (a pass and batches 0-2) against 40
    cut = share(calls + calls[:3])
    assert cut[:2] == (1, 22) and cut[2] < five[2]


def test_traced_answers_count_in_checks_and_not_in_attempted(sequence,
                                                              cartpole):
    """The traced call is judged: an answer of it beyond ``feas``'s limit
    makes the run not correct.  It is not attempted: its answers enter
    neither ``attempted`` nor ``failed`` nor ``uncertified``."""
    cell, calls, _ = sequence
    _, prog = cartpole
    n = 2 * len(calls)
    alone = run.judge(cell, Mesh(10, 4), calls, SEED)
    assert alone["correct"], alone["checks"]
    altered = _plant("answer_altered", [_copy(calls[0])], prog)
    unconverged = _copy(calls[0])
    unconverged.converged[:] = False
    for traced, correct in ((altered, False), ([unconverged], True)):
        verdict = run.judge(cell, Mesh(10, 4), calls + traced, SEED,
                            counted=n)
        assert verdict["correct"] is correct, verdict["checks"]
        assert verdict["attempted"] == n
        assert int(verdict["failed"].sum()) == 0
        assert verdict["checks"]["uncertified"] == \
            alone["checks"]["uncertified"]
    assert verdict["checks"]["feas"] == alone["checks"]["feas"]
    bad = run.judge(cell, Mesh(10, 4), calls + altered, SEED, counted=n)
    assert bad["checks"]["feas"]["value"] > cell.workload["limits"]["feas"]


def test_reference_agrees_with_the_program(cartpole):
    """The port's answers on the default mesh pass the reference's
    comparison, and the reference's tables equal the port's."""
    from pycollo_tpu_torch import mesh as port_mesh
    cell, prog = cartpole
    t = port_mesh.build_phase_tables("lobatto", np.full(10, 0.1),
                                     np.full(10, 4))
    S, I = Mesh(10, 4).defect_operator()
    assert np.abs(S - t.E).max() == 0.0
    assert np.abs(I - t.I).max() < 1e-15
    assert np.abs(Mesh(10, 4).quadrature_weights() - t.W).max() < 1e-15
    calls = _calls(cell, prog)
    verdict = run.judge(cell, Mesh(10, 4), calls, SEED)
    assert calls[0].converged.all()
    assert verdict["correct"], verdict["checks"]


FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _plant(fault, calls, prog):
    """What the fault would have returned in place of ``calls``."""
    for c in calls:
        if fault == "state_unchanged":
            # the solver's steps leave its starting point where it was
            xs = np.tile(prog.it.xs_guess, (len(c.converged), 1))
            theta = np.stack([c.x_full[i] for i in range(len(c.x_full))])
            import torch
            c.x_full = prog.it.assemble_full(
                torch.as_tensor(xs), torch.as_tensor(theta)).numpy()
        elif fault == "half_batch":
            # the second half left out, filled with the first half's answers
            h = len(c.converged) // 2
            c.x_full[h:] = c.x_full[:len(c.x_full) - h]
            c.objective[h:] = c.objective[:len(c.objective) - h]
        elif fault == "answer_altered":
            # one control value of one answer altered where it is produced
            c.x_full[0, prog.it.layout.phases[0].u_off + 3] += 1e-3
    return calls


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_come_out_not_correct(cartpole, fault):
    cell, prog = cartpole
    calls = _plant(fault, _calls(cell, prog), prog)
    verdict = run.judge(cell, Mesh(10, 4), calls, SEED)
    assert not verdict["correct"]
    assert verdict["checks"]["feas"]["value"] > \
        cell.workload["limits"]["feas"]


def test_control_float32_comes_out_not_correct():
    """The control: the program's float32 path in place of the float64 the
    configuration states converges nothing at the stated tolerance."""
    cell = run.load_cell("cartpole-sweep-b1024")
    prog = run.Program(cell, "cpu", Mesh(10, 4), dtype="float32")
    verdict = run.judge(cell, Mesh(10, 4), _calls(cell, prog), SEED)
    assert not verdict["correct"]
    assert verdict["checks"]["uncertified"]["value"] > \
        cell.workload["limits"]["uncertified"]


# ---------------------------------------------------------------- trace
def _ev(name, kind, a, b, tid=1, grid=None):
    return trace.Event(name, kind, a, b, tid, grid)


def test_trace_arithmetic_on_a_synthetic_trace():
    us = 1000
    events = [
        _ev("bench.call", "user_annotation", 0, 1000 * us),
        _ev("aten::mm", "cpu_op", 50 * us, 120 * us),
        _ev("aten::item", "cpu_op", 400 * us, 700 * us),
        _ev("gemm", "kernel", 100 * us, 300 * us, tid=9, grid=(4, 1, 1)),
        _ev("chol_linv_kernel<256>", "kernel", 250 * us, 400 * us, tid=9,
            grid=(1536, 1, 1)),
        _ev("Memcpy DtoH", "gpu_memcpy", 800 * us, 900 * us, tid=9),
        _ev("outside", "kernel", 2000 * us, 2100 * us, tid=9),
    ]
    s = trace.reduce(events, "bench.call")
    assert s["window_s"] == pytest.approx(1e-3)
    # busy: [100, 400] and [800, 900] us
    assert s["busy_s"] == pytest.approx(400e-6)
    idle = dict(s["idle_gaps"])
    # gaps [0,100] and [900,1000] (in the range, outside any op), [400,800]
    # (aten::item from 400)
    assert idle["aten::item"] == pytest.approx(400e-6)
    assert idle["bench.call"] == pytest.approx(200e-6)
    assert [k for k, _ in s["device_ops"]][0] == "gemm"
    ctx = type("Ctx", (), {})()
    ctx.trace, ctx.nv, ctx.traced_trips, ctx.batch = s, 148, 2, 256
    assert readers.device_idle(ctx) == pytest.approx(60.0)
    assert readers.launches_per_iter(ctx) == pytest.approx(1.0)
    # 1536 matrices of 148: 4 B (148*149/2 + 148^2 + 148) each over
    # 3.35e12 B/s = 0.0605 ms, against 150 us of kernel time
    bound = 4 * 1536 * (148 * 149 // 2 + 148 * 148 + 148) / 3.35e12
    assert bound_s(1536, 148) == pytest.approx(bound)
    assert readers.chol_linv_roofline(ctx) == pytest.approx(
        100 * bound / 150e-6)
    # a launch shape the reader cannot vouch for reads nothing: a grid
    # that is no whole multiple of the batch (several matrices a block),
    # or matrices too wide for one launch
    ctx.batch = 1024
    assert readers.chol_linv_roofline(ctx) is None
    ctx.batch, ctx.nv = 256, 361
    assert readers.chol_linv_roofline(ctx) is None


def test_roofline_reads_nothing_without_the_kernel():
    ctx = type("Ctx", (), {})()
    ctx.trace = dict(window_s=1.0, busy_s=0.5, kernels=[("gemm", 0.1, None)])
    ctx.nv, ctx.traced_trips, ctx.batch = 148, 1, 256
    assert readers.chol_linv_roofline(ctx) is None


# ---------------------------------------------------------------- card
@pytest.mark.cuda
def test_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_run_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
