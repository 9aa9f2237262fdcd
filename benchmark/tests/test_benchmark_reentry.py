"""Tests of the shuttle reentry cell's files and readers, on the CPU.

Run from the root of a checkout::

    python -m pytest benchmark/tests -q

They check that the readers of the multi-block factorization
(``harness/blocked.py``) read the program's counters per loop trip and the
kernel's roofline at the blocks' width, and nothing from a program without
the counters; that the shuttle's plain reference loads nothing of the
program; and that the shuttle cell's judge, on a small mesh, accepts the
program's answers and refuses planted faults.
"""

import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

import run  # noqa: E402
from harness import blocked, readers  # noqa: E402
from harness.collocation import Mesh  # noqa: E402
from harness.yardstick import bound_s  # noqa: E402

CELL = "shuttle-reentry-dispersion-b128"
SEED = 2 ** 31 + 61


def _ctx(**kw):
    ctx = types.SimpleNamespace(calls=[], trace=None, nv=768, batch=128,
                                traced_trips=0)
    ctx.__dict__.update(kw)
    return ctx


def _call(trips, factor_calls):
    return types.SimpleNamespace(iter_max=trips, factor_calls=factor_calls,
                                 solve_time=0.0)


def test_block_readers_scale_the_factor_calls(monkeypatch):
    fake = types.ModuleType(blocked.MODULE)

    def blocked_chol_linv():
        pass

    blocked_chol_linv.calls, blocked_chol_linv.blocks = 40, 200
    blocked_chol_linv.products = 2400
    fake.blocked_chol_linv = blocked_chol_linv
    monkeypatch.setitem(sys.modules, blocked.MODULE, fake)
    # 30 trips, 33 factorization calls: 1.1 calls a trip, 5 blocks and 60
    # products a call
    ctx = _ctx(calls=[_call(10, 11), _call(20, 22)])
    assert readers.factor_calls_per_iter(ctx) == pytest.approx(1.1)
    assert blocked.factor_blocks_per_iter(ctx) == pytest.approx(5.5)
    assert blocked.block_products_per_iter(ctx) == pytest.approx(66.0)


def test_block_readers_read_nothing_without_the_counters(monkeypatch):
    fake = types.ModuleType(blocked.MODULE)

    def blocked_chol_linv():
        pass

    blocked_chol_linv.calls = 40
    fake.blocked_chol_linv = blocked_chol_linv
    monkeypatch.setitem(sys.modules, blocked.MODULE, fake)
    ctx = _ctx(calls=[_call(10, 11)])
    assert blocked.factor_blocks_per_iter(ctx) is None
    assert blocked.block_products_per_iter(ctx) is None
    monkeypatch.delitem(sys.modules, blocked.MODULE)
    assert blocked.factor_blocks_per_iter(ctx) is None


def test_roofline_at_the_blocks_width():
    assert blocked.block_width(768) == 154
    assert blocked.block_width(628) == 157
    assert blocked.block_width(161) == 81
    us = 1e-6
    trace = dict(window_s=1.0, busy_s=0.5, kernels=[
        ("gemm", 100 * us, (4, 1, 1)),
        ("chol_linv_kernel<256>", 300 * us, (768, 1, 1)),
        ("chol_linv_kernel<256>", 200 * us, (128, 1, 1))])
    ctx = _ctx(trace=trace)
    want = 100 * (bound_s(768, 154) + bound_s(128, 154)) / (500 * us)
    assert blocked.chol_linv_roofline(ctx) == pytest.approx(want)
    # one block wide: the sweep's reader reads it, this one nothing; the
    # sweep's reader is the same loop at the matrix's own width
    one = _ctx(trace=trace, nv=148)
    assert blocked.chol_linv_roofline(one) is None
    assert readers.chol_linv_roofline(ctx) is None
    assert blocked.roofline_at(one, lambda n: n) == \
        readers.chol_linv_roofline(one)
    # a grid that is no whole multiple of the batch
    trace["kernels"].append(("chol_linv_kernel<256>", 1 * us, (100, 1, 1)))
    assert blocked.chol_linv_roofline(ctx) is None


def test_reference_loads_nothing_of_the_program():
    code = f"""
import sys, json
import numpy as np
sys.path.insert(0, 'benchmark')
from harness.collocation import Mesh
from harness.judge import Transcription
import run
cfg = json.load(open('benchmark/configs/shuttle-reentry-betts61-k32.json'))
ocp = run.load_module(run.BENCH / 'reference'
                      / 'shuttle-reentry-betts61-k32.py').problem(
    cfg['constants'])
tr = Transcription(ocp, Mesh(2, 4))
x = 0.5 * (tr.lo + tr.hi)[None].repeat(2, 0)
init = np.array([[v if v is not None else np.nan
                  for v in ocp.initial.values()]] * 2)
tr.feasibility(x, tr.pinned_values(init))
tr.stationarity(x)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert not loaded & {"pycollo_tpu_torch", "pycollo_tpu", "jax",
                         "jaxlib", "flax"}


@pytest.fixture(scope="module")
def shuttle():
    import torch
    torch.set_num_threads(2)
    cell = run.load_cell(CELL)
    mesh = Mesh(4, 4)
    prog = run.Program(cell, "cpu", mesh)
    mix = dict(cell.workload["mix"], B=2)
    ocp = run.reference_problem(cell)
    nominal = {s: v for s, v in ocp.initial.items() if v is not None}
    calls = [run.make_call(prog, mix, k, nominal) for k in range(2)]
    return cell, mesh, prog, calls


def test_judge_accepts_the_programs_answers(shuttle):
    cell, mesh, _, calls = shuttle
    assert all(c.converged.all() for c in calls)
    verdict = run.judge(cell, mesh, calls, SEED)
    assert verdict["correct"], verdict["checks"]
    assert list(verdict["checks"]) == ["feas", "stat", "uncertified"]


@pytest.mark.parametrize("fault", ["answer_altered", "final_time_altered"])
def test_planted_faults_come_out_not_correct(shuttle, fault):
    cell, mesh, prog, calls = shuttle
    c = calls[0]
    bad = types.SimpleNamespace(**vars(c))
    bad.x_full = c.x_full.copy()
    pl = prog.it.layout.phases[0]
    if fault == "answer_altered":
        # one bank-angle value of one answer moved by a tenth of a degree
        bad.x_full[0, pl.u_off + pl.N + 3] += np.pi / 1800
    else:
        # the final time of one answer a second later
        bad.x_full[1, pl.t_off + 1] += 1.0
    verdict = run.judge(cell, mesh, [bad], SEED)
    assert not verdict["correct"]
    assert verdict["checks"]["feas"]["value"] > \
        cell.workload["limits"]["feas"]
