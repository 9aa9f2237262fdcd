"""The dense IPM trip replayed as CUDA graphs (``solver/graphs.py``).

On a card the trip is captured once per solver and batch shape as CUDA
graphs, split where it runs eagerly (the escalation loop, and MAGMA's
batched ``cholesky_solve`` in GMRES), and replayed every trip.  On the CPU
the same static buffers, write-back, eager calls and counter replay run
through the graphs' stand-in (``graphs.Replay``: the capture is a direct
call), which these tests reach by patching the route's predicate
``ipm._replays_trip``.

Cart-pole swing-up on 2 mesh sections x 4 nodes, eight instances with
perturbed initial states (the ``bench.py`` recipe), through the mixed route
of the benchmark's cell, with and without escalation trips:

* the replayed solve's answers equal the eager trip's, bit for bit;
* its counters hold the identities of ``test_torch_tracing.py`` and equal
  the eager solve's, factorization calls included, and a second call
  replays without capturing;
* the predicate keeps the CPU, the block-banded step and the loop inertia
  on the eager trip;
* taped counts are made by each replay and by nothing else, and a
  recording that raises leaves no tape, recording or paused collector.

The ``cuda`` test does the same on the card with CUDA graphs, at B = 256
on the default mesh (no JAX here: ``--noconftest`` runs it there).
"""

import gc
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from cart_pole_swing_up_torch import build_problem  # noqa: E402
from pycollo_tpu_torch import profiling  # noqa: E402
from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.solver import graphs  # noqa: E402
from pycollo_tpu_torch.solver import ipm as ipm_mod  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

torch.set_num_threads(2)

#: the benchmark cell's route (benchmark/workloads/cartpole-sweep-b1024.json)
MIXED = dict(tol=1e-6, max_iter=80, kkt_precision="mixed", dc_floor=1e-7,
             dense_gmres_iters=12, eval_dtype="f32")
#: the same with a one-level ladder: some trips escalate
ESCALATING = dict(MIXED, spec_levels=())
#: the f64 route (``bench.py``'s), whose step is refined by two rounds of
#: iterative refinement on its factors in place of GMRES
F64 = dict(tol=1e-6, max_iter=80)
RESULT_FIELDS = ("x", "lam", "iterations", "converged", "kkt_error")
#: graphs of a mixed trip: its eager calls (the escalation loop, and
#: GMRES's least-squares solve in the step and in the corrector) split it
GRAPHS = 4
#: graphs of an f64 trip: split at the escalation loop and at its four
#: solves on the factors (three in the step, one in the corrector)
GRAPHS_F64 = 6


def _stand_in(device, kkt, opt):
    """``_replays_trip`` without its CUDA condition."""
    return kkt is None and opt.inertia == "speculative"


def _eager(device, kkt, opt):
    return False


def _theta(it, B, seed=0):
    rng = np.random.default_rng(seed)
    pl = it.layout.phases[0]
    th = np.tile(it.theta_default, (B, 1))
    th[:, pl.y_off + 0 * pl.N] = rng.uniform(-0.25, 0.25, B)
    th[:, pl.y_off + 1 * pl.N] = rng.uniform(-0.3, 0.3, B)
    return th


def _cart_pole(sections=None, nodes=None):
    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.settings.nlp_tolerance = 1e-6
    if sections is not None:
        phase = problem.phases[0]
        phase.mesh.number_mesh_sections = sections
        phase.mesh.number_mesh_section_nodes = nodes
    problem.initialise()
    return problem


@pytest.fixture(scope="module")
def problem():
    return _cart_pole(2, 4)


def _recorded_solve(solver, it, theta):
    """One call of ``solver`` inside a recording: the result, the
    counters and the factorization calls it made."""
    dev, dt = theta.device, theta.dtype
    x0 = torch.as_tensor(np.tile(it.xs_guess, (theta.shape[0], 1)),
                         dtype=dt, device=dev)
    calls = blocked_chol_linv.calls
    with profiling.recording() as rec:
        res = solver(x0, theta)
    return res, Counter(rec.counters), blocked_chol_linv.calls - calls


def _assert_equal(res, ref):
    for k in RESULT_FIELDS:
        a, b = getattr(res, k), getattr(ref, k)
        assert torch.equal(a, b), (k, (a != b).sum().item())


def _assert_identities(c, res, factor_calls, B):
    trips = c["ipm.trips"]
    assert trips == int(res.iterations.max())
    assert c["ipm.active_rows"] == int(res.iterations.sum())
    assert c["ipm.rows_computed"] == B * trips
    if factor_calls is not None:      # kernel calls: the mixed route
        assert c["ipm.escalation_trips"] == factor_calls - trips
    assert c["ipm.escalation_rows_factored"] == B * c["ipm.escalation_trips"]
    assert 0 <= c["ipm.escalation_rows"] <= c["ipm.escalation_rows_factored"]
    assert c["ipm.syncs"] == 2 * trips + c["ipm.escalation_trips"] + 1


# ------------------------------------------------------------ the CPU
@pytest.mark.parametrize("opts, graphs",
                         [(MIXED, GRAPHS), (ESCALATING, GRAPHS),
                          (F64, GRAPHS_F64)],
                         ids=["ladder", "escalating", "f64"])
def test_replay_equals_the_eager_trip_and_counts_as_it(problem, opts, graphs,
                                                       monkeypatch):
    it = problem.backend.mesh_iterations[0]
    solver = it.build_solver(IPMOptions(**opts))
    theta = torch.as_tensor(_theta(it, 8), dtype=torch.float64)
    monkeypatch.setattr(ipm_mod, "_replays_trip", _eager)
    ref, c_ref, calls_ref = _recorded_solve(solver, it, theta)
    monkeypatch.setattr(ipm_mod, "_replays_trip", _stand_in)
    first, c_first, calls_first = _recorded_solve(solver, it, theta)
    again, c_again, calls_again = _recorded_solve(solver, it, theta)
    assert "ipm.graph_replays" not in c_ref
    for res, c, calls in ((first, c_first, calls_first),
                          (again, c_again, calls_again)):
        _assert_equal(res, ref)
        _assert_identities(c, res, calls if opts is not F64 else None, 8)
        assert calls == calls_ref
        assert c["ipm.graph_replays"] == c["ipm.trips"]
        replayed = Counter(c)
        del replayed["ipm.graph_replays"], replayed["ipm.graph_captures"]
        assert replayed == c_ref
    assert c_first["ipm.graph_captures"] == graphs
    assert c_again["ipm.graph_captures"] == 0
    if opts is ESCALATING:
        assert c_ref["ipm.escalation_trips"] > 0


def test_replay_keeps_one_trip_per_batch_shape(problem, monkeypatch):
    """A call of another batch size captures its own graphs, and returns
    nothing that a later call overwrites."""
    it = problem.backend.mesh_iterations[0]
    solver = it.build_solver(IPMOptions(**MIXED))
    monkeypatch.setattr(ipm_mod, "_replays_trip", _stand_in)
    th8 = torch.as_tensor(_theta(it, 8), dtype=torch.float64)
    th4 = torch.as_tensor(_theta(it, 4, seed=1), dtype=torch.float64)
    r8, c8, _ = _recorded_solve(solver, it, th8)
    r4, c4, _ = _recorded_solve(solver, it, th4)
    kept = {k: getattr(r8, k).clone() for k in RESULT_FIELDS + ("mu",)}
    r8b, c8b, _ = _recorded_solve(solver, it, th8)
    assert c8["ipm.graph_captures"] == c4["ipm.graph_captures"] == GRAPHS
    assert c8b["ipm.graph_captures"] == 0
    _assert_equal(r8b, r8)
    for k, v in kept.items():
        assert torch.equal(getattr(r8, k), v), k
    monkeypatch.setattr(ipm_mod, "_replays_trip", _eager)
    _assert_equal(r4, _recorded_solve(solver, it, th4)[0])


def test_only_the_dense_speculative_route_on_a_card_replays(problem):
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    spec = IPMOptions(**MIXED)
    loop = IPMOptions(**dict(MIXED, inertia="loop"))
    banded = object()
    assert ipm_mod._replays_trip(card, None, spec)
    assert not ipm_mod._replays_trip(cpu, None, spec)
    assert not ipm_mod._replays_trip(card, banded, spec)
    assert not ipm_mod._replays_trip(card, None, loop)
    # the solves themselves: on the CPU, the banded step and the loop
    # inertia run the eager trip
    it = problem.backend.mesh_iterations[0]
    theta = _theta(it, 4)
    s = problem.settings
    for opts, linear_solver in ((MIXED, s.linear_solver),
                                (dict(MIXED, inertia="loop", max_iter=3),
                                 s.linear_solver),
                                (dict(tol=1e-6, max_iter=2),
                                 "block-banded")):
        dense, s.linear_solver = s.linear_solver, linear_solver
        try:
            it.build_solver(IPMOptions(**opts))
        finally:
            s.linear_solver = dense
        with profiling.recording() as rec:
            solve_batched(problem.backend, theta_batch=theta,
                          devices=[cpu])
        assert rec.counters["ipm.trips"] > 0
        assert "ipm.graph_replays" not in rec.counters
        assert "ipm.capture" not in rec.by_name()


def test_a_recording_that_raises_leaves_nothing_open():
    def trip(x):
        profiling.count("n")
        graphs.eager(x.add_, 1.0)
        raise RuntimeError("fault in the trip")

    replay = graphs.Replay(trip, torch.zeros(3))
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError, match="fault in the trip"):
            replay.run()
    assert replay.pieces is None
    assert profiling._local.tape is None and graphs._local.recording is None
    assert gc.isenabled()
    # the graph before the eager call ran, and counted
    assert rec.counters == {"n": 1}


def test_taped_counts_are_made_by_replays_alone():
    bumps = []
    with profiling.recording() as rec:
        with profiling.taping() as tape:
            profiling.count("n", 2)
            profiling.count("rows", torch.tensor([True, False, True]))
            profiling.bump(bumps.append, "x")
        assert bumps == [] and rec.counters == {}
        profiling.replay(tape)
        profiling.replay(tape)
    assert bumps == ["x", "x"]
    assert rec.counters == {"n": 4, "rows": 4}
    assert profiling._local.tape is None


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_graphs_equal_the_eager_trip(card, monkeypatch):
    """B = 256 on the default mesh: two calls through the graphs (the first
    captures) and one eager, the same instances."""
    problem = _cart_pole()
    it = problem.backend.mesh_iterations[0]
    solver = it.build_solver(IPMOptions(**MIXED))
    theta = torch.as_tensor(_theta(it, 256), dtype=torch.float64,
                            device=card)
    first, c_first, _ = _recorded_solve(solver, it, theta)
    again, c_again, calls_again = _recorded_solve(solver, it, theta)
    monkeypatch.setattr(ipm_mod, "_replays_trip", _eager)
    ref, c_ref, calls_ref = _recorded_solve(solver, it, theta)
    assert c_first["ipm.graph_captures"] == GRAPHS
    assert c_again["ipm.graph_captures"] == 0
    assert c_again["ipm.graph_replays"] == c_again["ipm.trips"] > 0
    assert calls_again == calls_ref
    for res in (first, again):
        _assert_equal(res, ref)
        np.testing.assert_array_equal(
            it.assemble_full(res.x, theta).cpu().numpy(),
            it.assemble_full(ref.x, theta).cpu().numpy())
    _assert_identities(c_again, again, calls_again, 256)
    replayed = Counter(c_again)
    del replayed["ipm.graph_replays"]
    assert replayed == c_ref
