"""The benchmark's shuttle reentry configuration through pycollo_tpu_torch.

Betts (2010), Example 6.1, as ``benchmark/problems/`` builds it from
``benchmark/configs/shuttle-reentry-betts61-k32.json``, held against the
benchmark's plain reference (``benchmark/reference/``, plain PyTorch) and
its judge (``benchmark/harness/judge.py``), on the CPU:

* the port's continuous dynamics equal the reference's at seeded random
  states and controls inside the bounds;
* the port's NLP constraints and objective equal the judge's transcription
  at seeded random ``x_full`` on a 4 x 4 mesh;
* a batch of four dispersed entries on an 8 x 4 mesh (n 192),
  warm-started from the nominal answer on that mesh
  (``scripts/shuttle_nominal_torch.py``'s solve there, from the committed
  nominal), solves on the float64 route to answers the judge accepts under
  the cell's limits, each the answer of its solve alone.  At 4 sections
  one answer rides a bound 2e-5 inside it, which the judge's ``stat`` reads
  as about 1e-5 on any route; the configuration's answers keep off every
  bound;
* four dispersed entries on the configuration's own mesh (32 x 4, n
  768, five blocks a factorization), warm-started from the committed
  nominal, solve on the cell's mixed route to answers the judge accepts
  under the cell's limits; on the f64 route's 8 x 4 mesh this route is not
  robust (some dispersed entries there wander off and stop at
  ``max_iter``);
* the committed nominal file holds what the script writes, at the
  configuration's sizes;
* on a mesh wide enough for two blocks, the factorization's counters
  (``blocked_chol_linv.blocks`` and ``.products``) and its span read the
  same through the replay's CPU stand-in as eagerly.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "scripts"))

from harness import traffic  # noqa: E402
from harness.collocation import Mesh  # noqa: E402
from harness.judge import Transcription  # noqa: E402

from pycollo_tpu_torch import profiling  # noqa: E402
from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.solver import ipm as ipm_mod  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

import shuttle_nominal_torch as nominal_script  # noqa: E402

torch.set_num_threads(2)

CONFIG = "shuttle-reentry-betts61-k32"
CELL = "shuttle-reentry-dispersion-b128"
CFG = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
WORKLOAD = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
#: the configuration's mixed route, through the multi-block factorization
MIXED = dict(tol=1e-6, kkt_precision="mixed", dc_floor=1e-7,
             dense_gmres_iters=12, eval_dtype="f32")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBLEM = _load(BENCH / "problems" / f"{CONFIG}.py", "shuttle_problem")
REFERENCE = _load(BENCH / "reference" / f"{CONFIG}.py", "shuttle_reference")


def _build(sections, nodes=4, nominal=PROBLEM.NOMINAL):
    problem = PROBLEM.build_problem(CFG["constants"], nominal=nominal)
    s = problem.settings
    s.console_out_progress = False
    s.nlp_tolerance = CFG["nlp_tolerance"]
    s.dtype = CFG["dtype"]
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = sections
    phase.mesh.number_mesh_section_nodes = nodes
    problem.initialise()
    return problem


@pytest.fixture(scope="module")
def ocp():
    return REFERENCE.problem(CFG["constants"])


@pytest.fixture(scope="module")
def coarse():
    """The problem on a 4 x 4 mesh, its guess the committed nominal."""
    return _build(4)


@pytest.fixture(scope="module")
def small_nominal(tmp_path_factory):
    """The script's nominal answer on an 8 x 4 mesh, from the committed
    one, as a file."""
    _, it, res = nominal_script.solve_nominal(CFG, 8, 4, PROBLEM.NOMINAL)
    rec = nominal_script.nominal_record(it, res, 8, 4)
    path = tmp_path_factory.mktemp("nominal") / "nominal_8x4.json"
    path.write_text(json.dumps(rec))
    return rec, path


def _random_x(tr, rng, M):
    """(M, n_full) points inside the transcription's bounds."""
    return tr.lo + rng.uniform(0.05, 0.95, (M, tr.n_full)) * (tr.hi - tr.lo)


def test_dynamics_equal_the_reference(coarse, ocp):
    rng = np.random.default_rng(61)
    M = 256
    lo, hi = ocp.state_bounds[:, 0], ocp.state_bounds[:, 1]
    y = lo[:, None] + rng.uniform(0.05, 0.95, (6, M)) * (hi - lo)[:, None]
    ulo, uhi = ocp.control_bounds[:, 0], ocp.control_bounds[:, 1]
    u = ulo[:, None] + rng.uniform(0.05, 0.95, (2, M)) * (uhi - ulo)[:, None]
    yt = torch.as_tensor(y, dtype=torch.float64)
    ut = torch.as_tensor(u, dtype=torch.float64)
    program = coarse.backend.program
    port = program.phase_functions[0].dynamics(
        yt, ut, torch.zeros(M, dtype=torch.float64),
        torch.zeros((0, M), dtype=torch.float64)).numpy()
    ref = ocp.dynamics(yt[None], ut[None])[0].numpy()
    assert port.shape == ref.shape == (6, M)
    scale = np.maximum(1.0, np.abs(ref))
    assert np.max(np.abs(port - ref) / scale) <= 1e-12


def test_nlp_equals_the_judges_transcription(coarse, ocp):
    it = coarse.backend.mesh_iterations[0]
    tr = Transcription(ocp, Mesh(4, 4))
    assert it.layout.n_full == tr.n_full == 8 * 13 + 2
    rng = np.random.default_rng(62)
    x = _random_x(tr, rng, 16)
    xt = torch.as_tensor(x, dtype=torch.float64)
    free = it.free_idx
    xs = (xt[:, free] - torch.as_tensor(it.r_full[free])) \
        / torch.as_tensor(it.V_full[free])
    c_port = it.c_unscaled(xs, xt).numpy()
    f_port = it.f_unscaled(xs, xt).numpy()
    c_ref = (tr.constraints(xt) * tr.row_scale).numpy()
    assert c_port.shape == c_ref.shape == (16, 6 * 12)
    np.testing.assert_allclose(c_port, c_ref, rtol=1e-12,
                               atol=1e-12 * np.abs(c_ref).max())
    np.testing.assert_allclose(f_port, tr.objective(xt).numpy(), rtol=1e-14)


def test_nominal_file_holds_what_the_script_writes(small_nominal):
    rec, _ = small_nominal
    committed = PROBLEM.read_nominal()
    assert set(committed) == set(rec)
    assert committed["mesh"] == CFG["mesh"]
    N = CFG["sizes"]["nodes"]
    assert len(committed["time"]) == N
    assert np.shape(committed["states"]) == (6, N)
    assert np.shape(committed["controls"]) == (2, N)
    assert committed["converged"] and rec["converged"]
    # the objective is the final latitude's negative, near the refined
    # answer (-0.59603) and GPOPS-II's (-0.59628)
    for r in (committed, rec):
        assert r["objective"] == pytest.approx(-r["states"][2][-1],
                                               abs=1e-12)
        assert r["time"][0] == 0.0
    assert abs(committed["objective"] + 0.59603) < 5e-4
    assert np.shape(rec["states"]) == (6, 25)
    # the configuration's sizes are the port's
    it = _build(4).backend.mesh_iterations[0]
    assert len(it.free_idx) == 8 * 13 + 2 - 10


def test_dispersed_batch_solves_and_each_instance_is_its_own(small_nominal,
                                                             ocp):
    _, path = small_nominal
    problem = _build(8, nominal=path)
    it = problem.backend.mesh_iterations[0]
    it.build_solver(IPMOptions(tol=CFG["nlp_tolerance"], max_iter=150))
    mix = dict(WORKLOAD["mix"], B=4)
    draws = traffic.batch(mix, 0)
    states = [str(v) for v in problem.phases[0].state_variables]
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (4, 1))
    for p in mix["perturb"]:
        theta[:, pl.y_off + states.index(p["state"]) * pl.N] = \
            draws[p["state"]]
    cpu = [torch.device("cpu")]
    res = solve_batched(problem.backend, theta_batch=theta, devices=cpu)
    assert np.asarray(res.converged).all()
    tr = Transcription(ocp, Mesh(8, 4))
    nominal = {s: v for s, v in ocp.initial.items() if v is not None}
    init = traffic.initial_values(mix, draws, nominal)
    initial = np.array([[init[s][i] if s in init else nominal[s]
                         for s in ocp.states] for i in range(4)])
    x = np.asarray(res.x_full)
    feas = np.maximum(tr.feasibility(x, tr.pinned_values(initial)),
                      tr.objective_gap(x, np.asarray(res.objective)))
    assert feas.max() <= WORKLOAD["limits"]["feas"]
    assert tr.stationarity(x).max() <= WORKLOAD["limits"]["stat"]
    for i in range(4):
        alone = solve_batched(problem.backend, theta_batch=theta[i:i + 1],
                              devices=cpu)
        np.testing.assert_allclose(np.asarray(alone.x_full)[0], x[i],
                                   rtol=1e-12, atol=1e-12)


def test_cells_mixed_route_certifies_dispersed_entries(ocp):
    problem = _build(CFG["mesh"]["sections"])
    it = problem.backend.mesh_iterations[0]
    assert len(it.free_idx) == CFG["sizes"]["n_free"]
    mix = dict(WORKLOAD["mix"], B=4)
    draws = traffic.batch(mix, 0)
    states = [str(v) for v in problem.phases[0].state_variables]
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (4, 1))
    for p in mix["perturb"]:
        theta[:, pl.y_off + states.index(p["state"]) * pl.N] = \
            draws[p["state"]]
    res = solve_batched(problem.backend, theta_batch=theta,
                        options=IPMOptions(**WORKLOAD["ipm"]),
                        devices=[torch.device("cpu")])
    assert np.asarray(res.converged).all()
    tr = Transcription(ocp, Mesh(CFG["mesh"]["sections"], 4))
    nominal = {s: v for s, v in ocp.initial.items() if v is not None}
    init = traffic.initial_values(mix, draws, nominal)
    initial = np.array([[init[s][i] if s in init else nominal[s]
                         for s in ocp.states] for i in range(4)])
    x = np.asarray(res.x_full)
    feas = np.maximum(tr.feasibility(x, tr.pinned_values(initial)),
                      tr.objective_gap(x, np.asarray(res.objective)))
    assert feas.max() <= WORKLOAD["limits"]["feas"]
    assert tr.stationarity(x).max() <= WORKLOAD["limits"]["stat"]


def _stand_in(device, kkt, opt):
    return kkt is None and opt.inertia == "speculative"


def _eager(device, kkt, opt):
    return False


def test_block_counters_read_the_same_through_the_replay(monkeypatch):
    """8 sections of 4 nodes: n 192, two blocks of 96 a factorization."""
    problem = _build(8)
    it = problem.backend.mesh_iterations[0]
    assert len(it.free_idx) == 192
    solver = it.build_solver(IPMOptions(**MIXED, max_iter=4))
    theta = torch.as_tensor(np.tile(it.theta_default, (4, 1)))
    x0 = torch.as_tensor(np.tile(it.xs_guess, (4, 1)))
    fn = blocked_chol_linv

    def solve(route):
        monkeypatch.setattr(ipm_mod, "_replays_trip", route)
        before = (fn.calls, fn.blocks, fn.products)
        with profiling.recording() as rec:
            res = solver(x0, theta)
        after = (fn.calls, fn.blocks, fn.products)
        return res, [a - b for a, b in zip(after, before)], rec

    ref, c_ref, rec_ref = solve(_eager)
    first, c_first, rec_first = solve(_stand_in)
    again, c_again, rec_again = solve(_stand_in)
    calls = c_ref[0]
    assert calls >= int(ref.iterations.max()) > 0
    # a block panel, a trailing update and two products of the inversion
    assert c_ref == [calls, 2 * calls, 4 * calls]
    assert c_first == c_again == c_ref
    for res in (first, again):
        for k in ("x", "lam", "iterations", "converged", "kkt_error"):
            assert torch.equal(getattr(res, k), getattr(ref, k)), k
    assert rec_again.counters["ipm.graph_replays"] == \
        rec_again.counters["ipm.trips"]
    # the span is each multi-block call's, eagerly and in the replayed
    # trip's code
    for rec in (rec_ref, rec_first, rec_again):
        assert rec.by_name()["block_chol.blocked"].count == calls
