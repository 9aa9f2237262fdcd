"""The port's mesh refinement loop against the JAX package, on the CPU.

* Scaling at mesh iterations 2 and 3: both packages build them from the
  same mesh tables, guesses and parameter guess (numpy, carried across),
  with ``settings.update_scaling`` off and on (the cross-iteration EWMA),
  on the multiphase point-move problem at 2 sections x 4 nodes per phase
  (path and endpoint constraints, integrals, a parameter).  The scales,
  the guess and the default parameters agree to 1e-12 relative.
* Brachistochrone at 2 sections x 4 nodes, Lobatto and Radau, from the
  reference's first-iteration ``x_full`` carried across: the solution
  data, its interpolation, the mesh errors, the next mesh (sections and
  nodes exactly) and the next guesses agree to 1e-10; the warm start built
  from the reference's multipliers agrees to 1e-12.
* ``problem.solve()`` on the same problems: the same mesh history, the
  objective to 1e-8 relative, the mesh tolerance met, and GPOPS-II's
  0.82434 to 1e-4.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from brachistochrone import build_problem as brach_jax  # noqa: E402
from brachistochrone_torch import build_problem as brach_torch  # noqa: E402
from multiphase_point_move import build_problem as mp_jax  # noqa: E402
from multiphase_point_move_torch import build_problem as mp_torch  # noqa: E402
from pycollo_tpu import mesh as jax_mesh  # noqa: E402
from pycollo_tpu.refinement import build_warm_start as jax_warm  # noqa: E402
from pycollo_tpu.solution import Solution as JaxSolution  # noqa: E402
from pycollo_tpu_torch import guess as port_guess  # noqa: E402
from pycollo_tpu_torch import mesh as port_mesh  # noqa: E402
from pycollo_tpu_torch.refinement import build_warm_start  # noqa: E402
from pycollo_tpu_torch.solution import Solution  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMResult  # noqa: E402
from pycollo_tpu_torch.transcription import IterationResult  # noqa: E402

torch.set_num_threads(2)

#: the scaling is the same float64 numpy code over Jacobians that agree to
#: the last digits
SCALE_TOL = 1e-12
#: solution post-processing: the dynamics evaluated by two frontends
POST_TOL = 1e-10
GPOPS_BRACHISTOCHRONE = 0.82434


def _setup(build, K=2, nodes=4, method="lobatto", update_scaling=False):
    problem = build()
    problem.settings.console_out_progress = False
    problem.settings.quadrature_method = method
    problem.settings.update_scaling = update_scaling
    for phase in problem.phases:
        phase.mesh.number_mesh_sections = K
        phase.mesh.number_mesh_section_nodes = nodes
    problem.initialise()
    return problem


def _carry_tables(t):
    """A reference ``PhaseMeshTables`` as the port's (numpy fields)."""
    return port_mesh.PhaseMeshTables(
        **{f.name: getattr(t, f.name) for f in dataclasses.fields(t)})


def _carry_guess(g):
    return port_guess.ProcessedPhaseGuess(tau=g.tau, y=g.y, u=g.u, q=g.q,
                                          t0=g.t0, tF=g.tF)


def _close(a, b, tol, what):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), rtol=tol,
                               atol=tol, err_msg=what)


# -- scaling at mesh iterations 2 and 3 ----------------------------------

def _next_mesh(rng, it):
    """Seeded tables and guesses for a next iteration of ``it``'s problem
    (reference types; each phase gets 3 sections of random size)."""
    tables, guesses = [], []
    for t, g in zip(it.tables, it.phase_guesses):
        sizes = rng.uniform(0.5, 1.5, 3)
        nodes = rng.integers(4, 8, 3)
        tables.append(jax_mesh.build_phase_tables(t.method, sizes, nodes))
        tau = np.linspace(-1.0, 1.0, 9)
        y = g.interpolate(tau)[0] * (1.0 + 0.2 * rng.standard_normal(
            (g.y.shape[0], 9))) + 0.1 * rng.standard_normal((g.y.shape[0], 9))
        u = 0.5 + rng.standard_normal((g.u.shape[0], 9))
        guesses.append(type(g)(tau=tau, y=y, u=u,
                               q=rng.uniform(0.5, 5.0, len(g.q)),
                               t0=g.t0, tF=g.tF * rng.uniform(0.9, 1.1)))
    return tables, guesses


@pytest.mark.parametrize("update_scaling", [False, True])
def test_scaling_at_mesh_iterations_2_and_3(update_scaling):
    pj = _setup(mp_jax, update_scaling=update_scaling)
    pt = _setup(mp_torch, update_scaling=update_scaling)
    rng = np.random.default_rng(2)
    for number in (2, 3):
        tables, guesses = _next_mesh(rng, pj.backend.mesh_iterations[-1])
        s_guess = rng.uniform(1.0, 2.0, 1)
        itj = pj.backend.new_mesh_iteration(tables, guesses, s_guess)
        itt = pt.backend.new_mesh_iteration(
            [_carry_tables(t) for t in tables],
            [_carry_guess(g) for g in guesses], s_guess)
        assert itj.number == itt.number == number
        np.testing.assert_array_equal(itt.free_idx, itj.free_idx)
        for name in ("V_ocp", "r_ocp", "W_ocp", "W_c", "V_full", "r_full",
                     "xs_guess", "theta_default"):
            np.testing.assert_allclose(getattr(itt, name),
                                       getattr(itj, name), rtol=SCALE_TOL,
                                       atol=0, err_msg=f"{name} #{number}")
        for name in ("w", "w_base"):
            assert getattr(itt, name) == pytest.approx(getattr(itj, name),
                                                       rel=SCALE_TOL), name
    if update_scaling:
        # the EWMA moved the scales away from the bounds-only ones
        V_bounds = pt.backend.mesh_iterations[0].V_ocp
        assert not np.allclose(pt.backend.mesh_iterations[-1].V_ocp,
                               V_bounds)


# -- solution, refinement and warm start from carried state -------------

@pytest.fixture(scope="module", params=["lobatto", "radau"])
def carried(request):
    """Both packages' brachistochrone at 2 x 4, and the reference's solve
    of its first mesh iteration."""
    pj = _setup(brach_jax, method=request.param)
    pt = _setup(brach_torch, method=request.param)
    rj = pj.backend.mesh_iterations[0].solve()
    assert rj.converged
    itt = pt.backend.mesh_iterations[0]
    rt = IterationResult(
        iteration=itt, x_full=np.asarray(rj.x_full), solve_time=0.0,
        ipm_result=IPMResult(*(torch.tensor(np.asarray(f))
                               for f in rj.ipm_result)))
    return pj, pt, rj, rt


def _compare_refinement(ref_j, ref_t):
    for name in ("absolute_mesh_errors", "relative_mesh_errors"):
        for ej, et in zip(getattr(ref_j, name), getattr(ref_t, name)):
            for a, b in zip(ej, et):
                _close(b, a, POST_TOL, name)
    for a, b in zip(ref_j.maximum_relative_mesh_errors,
                    ref_t.maximum_relative_mesh_errors):
        _close(b, a, POST_TOL, "maximum_relative_mesh_errors")
    for tj, tt in zip(ref_j.next_tables, ref_t.next_tables):
        assert (tt.method, tt.K, tt.N, tt.num_defect) \
            == (tj.method, tj.K, tj.N, tj.num_defect)
        np.testing.assert_array_equal(tt.section_nodes, tj.section_nodes)
        np.testing.assert_array_equal(tt.section_starts, tj.section_starts)
        for name in ("tau", "h_sections", "E", "I", "W"):
            _close(getattr(tt, name), getattr(tj, name), POST_TOL, name)
    for gj, gt in zip(ref_j.next_guesses, ref_t.next_guesses):
        for name in ("tau", "y", "u", "q", "t0", "tF"):
            _close(getattr(gt, name), getattr(gj, name), POST_TOL, name)


def test_solution_and_refinement_from_carried_state(carried):
    pj, pt, rj, rt = carried
    sol_j = JaxSolution(rj)
    sol_t = Solution(rt)
    _close(sol_t.parameter, sol_j.parameter, POST_TOL, "parameter")
    for dj, dt in zip(sol_j.phase_data, sol_t.phase_data):
        for f in dataclasses.fields(dj):
            _close(getattr(dt, f.name), getattr(dj, f.name), POST_TOL,
                   f.name)
    tau_q = np.concatenate([[-1.0], np.sort(np.random.default_rng(0)
                                            .uniform(-1, 1, 50)), [1.0]])
    for a, b in zip(sol_j.interpolate_phase(0, tau_q),
                    sol_t.interpolate_phase(0, tau_q)):
        _close(b, a, POST_TOL, "interpolate_phase")

    ref_j = sol_j.refine_mesh()
    ref_t = sol_t.refine_mesh()
    assert ref_t.max_relative_mesh_error > pt.settings.mesh_tolerance
    _compare_refinement(ref_j, ref_t)
    # The stagnation heuristic (error no better than half the previous
    # one) subdivides instead of raising the order.
    prev = [ref_j.max_relative_mesh_error]
    stag_j = sol_j.refine_mesh(prev_max_errors=prev)
    stag_t = sol_t.refine_mesh(prev_max_errors=prev)
    assert stag_t.next_tables[0].K >= ref_t.next_tables[0].K
    assert (stag_t.next_tables[0].section_nodes
            == pt.settings.collocation_points_min).all()
    _compare_refinement(stag_j, stag_t)


def test_plot_solution_and_mesh(carried):
    """``Solution.plot``/``plot_mesh`` draw the port's solution (matplotlib,
    imported only here)."""
    pytest.importorskip("matplotlib")
    sol = Solution(carried[3])
    fig = sol.plot(show=False)
    assert len(fig.axes) == 3
    fig = sol.plot_mesh(show=False)
    assert len(fig.axes) == 1


def test_warm_start_from_carried_multipliers(carried):
    pj, pt, rj, rt = carried
    ref_j = JaxSolution(rj).refine_mesh()
    itj1 = pj.backend.mesh_iterations[0]
    itt1 = pt.backend.mesh_iterations[0]
    s = np.asarray(rj.x_full)[itj1.layout.s_slice]
    itj2 = pj.backend.new_mesh_iteration(ref_j.next_tables,
                                         ref_j.next_guesses, s)
    itt2 = pt.backend.new_mesh_iteration(
        [_carry_tables(t) for t in ref_j.next_tables],
        [_carry_guess(g) for g in ref_j.next_guesses], s)
    wj = jax_warm(rj, itj1, itj2)
    wt = build_warm_start(rt, itt1, itt2)
    assert wt["lam"].shape == (itt2.layout.m_total,)
    assert wt["zl"].shape == wt["zu"].shape == (itt2.n_free,)
    for name in ("lam", "zl", "zu"):
        np.testing.assert_allclose(wt[name], np.asarray(wj[name]),
                                   rtol=SCALE_TOL, atol=SCALE_TOL,
                                   err_msg=name)
    assert wt["mu"] == pytest.approx(float(wj["mu"]), rel=SCALE_TOL)


# -- the whole loop ------------------------------------------------------

def _history(problem):
    return [[(t.K, t.N) for t in r.iteration.tables]
            for r in problem.mesh_iterations]


@pytest.mark.parametrize("method", ["lobatto", "radau"])
def test_solve_matches_reference(method):
    pj = _setup(brach_jax, method=method)
    pt = _setup(brach_torch, method=method)
    sol_j = pj.solve()
    sol_t = pt.solve(device="cpu")
    assert pt.mesh_tolerance_met and pj.mesh_tolerance_met
    assert len(pt.mesh_iterations) > 1
    assert _history(pt) == _history(pj)
    assert sol_t.objective == pytest.approx(sol_j.objective, rel=1e-8)
    assert sol_t.objective == pytest.approx(GPOPS_BRACHISTOCHRONE, rel=1e-4)
    for r in pt.mesh_iterations:
        assert r.ipm_result.x.device.type == "cpu"
        assert r.ipm_result.x.dtype == torch.float64
