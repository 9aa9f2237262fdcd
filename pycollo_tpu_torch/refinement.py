"""ph-adaptive mesh refinement (Patterson-Rao) and the outer solve loop.

Capability parity with ``pycollo/mesh_refinement.py`` (397 LoC) and the
mesh-iteration loop in ``pycollo/optimal_control_problem.py:387-443``:

* error estimation on a "ph mesh" with one extra node per section
  (``mesh_refinement.py:75-86``): the solution polynomials are evaluated on
  the ph mesh, the dynamics are integrated section-wise there, and the
  defect between the integrated and interpolated states gives the absolute
  error; relative error normalizes by (1 + max |Y|)
  (``mesh_refinement.py:206-240``);
* refinement decision per section (``mesh_refinement.py:242-392``):
  polynomial-order increase ``P_q = ceil(log(err/tol) / log(N_k))``,
  node-count reduction for over-resolved sections, subdivision into
  ``ceil(predicted / min)`` equal subsections at the minimum node count
  when the predicted order exceeds the maximum.  (The reference's
  section-merge path is dead code — ``MERGE_TOLERANCE_FACTOR = 0`` at
  ``mesh_refinement.py:333`` makes ``merge_required`` always false — so it
  is intentionally not reproduced.)

The error estimator, the decisions and the warm start run on host numpy
(the dynamics in float64 on the CPU) between solves: they are O(K * n)
work.  The NLP solve itself runs on the device the loop is given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import quadrature as quad
from .guess import ProcessedPhaseGuess
from .mesh import PhaseMeshTables, build_phase_tables
from .solution import Solution, eval_dynamics
from .utils import console_out, solve_device


class PattersonRaoMeshRefinement:
    """Mesh error estimation + next-mesh proposal for one solution.

    ``prev_max_errors`` (per-phase scalars from the previous mesh
    iteration) enables a stagnation heuristic beyond the reference: when a
    phase's error stopped improving (non-smooth solution features such as
    bang-bang control switches, where raising the polynomial order cannot
    help), the offending sections are subdivided instead of order-bumped.
    """

    def __init__(self, solution: Solution, prev_max_errors=None):
        self.sol = solution
        self.iteration = solution.iteration
        self.settings = self.iteration.settings
        self.backend = solution.backend
        self.prev_max_errors = prev_max_errors
        self.absolute_mesh_errors: List[np.ndarray] = []
        self.relative_mesh_errors: List[np.ndarray] = []
        self.maximum_relative_mesh_errors: List[np.ndarray] = []
        self.mesh_error()
        self.next_tables, self.next_guesses = self.next_iteration_mesh()

    # -- error estimation ------------------------------------------------
    def mesh_error(self):
        program = self.backend.program
        s = self.sol.parameter
        for i, (t, pd) in enumerate(zip(self.iteration.tables,
                                        self.sol.phase_data)):
            pf = program.phase_functions[i]
            abs_errs = []
            rel_errs = []
            sec_bounds = np.concatenate(
                [t.tau[t.section_starts], [t.tau[-1]]])
            for k in range(t.K):
                n_k = int(t.section_nodes[k])
                lo, hi = sec_bounds[k], sec_bounds[k + 1]
                h_k = hi - lo
                # ph mesh: one extra node in this section.
                sch_ph = quad.scheme(t.method, n_k + 1)
                tau_ph = lo + 0.5 * h_k * (sch_ph.points + 1.0)
                y_ph, u_ph = self.sol.interpolate_phase(i, tau_ph)
                time_ph = pd.stretch * tau_ph + pd.shift
                f_ph = eval_dynamics(pf, y_ph, u_ph, time_ph, s).T
                ncol_ph = sch_ph.num_collocation
                # Integrate the dynamics through the section on the ph mesh.
                Y = y_ph[:, 0:1].T + pd.stretch * 0.5 * h_k * (
                    sch_ph.integration[:, :ncol_ph] @ f_ph[:ncol_ph])
                abs_err = np.abs(Y - y_ph[:, 1:].T)         # (n_k, ny)
                scale = 1.0 + np.max(np.abs(y_ph), axis=1)  # (ny,)
                rel_err = abs_err / scale[None, :]
                abs_errs.append(abs_err)
                rel_errs.append(rel_err)
            self.absolute_mesh_errors.append(abs_errs)
            self.relative_mesh_errors.append(rel_errs)
            self.maximum_relative_mesh_errors.append(
                np.array([e.max() if e.size else 0.0 for e in rel_errs]))

    @property
    def max_relative_mesh_error(self) -> float:
        return max((float(m.max()) if m.size else 0.0
                    for m in self.maximum_relative_mesh_errors),
                   default=0.0)

    # -- next mesh -------------------------------------------------------
    def next_iteration_mesh(self):
        tables = []
        guesses = []
        for i, t in enumerate(self.iteration.tables):
            new_t = self.next_iteration_phase_mesh(i, t)
            tables.append(new_t)
            guesses.append(self._guess_on_mesh(i, new_t))
        return tables, guesses

    def next_iteration_phase_mesh(self, i: int,
                                  t: PhaseMeshTables) -> PhaseMeshTables:
        mesh_tol = self.settings.mesh_tolerance
        n_min = self.settings.collocation_points_min
        n_max = self.settings.collocation_points_max
        max_errs = self.maximum_relative_mesh_errors[i]
        if max_errs.size == 0 or max_errs.max() <= mesh_tol:
            return t  # phase already meets tolerance; keep its mesh

        N_k = t.section_nodes.astype(int)
        h_k = t.h_sections / t.h_sections.sum()
        with np.errstate(divide="ignore"):
            ratio = np.maximum(max_errs / mesh_tol, 1e-300)
            P_q = np.ceil(np.log(ratio) / np.log(N_k)).astype(int)
        # Over-resolved sections: soften the node reduction
        # (``mesh_refinement.py:328-340``).
        neg = P_q <= 0
        P_q[neg] = P_q[neg] + np.ceil(np.log(-P_q[neg] + 1.0)).astype(int)
        with np.errstate(divide="ignore"):
            log_tol = np.log(np.maximum(mesh_tol / np.maximum(max_errs,
                                                              1e-300),
                                        1e-300))
        reduction_tol = np.clip(1.0 + 1.0 / log_tol, 0.0, None)
        predicted = N_k + P_q
        predicted[neg] = (np.ceil(P_q[neg] * reduction_tol[neg])
                          + N_k[neg]).astype(int)
        subdivide = predicted >= n_max
        # Stagnation heuristic: error not improving -> the feature is not
        # resolvable by order increase (e.g. a control discontinuity);
        # split the offending sections instead.
        if (self.prev_max_errors is not None
                and self.prev_max_errors[i] is not None
                and max_errs.max() > 0.5 * self.prev_max_errors[i]):
            subdivide = subdivide | (max_errs > mesh_tol)

        new_sizes = []
        new_nodes = []
        for k in range(len(N_k)):
            if subdivide[k]:
                parts = int(np.ceil(predicted[k] / n_min))
                new_sizes.extend([h_k[k] / parts] * parts)
                new_nodes.extend([n_min] * parts)
            else:
                new_sizes.append(h_k[k])
                new_nodes.append(int(np.clip(predicted[k], n_min, n_max)))
        return build_phase_tables(t.method, new_sizes, new_nodes)

    def _guess_on_mesh(self, i: int,
                       new_t: PhaseMeshTables) -> ProcessedPhaseGuess:
        """Linear re-interpolation of the previous solution as the next
        guess (parity with ``pycollo/iteration.py:86-194``, which uses
        ``scipy.interpolate.interp1d`` with default linear kind).

        Deliberately NOT the high-order collocation-polynomial extension
        used for error estimation: Lagrange interpolation of near-bang-
        bang controls overshoots (Runge), seeding the refined NLP with
        oscillatory iterates near saddle points.
        """
        pd = self.sol.phase_data[i]
        t_old = self.sol.iteration.tables[i]
        y_new = np.vstack([np.interp(new_t.tau, t_old.tau, row)
                           for row in pd.y])
        u_new = np.vstack([np.interp(new_t.tau, t_old.tau, row)
                           for row in pd.u]) if pd.u.shape[0] else \
            np.zeros((0, len(new_t.tau)))
        return ProcessedPhaseGuess(tau=new_t.tau, y=y_new, u=u_new,
                                   q=pd.q, t0=pd.t0, tF=pd.tF)


def _display_mesh_result_info(solution, iteration):
    """Per-iteration solution report (``settings.display_mesh_result_info``;
    reference analogue: ``pycollo/iteration.py:607-646``)."""
    console_out(f"Mesh iteration {iteration.number} result", heading=True)
    console_out(f"objective: {solution.objective:.10g}")
    for i, pd in enumerate(solution.phase_data):
        parts = [f"phase {i}: t in [{pd.t0:.6g}, {pd.tF:.6g}]",
                 f"N = {pd.y.shape[1]} nodes"]
        if pd.q.size:
            parts.append("q = " + np.array2string(pd.q, precision=6))
        console_out("; ".join(parts))


def build_warm_start(prev_result, prev_it, new_it):
    """Interpolate the previous iteration's multipliers onto a new mesh.

    Replaces the reference's reliance on IPOPT's
    ``warm_start_init_point`` + guess recycling
    (``pycollo/iteration.py:528-583``): bound multipliers ``z`` are
    interpolated per variable over tau; defect multipliers are converted
    to costate-like densities (divide by the row's tau spacing and undo
    the constraint scaling) before interpolation; the barrier parameter
    restarts at the geometric mean of its final value and ``mu_init``.

    ``prev_result.ipm_result`` holds one instance's tensors, on whatever
    device the solve ran; they are read back once.  ``zl``/``zu`` cover
    ``[x; slack]``, and only their first ``n_free`` entries (the NLP
    variables) are carried.
    """
    res = prev_result.ipm_result
    lam_o, zl_o, zu_o, mu_final = (
        t.detach().cpu().numpy() for t in (res.lam, res.zl, res.zu, res.mu))
    lay_o, lay_n = prev_it.layout, new_it.layout

    # -- bound multipliers: scatter to full vectors, interp, re-gather ---
    def interp_z(z_free_old):
        z_full_o = np.zeros(lay_o.n_full)
        z_full_o[prev_it.free_idx] = z_free_old
        z_full_n = np.zeros(lay_n.n_full)
        for pl_o, pl_n, t_o, t_n in zip(lay_o.phases, lay_n.phases,
                                        prev_it.tables, new_it.tables):
            for off_o, off_n, nvar in ((pl_o.y_off, pl_n.y_off, pl_o.ny),
                                       (pl_o.u_off, pl_n.u_off, pl_o.nu)):
                for j in range(nvar):
                    old = z_full_o[off_o + j * pl_o.N:
                                   off_o + (j + 1) * pl_o.N]
                    z_full_n[off_n + j * pl_n.N:
                             off_n + (j + 1) * pl_n.N] = \
                        np.interp(t_n.tau, t_o.tau, old)
            z_full_n[pl_n.q_slice] = z_full_o[pl_o.q_slice]
            z_full_n[pl_n.t_slice] = z_full_o[pl_o.t_slice]
        z_full_n[lay_n.s_slice] = z_full_o[lay_o.s_slice]
        return np.clip(z_full_n[new_it.free_idx], 0.0, None)

    # -- constraint multipliers --------------------------------------
    lam_n = np.zeros(lay_n.m_total)
    for pl_o, pl_n, t_o, t_n in zip(lay_o.phases, lay_n.phases,
                                    prev_it.tables, new_it.tables):
        dtau_o = np.diff(t_o.tau)           # (num_defect,)
        dtau_n = np.diff(t_n.tau)
        nd_o, nd_n = pl_o.num_defect, pl_n.num_defect
        Wc_o = prev_it.W_c
        Wc_n = new_it.W_c
        for jj, _state in enumerate(pl_o.defect_states):
            sl_o = slice(pl_o.c_defect_off + jj * nd_o,
                         pl_o.c_defect_off + (jj + 1) * nd_o)
            sl_n = slice(pl_n.c_defect_off + jj * nd_n,
                         pl_n.c_defect_off + (jj + 1) * nd_n)
            density = lam_o[sl_o] * Wc_o[sl_o] / dtau_o
            dens_new = np.interp(t_n.tau[1:], t_o.tau[1:], density)
            lam_n[sl_n] = dens_new * dtau_n / Wc_n[sl_n]
        for jj in range(pl_o.npc):
            sl_o = slice(pl_o.c_path_off + jj * pl_o.N,
                         pl_o.c_path_off + (jj + 1) * pl_o.N)
            sl_n = slice(pl_n.c_path_off + jj * pl_n.N,
                         pl_n.c_path_off + (jj + 1) * pl_n.N)
            vals = lam_o[sl_o] * Wc_o[sl_o]
            lam_n[sl_n] = np.interp(t_n.tau, t_o.tau, vals) / Wc_n[sl_n]
        lam_n[pl_n.c_integral_off:pl_n.c_integral_off + pl_n.nq] = \
            lam_o[pl_o.c_integral_off:pl_o.c_integral_off + pl_o.nq]
    if lay_n.nb:
        lam_n[lay_n.c_endpoint_off:] = lam_o[lay_o.c_endpoint_off:]

    mu_init = prev_it.settings.ipm_mu_init
    mu_warm = float(np.clip(np.sqrt(float(mu_final) * mu_init), 1e-6,
                            mu_init))
    return dict(lam=lam_n, zl=interp_z(zl_o[:prev_it.n_free]),
                zu=interp_z(zu_o[:prev_it.n_free]), mu=mu_warm)


@dataclass
class RefinementLoopResult:
    iterations: list
    solution: Solution
    mesh_tolerance_met: bool
    mesh_errors: list


def run_mesh_refinement_loop(backend, display: bool = True, device="cuda"):
    """The outer ph-adaptive loop
    (``pycollo/optimal_control_problem.py:387-443``); every NLP solve runs
    on ``device`` (default the CUDA card; ``"cpu"`` names the CPU)."""
    device = solve_device(device)
    settings = backend.settings
    iterations = []
    solution = None
    mesh_errors = []
    tolerance_met = False
    it = backend.mesh_iterations[-1]
    warm = None
    prev_max_errors = None
    # ``settings.warm_start`` gates the cross-mesh multiplier warm start
    # (the reference's IPOPT ``warm_start_init_point`` pass-through,
    # ``pycollo/backend.py:1703-1709``; reference default False,
    # ``pycollo/settings.py:62``).  This package defaults it to True: the
    # interpolated warm start has a cold-retry fallback below.
    use_warm = bool(settings.warm_start)
    for loop_idx in range(settings.max_mesh_iterations):
        if display:
            shapes = [f"K={t.K},N={t.N}" for t in it.tables]
            console_out(f"Mesh iteration {it.number} ({'; '.join(shapes)})")
        result = it.solve(warm=warm, device=device)
        if warm is not None and not result.converged:
            # A diverging warm-started solve poisons the refinement loop
            # (garbage error estimates explode the next mesh); retry cold,
            # on the same device, before accepting the iterate.
            if display:
                console_out("  warm-started NLP did not converge; "
                            "retrying cold")
            cold = it.solve(device=device)
            if cold.converged or (float(cold.ipm_result.kkt_error)
                                  < float(result.ipm_result.kkt_error)):
                result = cold
        iterations.append(result)
        solution = Solution(result)
        if settings.display_mesh_result_info:
            _display_mesh_result_info(solution, it)
        if settings.display_mesh_result_graph:
            solution.plot(show=True)
        refinement = solution.refine_mesh(prev_max_errors=prev_max_errors)
        max_err = refinement.max_relative_mesh_error
        prev_max_errors = [float(m.max()) if m.size else None
                           for m in refinement.maximum_relative_mesh_errors]
        mesh_errors.append(max_err)
        if display:
            console_out(
                f"  objective {solution.objective:.8g}; max relative mesh "
                f"error {max_err:.3e}; NLP iters "
                f"{int(result.ipm_result.iterations)}; "
                f"KKT {float(result.ipm_result.kkt_error):.2e}")
        if max_err <= settings.mesh_tolerance:
            tolerance_met = True
            break
        if loop_idx == settings.max_mesh_iterations - 1:
            if display:
                console_out(
                    f"Maximum number of mesh iterations "
                    f"({settings.max_mesh_iterations}) reached without "
                    f"meeting the mesh tolerance "
                    f"{settings.mesh_tolerance:.1e}.")
            break
        prev_it = it
        it = backend.new_mesh_iteration(refinement.next_tables,
                                        refinement.next_guesses,
                                        solution.parameter)
        warm = build_warm_start(result, prev_it, it) if use_warm else None
    return RefinementLoopResult(iterations=iterations, solution=solution,
                                mesh_tolerance_met=tolerance_met,
                                mesh_errors=mesh_errors)
