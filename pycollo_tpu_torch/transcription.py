"""Transcription: OCP -> scaled NLP with batched PyTorch residual evaluators.

This module replaces the reference's per-iteration CasADi symbol expansion
(``pycollo/backend.py:1403-1679``) and the iteration bookkeeping
(``pycollo/iteration.py:196-453``) with a dense, batched evaluation: the
state/control trajectories of each phase are tensors ``(B, ny, N)`` /
``(B, nu, N)``, per-node user functions are evaluated for all mesh nodes of
all instances at once, and the defect/integral operators are plain batched
matmuls with the static mesh tables.

Every evaluator is batch-first: flat NLP vectors are ``(B, n)`` and the
results carry the same leading instance axis.  User functions are called
component-first (``y`` is ``(ny, B, N)``; see :mod:`.sym_backend`).

Layout invariants match the reference (SURVEY.md section 3.5):

* NLP variables per phase: ``[y0(N), y1(N), ..., u0(N), ..., q, t0, tF]``,
  phases concatenated, then global ``s`` (``pycollo/iteration.py:208-262``).
* Constraints per phase: ``[defects (ny x num_defect), paths (npc x N),
  integrals (nq)]`` then global endpoint constraints
  (``pycollo/iteration.py:264-314``).
* Defect (integral form): ``zeta = E y + 0.5 (tF - t0) I f`` with the
  [+1, -1] difference pattern in ``E`` (``pycollo/backend.py:1601-1603``).
* Integral: ``rho = q - 0.5 (tF - t0) W g`` (``pycollo/backend.py:1645-1647``).
* Time affinely normalized to tau in [-1, 1].
* Variables with equal lower == upper bounds leave the NLP and become
  entries of the per-instance parameter vector ``theta``
  (``pycollo/bounds.py:901-935``) — which is also how batched MPC-style
  instance perturbation enters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd, jacrev, vmap

from . import mesh as mesh_mod
from .bounds import (ProcessedPhaseBounds, ProcessedProblemBounds,
                     process_phase_bounds, process_problem_bounds)
from .guess import ProcessedPhaseGuess, process_phase_guess
from .structures import Endpoints, PhaseEndpoints
from .utils import DeviceConstants, solve_device

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _components(out, like):
    """Give a user function's output its leading component axis when it
    returned one component without it (shape of ``like``)."""
    out = torch.as_tensor(out, dtype=like.dtype, device=like.device)
    if out.dim() == like.dim():
        out = out.unsqueeze(0)
    return out


class FunctionalProgram:
    """Adapter for the functional (PyTorch-callable) frontend.

    User callables are component-first and broadcast over instance axes:
    ``f(y, u, t, s)`` gets ``y`` ``(ny, *batch)``, ``t`` ``(*batch)`` and
    returns ``(n_out, *batch)``; endpoint functions get an
    :class:`Endpoints` of component-first tensors.
    """

    def __init__(self, ocp):
        self.ocp = ocp
        self.phase_functions = [_FunctionalPhase(p) for p in ocp.phases]
        if not callable(ocp.objective_function):
            raise TypeError(
                "With the functional frontend, ocp.objective_function must "
                "be a callable taking an Endpoints structure.")
        self._objective = ocp.objective_function
        self._endpoint = ocp.endpoint_constraints \
            if callable(ocp.endpoint_constraints) else None

    def objective(self, ep: Endpoints):
        return self._objective(ep)

    def endpoint_constraints(self, ep: Endpoints):
        like = ep.phase[0].t0
        if self._endpoint is None:
            return torch.zeros((0,) + tuple(like.shape), dtype=like.dtype,
                               device=like.device)
        return _components(self._endpoint(ep), like)

    def resolve_numeric(self, value):
        return value

    def phase_resolver(self, phase_index):
        return lambda value: value


class _FunctionalPhase:
    def __init__(self, phase):
        self.phase = phase
        self._dyn = phase.state_equations
        if not callable(self._dyn):
            raise TypeError(
                f"Phase {phase.name!r}: with the functional frontend, "
                f"state_equations must be a callable f(y, u, t, s).")
        self._path = phase.path_constraints \
            if callable(phase.path_constraints) else None
        self._integrand = phase.integrand_functions \
            if callable(phase.integrand_functions) else None

    def dynamics(self, y, u, t, s):
        return _components(self._dyn(y, u, t, s), t)

    def path(self, y, u, t, s):
        if self._path is None:
            return torch.zeros((0,) + tuple(t.shape), dtype=t.dtype,
                               device=t.device)
        return _components(self._path(y, u, t, s), t)

    def integrand(self, y, u, t, s):
        if self._integrand is None:
            return torch.zeros((0,) + tuple(t.shape), dtype=t.dtype,
                               device=t.device)
        return _components(self._integrand(y, u, t, s), t)


@dataclass
class PhaseLayout:
    """Index bookkeeping for one phase within the flat NLP vectors.

    Parity with ``pycollo/iteration.py:196-342`` (variable/constraint
    counts and slices).
    """

    ny: int
    nu: int
    nq: int
    npc: int
    N: int
    num_defect: int
    y_off: int
    u_off: int
    q_off: int
    t_off: int
    c_defect_off: int
    c_path_off: int
    c_integral_off: int
    defect_states: np.ndarray      # indices of states with defect rows

    @property
    def num_defect_rows(self) -> int:
        return len(self.defect_states) * self.num_defect

    @property
    def y_slice(self):
        return slice(self.y_off, self.y_off + self.ny * self.N)

    @property
    def u_slice(self):
        return slice(self.u_off, self.u_off + self.nu * self.N)

    @property
    def q_slice(self):
        return slice(self.q_off, self.q_off + self.nq)

    @property
    def t_slice(self):
        return slice(self.t_off, self.t_off + 2)


@dataclass
class Layout:
    phases: List[PhaseLayout]
    s_off: int
    ns: int
    n_full: int
    c_endpoint_off: int
    nb: int
    m_total: int

    @property
    def s_slice(self):
        return slice(self.s_off, self.s_off + self.ns)


def build_layout(phase_dims, tables, ns: int, nb: int,
                 defect_state_lists) -> Layout:
    phases = []
    off = 0
    c_off = 0
    for (ny, nu, nq, npc), t, dstates in zip(phase_dims, tables,
                                             defect_state_lists):
        N = t.N
        pl = PhaseLayout(ny=ny, nu=nu, nq=nq, npc=npc, N=N,
                         num_defect=t.num_defect,
                         y_off=off, u_off=off + ny * N,
                         q_off=off + (ny + nu) * N,
                         t_off=off + (ny + nu) * N + nq,
                         c_defect_off=c_off,
                         c_path_off=c_off + len(dstates) * t.num_defect,
                         c_integral_off=c_off + len(dstates) * t.num_defect
                         + npc * N,
                         defect_states=np.asarray(dstates, dtype=int))
        off += (ny + nu) * N + nq + 2
        c_off = pl.c_integral_off + nq
        phases.append(pl)
    return Layout(phases=phases, s_off=off, ns=ns, n_full=off + ns,
                  c_endpoint_off=c_off, nb=nb, m_total=c_off + nb)



class CompiledOCP:
    """The compiled problem: frontend program + bounds/guess + iterations.

    Plays the role of the reference ``Backend``
    (``pycollo/backend.py:71-160``): owns the processed problem data and
    creates :class:`MeshIteration` objects as the refinement loop proceeds.
    """

    def __init__(self, ocp):
        self.ocp = ocp
        self.settings = ocp.settings
        #: working dtype of the NLP (every tensor the port creates names it)
        self.dtype = _DTYPES[self.settings.dtype]

        if ocp.is_symbolic:
            from .sym_backend import SymbolicProgram
            self.program = SymbolicProgram(ocp)
        else:
            self.program = FunctionalProgram(ocp)

        # Bounds (with symbolic resolution through aux data).
        self.phase_bounds: List[ProcessedPhaseBounds] = []
        for i, phase in enumerate(ocp.phases):
            resolver = self.program.phase_resolver(i) \
                if hasattr(self.program, "phase_resolver") else (lambda v: v)
            self.phase_bounds.append(
                process_phase_bounds(phase, self.settings, resolver))
        self.problem_bounds: ProcessedProblemBounds = process_problem_bounds(
            ocp, self.settings, self.program.resolve_numeric)

        # Guesses.
        self.phase_guesses: List[ProcessedPhaseGuess] = [
            process_phase_guess(p, self.program.resolve_numeric)
            for p in ocp.phases]
        s_guess = self.program.resolve_numeric(
            ocp.guess.parameter_variables)
        ns = ocp.number_parameter_variables
        if s_guess is None:
            sb = self.problem_bounds.s_bnd
            finite = np.isfinite(sb).all(axis=1) & (np.abs(sb) < 1e18).all(axis=1)
            s_guess = np.where(finite, 0.5 * (sb[:, 0] + sb[:, 1]), 0.0)
        self.s_guess = np.atleast_1d(np.asarray(s_guess, dtype=float)) \
            if ns else np.zeros(0)
        if self.s_guess.shape != (ns,):
            raise ValueError(f"Parameter guess must have shape ({ns},).")

        self.mesh_iterations: List["MeshIteration"] = []
        self.create_initial_iteration()

    # ------------------------------------------------------------------
    def initial_mesh_tables(self):
        method = self.settings.quadrature_method
        tables = []
        for phase in self.ocp.phases:
            pm = phase.mesh
            tables.append(mesh_mod.build_phase_tables(
                method, pm.mesh_section_sizes,
                pm.number_mesh_section_nodes))
        return tables

    def create_initial_iteration(self):
        tables = self.initial_mesh_tables()
        it = MeshIteration(self, tables, self.phase_guesses, self.s_guess,
                           number=1)
        self.mesh_iterations.append(it)
        return it

    def new_mesh_iteration(self, tables, phase_guesses, s_guess):
        """Start the next mesh iteration (``pycollo/backend.py:827-851``)."""
        it = MeshIteration(self, tables, phase_guesses, s_guess,
                           number=len(self.mesh_iterations) + 1)
        self.mesh_iterations.append(it)
        return it


class MeshIteration:
    """One transcription + solve on a fixed mesh.

    Parity with ``pycollo/iteration.py`` (live code path): interpolate the
    guess onto the mesh, build scaling, build the scaled NLP, solve, and
    post-process.  This class holds the static numpy metadata; its
    evaluators take tensors on any device.
    """

    def __init__(self, compiled: CompiledOCP, tables, phase_guesses,
                 s_guess, number: int):
        self.compiled = compiled
        self.ocp = compiled.ocp
        self.settings = compiled.settings
        self.dtype = compiled.dtype
        self.tables = tables
        self.number = number
        self.phase_guesses = phase_guesses
        self.s_guess = np.asarray(s_guess, dtype=float)

        ocp = self.ocp
        self.ns = ocp.number_parameter_variables
        self.nb = ocp.number_endpoint_constraints

        phase_dims = []
        defect_state_lists = []
        for phase, pb in zip(ocp.phases, compiled.phase_bounds):
            ny = phase.number_state_variables
            nu = phase.number_control_variables
            nq = phase.number_integrand_functions
            npc = phase.number_path_constraints
            phase_dims.append((ny, nu, nq, npc))
            if self.settings.remove_constant_variables:
                defect_state_lists.append(np.nonzero(pb.y_needed)[0])
            else:
                defect_state_lists.append(np.arange(ny))
        self.layout = build_layout(phase_dims, tables, self.ns, self.nb,
                                   defect_state_lists)

        from .profiling import Profiler
        self.profiler = Profiler()
        with self.profiler.span("variable metadata"):
            self._build_variable_metadata()
        with self.profiler.span("constraint metadata"):
            self._build_constraint_metadata()
        with self.profiler.span("guess interpolation"):
            self._build_guess_vector()
        with self.profiler.span("NLP function build"):
            self._build_nlp_functions()
        with self.profiler.span("scaling"):
            self._build_scaling()
        self._solver = None
        if self.settings.check_nlp_functions:
            self.dump_nlp_check_values()

    # -- variable metadata ---------------------------------------------
    def _ocp_var_scales_from_bounds(self):
        """Per-OCP-variable scales from bounds: V = xu - xl, r = midpoint
        (``pycollo/scaling.py:87-92``), V=1/r=0 for un/half-bounded.

        Returns flat arrays over the OCP variable order (per phase
        [y..., u..., q..., t0, tF], then s) — the granularity the EWMA
        cross-iteration update averages at
        (``pycollo/scaling.py:283-344``)."""
        inf_thresh = 1e18

        def var_scale(bnd):
            lo, hi = bnd[..., 0], bnd[..., 1]
            finite = (np.abs(lo) < inf_thresh) & (np.abs(hi) < inf_thresh) \
                & (hi > lo)
            Vv = np.where(finite, hi - lo, 1.0)
            rv = np.where(finite, 0.5 * (lo + hi), 0.0)
            return Vv, rv

        V_parts, r_parts = [], []
        for pb in self.compiled.phase_bounds:
            for bnd in (pb.y_bnd, pb.u_bnd, pb.q_bnd,
                        np.stack([pb.t0_bnd, pb.tF_bnd])):
                Vv, rv = var_scale(np.atleast_2d(bnd))
                V_parts.append(Vv)
                r_parts.append(rv)
        Vs, rs = var_scale(self.compiled.problem_bounds.s_bnd)
        V_parts.append(Vs)
        r_parts.append(rs)
        return (np.concatenate(V_parts) if V_parts else np.zeros(0),
                np.concatenate(r_parts) if r_parts else np.zeros(0))

    def _ocp_var_scales_from_guess(self, V_last, r_last):
        """Per-OCP-variable scales from the incoming guess trajectories
        (``pycollo/scaling.py:295-324``): trajectory variables (y, u) get
        V = amplitude across mesh nodes, r = midpoint of the range;
        point variables (q, t, s) get V = |value|,
        r = (V_next / V_last) * r_last.  Degenerate (zero) amplitudes
        keep the previous scale (guard absent in the reference, which
        divides by zero there)."""
        V = np.array(V_last)
        r = np.array(r_last)
        off = 0
        for pl, g in zip(self.layout.phases, self.phase_guesses):
            for traj in (g.y, g.u):
                for row in traj:
                    amp = row.max() - row.min()
                    if amp > 1e-12:
                        V[off] = amp
                        r[off] = row.max() - 0.5 * amp
                    off += 1
            for val in list(np.atleast_1d(g.q)) + [g.t0, g.tF]:
                v_next = abs(float(val))
                if v_next > 1e-12:
                    r[off] = (v_next / V[off]) * r[off]
                    V[off] = v_next
                off += 1
        for val in self.s_guess:
            v_next = abs(float(val))
            if v_next > 1e-12:
                r[off] = (v_next / V[off]) * r[off]
                V[off] = v_next
            off += 1
        return V, r

    def _ewma_weights(self, length: int):
        """Exponential weights over [oldest, ..., newest] mirroring
        ``pycollo/scaling.py:287-293``: newest gets alpha, older entries
        alpha*(1-alpha)^age, and the oldest entry's weight is divided by
        alpha so the weights sum to one."""
        alpha = self.settings.scaling_weight
        w = np.array([alpha * (1 - alpha) ** i for i in range(length)])
        w = np.flip(w)
        w[0] /= alpha
        return w

    def _build_variable_metadata(self):
        lay = self.layout
        cb = self.compiled
        inf_thresh = 1e18
        lb = np.empty(lay.n_full)
        ub = np.empty(lay.n_full)

        V_ocp, r_ocp = self._ocp_var_scales_from_bounds()
        use_update = (self.settings.update_scaling and self.number > 1
                      and self.settings.scaling_method != "none")
        if use_update:
            prev = self.compiled.mesh_iterations
            V_next, r_next = self._ocp_var_scales_from_guess(
                prev[-1].V_ocp, prev[-1].r_ocp)
            weights = self._ewma_weights(len(prev) + 1)
            V_ocp = np.average(
                np.vstack([[p.V_ocp for p in prev], V_next[None]]),
                axis=0, weights=weights)
            r_ocp = np.average(
                np.vstack([[p.r_ocp for p in prev], r_next[None]]),
                axis=0, weights=weights)
        self.V_ocp = V_ocp
        self.r_ocp = r_ocp

        # Expand OCP-level scales to the mesh and fill per-node bounds.
        V = np.ones(lay.n_full)
        r = np.zeros(lay.n_full)
        off = 0
        for pl, pb, t in zip(lay.phases, cb.phase_bounds, self.tables):
            N = pl.N
            # y: per-node bounds with endpoint overrides
            # (``pycollo/iteration.py:408-429``).
            y_lb = np.tile(pb.y_bnd[:, 0:1], (1, N))
            y_ub = np.tile(pb.y_bnd[:, 1:2], (1, N))
            y_lb[:, 0] = pb.y_t0_bnd[:, 0]
            y_ub[:, 0] = pb.y_t0_bnd[:, 1]
            y_lb[:, -1] = pb.y_tF_bnd[:, 0]
            y_ub[:, -1] = pb.y_tF_bnd[:, 1]
            lb[pl.y_slice] = y_lb.ravel()
            ub[pl.y_slice] = y_ub.ravel()
            V[pl.y_slice] = np.repeat(V_ocp[off:off + pl.ny], N)
            r[pl.y_slice] = np.repeat(r_ocp[off:off + pl.ny], N)
            off += pl.ny

            lb[pl.u_slice] = np.repeat(pb.u_bnd[:, 0], N)
            ub[pl.u_slice] = np.repeat(pb.u_bnd[:, 1], N)
            V[pl.u_slice] = np.repeat(V_ocp[off:off + pl.nu], N)
            r[pl.u_slice] = np.repeat(r_ocp[off:off + pl.nu], N)
            off += pl.nu

            lb[pl.q_slice] = pb.q_bnd[:, 0]
            ub[pl.q_slice] = pb.q_bnd[:, 1]
            V[pl.q_slice] = V_ocp[off:off + pl.nq]
            r[pl.q_slice] = r_ocp[off:off + pl.nq]
            off += pl.nq

            t_bnd = np.stack([pb.t0_bnd, pb.tF_bnd])
            lb[pl.t_slice] = t_bnd[:, 0]
            ub[pl.t_slice] = t_bnd[:, 1]
            V[pl.t_slice] = V_ocp[off:off + 2]
            r[pl.t_slice] = r_ocp[off:off + 2]
            off += 2

        sb = cb.problem_bounds.s_bnd
        lb[lay.s_slice] = sb[:, 0]
        ub[lay.s_slice] = sb[:, 1]
        V[lay.s_slice] = V_ocp[off:off + lay.ns]
        r[lay.s_slice] = r_ocp[off:off + lay.ns]

        if self.settings.scaling_method == "none":
            V = np.ones_like(V)
            r = np.zeros_like(r)

        self.lb_full = lb
        self.ub_full = ub
        self.V_full = V
        self.r_full = r
        self.free_mask = (ub - lb) > 0
        self.free_idx = np.nonzero(self.free_mask)[0]
        self.fixed_idx = np.nonzero(~self.free_mask)[0]
        self.n_free = len(self.free_idx)
        # Default theta: fixed entries hold their pinned value.
        theta = np.zeros(lay.n_full)
        theta[self.fixed_idx] = 0.5 * (lb[self.fixed_idx]
                                       + ub[self.fixed_idx])
        self.theta_default = theta
        # Scaled bounds for the free variables.
        Vf = V[self.free_idx]
        rf = r[self.free_idx]
        with np.errstate(over="ignore", invalid="ignore"):
            self.xs_lb = np.where(lb[self.free_idx] < -inf_thresh, -1e19,
                                  (lb[self.free_idx] - rf) / Vf)
            self.xs_ub = np.where(ub[self.free_idx] > inf_thresh, 1e19,
                                  (ub[self.free_idx] - rf) / Vf)

    # -- constraint metadata --------------------------------------------
    def _build_constraint_metadata(self):
        lay = self.layout
        cb = self.compiled
        cl = np.empty(lay.m_total)
        cu = np.empty(lay.m_total)
        for pl, pb in zip(lay.phases, cb.phase_bounds):
            d0 = pl.c_defect_off
            cl[d0:pl.c_path_off] = 0.0
            cu[d0:pl.c_path_off] = 0.0
            path_lb = np.repeat(pb.path_bnd[:, 0], pl.N)
            path_ub = np.repeat(pb.path_bnd[:, 1], pl.N)
            cl[pl.c_path_off:pl.c_integral_off] = path_lb
            cu[pl.c_path_off:pl.c_integral_off] = path_ub
            cl[pl.c_integral_off:pl.c_integral_off + pl.nq] = 0.0
            cu[pl.c_integral_off:pl.c_integral_off + pl.nq] = 0.0
        bb = cb.problem_bounds.b_bnd
        cl[lay.c_endpoint_off:] = bb[:, 0]
        cu[lay.c_endpoint_off:] = bb[:, 1]
        self.cl = cl
        self.cu = cu

    # -- guess -----------------------------------------------------------
    def _build_guess_vector(self):
        lay = self.layout
        x = np.array(self.theta_default)
        for pl, g, t in zip(lay.phases, self.phase_guesses, self.tables):
            y_mesh, u_mesh = g.interpolate(t.tau)
            x[pl.y_slice] = y_mesh.ravel()
            x[pl.u_slice] = u_mesh.ravel()
            x[pl.q_slice] = g.q
            x[pl.t_off] = g.t0
            x[pl.t_off + 1] = g.tF
        x[lay.s_slice] = self.s_guess
        self.x_full_guess = x
        # Fixed entries of theta keep their pinned (bound) values; the
        # guess supplies the free entries.
        self.xs_guess = ((x - self.r_full) / self.V_full)[self.free_idx]


    # -- NLP functions ----------------------------------------------------
    def _build_nlp_functions(self):
        lay = self.layout
        program = self.compiled.program
        consts = DeviceConstants(free_idx=self.free_idx,
                                 V_free=self.V_full[self.free_idx],
                                 r_free=self.r_full[self.free_idx])
        for p, (pl, t) in enumerate(zip(lay.phases, self.tables)):
            consts.add(**{f"E{p}": t.E, f"I{p}": t.I, f"W{p}": t.W,
                          f"tau{p}": t.tau, f"ds{p}": pl.defect_states})
        self._consts = consts

        def assemble_full(xs, theta):
            # theta's dtype governs the evaluation precision (the solver
            # passes an f32 theta for derivative evaluations in
            # ``eval_dtype="f32"`` mode).
            vals = xs.to(theta.dtype) * consts("V_free", theta) \
                + consts("r_free", theta)
            return theta.index_copy(-1, consts("free_idx", theta), vals)

        def phase_values(x_full, p, pl):
            """Phase p of x_full (*batch, n_full): y (*batch, ny, N),
            u (*batch, nu, N), q (*batch, nq), t0/tF/stretch (*batch) and
            the node times (*batch, N)."""
            bs = x_full.shape[:-1]
            y = x_full[..., pl.y_slice].reshape(*bs, pl.ny, pl.N)
            u = x_full[..., pl.u_slice].reshape(*bs, pl.nu, pl.N)
            q = x_full[..., pl.q_slice]
            t0 = x_full[..., pl.t_off]
            tF = x_full[..., pl.t_off + 1]
            stretch = 0.5 * (tF - t0)
            shift = 0.5 * (t0 + tF)
            t_nodes = stretch[..., None] * consts(f"tau{p}", x_full) \
                + shift[..., None]
            return y, u, q, t0, tF, stretch, t_nodes

        def endpoints(x_full):
            """Component-first endpoint values of x_full (*batch, n_full)."""
            s = x_full[..., lay.s_slice].movedim(-1, 0)
            eps = []
            for p, pl in enumerate(lay.phases):
                y, u, q, t0, tF, _, _ = phase_values(x_full, p, pl)
                eps.append(PhaseEndpoints(y0=y[..., 0].movedim(-1, 0),
                                          yF=y[..., -1].movedim(-1, 0),
                                          q=q.movedim(-1, 0), t0=t0, tF=tF))
            return Endpoints(phase=tuple(eps), s=s)

        def constraints_raw(x_full):
            """Unscaled constraints (*batch, m) in the reference layout."""
            bs = x_full.shape[:-1]
            # (ns, *batch, 1): broadcasts against the (*batch, N) nodes
            s = x_full[..., lay.s_slice].movedim(-1, 0)[..., None]
            parts = []
            for p, pl in enumerate(lay.phases):
                pf = program.phase_functions[p]
                y, u, q, t0, tF, stretch, t_nodes = phase_values(
                    x_full, p, pl)
                yc = y.movedim(-2, 0)           # (ny, *batch, N)
                uc = u.movedim(-2, 0)
                f = pf.dynamics(yc, uc, t_nodes, s).movedim(0, -2)
                E = consts(f"E{p}", x_full)
                I = consts(f"I{p}", x_full)
                defect = y @ E.T + stretch[..., None, None] * (f @ I.T)
                defect = defect[..., consts(f"ds{p}", x_full), :]
                parts.append(defect.reshape(*bs, -1))
                if pl.npc:
                    pc = pf.path(yc, uc, t_nodes, s).movedim(0, -2)
                    parts.append(pc.reshape(*bs, -1))
                if pl.nq:
                    rho = pf.integrand(yc, uc, t_nodes, s).movedim(0, -2)
                    parts.append(q - stretch[..., None]
                                 * (rho @ consts(f"W{p}", x_full)))
            b = program.endpoint_constraints(endpoints(x_full))
            parts.append(b.movedim(0, -1))
            return torch.cat(parts, dim=-1)

        def objective_raw(x_full):
            return program.objective(endpoints(x_full))

        def f_unscaled(xs, theta):
            return objective_raw(assemble_full(xs, theta))

        def c_unscaled(xs, theta):
            return constraints_raw(assemble_full(xs, theta))

        self.assemble_full = assemble_full
        self.endpoints_of = endpoints
        self.f_unscaled = f_unscaled
        self.c_unscaled = c_unscaled

    # -- structured derivatives -------------------------------------------
    def _build_structured_derivatives(self):
        """Per-node block assembly of the constraint Jacobian and the
        Lagrangian Hessian, for a batch of instances.

        The only nonlinearities are the *per-node* user functions, so
        their small Jacobian/Hessian blocks are computed with one
        ``torch.func.vmap`` over all mesh nodes of all instances and
        scattered into the transcription operators' structural pattern
        with one ``index_add_`` on precomputed flat indices.
        """
        if getattr(self, "_structured_derivs", None) is not None:
            return self._structured_derivs
        lay = self.layout
        program = self.compiled.program
        consts = self._consts
        n_full = lay.n_full
        m_total = lay.m_total
        ns = lay.ns

        # Static per-phase index arrays.
        phase_static = []
        ep_idx_list = []
        for pl in lay.phases:
            nz = pl.ny + pl.nu
            node_cols = np.empty((pl.N, nz), dtype=np.int64)
            for l in range(pl.ny):
                node_cols[:, l] = pl.y_off + l * pl.N + np.arange(pl.N)
            for l in range(pl.nu):
                node_cols[:, pl.ny + l] = pl.u_off + l * pl.N \
                    + np.arange(pl.N)
            # Hessian node block covers [z..., t0, tF, s...].
            D = nz + 2 + ns
            hess_idx = np.empty((pl.N, D), dtype=np.int64)
            hess_idx[:, :nz] = node_cols
            hess_idx[:, nz] = pl.t_off
            hess_idx[:, nz + 1] = pl.t_off + 1
            hess_idx[:, nz + 2:] = lay.s_off + np.arange(ns)[None, :]
            phase_static.append(dict(node_cols=node_cols,
                                     hess_idx=hess_idx, nz=nz, D=D))
            ep_idx_list.extend(
                [pl.y_off + l * pl.N for l in range(pl.ny)]
                + [pl.y_off + (l + 1) * pl.N - 1 for l in range(pl.ny)]
                + list(range(pl.q_off, pl.q_off + pl.nq))
                + [pl.t_off, pl.t_off + 1])
        ep_idx_list.extend(range(lay.s_off, lay.s_off + ns))
        ep_idx = np.asarray(ep_idx_list, dtype=np.int64)
        consts.add(ep_idx=ep_idx)
        s_cols = lay.s_off + np.arange(ns)
        flat_index = {}

        def scatter_add(key, parts, like, shape):
            """Sum contributions into a zero (B, *shape) tensor.

            ``parts``: (flat index array, values (B, *index.shape)) pairs
            in a fixed order.  Contributions are added in rounds in which
            every target index occurs at most once (the k-th round takes
            each index's k-th contribution), so no two additions race on
            the GPU and the sum is reproducible, in the order of ``parts``.
            The rounds depend only on the layout and are built once per
            device."""
            B = like.shape[0]
            rounds = flat_index.get((key, like.device))
            if rounds is None:
                idx = np.concatenate([np.ravel(i) for i, _ in parts])
                order = np.argsort(idx, kind="stable")
                srt = idx[order]
                new_run = np.r_[True, srt[1:] != srt[:-1]]
                run_start = np.flatnonzero(new_run)[np.cumsum(new_run) - 1]
                rank = np.empty(len(idx), dtype=np.int64)
                rank[order] = np.arange(len(idx)) - run_start
                rounds = []
                for r in range(int(rank.max()) + 1 if len(idx) else 0):
                    pos = np.flatnonzero(rank == r)
                    rounds.append((torch.as_tensor(idx[pos]).to(like.device),
                                   torch.as_tensor(pos).to(like.device)))
                flat_index[(key, like.device)] = rounds
            vals = torch.cat([v.reshape(B, -1) for _, v in parts], dim=1)
            out = torch.zeros((B, shape[0] * shape[1]), dtype=like.dtype,
                              device=like.device)
            for idx_r, pos_r in rounds:
                out.index_add_(1, idx_r, vals[:, pos_r])
            return out.view(B, *shape)

        # Per-node functions below keep a singleton node axis: under
        # torch.func's forward mode, arithmetic between a 0-d tensor and a
        # Python float promotes to float64, which would break f32 assembly.

        def phase_F(p, pl):
            """Per-node concatenated user function (f, path, rho); t0, tF
            and tau_j are (1,)."""
            pf = program.phase_functions[p]

            def F(wz, t0, tF, s, tau_j):
                y = wz[:pl.ny, None]
                u = wz[pl.ny:, None]
                sc = s[:, None]
                t_j = 0.5 * (tF - t0) * tau_j + 0.5 * (t0 + tF)
                parts = [pf.dynamics(y, u, t_j, sc)]
                if pl.npc:
                    parts.append(pf.path(y, u, t_j, sc))
                if pl.nq:
                    parts.append(pf.integrand(y, u, t_j, sc))
                return torch.cat(parts)[:, 0]

            return F

        def node_values(x_full, p, pl):
            """(B, N, nz) node values and (B,) t0, tF, stretch and
            (B, ns) parameters of phase p."""
            B = x_full.shape[0]
            t0 = x_full[:, pl.t_off]
            tF = x_full[:, pl.t_off + 1]
            y = x_full[:, pl.y_slice].reshape(B, pl.ny, pl.N)
            u = x_full[:, pl.u_slice].reshape(B, pl.nu, pl.N)
            wz = torch.cat([y, u], dim=1).transpose(1, 2)
            return wz, t0, tF, 0.5 * (tF - t0), x_full[:, lay.s_slice]

        def node_jacobians(x_full, p):
            """Phase p's per-node user functions and their Jacobians at
            every node of every instance, by one ``vmap`` over the B*N
            nodes: values Fv (B, N, nf) and the blocks with respect to the
            node's (y, u) (B, N, nf, nz), t0 and tF (B, N, nf) and s
            (B, N, nf, ns).  Dtype-polymorphic (follows ``x_full``)."""
            pl = lay.phases[p]
            B, N, nz = x_full.shape[0], pl.N, phase_static[p]["nz"]
            wz, t0, tF, _, s = node_values(x_full, p, pl)
            args = (wz.reshape(B * N, nz),
                    t0.repeat_interleave(N)[:, None],
                    tF.repeat_interleave(N)[:, None],
                    s.repeat_interleave(N, dim=0),
                    consts(f"tau{p}", x_full).repeat(B)[:, None])
            F = phase_F(p, pl)
            Jw, Jt0, JtF, Js = vmap(jacfwd(F, argnums=(0, 1, 2, 3)))(*args)
            Fv = vmap(F)(*args)
            nf = Fv.shape[-1]
            return (Fv.reshape(B, N, nf), Jw.reshape(B, N, nf, nz),
                    Jt0.reshape(B, N, nf), JtF.reshape(B, N, nf),
                    Js.reshape(B, N, nf, ns))

        def endpoints_at(x_ep, xf, ep_t):
            """Endpoints of one instance's xf (n_full,) with its entries at
            ``ep_idx`` (ep_t) replaced by x_ep (singleton instance axis: see
            phase_F)."""
            return self.endpoints_of(xf.index_copy(0, ep_t, x_ep)[None])

        def endpoint_jacobian(x_full):
            """(B, nb, len(ep_idx)) Jacobian of the raw endpoint constraints
            over the endpoint variables: nb is small, and reverse mode
            through the endpoint extraction is cheap and exact."""
            ep_t = consts("ep_idx", x_full)

            def b_of(x_ep, xf):
                return program.endpoint_constraints(
                    endpoints_at(x_ep, xf, ep_t))[:, 0]
            return vmap(jacrev(b_of))(x_full[:, ep_t], x_full)

        def jac_full(x_full):
            """Dense (B, m_total, n_full) Jacobian of the raw constraints.

            Dtype-polymorphic: follows ``x_full.dtype`` (the solver's
            ``eval_dtype="f32"`` mode assembles in f32)."""
            B = x_full.shape[0]
            parts = []
            for p, (pl, st) in enumerate(zip(lay.phases, phase_static)):
                N, nd = pl.N, pl.num_defect
                stretch = 0.5 * (x_full[:, pl.t_off + 1] - x_full[:, pl.t_off])
                Fv, Jw, Jt0, JtF, Js = node_jacobians(x_full, p)
                I = consts(f"I{p}", x_full)
                W = consts(f"W{p}", x_full)
                E = consts(f"E{p}", x_full)
                cols = st["node_cols"]
                # Defect rows.
                for kk, k in enumerate(pl.defect_states):
                    rows = pl.c_defect_off + kk * nd + np.arange(nd)
                    blk = stretch[:, None, None, None] * I[None, :, :, None] \
                        * Jw[:, None, :, k, :]
                    parts.append((rows[:, None, None] * n_full + cols[None],
                                  blk))
                    parts.append((rows[:, None] * n_full + cols[None, :, k],
                                  E.expand(B, nd, N)))
                    If_k = Fv[:, :, k] @ I.T
                    col_t0 = -0.5 * If_k + stretch[:, None] * (Jt0[:, :, k] @ I.T)
                    col_tF = 0.5 * If_k + stretch[:, None] * (JtF[:, :, k] @ I.T)
                    parts.append((rows * n_full + pl.t_off, col_t0))
                    parts.append((rows * n_full + pl.t_off + 1, col_tF))
                    if ns:
                        parts.append((rows[:, None] * n_full + s_cols[None],
                                      stretch[:, None, None] * torch.einsum(
                                          "dn,bns->bds", I, Js[:, :, k, :])))
                # Path rows.
                for k in range(pl.npc):
                    rows = pl.c_path_off + k * N + np.arange(N)
                    parts.append((rows[:, None] * n_full + cols,
                                  Jw[:, :, pl.ny + k, :]))
                    parts.append((rows * n_full + pl.t_off,
                                  Jt0[:, :, pl.ny + k]))
                    parts.append((rows * n_full + pl.t_off + 1,
                                  JtF[:, :, pl.ny + k]))
                    if ns:
                        parts.append((rows[:, None] * n_full + s_cols[None],
                                      Js[:, :, pl.ny + k, :]))
                # Integral rows.
                iq0 = pl.ny + pl.npc
                for k in range(pl.nq):
                    row = pl.c_integral_off + k
                    parts.append((row * n_full + cols,
                                  -stretch[:, None, None] * W[None, :, None]
                                  * Jw[:, :, iq0 + k, :]))
                    parts.append((np.array([row * n_full + pl.q_off + k]),
                                  torch.ones((B, 1), dtype=x_full.dtype,
                                             device=x_full.device)))
                    Wr = Fv[:, :, iq0 + k] @ W
                    parts.append((np.array([row * n_full + pl.t_off]),
                                  0.5 * Wr - stretch * (Jt0[:, :, iq0 + k] @ W)))
                    parts.append((np.array([row * n_full + pl.t_off + 1]),
                                  -0.5 * Wr - stretch * (JtF[:, :, iq0 + k] @ W)))
                    if ns:
                        parts.append((row * n_full + s_cols,
                                      -stretch[:, None] * torch.einsum(
                                          "n,bns->bs", W, Js[:, :, iq0 + k, :])))
            if lay.nb:
                rows = lay.c_endpoint_off + np.arange(lay.nb)
                parts.append((rows[:, None] * n_full + ep_idx[None],
                              endpoint_jacobian(x_full)))
            return scatter_add("jac", parts, x_full, (m_total, n_full))

        # derivative_level (reference ``pycollo/settings.py`` derivative
        # level 1/2): level 2 = exact Lagrangian Hessian; level 1 =
        # Gauss-Newton — second derivatives of the user's dynamics/path/
        # integrand and endpoint constraints are dropped, keeping only the
        # objective curvature.
        exact_hessian = self.settings.derivative_level == 2

        def node_hessians(x_full, eta, p):
            """(B, N, D, D) Hessian blocks of eta . c_raw's share at each
            node of phase p over the node's [y, u, t0, tF, s], by one
            ``vmap`` over the B*N nodes.  Dtype-polymorphic (follows
            ``x_full``)."""
            pl, st = lay.phases[p], phase_static[p]
            B = x_full.shape[0]
            N, nd, nz, D = pl.N, pl.num_defect, st["nz"], st["D"]
            eta = eta.to(x_full.dtype)
            wz, t0, tF, _, s = node_values(x_full, p, pl)
            I = consts(f"I{p}", x_full)
            W = consts(f"W{p}", x_full)
            # Per-node multiplier weights.
            kappa_f = torch.zeros((B, N, pl.ny), dtype=x_full.dtype,
                                  device=x_full.device)
            for kk, k in enumerate(pl.defect_states):
                off = pl.c_defect_off + kk * nd
                kappa_f[:, :, k] = eta[:, off:off + nd] @ I
            eta_p = eta[:, pl.c_path_off:pl.c_path_off + pl.npc * N] \
                .reshape(B, pl.npc, N).transpose(1, 2)
            eta_i = eta[:, pl.c_integral_off:pl.c_integral_off + pl.nq]
            pf = program.phase_functions[p]

            def phi(vec, kf_j, ep_j, W_j, tau_j, ei):
                # singleton node axis: see phase_F; W_j, tau_j are (1,)
                yv = vec[:pl.ny, None]
                uv = vec[pl.ny:nz, None]
                t0v = vec[nz:nz + 1]
                tFv = vec[nz + 1:nz + 2]
                sv = vec[nz + 2:, None]
                stretch_v = 0.5 * (tFv - t0v)
                t_j = stretch_v * tau_j + 0.5 * (t0v + tFv)
                val = stretch_v * (kf_j @ pf.dynamics(yv, uv, t_j, sv))
                if pl.npc:
                    val = val + ep_j @ pf.path(yv, uv, t_j, sv)
                if pl.nq:
                    val = val - stretch_v * W_j * (
                        ei @ pf.integrand(yv, uv, t_j, sv))
                return val[0]

            vecs = torch.cat([wz, t0[:, None, None].expand(B, N, 1),
                              tF[:, None, None].expand(B, N, 1),
                              s[:, None, :].expand(B, N, ns)], dim=-1)
            blocks = vmap(hessian(phi))(
                vecs.reshape(B * N, D), kappa_f.reshape(B * N, pl.ny),
                eta_p.reshape(B * N, pl.npc), W.repeat(B)[:, None],
                consts(f"tau{p}", x_full).repeat(B)[:, None],
                eta_i.repeat_interleave(N, dim=0))
            return blocks.reshape(B, N, D, D)

        def endpoint_hessian(x_full, eta):
            """(B, E, E) Hessian of w J (+ eta_b . b at derivative level 2)
            over the E = len(ep_idx) endpoint variables."""
            eta = eta.to(x_full.dtype)
            ep_t = consts("ep_idx", x_full)

            def ep_val(x_ep, xf, eta_b):
                ep = endpoints_at(x_ep, xf, ep_t)
                val = self.w * program.objective(ep)
                if lay.nb and exact_hessian:
                    val = val + eta_b @ program.endpoint_constraints(ep)
                return val[0]

            return vmap(hessian(ep_val))(x_full[:, ep_t], x_full,
                                         eta[:, lay.c_endpoint_off:])

        def hess_full(x_full, eta):
            """Dense (B, n_full, n_full) Hessian of eta . c_raw + w J.

            Dtype-polymorphic (see ``jac_full``)."""
            parts = []
            if exact_hessian:
                for p, st in enumerate(phase_static):
                    hi = st["hess_idx"]
                    parts.append((hi[:, :, None] * n_full + hi[:, None, :],
                                  node_hessians(x_full, eta, p)))
            # Endpoint/objective part over the endpoint-relevant entries.
            parts.append((ep_idx[:, None] * n_full + ep_idx[None, :],
                          endpoint_hessian(x_full, eta)))
            return scatter_add("hess", parts, x_full, (n_full, n_full))

        def jac_c_scaled(xs, theta):
            J = jac_full(self.assemble_full(xs, theta))
            fi = consts("free_idx", theta)
            return consts("W_c", theta)[:, None] * J[:, :, fi] \
                * consts("V_free", theta)

        def hess_lag_scaled(xs, lam, theta):
            x_full = self.assemble_full(xs, theta)
            eta = consts("W_c", theta) * lam.to(theta.dtype)
            H = hess_full(x_full, eta)
            fi = consts("free_idx", theta)
            Vf = consts("V_free", theta)
            return H[:, fi][:, :, fi] * Vf[:, None] * Vf[None, :]

        self.jac_c_scaled = jac_c_scaled
        self.hess_lag_scaled = hess_lag_scaled
        self._jac_full_fn = jac_full
        # The per-node and endpoint blocks themselves, for the block-banded
        # KKT operator (solver/block_kkt.py), which assembles from them.
        self.ep_idx = ep_idx
        self.node_jacobians = node_jacobians
        self.node_hessians = node_hessians
        self.endpoint_jacobian = endpoint_jacobian
        self.endpoint_hessian = endpoint_hessian
        self._structured_derivs = dict(jac_c=jac_c_scaled,
                                       hess_lag=hess_lag_scaled)
        return self._structured_derivs

    def _expand_W_ocp(self, W_ocp):
        """Expand per-OCP-constraint scales to the mesh-row vector
        (``pycollo/scaling.py:252-269``).  Returns (W_c, W_ocp); a None
        input produces all-ones at both granularities."""
        lay = self.layout
        n_ocp = sum(len(pl.defect_states) + pl.npc + pl.nq
                    for pl in lay.phases) + lay.nb
        if W_ocp is None:
            W_ocp = np.ones(n_ocp)
        W_c = np.ones(lay.m_total)
        off = 0
        for pl in lay.phases:
            nd_states = len(pl.defect_states)
            W_c[pl.c_defect_off:pl.c_path_off] = np.repeat(
                W_ocp[off:off + nd_states], pl.num_defect)
            off += nd_states
            if pl.npc:
                W_c[pl.c_path_off:pl.c_integral_off] = np.repeat(
                    W_ocp[off:off + pl.npc], pl.N)
                off += pl.npc
            if pl.nq:
                W_c[pl.c_integral_off:pl.c_integral_off + pl.nq] = \
                    W_ocp[off:off + pl.nq]
                off += pl.nq
        if lay.nb:
            W_c[lay.c_endpoint_off:] = W_ocp[off:off + lay.nb]
        return W_c, W_ocp

    # -- scaling ---------------------------------------------------------
    def _build_scaling(self):
        """Objective / constraint scaling (``pycollo/scaling.py:271-430``).

        One-time setup at the guess (a single dense Jacobian + two
        gradients), evaluated in f64 on the CPU.
        """
        lay = self.layout
        cpu64 = dict(dtype=torch.float64, device="cpu")
        xs0 = torch.as_tensor(self.xs_guess, **cpu64)[None]
        theta0 = torch.as_tensor(self.theta_default, **cpu64)[None]
        method = self.settings.scaling_method

        def grad_f_unscaled():
            return grad(lambda xs: self.f_unscaled(xs, theta0).sum())(
                xs0)[0].numpy()

        # The objective scale must exist before the structured Hessian
        # reads it; the gradient layer below refines it.
        self.w = 1.0
        self.w_base = 1.0
        use_update = (self.settings.update_scaling and self.number > 1
                      and method != "none")
        if method == "none":
            self.W_c = np.ones(lay.m_total)
            self.W_ocp = self._expand_W_ocp(None)[1]
        else:
            # Constraint scales (per OCP constraint): defect rows 1/V_y,
            # integral rows 1/V_q, path/endpoint rows 1/(mean row norms of
            # G at the guess) (``pycollo/scaling.py:370-430``).  G comes
            # from the structured per-node assembly.
            self._build_structured_derivatives()
            V_free = self.V_full[self.free_idx]
            x_full0 = torch.as_tensor(self.x_full_guess, **cpu64)[None]
            G = self._jac_full_fn(x_full0)[0].numpy()
            G = G[:, self.free_idx] * V_free[None, :]
            G_norm = np.sqrt((G ** 2).sum(axis=1))
            W_parts = []
            for pl, pb in zip(lay.phases, self.compiled.phase_bounds):
                Vy = self.V_full[pl.y_slice].reshape(pl.ny, pl.N)[:, 0]
                W_parts.append(1.0 / Vy[pl.defect_states])
                if pl.npc:
                    rows = G_norm[pl.c_path_off:pl.c_integral_off]
                    mean_rows = rows.reshape(pl.npc, pl.N).mean(axis=1)
                    W_parts.append(1.0 / np.maximum(mean_rows, 1e-8))
                if pl.nq:
                    W_parts.append(1.0 / self.V_full[pl.q_slice])
            if lay.nb:
                W_parts.append(
                    1.0 / np.maximum(G_norm[lay.c_endpoint_off:], 1e-8))
            W_ocp = np.concatenate(W_parts) if W_parts else np.zeros(0)
            # EWMA across mesh iterations (``pycollo/scaling.py:283-344``,
            # gated by ``settings.update_scaling``, weight alpha).
            if use_update:
                prev = self.compiled.mesh_iterations
                weights = self._ewma_weights(len(prev) + 1)
                W_ocp = np.average(
                    np.vstack([[p.W_ocp for p in prev], W_ocp[None]]),
                    axis=0, weights=weights)
            self.W_ocp = W_ocp
            W_c = self._expand_W_ocp(W_ocp)[0]
            # IPOPT-style gradient-based row scaling on top of the
            # reference-parity scales: IPOPT's default
            # ``nlp_scaling_method = gradient-based`` caps each row's max
            # gradient at 100.
            G_inf = np.abs(G * W_c[:, None]).max(axis=1)
            W_c *= np.minimum(1.0, 100.0 / np.maximum(G_inf, 1e-8))
            self.W_c = W_c
            # Objective scale w: 1.0 on the first mesh iteration, then
            # 1/||grad J|| at the guess (``pycollo/scaling.py:271-281``),
            # EWMA-averaged with previous iterations when
            # ``update_scaling`` (``pycollo/scaling.py:283-293``).
            if self.number == 1:
                self.w_base = 1.0
            else:
                g = grad_f_unscaled()
                g_norm = float(np.sqrt((g ** 2).sum()))
                w_cand = 1.0 if np.isclose(g_norm, 0.0) else 1.0 / g_norm
                if use_update:
                    prev = self.compiled.mesh_iterations
                    weights = self._ewma_weights(len(prev) + 1)
                    w_cand = float(np.average(
                        np.array([p.w_base for p in prev] + [w_cand]),
                        weights=weights))
                self.w_base = w_cand
            self.w = self.w_base
            gJ = grad_f_unscaled()
            gJ_inf = float(np.abs(self.w * gJ).max())
            self.w *= min(1.0, 100.0 / max(gJ_inf, 1e-8))

        consts = self._consts
        consts.add(W_c=self.W_c)
        w = self.w

        def f_scaled(xs, theta):
            return w * self.f_unscaled(xs, theta)

        def c_scaled(xs, theta):
            return consts("W_c", theta) * self.c_unscaled(xs, theta)

        self.f_scaled = f_scaled
        self.c_scaled = c_scaled
        self.cl_scaled = self.W_c * self.cl
        self.cu_scaled = self.W_c * self.cu

    # -- solve ------------------------------------------------------------
    def build_kkt_operator(self):
        """Scaled-space banded-arrowhead KKT operator for the IPM.

        Wraps :class:`solver.block_kkt.BlockKKT` (which works on the full,
        unscaled variable layout) with the scaled-free-space interface the
        solver's structured step expects, batch-first.  This is the
        ``linear_solver = "block-banded"`` path replacing the reference's
        MUMPS sparse factorization (``pycollo/backend.py:1695-1711``).
        """
        from .solver.block_kkt import BlockKKT
        block = BlockKKT(self)
        it = self

        class _ScaledKKT:
            def assemble(self, xs, theta, lam, sig_free, dinv_rows):
                x_full = it.assemble_full(xs, theta)
                eta = it._consts("W_c", theta) * lam
                return block.assemble(x_full, eta, sig_free, dinv_rows)

            def factor(self, blocks, dw):
                return block.factor(blocks, dw)

            def solve(self, blocks, factors, rhs):
                return block.solve(blocks, factors, rhs)

            def kmul(self, blocks, dw, dx):
                return block.kmul(blocks, dw, dx)

        return _ScaledKKT()

    def build_solver(self, options=None, use_structured=True):
        """Build the batched interior-point solver of this iteration's NLP:
        the dense condensed-KKT path, or with ``linear_solver =
        "block-banded"`` the structured banded-arrowhead path.
        ``use_structured=False`` leaves the derivatives to the solver's
        generic ``torch.func`` fallback instead of the per-node structured
        assembly (and so takes the dense path)."""
        from .solver.ipm import IPMOptions, build_ipm_solver
        if options is None:
            options = IPMOptions(tol=self.settings.nlp_tolerance,
                                 max_iter=self.settings.max_nlp_iterations,
                                 mu_init=self.settings.ipm_mu_init,
                                 mu_min=self.settings.ipm_mu_min,
                                 line_search=self.settings.ipm_line_search,
                                 inertia=self.settings.ipm_inertia)
        with self.profiler.span("solver build"):
            derivatives = None
            if use_structured:
                derivatives = dict(self._build_structured_derivatives())
                if self.settings.linear_solver == "block-banded":
                    derivatives["kkt"] = self.build_kkt_operator()
            self._solver = build_ipm_solver(
                self.f_scaled, self.c_scaled, self.xs_lb, self.xs_ub,
                self.cl_scaled, self.cu_scaled, options,
                derivatives=derivatives)
        return self._solver

    def solve(self, theta=None, warm=None, device="cuda"):
        """Solve this mesh iteration's NLP on ``device`` (default the CUDA
        card; ``"cpu"`` names the CPU); returns an IterationResult.

        ``warm`` is an optional dict with keys ``lam`` (m,), ``zl``/``zu``
        (n_free,), ``mu`` (scalar) interpolated from the previous mesh
        iteration.
        """
        import time

        from .solver.ipm import IPMResult
        device = solve_device(device)
        if self._solver is None:
            self.build_solver()
        if theta is None:
            theta = self.theta_default
        kw = dict(dtype=self.dtype, device=device)
        theta_t = torch.as_tensor(theta, **kw).reshape(1, -1)
        xs0 = torch.as_tensor(self.xs_guess, **kw).reshape(1, -1)
        t0 = time.perf_counter()
        if warm is None:
            res = self._solver(xs0, theta_t)
        else:
            res = self._solver.warm(
                xs0, theta_t,
                *(torch.as_tensor(warm[k], **kw).reshape(1, -1)
                  for k in ("lam", "zl", "zu")),
                torch.as_tensor(warm["mu"], **kw).reshape(1))
        x_full = self.assemble_full(res.x, theta_t)[0].cpu().numpy()
        solve_time = time.perf_counter() - t0
        self.profiler.add("NLP solve", solve_time)
        return IterationResult(iteration=self,
                               ipm_result=IPMResult(*(f[0] for f in res)),
                               x_full=x_full, solve_time=solve_time)

    def dump_nlp_check_values(self, path: Optional[str] = None):
        """Dump NLP function values at the guess to JSON.

        Parity with the reference's ``check_nlp_functions`` debug dump
        (``pycollo/iteration.py:1210-1239``, ``pycollo/settings.py:360-365``).
        """
        import json
        cpu64 = dict(dtype=torch.float64, device="cpu")
        xs0 = torch.as_tensor(self.xs_guess, **cpu64)[None]
        theta0 = torch.as_tensor(self.theta_default, **cpu64)[None]
        g = grad(lambda xs: self.f_scaled(xs, theta0).sum())(xs0)
        data = {
            "x_scaled_guess": self.xs_guess.tolist(),
            "J_scaled": float(self.f_scaled(xs0, theta0)[0]),
            "g_scaled": g[0].tolist(),
            "c_scaled": self.c_scaled(xs0, theta0)[0].tolist(),
            "constraint_scales_W": self.W_c.tolist(),
            "objective_scale_w": float(self.w),
        }
        path = path or f"nlp_check_values_iter{self.number}.json"
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
        return path


@dataclass
class IterationResult:
    """Raw solve output for one mesh iteration."""

    iteration: MeshIteration
    ipm_result: object
    x_full: np.ndarray
    solve_time: float

    @property
    def objective(self) -> float:
        """Unscaled objective (``pycollo/scaling.py:186-189``)."""
        return float(self.ipm_result.f) / self.iteration.w

    @property
    def converged(self) -> bool:
        return bool(self.ipm_result.converged)
