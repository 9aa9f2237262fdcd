"""Solution post-processing.

Capability parity with ``pycollo/solution/`` (~560 LoC): unscale the NLP
solution into per-phase :class:`PhaseSolutionData` (tau, y, dy, u, q, t0,
tF, stretch, shift, time), provide the per-section polynomial continuous
extension of the collocation solution (dy interpolated at collocation
points, y recovered by exact integration — the integral-form analogue of
``solution_abc.py:60-142``), mesh refinement dispatch, and plotting.

This is host post-processing between solves: it reads the iteration's
unscaled ``x_full`` (numpy) and evaluates the phase dynamics on float64 CPU
tensors, whatever device the NLP was solved on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from . import quadrature as quad


def eval_dynamics(phase_functions, y, u, time, s) -> np.ndarray:
    """The phase dynamics at nodes, in float64 on the CPU.

    ``y`` (ny, N), ``u`` (nu, N), ``time`` (N,) and ``s`` (ns,) are numpy
    arrays; the node axis is the batch axis of the component-first
    callables.  Returns (ny, N).
    """
    def t64(a):
        return torch.tensor(np.asarray(a), dtype=torch.float64)

    with torch.no_grad():
        f = phase_functions.dynamics(t64(y), t64(u), t64(time),
                                     t64(s)[:, None])
    return f.numpy()


@dataclass
class PhaseSolutionData:
    """Structured solution values for one phase."""

    tau: np.ndarray       # (N,)
    time: np.ndarray      # (N,) physical time at mesh nodes
    y: np.ndarray         # (ny, N)
    dy: np.ndarray        # (ny, N) state derivatives at mesh nodes
    u: np.ndarray         # (nu, N)
    q: np.ndarray         # (nq,)
    t0: float
    tF: float
    stretch: float
    shift: float


class Solution:
    """Processed solution of one mesh iteration.

    Exposes the reference's user-facing accessors
    (``pycollo/solution/solution_abc.py``): ``objective``, ``state``,
    ``control``, ``integral``, ``time``, ``parameter``, plus the polynomial
    evaluators used by mesh refinement and plotting.
    """

    def __init__(self, iteration_result):
        self.it_result = iteration_result
        self.iteration = iteration_result.iteration
        self.backend = self.iteration.compiled
        self.ocp = self.iteration.ocp
        self._process()

    def _process(self):
        it = self.iteration
        lay = it.layout
        x_full = self.it_result.x_full
        self.x_full = x_full
        self.parameter = x_full[lay.s_slice]
        self.phase_data: List[PhaseSolutionData] = []
        program = self.backend.program
        for i, (pl, t) in enumerate(zip(lay.phases, it.tables)):
            y = x_full[pl.y_slice].reshape(pl.ny, pl.N)
            u = x_full[pl.u_slice].reshape(pl.nu, pl.N).copy()
            q = x_full[pl.q_slice]
            if pl.nu and t.method == "radau":
                # The final mesh node of a Radau phase is not a
                # collocation point, so its control is a dangling NLP
                # variable (only bounded, never constrained) — replace it
                # with the extrapolation of the last section's control
                # polynomial (analogue of the reference's Radau handling,
                # ``pycollo/solution/solution_abc.py:104-142``).
                k = t.K - 1
                n_k = int(t.section_nodes[k])
                start = int(t.section_starts[k])
                sch = quad.scheme(t.method, n_k)
                ncol = sch.num_collocation
                nodes = t.tau[start:start + n_k]
                lo, hi = nodes[0], t.tau[-1]
                xc = 2.0 * (nodes - lo) / (hi - lo) - 1.0
                Lq = quad.interpolation_matrix(xc[:ncol], np.array([1.0]))
                u[:, -1] = (Lq @ u[:, start:start + ncol].T)[0]
            t0 = float(x_full[pl.t_off])
            tF = float(x_full[pl.t_off + 1])
            stretch = 0.5 * (tF - t0)
            shift = 0.5 * (t0 + tF)
            time = stretch * t.tau + shift
            dy = eval_dynamics(program.phase_functions[i], y, u, time,
                               self.parameter)
            self.phase_data.append(PhaseSolutionData(
                tau=t.tau, time=time, y=y, dy=dy, u=u, q=q, t0=t0, tF=tF,
                stretch=stretch, shift=shift))

    # -- reference-parity accessors -------------------------------------
    @property
    def objective(self) -> float:
        return self.it_result.objective

    @property
    def state(self):
        return [pd.y for pd in self.phase_data]

    @property
    def control(self):
        return [pd.u for pd in self.phase_data]

    @property
    def state_derivative(self):
        return [pd.dy for pd in self.phase_data]

    @property
    def integral(self):
        return [pd.q for pd in self.phase_data]

    @property
    def time(self):
        return [pd.time for pd in self.phase_data]

    # Reference's private-name alias used by examples
    # (``examples/cart_pole_swing_up/cart_pole_swing_up_explicit.py:84``).
    @property
    def _time_(self):
        return self.time

    @property
    def initial_time(self):
        return [pd.t0 for pd in self.phase_data]

    @property
    def final_time(self):
        return [pd.tF for pd in self.phase_data]

    # -- polynomial continuous extension --------------------------------
    def interpolate_phase(self, phase_index: int, tau_query: np.ndarray):
        """Evaluate the collocation polynomials of a phase at ``tau_query``.

        Returns (y_q, u_q) with shapes (ny, len(tau_query)), (nu, ...).
        Integral-form evaluation: within each section, dy is interpolated
        at the collocation points and y recovered as
        ``y(tq) = y_sec_start + stretch * int dy`` (exact for the
        collocation polynomial; analogue of ``solution_abc.py:60-142``).
        """
        t = self.iteration.tables[phase_index]
        pd = self.phase_data[phase_index]
        tau_query = np.asarray(tau_query)
        ny, nu = pd.y.shape[0], pd.u.shape[0]
        y_q = np.empty((ny, len(tau_query)))
        u_q = np.empty((nu, len(tau_query)))
        sec_bounds = np.concatenate(
            [t.tau[t.section_starts], [t.tau[-1]]])
        for k in range(t.K):
            n_k = int(t.section_nodes[k])
            start = int(t.section_starts[k])
            lo, hi = sec_bounds[k], sec_bounds[k + 1]
            if k == t.K - 1:
                sel = (tau_query >= lo - 1e-14) & (tau_query <= hi + 1e-14)
            else:
                sel = (tau_query >= lo - 1e-14) & (tau_query < hi)
            if not np.any(sel):
                continue
            # Map to the section's reference element [-1, 1].
            h_k = hi - lo
            xq = 2.0 * (tau_query[sel] - lo) / h_k - 1.0
            nodes = t.tau[start:start + n_k]
            xc = 2.0 * (nodes - lo) / h_k - 1.0
            sch = quad.scheme(t.method, n_k)
            ncol = sch.num_collocation
            Iq = quad.integration_matrix(xc[:ncol], xq)  # (nq, ncol)
            dy_sec = pd.dy[:, start:start + ncol]         # (ny, ncol)
            y_q[:, sel] = pd.y[:, start:start + 1] \
                + pd.stretch * 0.5 * h_k * (Iq @ dy_sec.T).T
            Lq = quad.interpolation_matrix(xc, xq)
            u_q[:, sel] = (Lq @ pd.u[:, start:start + n_k].T).T
        return y_q, u_q

    # -- mesh refinement dispatch ---------------------------------------
    def refine_mesh(self, prev_max_errors=None):
        """Estimate mesh error and propose the next mesh
        (``solution_abc.py:147-151``)."""
        from .refinement import PattersonRaoMeshRefinement
        return PattersonRaoMeshRefinement(self,
                                          prev_max_errors=prev_max_errors)

    # -- plotting --------------------------------------------------------
    def plot(self, **kwargs):
        from .vis.plot import plot_solution
        return plot_solution(self, **kwargs)

    def plot_mesh(self, **kwargs):
        from .vis.plot import plot_mesh
        return plot_mesh(self, **kwargs)
