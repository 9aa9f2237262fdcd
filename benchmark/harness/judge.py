"""The comparison that decides ``correct``: answers judged by what they say.

Each answer of the program is one instance's ``x_full`` (the unscaled NLP
vector in the program's documented layout: per state a column of its N
node values, then per control, then the integrals, t0 and tF) and its
reported objective.  The plain reference (``reference/<config>.py``)
describes the problem in plain PyTorch; this module transcribes it on its
own tables (:mod:`.collocation`) and measures, per answer, in float64 on
the CPU:

``feas``
    the largest violation of the transcribed problem: every collocation
    defect, the integral's quadrature, the box bounds and the pinned
    endpoint values (the instance's own initial state, drawn from the
    seed), each over the range of the variable's bounds;
``obj_gap``
    |reported objective - the reference's objective at ``x_full``| over
    max(1, |the reference's objective|);
``stat``
    first-order optimality: with the variables scaled to [0, 1] by their
    bounds and each constraint row by its state's range, the multipliers
    are fitted by least squares on the variables away from their bounds
    (``BOUND_GAP``), and the projected-gradient residual
    |z - clip(z - (grad f + J^T lam), 0, 1)| is taken over every free
    variable, over max(1, |grad f|_inf).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch.func import jacrev, vmap

from .collocation import Mesh

#: scaled distance to a bound under which a variable does not take part in
#: the least-squares fit of the multipliers (its bound multiplier is not
#: known); the projected-gradient residual still covers it
BOUND_GAP = 1e-3


@dataclass
class OCP:
    """One phase, described in plain PyTorch by a reference module.

    Bounds are ``(lower, upper)`` pairs; ``initial`` and ``final`` give the
    pinned endpoint value of each state (None where it is free).
    ``dynamics(y, u)`` and ``integrand(y, u)`` take ``y`` (..., ny, N) and
    ``u`` (..., nu, N) and return (..., ny, N) and (..., nq, N);
    ``objective(y, u, q, t0, tF)`` returns (...,)."""

    states: Sequence[str]
    controls: Sequence[str]
    state_bounds: np.ndarray       # (ny, 2)
    control_bounds: np.ndarray     # (nu, 2)
    integral_bounds: np.ndarray    # (nq, 2)
    t0_bounds: tuple
    tF_bounds: tuple
    initial: Dict[str, Optional[float]]
    final: Dict[str, Optional[float]]
    dynamics: Callable
    integrand: Callable
    objective: Callable

    @property
    def ny(self):
        return len(self.states)

    @property
    def nu(self):
        return len(self.controls)

    @property
    def nq(self):
        return len(self.integral_bounds)


class Transcription:
    """The reference's transcription of ``ocp`` on ``mesh``."""

    def __init__(self, ocp: OCP, mesh: Mesh):
        self.ocp, self.mesh = ocp, mesh
        N = mesh.N
        self.N = N
        S, I = mesh.defect_operator()
        f64 = dict(dtype=torch.float64)
        self.S = torch.as_tensor(S, **f64)
        self.I = torch.as_tensor(I, **f64)
        self.w = torch.as_tensor(mesh.quadrature_weights(), **f64)
        ny, nu, nq = ocp.ny, ocp.nu, ocp.nq
        self.n_full = (ny + nu) * N + nq + 2
        lo = np.concatenate([np.repeat(ocp.state_bounds[:, 0], N),
                             np.repeat(ocp.control_bounds[:, 0], N),
                             ocp.integral_bounds[:, 0],
                             [ocp.t0_bounds[0], ocp.tF_bounds[0]]])
        hi = np.concatenate([np.repeat(ocp.state_bounds[:, 1], N),
                             np.repeat(ocp.control_bounds[:, 1], N),
                             ocp.integral_bounds[:, 1],
                             [ocp.t0_bounds[1], ocp.tF_bounds[1]]])
        # pinned entries: fixed times, pinned endpoint states
        pinned = lo == hi
        for i, name in enumerate(ocp.states):
            if ocp.initial.get(name) is not None:
                pinned[i * N] = True
            if ocp.final.get(name) is not None:
                pinned[i * N + N - 1] = True
        self.pinned = pinned
        self.free = ~pinned
        self.lo, self.hi = lo, hi
        rng = hi - lo
        # the range of a pinned time is 1; every other variable is boxed
        self.range = np.where(rng > 0, rng, 1.0)
        # constraint row scales: a defect row by its state's range, the
        # integral by its bound range
        srange = ocp.state_bounds[:, 1] - ocp.state_bounds[:, 0]
        qrange = ocp.integral_bounds[:, 1] - ocp.integral_bounds[:, 0]
        self.row_scale = torch.as_tensor(np.concatenate(
            [np.repeat(srange, S.shape[0]), qrange]), **f64)

    # --------------------------------------------------------------
    def pinned_values(self, initial: np.ndarray) -> np.ndarray:
        """(M, n_full) with each instance's pinned values where
        ``self.pinned`` (the given (M, ny) initial states, NaN where a
        state is free, the final targets and the fixed times) and NaN
        elsewhere."""
        ocp, N = self.ocp, self.N
        M = initial.shape[0]
        out = np.full((M, self.n_full), np.nan)
        fixed = self.lo == self.hi
        out[:, fixed] = self.lo[fixed]
        for i, name in enumerate(ocp.states):
            if ocp.initial.get(name) is not None:
                out[:, i * N] = initial[:, i]
            if ocp.final.get(name) is not None:
                out[:, i * N + N - 1] = ocp.final[name]
        return out

    def split(self, x: torch.Tensor):
        """(..., n_full) -> y (..., ny, N), u (..., nu, N), q (..., nq),
        t0 (...), tF (...)."""
        ocp, N = self.ocp, self.N
        ny, nu, nq = ocp.ny, ocp.nu, ocp.nq
        lead = x.shape[:-1]
        y = x[..., :ny * N].reshape(*lead, ny, N)
        u = x[..., ny * N:(ny + nu) * N].reshape(*lead, nu, N)
        q = x[..., (ny + nu) * N:(ny + nu) * N + nq]
        return y, u, q, x[..., -2], x[..., -1]

    def constraints(self, x: torch.Tensor) -> torch.Tensor:
        """(..., m) scaled equality residuals: the defects of every state,
        then the integrals."""
        y, u, q, t0, tF = self.split(x)
        stretch = (0.5 * (tF - t0))[..., None, None]
        f = self.ocp.dynamics(y, u)
        defect = (y @ self.S.T) + stretch * (f @ self.I.T)
        g = self.ocp.integrand(y, u)
        integral = q - stretch[..., 0] * (g @ self.w)
        c = torch.cat([defect.reshape(*defect.shape[:-2], -1), integral],
                      dim=-1)
        return c / self.row_scale

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        return self.ocp.objective(*self.split(x))

    # --------------------------------------------------------------
    def feasibility(self, x: np.ndarray, pinned: np.ndarray) -> np.ndarray:
        """(M,) the largest scaled violation of each answer."""
        xt = torch.as_tensor(x, dtype=torch.float64)
        c = self.constraints(xt).abs().amax(dim=-1).numpy()
        rng = self.range
        box = np.maximum(np.maximum(self.lo - x, x - self.hi), 0.0) / rng
        pin = np.where(self.pinned, np.abs(x - np.nan_to_num(pinned)), 0.0) \
            / rng
        out = np.maximum(c, np.maximum(box.max(axis=1), pin.max(axis=1)))
        # a non-finite answer is as infeasible as it gets
        return np.where(np.isfinite(x).all(axis=1), out, np.inf)

    def objective_gap(self, x: np.ndarray, reported: np.ndarray) -> np.ndarray:
        ref = self.objective(torch.as_tensor(x, dtype=torch.float64)).numpy()
        gap = np.abs(np.asarray(reported, dtype=np.float64) - ref) \
            / np.maximum(1.0, np.abs(ref))
        return np.where(np.isfinite(gap), gap, np.inf)

    def stationarity(self, x: np.ndarray, chunk: int = 512) -> np.ndarray:
        """(M,) the scaled projected-gradient residual of each answer."""
        out = []
        for a in range(0, x.shape[0], chunk):
            out.append(self._stationarity(x[a:a + chunk]))
        return np.concatenate(out) if out else np.zeros(0)

    def _stationarity(self, x: np.ndarray) -> np.ndarray:
        f64 = dict(dtype=torch.float64)
        free = torch.as_tensor(np.nonzero(self.free)[0])
        lo = torch.as_tensor(self.lo, **f64)[free]
        rng = torch.as_tensor(self.range, **f64)[free]
        xt = torch.as_tensor(x, **f64)
        z = (xt[:, free] - lo) / rng

        def full(zi, xi):
            return xi.index_put((free,), lo + rng * zi)

        def obj(zi, xi):
            return self.objective(full(zi, xi))

        def con(zi, xi):
            return self.constraints(full(zi, xi))

        g = vmap(jacrev(obj))(z, xt)                  # (M, nf)
        J = vmap(jacrev(con))(z, xt)                  # (M, m, nf)
        inner = ((z > BOUND_GAP) & (z < 1.0 - BOUND_GAP)).to(torch.float64)
        A = J.transpose(-1, -2) * inner[..., None]    # (M, nf, m)
        b = -(g * inner)[..., None]
        lam = torch.linalg.lstsq(A, b, driver="gelsd").solution
        r = g + (J.transpose(-1, -2) @ lam)[..., 0]
        e = (z - (z - r).clamp(0.0, 1.0)).abs().amax(dim=-1)
        scale = g.abs().amax(dim=-1).clamp(min=1.0)
        res = (e / scale).numpy()
        return np.where(np.isfinite(res), res, np.inf)
