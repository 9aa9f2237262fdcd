"""Initial guess containers and mesh interpolation.

Capability parity with ``pycollo/guess.py``: user supplies per-phase time
arrays (strictly ascending, ``pycollo/guess.py:10-22``), state/control
trajectories of shape (num_var, num_time_points), integral values and
problem parameter guesses; the internal processing validates shapes,
normalizes time to tau in [-1, 1] (``pycollo/guess.py:164-176``), and
linearly interpolates onto mesh nodes (``pycollo/iteration.py:86-194``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["PhaseGuess", "EndpointGuess", "ProcessedPhaseGuess"]


class PhaseGuess:
    """User-facing guess for one phase."""

    def __init__(self, phase=None, *, time=None, state_variables=None,
                 control_variables=None, integral_variables=None):
        self.phase = phase
        self._time = None
        if time is not None:
            self.time = time
        self.state_variables = state_variables
        self.control_variables = control_variables
        self.integral_variables = integral_variables

    @property
    def time(self):
        return self._time

    @time.setter
    def time(self, value):
        value = np.asarray(value, dtype=float).ravel()
        if value.size < 2:
            raise ValueError("Guess time must contain at least two points.")
        if np.any(np.diff(value) <= 0):
            raise ValueError("Guess time must be strictly ascending.")
        self._time = value


class EndpointGuess:
    """User-facing guess for problem-level parameter variables."""

    def __init__(self, ocp=None, *, parameter_variables=None):
        self.ocp = ocp
        self.parameter_variables = parameter_variables


class ProcessedPhaseGuess:
    """Validated, tau-normalized guess for one phase."""

    def __init__(self, *, tau, y, u, q, t0, tF):
        self.tau = tau    # (nt,) normalized to [-1, 1]
        self.y = y        # (ny, nt)
        self.u = u        # (nu, nt)
        self.q = q        # (nq,)
        self.t0 = t0
        self.tF = tF

    def interpolate(self, tau_mesh: np.ndarray):
        """Linear interpolation of y and u onto the mesh nodes."""
        y_mesh = np.stack([np.interp(tau_mesh, self.tau, row)
                           for row in self.y]) if self.y.size else \
            np.zeros((0, len(tau_mesh)))
        u_mesh = np.stack([np.interp(tau_mesh, self.tau, row)
                           for row in self.u]) if self.u.size else \
            np.zeros((0, len(tau_mesh)))
        return y_mesh, u_mesh


def _as_2d(value, num, nt, what):
    if value is None:
        if num == 0:
            return np.zeros((0, nt))
        raise ValueError(f"Missing {what} guess.")
    arr = np.asarray(value, dtype=float)
    if arr.ndim == 1:
        if num == 1 and arr.size == nt:
            arr = arr[None, :]
        else:
            raise ValueError(
                f"{what} guess must have shape ({num}, {nt}), got "
                f"{arr.shape}.")
    if arr.shape != (num, nt):
        raise ValueError(f"{what} guess must have shape ({num}, {nt}), got "
                         f"{arr.shape}.")
    return arr


def process_phase_guess(phase, resolve=lambda v: v) -> ProcessedPhaseGuess:
    """Validate a phase guess and normalize its time base to tau."""
    g: PhaseGuess = phase.guess
    if g.time is None:
        raise ValueError(f"Phase {phase.name!r} needs a time guess.")
    t = g.time
    nt = t.size
    ny = phase.number_state_variables
    nu = phase.number_control_variables
    nq = phase.number_integrand_functions
    y = _as_2d(resolve(g.state_variables), ny, nt, "state")
    u = _as_2d(resolve(g.control_variables), nu, nt, "control")
    q_val = resolve(g.integral_variables)
    if q_val is None:
        q = np.zeros(nq)
    else:
        q = np.atleast_1d(np.asarray(q_val, dtype=float))
        if q.shape != (nq,):
            raise ValueError(f"Integral guess must have shape ({nq},), got "
                             f"{q.shape}.")
    t0, tF = float(t[0]), float(t[-1])
    # Affine map t -> tau in [-1, 1] (``pycollo/guess.py:164-176``).
    stretch = 0.5 * (tF - t0)
    shift = 0.5 * (t0 + tF)
    tau = (t - shift) / stretch
    tau[0], tau[-1] = -1.0, 1.0
    return ProcessedPhaseGuess(tau=tau, y=y, u=u, q=q, t0=t0, tF=tF)
