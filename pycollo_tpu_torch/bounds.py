"""Bounds containers and normalization.

Capability parity with ``pycollo/bounds.py`` (951 LoC): user-facing
``PhaseBounds`` / ``EndpointBounds`` accepting scalars, pairs, iterables of
pairs, dicts keyed by variable (symbol or name), or ``None``; ``None`` maps
to +/- ``settings.numerical_inf`` when ``assume_inf_bounds`` is set; lower >
upper clashes are errors unless within the abs/rel clash tolerance (then
collapsed to equality, ``pycollo/bounds.py:817-850``); variables whose lower
and upper bounds are equal leave the NLP and become per-instance constants
(``pycollo/bounds.py:901-935``) — here they become entries of the parameter
vector ``theta`` so batched instances can perturb them; and endpoint state
constraints narrow the first/last mesh-node bounds of each state
(``pycollo/bounds.py:346-401``, ``pycollo/iteration.py:408-429``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

__all__ = ["PhaseBounds", "EndpointBounds", "ProcessedPhaseBounds",
           "ProcessedProblemBounds", "process_bounds_value"]


def _is_pair(value) -> bool:
    try:
        return (len(value) == 2
                and np.isscalar(value[0]) or isinstance(value[0], (int, float, np.floating, np.integer)))
    except TypeError:
        return False


def process_bounds_value(value, num: int, names: Sequence[str],
                         inf: float, assume_inf: bool,
                         what: str = "bounds") -> np.ndarray:
    """Normalize a user bounds spec to an (num, 2) array.

    Accepted forms (parity with ``pycollo/bounds.py:496-690``):
    scalar (lb == ub, broadcast if num == 1), a (lb, ub) pair for a single
    variable, an iterable of scalars/pairs (one per variable), or a dict
    keyed by variable name/symbol with scalar or pair values.  ``None``
    entries become (-inf, +inf) if ``assume_inf`` else raise.
    """
    out = np.full((num, 2), np.nan)

    def set_row(i, val):
        if val is None:
            if not assume_inf:
                raise ValueError(
                    f"Missing {what} for {names[i]!r} and "
                    f"assume_inf_bounds is disabled.")
            out[i] = (-inf, inf)
        elif np.isscalar(val) or isinstance(val, (int, float, np.floating,
                                                  np.integer)):
            out[i] = (float(val), float(val))
        else:
            pair = np.asarray(val, dtype=float).ravel()
            if pair.size == 1:
                out[i] = (pair[0], pair[0])
            elif pair.size == 2:
                out[i] = pair
            else:
                raise ValueError(
                    f"Cannot interpret {what} entry {val!r} for "
                    f"{names[i]!r}: expected a scalar or (lower, upper) pair.")

    if value is None:
        for i in range(num):
            set_row(i, None)
        return out

    if isinstance(value, dict):
        key_map = {}
        for key, val in value.items():
            key_map[str(key)] = val
        unknown = set(key_map) - set(str(n) for n in names)
        if unknown:
            raise ValueError(f"Unknown variable(s) in {what} dict: "
                             f"{sorted(unknown)}; expected from {list(names)}.")
        for i, name in enumerate(names):
            set_row(i, key_map.get(str(name)))
        return out

    if np.isscalar(value) or isinstance(value, (int, float, np.floating,
                                                np.integer)):
        if num == 1:
            set_row(0, value)
            return out
        raise ValueError(f"Scalar {what} given for {num} variables.")

    arr = list(value)
    if num == 1 and len(arr) == 2 and all(
            np.isscalar(v) or isinstance(v, (int, float, np.floating,
                                             np.integer)) or v is None
            for v in arr):
        # Ambiguous case: a 2-list for a single variable is a (lb, ub) pair.
        set_row(0, arr)
        return out
    if len(arr) != num:
        raise ValueError(
            f"{what} must supply one entry per variable ({num}), "
            f"got {len(arr)}.")
    for i, val in enumerate(arr):
        set_row(i, val)
    return out


def _check_clashes(bnd: np.ndarray, names: Sequence[str], what: str,
                   abs_tol: float, rel_tol: float) -> np.ndarray:
    """Validate lower <= upper; collapse near-equal clashes to the midpoint."""
    bnd = bnd.copy()
    for i in range(bnd.shape[0]):
        lo, hi = bnd[i]
        if lo > hi:
            scale = max(abs(lo), abs(hi), 1.0)
            if (lo - hi) <= max(abs_tol, rel_tol * scale):
                mid = 0.5 * (lo + hi)
                bnd[i] = (mid, mid)
            else:
                raise ValueError(
                    f"Lower bound {lo} exceeds upper bound {hi} for "
                    f"{what} {names[i]!r}.")
    return bnd


class PhaseBounds:
    """User-facing bounds for one phase.

    Attributes mirror the reference ``PhaseBounds``: ``initial_time``,
    ``final_time``, ``state_variables``, ``control_variables``,
    ``integral_variables``, ``path_constraints``,
    ``initial_state_constraints``, ``final_state_constraints``.
    """

    def __init__(self, phase=None, *, initial_time=None, final_time=None,
                 state_variables=None, control_variables=None,
                 integral_variables=None, path_constraints=None,
                 initial_state_constraints=None,
                 final_state_constraints=None):
        self.phase = phase
        self.initial_time = initial_time
        self.final_time = final_time
        self.state_variables = state_variables
        self.control_variables = control_variables
        self.integral_variables = integral_variables
        self.path_constraints = path_constraints
        self.initial_state_constraints = initial_state_constraints
        self.final_state_constraints = final_state_constraints


class EndpointBounds:
    """User-facing problem-level bounds: parameters and endpoint constraints."""

    def __init__(self, ocp=None, *, parameter_variables=None,
                 endpoint_constraints=None):
        self.ocp = ocp
        self.parameter_variables = parameter_variables
        self.endpoint_constraints = endpoint_constraints


class ProcessedPhaseBounds:
    """Normalized per-phase bounds arrays plus the ``_needed`` masks."""

    def __init__(self, *, y_bnd, u_bnd, q_bnd, t0_bnd, tF_bnd,
                 y_t0_bnd, y_tF_bnd, path_bnd):
        self.y_bnd = y_bnd          # (ny, 2)
        self.u_bnd = u_bnd          # (nu, 2)
        self.q_bnd = q_bnd          # (nq, 2)
        self.t0_bnd = t0_bnd        # (2,)
        self.tF_bnd = tF_bnd        # (2,)
        self.y_t0_bnd = y_t0_bnd    # (ny, 2) first-node bounds
        self.y_tF_bnd = y_tF_bnd    # (ny, 2) last-node bounds
        self.path_bnd = path_bnd    # (npc, 2)
        self.y_needed = ~np.isclose(y_bnd[:, 0], y_bnd[:, 1])
        self.u_needed = ~np.isclose(u_bnd[:, 0], u_bnd[:, 1])
        self.q_needed = ~np.isclose(q_bnd[:, 0], q_bnd[:, 1])
        self.t_needed = np.array([not np.isclose(t0_bnd[0], t0_bnd[1]),
                                  not np.isclose(tF_bnd[0], tF_bnd[1])])


class ProcessedProblemBounds:
    """Normalized problem-level bounds: parameters and endpoint constraints."""

    def __init__(self, *, s_bnd, b_bnd):
        self.s_bnd = s_bnd          # (ns, 2)
        self.b_bnd = b_bnd          # (nb, 2)
        self.s_needed = ~np.isclose(s_bnd[:, 0], s_bnd[:, 1])


def process_phase_bounds(phase, settings,
                         resolve=lambda v: v) -> ProcessedPhaseBounds:
    """Build :class:`ProcessedPhaseBounds` from a phase's user bounds.

    ``resolve`` maps possibly-symbolic bound entries to numbers (used by the
    symbolic frontend to evaluate aux-data expressions in bounds).
    """
    b: PhaseBounds = phase.bounds
    inf = settings.numerical_inf
    assume = settings.assume_inf_bounds
    abs_tol = settings.bound_clash_absolute_tolerance
    rel_tol = settings.bound_clash_relative_tolerance
    y_names = [str(v) for v in phase.state_variables]
    u_names = [str(v) for v in phase.control_variables]
    q_names = [f"q{i}" for i in range(phase.number_integrand_functions)]
    pc_names = [f"path{i}" for i in range(phase.number_path_constraints)]

    def norm(value, num, names, what):
        value = resolve(value)
        arr = process_bounds_value(value, num, names, inf, assume, what)
        return _check_clashes(arr, names, what, abs_tol, rel_tol)

    y_bnd = norm(b.state_variables, len(y_names), y_names, "state bounds")
    u_bnd = norm(b.control_variables, len(u_names), u_names, "control bounds")
    q_bnd = norm(b.integral_variables, len(q_names), q_names,
                 "integral bounds")
    t0_bnd = norm(b.initial_time, 1, ["t0"], "initial time bounds")[0]
    tF_bnd = norm(b.final_time, 1, ["tF"], "final time bounds")[0]
    path_bnd = norm(b.path_constraints, len(pc_names), pc_names,
                    "path constraint bounds")

    def endpoint(value, default, what):
        if value is None:
            return default.copy()
        value = resolve(value)
        arr = process_bounds_value(value, len(y_names), y_names, inf, True,
                                   what)
        # Entries absent from a dict spec fall back to the full-phase bounds.
        if isinstance(value, dict):
            given = set(str(k) for k in value)
            for i, name in enumerate(y_names):
                if str(name) not in given:
                    arr[i] = default[i]
        arr = _check_clashes(arr, y_names, what, abs_tol, rel_tol)
        if settings.override_endpoint_bounds:
            # Endpoint bounds may only narrow the full-phase bounds.
            arr[:, 0] = np.maximum(arr[:, 0], default[:, 0])
            arr[:, 1] = np.minimum(arr[:, 1], default[:, 1])
            arr = _check_clashes(arr, y_names, what, abs_tol, rel_tol)
        return arr

    y_t0_bnd = endpoint(b.initial_state_constraints, y_bnd,
                        "initial state constraints")
    y_tF_bnd = endpoint(b.final_state_constraints, y_bnd,
                        "final state constraints")

    if np.any(t0_bnd[0] > tF_bnd[1]):
        raise ValueError("Initial time lower bound exceeds final time upper "
                         "bound.")

    return ProcessedPhaseBounds(y_bnd=y_bnd, u_bnd=u_bnd, q_bnd=q_bnd,
                                t0_bnd=t0_bnd, tF_bnd=tF_bnd,
                                y_t0_bnd=y_t0_bnd, y_tF_bnd=y_tF_bnd,
                                path_bnd=path_bnd)


def process_problem_bounds(ocp, settings,
                           resolve=lambda v: v) -> ProcessedProblemBounds:
    b: EndpointBounds = ocp.bounds
    inf = settings.numerical_inf
    assume = settings.assume_inf_bounds
    abs_tol = settings.bound_clash_absolute_tolerance
    rel_tol = settings.bound_clash_relative_tolerance
    s_names = [str(v) for v in ocp.parameter_variables]
    nb = ocp.number_endpoint_constraints
    b_names = [f"endpoint{i}" for i in range(nb)]
    s_bnd = process_bounds_value(resolve(b.parameter_variables), len(s_names),
                                 s_names, inf, assume, "parameter bounds")
    s_bnd = _check_clashes(s_bnd, s_names, "parameter bounds", abs_tol,
                           rel_tol)
    b_bnd = process_bounds_value(resolve(b.endpoint_constraints), nb, b_names,
                                 inf, True, "endpoint constraint bounds")
    # Endpoint constraints with no bounds given default to equality == 0
    # (parity with the reference's endpoint-constraint handling where
    # unspecified constraints are pinned, ``pycollo/bounds.py:346-401``).
    if b.endpoint_constraints is None:
        b_bnd = np.zeros((nb, 2))
    b_bnd = _check_clashes(b_bnd, b_names, "endpoint constraint bounds",
                           abs_tol, rel_tol)
    return ProcessedProblemBounds(s_bnd=s_bnd, b_bnd=b_bnd)
