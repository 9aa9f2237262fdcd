"""Symbolic (sympy) frontend: lambdify user expressions into PyTorch callables.

This replaces the reference's CasADi backend preprocessing
(``pycollo/backend.py:303-617``): auxiliary data is partitioned and
fixed-point substituted into the user equations until only root symbols
remain (depth cap 100, ``pycollo/backend.py:557-609``), and the resulting
expressions are lambdified with sympy's PyTorch printer into functions
``f(y, u, t, s) -> tensor`` consumed by the transcription.  There is no
symbolic differentiation here — derivatives come from ``torch.func``
(``grad`` / ``jacfwd`` / ``hessian``) downstream.

The lambdified code is elementwise, so every callable is component-first
and broadcasts over instance axes: ``y`` is ``(ny, *batch)``, ``t`` is
``(*batch)``, and the result is ``(n_out, *batch)``, with ``*batch`` empty
for one mesh node.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence

import numpy as np
import sympy
import torch

from .structures import Endpoints

_MAX_SUBSTITUTION_DEPTH = 100


def _sympify_aux(aux: Dict) -> Dict:
    out = {}
    for key, value in aux.items():
        out[sympy.sympify(key)] = sympy.sympify(value)
    return out


def resolve_aux(expr, aux_map: Dict, what: str = "expression"):
    """Fixed-point substitute aux definitions into ``expr``.

    Parity with ``pycollo/backend.py:557-609`` (depth cap 100).
    """
    expr = sympy.sympify(expr)
    for _ in range(_MAX_SUBSTITUTION_DEPTH):
        new = expr.xreplace(aux_map)
        if new == expr:
            return new
        expr = new
    raise RecursionError(
        f"Auxiliary data substitution for {what} did not reach a fixed "
        f"point within {_MAX_SUBSTITUTION_DEPTH} iterations; check for "
        f"cyclic auxiliary data definitions.")


def _check_free_symbols(expr, allowed, what: str):
    extra = expr.free_symbols - set(allowed)
    if extra:
        raise ValueError(
            f"{what} contains symbols {sorted(map(str, extra))} that are "
            f"not state/control/parameter/endpoint variables and are not "
            f"defined in auxiliary data.")


def _sqrt(x):
    """``torch.sqrt`` whose derivatives at exactly 0 are 0, not inf.

    A norm ``sqrt(v . v)`` at ``v = 0`` otherwise has the derivative
    ``inf * 0 = NaN``, and so does every product with it, such as a drag
    term ``|v| v`` whose true derivative there is 0.  Delta III's guess puts
    the relative velocity ``v - omega x r`` at exactly 0 in torch's
    arithmetic (the JAX package's XLA contracts it into a fused
    multiply-add that leaves -2.28e-14, with a finite Jacobian).  Off 0 the
    value and every derivative are ``torch.sqrt``'s, bit for bit; the inner
    ``where`` keeps the unused branch finite under differentiation."""
    zero = x == 0
    return torch.where(zero, torch.zeros_like(x),
                       torch.sqrt(torch.where(zero, torch.ones_like(x), x)))


#: the namespace of the lambdified code: torch, with ``sqrt`` as ``_sqrt``
_MODULES = [{"sqrt": _sqrt}, "torch"]


def _lambdify_vector(exprs: Sequence, args: Sequence,
                     label: str) -> Callable:
    """Lambdify a tuple of scalar expressions into an array-valued fn."""
    exprs = [sympy.sympify(e) for e in exprs]
    fn = sympy.lambdify(tuple(args), exprs, modules=_MODULES, cse=True)
    return fn


def _stack_outputs(vals, args):
    """Stack lambdified outputs (tensors or numeric constants) into one
    ``(len(vals), *batch)`` tensor.

    The dtype is promoted over all the arguments and the device is theirs;
    constants broadcast to the arguments' common shape, filled on the
    device (a host-to-device copy would wait on the device, which a CUDA
    graph's capture refuses)."""
    dt = functools.reduce(torch.promote_types, [a.dtype for a in args])
    dev = args[0].device
    shape = torch.broadcast_shapes(*(a.shape for a in args))
    if not vals:
        return torch.zeros((0,) + tuple(shape), dtype=dt, device=dev)
    return torch.stack([v.to(dtype=dt, device=dev).expand(shape)
                        if torch.is_tensor(v)
                        else torch.full(shape, v, dtype=dt, device=dev)
                        for v in vals])


class SymbolicPhaseFunctions:
    """PyTorch callables for one phase, lambdified from sympy expressions."""

    def __init__(self, phase, ocp):
        self.phase = phase
        y_syms = list(phase.state_variables)
        u_syms = list(phase.control_variables)
        s_syms = list(ocp.parameter_variables)
        aux = _sympify_aux({**ocp.auxiliary_data, **phase.auxiliary_data})
        self.aux_map = aux
        # Continuous-time symbol: ``t`` (also what
        # ``sympy.physics.mechanics.dynamicsymbols._t`` resolves to) may
        # appear in dynamics/path/integrand expressions and is bound to
        # the node times.  The reference has no continuous-time symbol at
        # all; supporting it here closes a silent-wrong-answer hole
        # (time-dependent sympy dynamics previously dropped ``t``).  A
        # state/control/parameter literally named ``t`` wins the clash.
        t_sym = sympy.Symbol("t")
        var_syms = set(y_syms) | set(u_syms) | set(s_syms)
        self._t_sym = None if t_sym in var_syms or t_sym in aux else t_sym
        allowed = var_syms | ({self._t_sym} if self._t_sym else set())

        def prepare(exprs, what):
            resolved = []
            for e in exprs:
                r = resolve_aux(e, aux, what)
                _check_free_symbols(r, allowed, what)
                resolved.append(r)
            return resolved

        self.y_eqn = prepare(list(phase.state_equations),
                             f"state equations of phase {phase.name!r}")
        self.p_con = prepare(list(phase.path_constraints),
                             f"path constraints of phase {phase.name!r}")
        self.q_fnc = prepare(list(phase.integrand_functions),
                             f"integrand functions of phase {phase.name!r}")

        args = tuple(y_syms) + tuple(u_syms) + tuple(s_syms) \
            + ((self._t_sym,) if self._t_sym else ())
        self._ny, self._nu, self._ns = len(y_syms), len(u_syms), len(s_syms)
        self._dyn = _lambdify_vector(self.y_eqn, args, "dynamics")
        self._path = _lambdify_vector(self.p_con, args, "path") \
            if self.p_con else None
        self._integrand = _lambdify_vector(self.q_fnc, args, "integrand") \
            if self.q_fnc else None

    def _call(self, fn, y, u, t, s):
        args = [y[i] for i in range(self._ny)] \
            + [u[i] for i in range(self._nu)] \
            + [s[i] for i in range(self._ns)] \
            + ([t] if self._t_sym else [])
        # Dtype and shape follow all the inputs (f32 evaluation mode casts
        # y/u/t/s down); numeric constants from lambdify are cast to it.
        return _stack_outputs(fn(*args), args + [t])

    def dynamics(self, y, u, t, s):
        return self._call(self._dyn, y, u, t, s)

    def path(self, y, u, t, s):
        if self._path is None:
            return _stack_outputs([], [y, t])
        return self._call(self._path, y, u, t, s)

    def integrand(self, y, u, t, s):
        if self._integrand is None:
            return _stack_outputs([], [y, t])
        return self._call(self._integrand, y, u, t, s)


class SymbolicProgram:
    """All PyTorch callables + numeric resolvers for a symbolic-frontend OCP."""

    def __init__(self, ocp):
        self.ocp = ocp
        self.phase_functions = [SymbolicPhaseFunctions(p, ocp)
                                for p in ocp.phases]
        self.aux_map = _sympify_aux(ocp.auxiliary_data)

        # Endpoint symbol ordering: per phase (y_t0, y_tF, q, t0, tF), then s
        # (matches the reference's x_b layout, ``pycollo/backend.py:632-704``).
        ep_syms = []
        for p in ocp.phases:
            ep_syms.extend(list(p.initial_state_variables))
            ep_syms.extend(list(p.final_state_variables))
            ep_syms.extend(list(p.integral_variables))
            ep_syms.append(p.initial_time_variable)
            ep_syms.append(p.final_time_variable)
        ep_syms.extend(list(ocp.parameter_variables))
        self.endpoint_symbols = ep_syms

        allowed = set(ep_syms)
        J = resolve_aux(ocp.objective_function, self.aux_map,
                        "objective function")
        _check_free_symbols(J, allowed, "The objective function")
        self._J_expr = J
        b_exprs = []
        for i, b in enumerate(ocp.endpoint_constraints):
            r = resolve_aux(b, self.aux_map, f"endpoint constraint {i}")
            _check_free_symbols(r, allowed, f"Endpoint constraint {i}")
            b_exprs.append(r)
        self._b_exprs = b_exprs

        self._J_fn = sympy.lambdify(tuple(ep_syms), J, modules=_MODULES,
                                    cse=True)
        self._b_fn = _lambdify_vector(b_exprs, ep_syms, "endpoint") \
            if b_exprs else None

    def _endpoint_args(self, ep: Endpoints):
        args = []
        for p_ep in ep.phase:
            args.extend([p_ep.y0[i] for i in range(p_ep.y0.shape[0])])
            args.extend([p_ep.yF[i] for i in range(p_ep.yF.shape[0])])
            args.extend([p_ep.q[i] for i in range(p_ep.q.shape[0])])
            args.append(p_ep.t0)
            args.append(p_ep.tF)
        args.extend([ep.s[i] for i in range(ep.s.shape[0])])
        return args

    def objective(self, ep: Endpoints):
        """Objective, ``(*batch)``."""
        args = self._endpoint_args(ep)
        return _stack_outputs([self._J_fn(*args)], args)[0]

    def endpoint_constraints(self, ep: Endpoints):
        """Endpoint constraints, ``(nb, *batch)``."""
        args = self._endpoint_args(ep)
        vals = self._b_fn(*args) if self._b_fn is not None else []
        return _stack_outputs(vals, args)

    # -- numeric resolution of bounds / guess entries -------------------
    def resolve_numeric(self, value, aux_map=None):
        """Map possibly-symbolic bounds/guess entries to plain numbers."""
        if aux_map is None:
            aux_map = self.aux_map
        if value is None:
            return None
        if isinstance(value, dict):
            return {k: self.resolve_numeric(v, aux_map)
                    for k, v in value.items()}
        if isinstance(value, sympy.Basic):
            resolved = resolve_aux(value, aux_map, "bound value")
            if resolved.free_symbols:
                raise ValueError(
                    f"Bound/guess value {value} does not resolve to a "
                    f"number; unresolved symbols "
                    f"{sorted(map(str, resolved.free_symbols))}.")
            return float(resolved)
        if isinstance(value, (list, tuple)):
            return type(value)(self.resolve_numeric(v, aux_map)
                               for v in value)
        if isinstance(value, np.ndarray) and value.dtype == object:
            return np.array([[self.resolve_numeric(v, aux_map) for v in row]
                             for row in np.atleast_2d(value)])
        return value

    def phase_resolver(self, phase_index: int):
        """Resolver using the merged problem+phase auxiliary data."""
        aux_map = self.phase_functions[phase_index].aux_map
        return lambda value: self.resolve_numeric(value, aux_map)
