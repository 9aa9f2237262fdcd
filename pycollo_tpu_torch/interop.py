"""Carry the numeric state of a solve across from the JAX package.

There are no model weights in this system: what defines and drives a solve
is the numeric state of a mesh iteration (its mesh tables, scaling, guess
and default parameters) and the interior-point solver's state.  These
functions take that state as a dict of numpy arrays — exported from
:mod:`pycollo_tpu` with ``numpy.asarray`` — and return the port's tensors,
so the two packages can be compared step by step on the same inputs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .solver.ipm import _State

#: per-phase mesh tables (lists, one array per phase)
MESH_TABLES = ("tau", "E", "I", "W")
#: per-iteration vectors
ITERATION_VECTORS = ("V_full", "r_full", "W_c", "xs_guess", "theta_default")

_STATE_INT = ("it", "fcnt", "ls_fail", "r_stall", "r_ent")
_STATE_BOOL = ("done", "rmode")


def _tensor(a, dtype, device):
    return torch.as_tensor(np.asarray(a)).to(dtype=dtype, device=device)


def iteration_arrays_from_numpy(arrays: Mapping, device="cpu",
                                dtype: torch.dtype = torch.float64) -> Dict:
    """Mesh-iteration arrays as tensors.

    ``arrays`` holds ``tau``, ``E``, ``I``, ``W`` (each a sequence with one
    array per phase), ``V_full``, ``r_full``, ``W_c``, ``xs_guess``,
    ``theta_default`` and the objective scale ``w``.  Returns the same keys
    with tensors of ``dtype`` on ``device`` (``w`` stays a float).
    """
    out = {}
    for key in MESH_TABLES:
        phases: Sequence = arrays[key]
        out[key] = [_tensor(a, dtype, device) for a in phases]
    for key in ITERATION_VECTORS:
        out[key] = _tensor(arrays[key], dtype, device)
    out["w"] = float(arrays["w"])
    return out


def ipm_state_from_numpy(arrays: Mapping, device="cpu",
                         dtype: torch.dtype = torch.float64) -> _State:
    """Interior-point solver state as the port's ``_State``.

    ``arrays`` maps every ``_State`` field name to an array with the
    leading instance axis (e.g. the fields of the JAX package's
    ``jax.vmap(solver._init_state)`` output).  Counters become int32,
    flags bool, and everything else ``dtype``.
    """
    fields = {}
    for name in _State._fields:
        if name in _STATE_INT:
            dt = torch.int32
        elif name in _STATE_BOOL:
            dt = torch.bool
        else:
            dt = dtype
        fields[name] = _tensor(arrays[name], dt, device)
    return _State(**fields)
