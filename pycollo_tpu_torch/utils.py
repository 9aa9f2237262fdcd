"""Small shared utilities: options registries, formatting helpers, and the
per-device cache of numpy constants.

``Options`` reproduces the capability of the reference's
options-registry-with-unsupported-markers pattern (pyproprop ``Options`` used
at ``pycollo/backend.py:1925``, ``pycollo/quadrature.py:34`` etc.) without the
pyproprop dependency: a tuple of valid keyword options, a default, and a set
of enumerated-but-unsupported options that raise on use.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

import numpy as np
import torch


class Options:
    """Registry of keyword options with a default and unsupported markers."""

    def __init__(self, options: Iterable[str], default: Optional[str] = None,
                 unsupported: Iterable[str] = ()):
        self.options = tuple(options)
        if isinstance(unsupported, str):
            unsupported = (unsupported,)
        self.unsupported = tuple(unsupported)
        for unsup in self.unsupported:
            if unsup not in self.options:
                raise ValueError(f"Unsupported option {unsup!r} is not one of "
                                 f"the enumerated options {self.options}.")
        if default is None:
            default = self.options[0]
        if default not in self.options:
            raise ValueError(f"Default {default!r} not in {self.options}.")
        if default in self.unsupported:
            raise ValueError(f"Default {default!r} is marked unsupported.")
        self.default = default

    def validate(self, value: str) -> str:
        if isinstance(value, str):
            value = value.casefold().strip()
        if value not in self.options:
            raise ValueError(f"{value!r} is not a valid option. Choose one of "
                             f"{self.options}.")
        if value in self.unsupported:
            supported = tuple(o for o in self.options
                              if o not in self.unsupported)
            raise ValueError(f"{value!r} is not currently supported. "
                             f"Choose one of {supported}.")
        return value


def format_case(item: str, case: str = "title") -> str:
    """Format an identifier-ish string for display."""
    words = str(item).replace("_", " ").split()
    if case == "title":
        return " ".join(w.capitalize() for w in words)
    return " ".join(words)


def format_time(seconds: float) -> str:
    """Human-readable duration (capability of ``pycollo/utils.py:format_time``)."""
    if seconds < 1e-3:
        return f"{seconds * 1e6:.2f} us"
    if seconds < 1.0:
        return f"{seconds * 1e3:.2f} ms"
    if seconds < 60.0:
        return f"{seconds:.2f} s"
    minutes, rem = divmod(seconds, 60.0)
    return f"{int(minutes)} min {rem:.1f} s"


def solve_device(device) -> torch.device:
    """The torch device an entry point solves on (default ``"cuda"``).

    Raises when a CUDA device is asked for and none is available: the
    package runs on the card unless the caller names the CPU, and never
    falls back to it silently.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (devices="
            "[torch.device('cpu')] for a batched solve) to solve on the CPU.")
    return device


#: torch keeps its forward-mode AD levels in one stack for the whole process,
#: not one per thread, so two threads inside forward-mode transforms
#: (``jacfwd``, ``hessian``, ``jvp``) at once break each other's levels
#: (the blocks of distinct devices in a batch solve run in threads); every
#: forward-mode transform of the package runs under this lock, re-entrant
#: because transforms nest
FORWARD_AD_LOCK = threading.RLock()


def console_out(message: str, heading: bool = False) -> None:
    """Print a progress message, optionally underlined as a heading."""
    if heading:
        bar = "=" * len(message)
        print(f"\n{message}\n{bar}\n")
    else:
        print(message)


class DeviceConstants:
    """Named numpy constants, materialised as tensors once per device/dtype.

    The transcription and the solver hold their static tables (mesh
    operators, scales, bounds, index arrays) as numpy arrays and evaluate on
    whatever device and dtype their inputs have; ``consts(name, like)``
    returns the table on ``like``'s device, floating tables in ``like``'s
    dtype (or ``dtype``), integer tables as int64 and boolean ones as bool,
    copying each combination to the device only once.
    """

    def __init__(self, **arrays):
        self._arrays: Dict[str, np.ndarray] = {}
        self._cache: Dict[tuple, torch.Tensor] = {}
        self.add(**arrays)

    def add(self, **arrays) -> None:
        for name, arr in arrays.items():
            self._arrays[name] = np.asarray(arr)

    def __call__(self, name: str, like: torch.Tensor,
                 dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        arr = self._arrays[name]
        if dtype is None:
            if arr.dtype == np.bool_:
                dtype = torch.bool
            elif arr.dtype.kind in "iu":
                dtype = torch.int64
            else:
                dtype = like.dtype
        key = (name, like.device, dtype)
        out = self._cache.get(key)
        if out is None:
            out = torch.as_tensor(arr).to(device=like.device, dtype=dtype)
            self._cache[key] = out
        return out
