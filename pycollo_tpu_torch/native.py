"""ctypes bindings for the native C++ numerics library.

Loads ``native/libpycollo_tpu_native.so`` (building it with the repo's
Makefile on first use if a compiler is available) and exposes the
high-precision quadrature root finders and the barycentric interpolation
matrix builder.  Every entry point has a numpy fallback so the package
works without a C++ toolchain; :mod:`pycollo_tpu_torch.quadrature` prefers the
native implementations when present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libpycollo_tpu_native.so"

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _try_build() -> bool:
    if not (_NATIVE_DIR / "quadlib.cpp").exists():
        return False
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not _LIB_PATH.exists() and not _try_build():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.lgl_nodes_weights.argtypes = [ctypes.c_int, dptr, dptr]
    lib.lgl_nodes_weights.restype = ctypes.c_int
    lib.lgr_nodes_weights.argtypes = [ctypes.c_int, dptr, dptr]
    lib.lgr_nodes_weights.restype = ctypes.c_int
    lib.barycentric_interp_matrix.argtypes = [dptr, ctypes.c_int, dptr,
                                              ctypes.c_int, dptr]
    lib.barycentric_interp_matrix.restype = ctypes.c_int
    _lib = lib
    return _lib


def _as_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lgl_nodes_weights(n: int):
    """LGL points/weights via long-double Newton iteration, or None."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.empty(n)
    weights = np.empty(n)
    if lib.lgl_nodes_weights(n, _as_ptr(points), _as_ptr(weights)) != 0:
        return None
    return points, weights


def lgr_nodes_weights(m: int):
    """Left-Radau collocation points/weights (m of them), or None."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.empty(m)
    weights = np.empty(m)
    if lib.lgr_nodes_weights(m, _as_ptr(points), _as_ptr(weights)) != 0:
        return None
    return points, weights


def barycentric_interp_matrix(xc: np.ndarray, xq: np.ndarray):
    """Interpolation matrix via native barycentric evaluation, or None."""
    lib = get_lib()
    if lib is None or len(xc) > 64:
        return None
    xc = np.ascontiguousarray(xc, dtype=float)
    xq = np.ascontiguousarray(xq, dtype=float)
    L = np.empty((len(xq), len(xc)))
    rc = lib.barycentric_interp_matrix(_as_ptr(xc), len(xc), _as_ptr(xq),
                                       len(xq), _as_ptr(L))
    return L if rc == 0 else None
