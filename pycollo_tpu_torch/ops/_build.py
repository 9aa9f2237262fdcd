"""Build and load the package's CUDA kernels at first use.

Each kernel source under ``pycollo_tpu_torch/csrc/`` exposes a plain C
entry point.  :func:`load` compiles one source with ``nvcc`` into a shared
library under ``pycollo_tpu_torch/_build/`` (named by a hash of the source
and the flags, so an edited source rebuilds) and loads it with ``ctypes``.
Nothing is compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: ``--use_fast_math`` is deliberately absent: the kernels' NaN-on-failure
#: contracts and f32 accuracy rely on IEEE sqrt and division.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin); "
                       "the CUDA toolkit is needed to build the kernels.")


def _compile(src: Path, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: concurrent builders never see a partial


def load(source: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<source>``."""
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        src = CSRC_DIR / source
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        out = BUILD_DIR / f"{src.stem}-{digest[:16]}.so"
        if not out.exists():
            _compile(src, out)
        lib = ctypes.CDLL(str(out))
        _libs[source] = lib
        return lib
