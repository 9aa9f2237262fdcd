"""``bench_torch.py`` prints ``bench.py``'s JSON line.

The port's bench runs as a subprocess on the CPU (``--device cpu``) at
B = 2; its one JSON line must carry the keys that ``bench.py`` prints (read
from ``bench.py``'s source), name the linear solver it ran, and converge
every instance.  The block-banded case is ``slow``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _bench_py_keys():
    """The keys of ``bench.py``'s JSON line: top level and ``detail``."""
    src = (ROOT / "bench.py").read_text()
    block = src[src.index("print(json.dumps({"):]
    top, _, detail = block.partition('"detail": {')
    detail = detail.partition("}")[0]
    keys = re.findall(r'"(\w+)":', top)
    return set(keys) | {"detail"}, set(re.findall(r'"(\w+)":', detail))


@pytest.mark.parametrize("linear_solver", [
    "condensed-cholesky",
    pytest.param("block-banded", marks=pytest.mark.slow)])
def test_bench_torch_prints_the_bench_schema(linear_solver):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "2", linear_solver,
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    line = json.loads(lines[0])
    top, detail = _bench_py_keys()
    assert {"metric", "value", "vs_baseline", "linear_solver"} <= top | detail
    assert set(line) == top
    assert set(line["detail"]) == detail
    assert line["unit"] == "solves/sec" and line["value"] > 0
    assert line["detail"]["linear_solver"] == linear_solver
    assert line["detail"]["device"] == "cpu"
    assert line["detail"]["chunk_size"] == 2
    assert line["detail"]["n_chunks"] == 4
    assert line["detail"]["converged_fraction"] == 1.0
