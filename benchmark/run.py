"""One run of one cell of the benchmark of pycollo_tpu_torch.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its files are
found by name: ``benchmark/workloads/<cell>.json`` (the route, the solver's
options and the traffic), ``benchmark/configs/<config>.json`` (the
problem's published constants, mesh and precision),
``benchmark/problems/<config>.py`` (the problem as the program builds it),
``benchmark/reference/<config>.py`` (the plain reference) and
``benchmark/metrics/<metric>.py`` (one reader per metric).

A run builds the problem and its solver, solves one warm-up call (all of
that is ``setup_s``), then calls in a closed loop: each call is one
``solve_batched`` call of the next batch of the cell's sequence, and the
next is sent when it returns.  The window is a whole number of passes of
the sequence, one call of each batch in order (``harness/traffic.py``): a
first pass always, and another while the time elapsed plus the mean pass
fits in ``--seconds``.  With ``--trace 1`` one more call, of the
sequence's first batch, runs under ``torch.profiler`` after the window.
Once the window has closed, every answer is judged against the plain
reference (``harness/judge.py``); ``attempted``, ``failed`` and the share
``uncertified`` count the window's answers alone, so every run counts the
same instances of each pass, and the traced call's answers are held to the
other limits.  The run prints each number compared beside its limit as the
last lines of standard error, and one JSON line as the last line of
standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``.

It exits with 1 and prints no result without a CUDA device, and with 3
when a module of JAX or of the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: fixed cache folders inside the checkout, so that only a cell's first run
#: in a checkout builds anything (the program's own kernel build goes to
#: ``pycollo_tpu_torch/_build/``, also inside the checkout)
CACHE = ROOT / ".bench_cache"
#: top-level modules a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "pycollo_tpu")
#: the harness's own profiler range around each traced call
CALL_RANGE = "bench.call"
#: the program's CPU threads through set-up and the window: the IPM is
#: host-bound on one thread, and idle worker threads only take cores from
#: it; the judge gets the machine's threads back
WINDOW_THREADS = 1

for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)

if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import numpy as np  # noqa: E402

from harness import traffic  # noqa: E402
from harness.collocation import Mesh  # noqa: E402
from harness.judge import Transcription  # noqa: E402


def load_module(path: Path):
    """Import a file of the benchmark by its path (its name may hold '-'
    and '.')."""
    name = "bench_" + "".join(ch if ch.isalnum() else "_"
                              for ch in str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    """A cell's entry of ``BENCHMARK.json`` and the files it names."""

    name: str
    chips: int
    workload: Dict
    config: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, bench_json: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = read_json(bench_json)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in {bench_json}")
    entry = entries[0]
    workload = read_json(BENCH / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise SystemExit(f"{name}: BENCHMARK.json names config "
                         f"{entry['config']!r}, the workload file "
                         f"{workload['config']!r}")
    config = read_json(BENCH / "configs" / f"{entry['config']}.json")

    def mine(metrics):
        return [m for m in metrics
                if "workloads" not in m or name in m["workloads"]]

    return Cell(name=name, chips=int(entry["chips"]), workload=workload,
                config=config, end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


# ---------------------------------------------------------------- program
@dataclass
class Call:
    """One call into the program and what it returned: per answer its
    ``x_full``, objective and converged flag, with the initial state the
    reference expects in it."""

    solve_time: float
    iter_max: int
    factor_calls: int
    x_full: np.ndarray
    objective: np.ndarray
    converged: np.ndarray
    initial: Dict[str, np.ndarray] = field(repr=False)


def _program_path():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch
    return torch


def build_problem(cell: Cell, mesh: Mesh, dtype: Optional[str] = None):
    """The cell's problem, as ``problems/<config>.py`` builds it, with the
    configuration's tolerance, precision and mesh."""
    cfg = cell.config
    problem = load_module(BENCH / "problems" / f"{cfg['name']}.py") \
        .build_problem(cfg["constants"])
    s = problem.settings
    s.console_out_progress = False
    s.nlp_tolerance = cfg["nlp_tolerance"]
    s.dtype = dtype or cfg["dtype"]
    s.quadrature_method = cfg["mesh"]["quadrature"]
    for phase in problem.phases:
        phase.mesh.number_mesh_sections = mesh.K
        phase.mesh.number_mesh_section_nodes = mesh.n
    return problem


class Program:
    """The system under test: the cell's problem built and initialised
    once by pycollo_tpu_torch, its first mesh's solver on ``device``, and
    each call one ``solve_batched`` call of a batch.

    ``dtype`` and ``ipm`` override the configuration's precision and the
    cell's solver options (the controls in ``readings.py`` use them)."""

    def __init__(self, cell: Cell, device: str, mesh: Mesh,
                 dtype: Optional[str] = None, ipm: Optional[Dict] = None):
        torch = _program_path()
        from pycollo_tpu_torch.solver.ipm import IPMOptions

        self.torch = torch
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the mixed path refuses TF32 (solver/ipm.py:_run)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        problem = build_problem(cell, mesh, dtype)
        problem.initialise()
        self.problem = problem
        self.it = problem.backend.mesh_iterations[0]
        self.it.build_solver(IPMOptions(**dict(cell.workload["ipm"],
                                               **(ipm or {}))))
        self.nv = self.it._solver.dims["nv"]
        self.states = [str(v) for v in problem.phases[0].state_variables]

    def theta(self, mix: Dict, draws: Dict[str, np.ndarray]):
        """The (B, n_full) parameter batch of the draws."""
        from pycollo_tpu_torch.parallel.batch import resolve_theta_index
        it = self.it
        idx = {p["state"]: resolve_theta_index(
            it, (0, "y", self.states.index(p["state"]), 0))
            for p in mix["perturb"]}
        nominal = {s: float(it.theta_default[i]) for s, i in idx.items()}
        values = traffic.initial_values(mix, draws, nominal)
        theta = np.tile(it.theta_default, (int(mix["B"]), 1))
        for s, i in idx.items():
            theta[:, i] = values[s]
        return theta

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def answer(self, mix: Dict, draws: Dict[str, np.ndarray],
               initial: Dict[str, np.ndarray]) -> Call:
        """One ``solve_batched`` call of the draws, ended by a device
        synchronise."""
        from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv
        from pycollo_tpu_torch.parallel import batch
        theta = self.theta(mix, draws)
        calls = blocked_chol_linv.calls
        res = batch.solve_batched(self.problem.backend, theta_batch=theta,
                                  devices=[self.device])
        self.sync()
        return Call(solve_time=float(res.solve_time),
                    iter_max=int(np.max(res.iterations)),
                    factor_calls=blocked_chol_linv.calls - calls,
                    x_full=np.asarray(res.x_full),
                    objective=np.asarray(res.objective),
                    converged=np.asarray(res.converged, dtype=bool),
                    initial=initial)


def torch_threads(n: int) -> int:
    """Set torch's CPU threads to ``n``; returns the number before."""
    torch = _program_path()
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    return before


def make_call(prog: Program, mix: Dict, k: int,
              reference_nominal: Dict[str, float]) -> Call:
    """One call of the traffic's batch ``k``; the reference's initial
    states of it ride along."""
    draws = traffic.batch(mix, k)
    return prog.answer(mix, draws, traffic.initial_values(
        mix, draws, reference_nominal))


# ---------------------------------------------------------------- judge
def judge(cell: Cell, mesh: Mesh, calls: List[Call], seed: int,
          ocp=None, counted: Optional[int] = None) -> Dict:
    """The comparison with the plain reference over every answer of
    ``calls``: the numbers compared, and which answers it rejects.  The
    first ``counted`` answers (all by default) are those attempted: they
    alone enter ``attempted``, ``failed`` and ``uncertified``."""
    if ocp is None:
        ocp = reference_problem(cell)
    tr = Transcription(ocp, mesh)
    inp = judge_inputs(ocp, tr, calls)
    conv = np.concatenate([c.converged for c in calls])
    idx = np.nonzero(conv)[0]
    feas = np.full(conv.size, np.nan)
    stat = np.full(conv.size, np.nan)
    if idx.size:
        feas[idx] = np.maximum(
            tr.feasibility(inp["x"][idx], inp["pins"][idx]),
            tr.objective_gap(inp["x"][idx], inp["reported"][idx]))
    lim = cell.workload["limits"]
    if idx.size and "stat" in lim:
        take = int(cell.workload["stat_sample"])
        sample = idx if idx.size <= take else np.sort(
            traffic.sample_rng(seed).choice(idx, take, replace=False))
        stat[sample] = tr.stationarity(inp["x"][sample])
    rejected = np.zeros(conv.size, dtype=bool)
    for name, vals in (("feas", feas), ("stat", stat)):
        if name in lim:
            rejected |= np.nan_to_num(vals, nan=0.0) > lim[name]
    failed = (~conv | rejected)[:conv.size if counted is None else counted]
    values = {"feas": float(np.nanmax(feas)) if idx.size else None,
              "stat": float(np.nanmax(stat))
              if np.isfinite(stat).any() else None,
              "uncertified": float(failed.mean())}
    # a cell compares the numbers its workload file gives a limit
    checks = {k: {"value": v, "limit": lim[k]}
              for k, v in values.items() if k in lim}
    correct = all(c["limit"] is not None
                  and (c["value"] is None or c["value"] <= c["limit"])
                  for c in checks.values())
    return dict(checks=checks, correct=correct, attempted=int(failed.size),
                failed=failed, stat_count=int(np.isfinite(stat).sum()))


def judge_inputs(ocp, tr: Transcription, calls: List[Call]) -> Dict:
    """The answers of ``calls`` stacked, with the values the reference
    pins in each: the instance's own initial state, from its draws and the
    reference's nominal values."""
    x = np.concatenate([c.x_full for c in calls])
    initial = np.full((x.shape[0], ocp.ny), np.nan)
    for i, s in enumerate(ocp.states):
        if ocp.initial.get(s) is not None:
            initial[:, i] = np.concatenate(
                [c.initial.get(s, np.full(len(c.converged), ocp.initial[s]))
                 for c in calls])
    return dict(x=x, pins=tr.pinned_values(initial),
                reported=np.concatenate([c.objective for c in calls]))


def reference_problem(cell: Cell):
    return load_module(BENCH / "reference" / f"{cell.config['name']}.py") \
        .problem(cell.config["constants"])


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------- run
def traced_call(prog: Program, mix: Dict, nominal) -> tuple:
    """One more call of the window's first batch under ``torch.profiler``,
    inside the harness's range :data:`CALL_RANGE`: the call and the
    trace's reduction (``harness/trace.py``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness.trace import events_of, reduce
    acts = [ProfilerActivity.CPU]
    if prog.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(CALL_RANGE):
            call = make_call(prog, mix, traffic.window_batch(mix, 0),
                             nominal)
    CACHE.mkdir(parents=True, exist_ok=True)
    summary = reduce(events_of(prof, CACHE / "trace.json"), CALL_RANGE)
    return call, summary


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", mesh: Optional[Mesh] = None,
             B: Optional[int] = None) -> Dict:
    """One run of ``cell``; ``mesh`` and ``B`` shrink it for the CPU
    rehearsals of the tests.  Returns the result line's fields and the
    lines of checks."""
    cfg = cell.config
    mesh = mesh or Mesh(int(cfg["mesh"]["sections"]),
                                int(cfg["mesh"]["nodes_per_section"]))
    mix = dict(cell.workload["mix"])
    if B is not None:
        mix["B"] = B
    traffic.check(mix)
    ocp = reference_problem(cell)
    nominal = {s: v for s, v in ocp.initial.items() if v is not None}

    judge_threads = torch_threads(WINDOW_THREADS)
    prog = Program(cell, device, mesh)
    torch = prog.torch
    make_call(prog, mix, traffic.warmup_batch(mix), nominal)

    setup_s = time.perf_counter() - T_START
    calls, window_s = traffic.window(
        mix, seconds, lambda k: make_call(prog, mix, k, nominal),
        time.perf_counter)

    summary, traced = None, []
    if trace:
        call, summary = traced_call(prog, mix, nominal)
        traced = [call]
    if prog.device.type == "cuda":
        memory_peak = int(torch.cuda.max_memory_allocated(prog.device))
        device_info = dict(platform="gpu",
                           kind=torch.cuda.get_device_name(prog.device),
                           count=cell.chips)
    else:
        import resource
        memory_peak = 1024 * resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss
        device_info = dict(platform="cpu", kind="cpu", count=1)
    device_info["memory_peak_bytes"] = memory_peak
    nv = prog.nv
    del prog
    if device == "cuda":
        torch.cuda.empty_cache()

    torch_threads(judge_threads)
    verdict = judge(cell, mesh, calls + traced, seed, ocp,
                    counted=sum(len(c.converged) for c in calls))
    ctx = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=calls, nv=nv,
        batch=int(mix["B"]),
        certified=int((~verdict["failed"]).sum()),
        trace=summary,
        traced_trips=traced[0].iter_max if traced else 0)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    out = dict(correct=verdict["correct"], attempted=verdict["attempted"],
               failed=int(verdict["failed"].sum()), metrics=metrics,
               device=device_info)
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = verdict["checks"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 1
    return emit(run_cell(cell, args.seed, args.seconds, bool(args.trace)))


def emit(out: Dict) -> int:
    """Print a run's result, unless a forbidden module was loaded: the
    checks as the last lines of standard error, the result as the last
    line of standard output."""
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that a run may not load: {bad}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
