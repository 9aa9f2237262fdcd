"""The nominal optimum of the benchmark's shuttle configuration.

Run from the root of a checkout, on the CPU (about a minute)::

    python3 scripts/shuttle_nominal_torch.py [--out PATH]

It builds ``benchmark/problems/shuttle-reentry-betts61-k32.py`` with the
configuration's constants, mesh and precision
(``benchmark/configs/shuttle-reentry-betts61-k32.json``) and the example's
straight-line guess, solves it with pycollo_tpu_torch on the CPU in
float64 at the nominal entry state, and writes the answer at the mesh's
nodes: ``time``, ``states`` (6, N), ``controls`` (2, N), ``objective``,
the mesh and the solve's ``iterations`` and ``kkt_error``.  The default
``--out`` is the nominal file the problem reads its guess from.
"""

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CONFIG = "shuttle-reentry-betts61-k32"
#: the f64 route, with room for the cold start from straight lines
OPTIONS = dict(max_iter=500)


def problem_module():
    path = ROOT / "benchmark" / "problems" / f"{CONFIG}.py"
    spec = importlib.util.spec_from_file_location("shuttle_problem", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def solve_nominal(cfg, sections=None, nodes=None, guess=None):
    """The nominal solve on the configuration's mesh (or ``sections`` x
    ``nodes``) from the example's straight lines (or from the nominal file
    ``guess``): the problem, its mesh iteration and the batch result."""
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    problem = problem_module().build_problem(cfg["constants"], nominal=guess)
    s = problem.settings
    s.console_out_progress = False
    s.nlp_tolerance = cfg["nlp_tolerance"]
    s.dtype = cfg["dtype"]
    s.quadrature_method = cfg["mesh"]["quadrature"]
    phase = problem.phases[0]
    phase.mesh.number_mesh_sections = sections or cfg["mesh"]["sections"]
    phase.mesh.number_mesh_section_nodes = \
        nodes or cfg["mesh"]["nodes_per_section"]
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    it.build_solver(IPMOptions(tol=cfg["nlp_tolerance"], **OPTIONS))
    res = solve_batched(problem.backend,
                        theta_batch=np.asarray(it.theta_default)[None],
                        devices=[torch.device("cpu")])
    return problem, it, res


def nominal_record(it, res, sections, nodes):
    """The answer at the mesh's nodes, as the nominal file holds it."""
    pl = it.layout.phases[0]
    x = np.asarray(res.x_full)[0]
    N = pl.N
    y = x[pl.y_off:pl.y_off + 6 * N].reshape(6, N)
    u = x[pl.u_off:pl.u_off + 2 * N].reshape(2, N)
    t0, tF = x[pl.t_off], x[pl.t_off + 1]
    tau = np.asarray(it.tables[0].tau, dtype=np.float64)
    return dict(
        mesh={"quadrature": "lobatto", "sections": sections,
              "nodes_per_section": nodes},
        objective=float(np.asarray(res.objective)[0]),
        iterations=int(np.asarray(res.iterations)[0]),
        converged=bool(np.asarray(res.converged)[0]),
        kkt_error=float(np.asarray(res.kkt_error)[0]),
        time=(t0 + 0.5 * (tau + 1.0) * (tF - t0)).tolist(),
        states=y.tolist(), controls=u.tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=problem_module().NOMINAL)
    args = ap.parse_args(argv)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{CONFIG}.json").read_text())
    K, n = cfg["mesh"]["sections"], cfg["mesh"]["nodes_per_section"]
    _, it, res = solve_nominal(cfg, K, n)
    rec = nominal_record(it, res, K, n)
    if not rec["converged"]:
        print(json.dumps({k: rec[k] for k in ("objective", "iterations",
                                              "kkt_error")}),
              file=sys.stderr)
        raise SystemExit("the nominal solve did not converge")
    args.out.write_text(json.dumps(rec) + "\n")
    print(json.dumps({k: rec[k] for k in ("mesh", "objective", "iterations",
                                          "kkt_error")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
