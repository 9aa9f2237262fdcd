"""Mesh histories of the port against the JAX package's stored ones.

``tests/data/oracles_jax.json`` (written by
``scripts/oracles_reference_jax.py``) holds, per problem, the JAX package's
mesh history on the CPU.  A solved problem of the port matches an entry when
every mesh iteration has the stored nodes per section, ``n_free``,
``m_total`` and convergence flag; a converged mesh the stored objective to
``OBJECTIVE_RTOL`` relative; a mesh where the JAX package did not converge
the stored objective to ``UNCONVERGED_RTOL``, the same IPM iterations and a
finite KKT error; and the whole solve the stored final objective and mesh
verdict.  Imports numpy only, so that ``chip_smoke.py`` uses it on a
machine without JAX.
"""

import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data" / "oracles_jax.json"
#: converged objectives against the JAX package, relative
OBJECTIVE_RTOL = 1e-8
#: where the JAX package's mesh did not converge
UNCONVERGED_RTOL = 1e-6


def load():
    return json.loads(DATA.read_text())


def mesh_history(problem):
    """The mesh history of a solved problem, in the stored file's form."""
    return [{
        "section_nodes": [[int(n) for n in t.section_nodes]
                          for t in r.iteration.tables],
        "n_free": int(r.iteration.n_free),
        "m_total": int(r.iteration.layout.m_total),
        "converged": bool(r.converged),
        "objective": float(r.objective),
        "iterations": int(r.ipm_result.iterations),
        "kkt_error": float(r.ipm_result.kkt_error),
    } for r in problem.mesh_iterations]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def mismatches(problem, solution, ref):
    """How a solved problem differs from a stored entry ([] when it
    matches)."""
    got = mesh_history(problem)
    want = ref["meshes"]
    if len(got) != len(want):
        return [f"{len(got)} mesh iterations, the JAX package {len(want)}: "
                f"{[g['section_nodes'] for g in got]} against "
                f"{[w['section_nodes'] for w in want]}"]
    out = []
    for i, (g, w) in enumerate(zip(got, want), start=1):
        for key in ("section_nodes", "n_free", "m_total", "converged"):
            if g[key] != w[key]:
                out.append(f"mesh {i}: {key} {g[key]} against {w[key]}")
        if w["converged"]:
            if _rel(g["objective"], w["objective"]) > OBJECTIVE_RTOL:
                out.append(f"mesh {i}: objective {g['objective']!r} against "
                           f"{w['objective']!r}")
        else:
            if _rel(g["objective"], w["objective"]) > UNCONVERGED_RTOL:
                out.append(f"mesh {i} (unconverged): objective "
                           f"{g['objective']!r} against {w['objective']!r}")
            if g["iterations"] != w["iterations"]:
                out.append(f"mesh {i} (unconverged): {g['iterations']} IPM "
                           f"iterations against {w['iterations']}")
            if not np.isfinite(g["kkt_error"]):
                out.append(f"mesh {i}: KKT error {g['kkt_error']}")
    rtol = OBJECTIVE_RTOL if want[-1]["converged"] else UNCONVERGED_RTOL
    if _rel(float(solution.objective), ref["objective"]) > rtol:
        out.append(f"final objective {solution.objective!r} against "
                   f"{ref['objective']!r}")
    if bool(problem.mesh_tolerance_met) != ref["mesh_tolerance_met"]:
        out.append(f"mesh tolerance met {problem.mesh_tolerance_met}, the "
                   f"JAX package {ref['mesh_tolerance_met']}")
    return out
