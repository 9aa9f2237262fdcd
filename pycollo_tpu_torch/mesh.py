"""Temporal meshes: user-facing per-phase specs and static transcription tables.

``PhaseMesh`` mirrors the reference's user-facing mesh spec
(``pycollo/mesh.py:10-107``): number of mesh sections (default 10), normalized
section sizes, and nodes per section (default = collocation_points_min).

``PhaseMeshTables`` replaces the reference's per-iteration sparse-matrix mesh
(``pycollo/mesh.py:204-356``) with *dense* defect/integration operator
matrices: the (num_defect, N) operators are applied as plain batched
matmuls over problem instances.  The block-banded sparsity is recovered later by the structured
KKT factorization, not by sparse matrix formats.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

import numpy as np

from . import quadrature as quad

TAU_0 = -1.0
TAU_F = 1.0
PERIOD = TAU_F - TAU_0

DEFAULT_NUMBER_MESH_SECTIONS = 10


class PhaseMesh:
    """User-facing mesh specification for one phase.

    Parameters mirror the reference (``pycollo/mesh.py:15-47``):
    ``number_mesh_sections`` (default 10), ``mesh_section_sizes``
    (normalized to sum to 1), ``number_mesh_section_nodes`` (scalar or
    per-section; defaults to the settings' ``collocation_points_min``).
    """

    def __init__(self, phase=None, *,
                 number_mesh_sections: Optional[int] = None,
                 mesh_section_sizes: Optional[Iterable[float]] = None,
                 number_mesh_section_nodes=None):
        self.phase = phase
        self._mesh_sec_sizes = None
        self._num_mesh_sec_nodes = None
        if number_mesh_sections is None:
            number_mesh_sections = DEFAULT_NUMBER_MESH_SECTIONS
        self.number_mesh_sections = number_mesh_sections
        self.mesh_section_sizes = mesh_section_sizes
        if number_mesh_section_nodes is not None:
            self.number_mesh_section_nodes = number_mesh_section_nodes

    @property
    def number_mesh_sections(self) -> int:
        return self._num_mesh_secs

    @number_mesh_sections.setter
    def number_mesh_sections(self, num):
        self._num_mesh_secs = int(num)
        if (self._mesh_sec_sizes is not None
                and len(self._mesh_sec_sizes) != self._num_mesh_secs):
            self.mesh_section_sizes = None
        if (self._num_mesh_sec_nodes is not None
                and len(self._num_mesh_sec_nodes) != self._num_mesh_secs):
            uniq = set(int(v) for v in self._num_mesh_sec_nodes)
            if len(uniq) == 1:
                self.number_mesh_section_nodes = uniq.pop()
            else:
                raise ValueError("Mismatch between mesh section sizes and "
                                 "mesh section nodes.")

    @property
    def mesh_section_sizes(self) -> np.ndarray:
        if self._mesh_sec_sizes is None:
            return np.ones(self._num_mesh_secs) / self._num_mesh_secs
        return self._mesh_sec_sizes

    @mesh_section_sizes.setter
    def mesh_section_sizes(self, sizes):
        if sizes is None:
            self._mesh_sec_sizes = None
            return
        sizes = np.asarray(sizes, dtype=float)
        if len(sizes) != self._num_mesh_secs:
            raise ValueError(
                f"Mesh section sizes must be an iterable of length "
                f"{self._num_mesh_secs} (matching the number of sections).")
        self._mesh_sec_sizes = sizes / sizes.sum()

    @property
    def number_mesh_section_nodes(self) -> np.ndarray:
        if self._num_mesh_sec_nodes is None:
            default = quad.DEFAULT_COLLOCATION_POINTS_MIN
            if self.phase is not None:
                ocp = getattr(self.phase, "optimal_control_problem", None)
                if ocp is not None:
                    default = ocp.settings.collocation_points_min
            return np.full(self._num_mesh_secs, default, dtype=int)
        return self._num_mesh_sec_nodes

    @number_mesh_section_nodes.setter
    def number_mesh_section_nodes(self, num_nodes):
        try:
            num_nodes = int(num_nodes)
        except TypeError:
            num_nodes = np.array([int(v) for v in num_nodes], dtype=int)
        else:
            num_nodes = np.full(self._num_mesh_secs, num_nodes, dtype=int)
        if len(num_nodes) != self._num_mesh_secs:
            raise ValueError(
                f"Number of mesh section nodes must be an iterable of length "
                f"{self._num_mesh_secs} (matching the number of sections).")
        self._num_mesh_sec_nodes = num_nodes

    def __repr__(self):
        return (f"PhaseMesh(number_mesh_sections={self._num_mesh_secs}, "
                f"mesh_section_sizes={self.mesh_section_sizes}, "
                f"number_mesh_section_nodes={self.number_mesh_section_nodes})")


@dataclass(frozen=True)
class PhaseMeshTables:
    """Static transcription operators for one phase on tau in [-1, 1].

    Built once per mesh iteration from numpy; consumed as constants by the
    jitted residual evaluators.  Replaces the reference's
    ``sA_matrix``/``sI_matrix``/``W_matrix`` scipy-sparse trio
    (``pycollo/mesh.py:280-340``) with dense operators:

    - ``defect = E @ y + stretch * (I @ f)`` per state column, where
      ``E`` holds the [+1 at section start, -1 at node] difference pattern
      and ``I`` the section-scaled integration blocks;
    - ``integral = q - stretch * (W @ g)`` with the phase-global quadrature
      weight vector ``W``.
    """

    method: str
    K: int                                # number of sections
    N: int                                # number of mesh nodes
    num_defect: int                       # sum over sections of (n_k - 1)
    tau: np.ndarray = field(repr=False)   # (N,)
    h_sections: np.ndarray = field(repr=False)      # (K,) section widths
    section_nodes: np.ndarray = field(repr=False)   # (K,) nodes per section
    section_starts: np.ndarray = field(repr=False)  # (K,) start node index
    E: np.ndarray = field(repr=False)     # (num_defect, N)
    I: np.ndarray = field(repr=False)     # (num_defect, N)
    W: np.ndarray = field(repr=False)     # (N,)
    #: boolean (N,) mask of collocation nodes (False only for Radau section
    #: right-endpoints, which coincide with the next section's start).
    collocation_mask: np.ndarray = field(repr=False)


def build_phase_tables(method: str,
                       section_sizes: Sequence[float],
                       section_nodes: Sequence[int]) -> PhaseMeshTables:
    """Assemble static transcription tables for one phase.

    Structure parity with ``pycollo/mesh.py:236-356``: sections share
    boundary nodes, defects count ``sum(n_k - 1)``, and the quadrature
    weight vector accumulates per-section contributions at shared nodes.
    """
    section_sizes = np.asarray(section_sizes, dtype=float)
    section_sizes = section_sizes / section_sizes.sum()
    section_nodes = np.asarray(section_nodes, dtype=int)
    if len(section_sizes) != len(section_nodes):
        raise ValueError("section_sizes and section_nodes length mismatch")
    K = len(section_nodes)
    h_sections = PERIOD * section_sizes
    boundaries = TAU_0 + np.concatenate([[0.0], np.cumsum(h_sections)])
    boundaries[-1] = TAU_F

    num_defect = int(np.sum(section_nodes - 1))
    N = num_defect + 1
    section_starts = np.concatenate([[0], np.cumsum(section_nodes - 1)[:-1]])

    tau = np.empty(N)
    E = np.zeros((num_defect, N))
    I = np.zeros((num_defect, N))
    W = np.zeros(N)
    colloc = np.zeros(N, dtype=bool)

    row = 0
    for k in range(K):
        n_k = int(section_nodes[k])
        h_k = h_sections[k]
        start = int(section_starts[k])
        sch = quad.scheme(method, n_k)
        # Map reference-element points onto [boundaries[k], boundaries[k+1]].
        local = 0.5 * (boundaries[k] + boundaries[k + 1]) \
            + 0.5 * h_k * sch.points
        tau[start:start + n_k] = local
        tau[start] = boundaries[k]
        rows = slice(row, row + n_k - 1)
        cols = slice(start, start + n_k)
        E[rows, start] += 1.0
        E[rows.start:rows.stop, start + 1:start + n_k] -= np.eye(n_k - 1)
        I[rows, cols] = 0.5 * h_k * sch.integration
        W[cols] += 0.5 * h_k * sch.weights
        colloc[start:start + sch.num_collocation] = True
        row += n_k - 1
    tau[-1] = TAU_F
    colloc[-1] = colloc[-1] or (method == quad.LOBATTO)
    return PhaseMeshTables(method=method, K=K, N=N, num_defect=num_defect,
                           tau=tau, h_sections=h_sections,
                           section_nodes=section_nodes,
                           section_starts=section_starts,
                           E=E, I=I, W=W, collocation_mask=colloc)
