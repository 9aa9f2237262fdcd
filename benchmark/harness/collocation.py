"""Legendre-Gauss-Lobatto collocation tables, worked out afresh.

The plain reference's own transcription tables: nodes, quadrature weights
and the integral-form integration matrix of each mesh section, built from
the Lagrange basis in the monomial basis on [-1, 1] (the program builds
its tables from Legendre-basis coefficients).  A section of n nodes is
collocated in integral form,

    y(x_i) = y(x_0) + (h / 2) * stretch * sum_j A[i-1, j] f(x_j),
    A[i-1, j] = integral from -1 to x_i of ell_j,   i = 1 .. n-1,

with h the section's width in tau (tau in [-1, 1] over the phase) and
stretch = (tF - t0) / 2; the quadrature of an integrand over the phase is
stretch * sum over sections of (h / 2) * sum_j w_j g(x_j).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
from numpy.polynomial import legendre as L
from numpy.polynomial import polynomial as P


def lgl_nodes(n: int) -> np.ndarray:
    """The n LGL nodes on [-1, 1]: the endpoints and the roots of
    P'_{n-1}."""
    if n < 2:
        raise ValueError("LGL needs at least two nodes")
    inner = L.Legendre.basis(n - 1).deriv().roots()
    return np.concatenate([[-1.0], np.sort(inner.real), [1.0]])


def lgl_weights(x: np.ndarray) -> np.ndarray:
    """w_j = 2 / (n (n - 1) P_{n-1}(x_j)^2)."""
    n = len(x)
    p = L.Legendre.basis(n - 1)(x)
    return 2.0 / (n * (n - 1) * p ** 2)


def integration_matrix(x: np.ndarray) -> np.ndarray:
    """(n - 1, n): the integral from -1 to x_i of the j-th Lagrange basis
    polynomial of the nodes ``x``, for i = 1 .. n - 1."""
    n = len(x)
    A = np.empty((n - 1, n))
    for j in range(n):
        others = np.delete(x, j)
        coef = P.polyfromroots(others) / np.prod(x[j] - others)
        prim = P.polyint(coef, lbnd=-1.0)
        A[:, j] = P.polyval(x[1:], prim)
    return A


@dataclass(frozen=True)
class Mesh:
    """One phase's mesh: ``K`` equal sections of ``n`` LGL nodes each,
    neighbouring sections sharing their boundary node."""

    K: int
    n: int

    @property
    def N(self) -> int:
        return self.K * (self.n - 1) + 1

    def tau(self) -> np.ndarray:
        """(N,) nodes on [-1, 1]."""
        x = lgl_nodes(self.n)
        h = 2.0 / self.K
        out = [(-1.0 + k * h) + 0.5 * h * (x[:-1] + 1.0)
               for k in range(self.K)]
        return np.concatenate(out + [[1.0]])

    def defect_operator(self) -> Tuple[np.ndarray, np.ndarray]:
        """(``S``, ``I``), each (K (n - 1), N): the defect rows of a state
        column y with derivative column f are ``S @ y + stretch * I @ f``,
        where ``S @ y`` is the section's first node less node i."""
        A = integration_matrix(lgl_nodes(self.n))
        h = 2.0 / self.K
        S = np.zeros((self.N - 1, self.N))
        I = np.zeros((self.N - 1, self.N))
        for k in range(self.K):
            c0 = k * (self.n - 1)
            for i in range(1, self.n):
                S[c0 + i - 1, c0] += 1.0
                S[c0 + i - 1, c0 + i] -= 1.0
            I[c0:c0 + self.n - 1, c0:c0 + self.n] = 0.5 * h * A
        return S, I

    def quadrature_weights(self) -> np.ndarray:
        """(N,): the phase integral is ``stretch * w @ g``."""
        w = lgl_weights(lgl_nodes(self.n))
        h = 2.0 / self.K
        out = np.zeros(self.N)
        for k in range(self.K):
            c0 = k * (self.n - 1)
            out[c0:c0 + self.n] += 0.5 * h * w
        return out
