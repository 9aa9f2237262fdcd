"""Collocation quadrature schemes (Legendre-Gauss-Lobatto / -Radau).

Provides, for each (method, order), the static numpy tables needed by the
transcription: collocation points on [-1, 1], quadrature weights, the
integral-form integration matrix, and the differentiation matrix.

Capability parity with the reference quadrature module
(``pycollo/quadrature.py:31-268``): LGL (default) and LGR schemes for
orders 2..20, with Gauss enumerated but unsupported.  The construction here
is different from the reference (which solves moment conditions for Butcher
arrays): we build everything from Lagrange interpolation in the Legendre
basis, which is exact for the polynomial spaces involved and numerically
stable for n <= 20.

Conventions (self-consistent, differ from the reference's internal scaling):
 - points live on the reference element x in [-1, 1];
 - weights sum to 2 (the length of the element);
 - ``integration[i, j] = integral_{-1}^{x_{i+1}} ell_j(x) dx`` so that the
   integral-form defect on a section reads
   ``y_{i+1} = y_0 + stretch * (h_k / 2) * sum_j I_ij f_j``
   where ``h_k`` is the section width in global tau and
   ``stretch = (tF - t0) / 2``;
 - ``differentiation[i, j] = ell'_j(x_i)``.

For Radau schemes the collocation (interpolation) points are the order-(n-1)
left-Radau points (which include -1); the right endpoint +1 is a mesh node
but not a collocation point, so its weight is zero and the last column of the
integration matrix is zero — mirroring the reference's zero-weight appended
node (``pycollo/quadrature.py:123-133``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
from numpy.polynomial import legendre as npleg

from .utils import Options

GAUSS = "gauss"
LOBATTO = "lobatto"
RADAU = "radau"
QUADRATURES = Options((GAUSS, LOBATTO, RADAU), default=LOBATTO,
                      unsupported=(GAUSS,))

#: Hard limits on collocation points per mesh section.  Above 20 the
#: orthogonal-polynomial root finding becomes unstable (same rationale as the
#: reference, ``pycollo/quadrature.py:5-14``).
COLLOCATION_POINTS_MIN_BOUND = 2
COLLOCATION_POINTS_MAX_BOUND = 20
DEFAULT_COLLOCATION_POINTS_MIN = 4
DEFAULT_COLLOCATION_POINTS_MAX = 10


def _legendre_P(k: int):
    """Return the Legendre polynomial P_k as a numpy Legendre object."""
    return npleg.Legendre([0.0] * k + [1.0])


def lobatto_points(n: int) -> np.ndarray:
    """n Legendre-Gauss-Lobatto points on [-1, 1] (endpoints included).

    Uses the native long-double Newton iteration when available (exact to
    f64 at order 20, where numpy's companion-matrix roots degrade — the
    reference's stability ceiling, ``pycollo/quadrature.py:5-9``).
    """
    if n < 2:
        raise ValueError("Lobatto scheme needs at least 2 points.")
    if n == 2:
        return np.array([-1.0, 1.0])
    from . import native
    res = native.lgl_nodes_weights(n)
    if res is not None:
        return res[0]
    interior = _legendre_P(n - 1).deriv().roots()
    return np.concatenate([[-1.0], np.real(interior), [1.0]])


def lobatto_weights(n: int, points: np.ndarray) -> np.ndarray:
    """LGL weights on [-1, 1]: w_j = 2 / (n (n-1) P_{n-1}(x_j)^2)."""
    from . import native
    res = native.lgl_nodes_weights(n)
    if res is not None:
        return res[1]
    P = _legendre_P(n - 1)
    return 2.0 / (n * (n - 1) * P(points) ** 2)


def radau_collocation_points(m: int) -> np.ndarray:
    """m left-Radau points on [-1, 1): roots of P_{m-1} + P_m (includes -1)."""
    if m < 1:
        raise ValueError("Radau scheme needs at least 1 collocation point.")
    if m == 1:
        return np.array([-1.0])
    from . import native
    res = native.lgr_nodes_weights(m)
    if res is not None:
        return res[0]
    poly = _legendre_P(m - 1) + _legendre_P(m)
    roots = np.real(poly.roots())
    roots.sort()
    # The leftmost root is analytically -1; snap it.
    roots[0] = -1.0
    return roots


def radau_weights(m: int, points: np.ndarray) -> np.ndarray:
    """Left-Radau weights: w_0 = 2/m^2, w_j = (1-x_j)/(m^2 P_{m-1}(x_j)^2)."""
    from . import native
    res = native.lgr_nodes_weights(m)
    if res is not None:
        return res[1]
    P = _legendre_P(m - 1)
    w = (1.0 - points) / (m ** 2 * P(points) ** 2)
    w[0] = 2.0 / m ** 2
    return w


def _lagrange_legendre_coefficients(xc: np.ndarray) -> np.ndarray:
    """Legendre-basis coefficients of the Lagrange basis on nodes ``xc``.

    Returns C of shape (m, m) with ell_j(x) = sum_b C[b, j] P_b(x).
    """
    m = len(xc)
    V = npleg.legvander(xc, m - 1)          # V[a, b] = P_b(xc[a])
    return np.linalg.solve(V, np.eye(m))    # C[:, j] solves V @ c = e_j


def interpolation_matrix(xc: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """L[i, j] = ell_j(xq_i) for the Lagrange basis on nodes ``xc``."""
    from . import native
    L = native.barycentric_interp_matrix(np.asarray(xc, dtype=float),
                                         np.asarray(xq, dtype=float))
    if L is not None:
        return L
    C = _lagrange_legendre_coefficients(np.asarray(xc, dtype=float))
    Vq = npleg.legvander(np.asarray(xq, dtype=float), len(xc) - 1)
    return Vq @ C


def integration_matrix(xc: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """I[i, j] = integral_{-1}^{xq_i} ell_j(x) dx on nodes ``xc``."""
    xc = np.asarray(xc, dtype=float)
    xq = np.asarray(xq, dtype=float)
    C = _lagrange_legendre_coefficients(xc)
    m = len(xc)
    # Integrate each Legendre basis poly from -1: use legint with lbnd=-1.
    rows = []
    for b in range(m):
        coeffs = np.zeros(m)
        coeffs[b] = 1.0
        int_coeffs = npleg.legint(coeffs, lbnd=-1.0)
        rows.append(npleg.legval(xq, int_coeffs))
    Lint = np.stack(rows, axis=1)           # (len(xq), m): integral of P_b at xq_i
    return Lint @ C


def differentiation_matrix(xc: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """D[i, j] = ell'_j(xq_i) on nodes ``xc``."""
    xc = np.asarray(xc, dtype=float)
    xq = np.asarray(xq, dtype=float)
    C = _lagrange_legendre_coefficients(xc)
    m = len(xc)
    rows = []
    for b in range(m):
        coeffs = np.zeros(m)
        coeffs[b] = 1.0
        d_coeffs = npleg.legder(coeffs)
        rows.append(npleg.legval(xq, d_coeffs))
    Ld = np.stack(rows, axis=1)
    return Ld @ C


@dataclass(frozen=True)
class SectionScheme:
    """Static collocation tables for one section of ``order`` nodes."""

    method: str
    order: int
    #: (n,) mesh nodes on [-1, 1] including both endpoints.
    points: np.ndarray = field(repr=False)
    #: (n,) quadrature weights on [-1, 1] (sum to 2; Radau: last is 0).
    weights: np.ndarray = field(repr=False)
    #: (n-1, n): I[i, j] = integral_{-1}^{points[i+1]} ell_j dx, where the
    #: Lagrange basis is over the *collocation* points (Radau: last col 0).
    integration: np.ndarray = field(repr=False)
    #: (n, n): D[i, j] = ell'_j(points[i]) over all mesh nodes.
    differentiation: np.ndarray = field(repr=False)
    #: number of collocation points (LGL: n, LGR: n-1).
    num_collocation: int = 0


@functools.lru_cache(maxsize=None)
def scheme(method: str, order: int) -> SectionScheme:
    """Build (and cache) the section scheme for ``order`` mesh nodes."""
    if not (COLLOCATION_POINTS_MIN_BOUND <= order
            <= COLLOCATION_POINTS_MAX_BOUND):
        raise ValueError(
            f"Collocation order {order} outside supported range "
            f"[{COLLOCATION_POINTS_MIN_BOUND}, {COLLOCATION_POINTS_MAX_BOUND}].")
    method = QUADRATURES.validate(method)
    if method == LOBATTO:
        pts = lobatto_points(order)
        w = lobatto_weights(order, pts)
        integ = integration_matrix(pts, pts[1:])
        diff = differentiation_matrix(pts, pts)
        ncol = order
    elif method == RADAU:
        colloc = radau_collocation_points(order - 1)
        pts = np.concatenate([colloc, [1.0]])
        w = np.concatenate([radau_weights(order - 1, colloc), [0.0]])
        integ = np.zeros((order - 1, order))
        integ[:, :-1] = integration_matrix(colloc, pts[1:])
        diff = np.zeros((order, order))
        diff[:, :-1] = differentiation_matrix(colloc, pts)
        ncol = order - 1
    else:  # pragma: no cover - GAUSS is rejected by Options.validate
        raise NotImplementedError(method)
    return SectionScheme(method=method, order=order, points=pts, weights=w,
                         integration=integ, differentiation=diff,
                         num_collocation=ncol)
