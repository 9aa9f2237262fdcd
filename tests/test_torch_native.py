"""Twin of ``tests/unit/test_native.py`` for the port.

The port's ``pycollo_tpu_torch.native`` loads the same C++ library
(``native/``) as the JAX package's ``pycollo_tpu.native``: on the same
inputs both must return identical arrays, and each must agree with its
package's numpy fallback (the quadrature module's companion-matrix and
Legendre-Vandermonde code, reached by hiding the library) to
``FALLBACK_TOL``.  The reference test's own accuracy assertions are kept on
the port's output.  JAX is imported inside the tests only.
"""

import numpy as np
import pytest
import torch

from pycollo_tpu_torch import native
from pycollo_tpu_torch import quadrature as quad

torch.set_num_threads(2)

#: native long-double roots against numpy's companion-matrix roots, which
#: lose a few digits at high order (at most 6.3e-14 over these cases)
FALLBACK_TOL = 1e-12


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no C++ toolchain)")
    return lib


def _packages():
    """(native module, quadrature module) of the port and the JAX package."""
    from pycollo_tpu import native as jax_native
    from pycollo_tpu import quadrature as jax_quad
    return (native, quad), (jax_native, jax_quad)


def _same(name, *args):
    """``name`` of both packages' native modules: the port's result, after
    checking it is identical to the JAX package's."""
    (port, _), (ref, _) = _packages()
    out = getattr(port, name)(*args)
    assert out is not None
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(getattr(ref, name)(*args)))
    return out


def _fallback(monkeypatch, fn, *args):
    """Each package's quadrature ``fn`` with its native library hidden."""
    outs = []
    for nat, qd in _packages():
        with monkeypatch.context() as m:
            m.setattr(nat, "get_lib", lambda: None)
            outs.append(getattr(qd, fn)(*args))
    return outs


def _against_fallback(monkeypatch, native_out, fn, *args):
    for out in _fallback(monkeypatch, fn, *args):
        np.testing.assert_allclose(out, native_out, rtol=FALLBACK_TOL,
                                   atol=FALLBACK_TOL, err_msg=fn)


def _lgl(monkeypatch, n):
    pts, w = _same("lgl_nodes_weights", n)
    _against_fallback(monkeypatch, pts, "lobatto_points", n)
    _against_fallback(monkeypatch, w, "lobatto_weights", n, pts)
    return pts, w


def test_lgl_matches_analytic(lib, monkeypatch):
    pts, w = _lgl(monkeypatch, 4)
    np.testing.assert_allclose(
        pts, [-1.0, -1.0 / np.sqrt(5), 1.0 / np.sqrt(5), 1.0], atol=1e-15)
    np.testing.assert_allclose(w, np.array([1, 5, 5, 1]) / 6.0, atol=1e-15)


@pytest.mark.parametrize("n", [2, 5, 10, 15, 20])
def test_lgl_quadrature_exactness_high_order(lib, monkeypatch, n):
    """Exactness to degree 2n-3 must hold tightly even at order 20."""
    pts, w = _lgl(monkeypatch, n)
    for deg in range(0, 2 * n - 2):
        approx = np.dot(w, pts ** deg)
        exact = (1 - (-1.0) ** (deg + 1)) / (deg + 1)
        np.testing.assert_allclose(approx, exact, atol=5e-13)


@pytest.mark.parametrize("m", [1, 3, 8, 15, 19])
def test_lgr_quadrature_exactness(lib, monkeypatch, m):
    pts, w = _same("lgr_nodes_weights", m)
    _against_fallback(monkeypatch, pts, "radau_collocation_points", m)
    _against_fallback(monkeypatch, w, "radau_weights", m, pts)
    assert pts[0] == -1.0
    for deg in range(0, 2 * m - 1):
        approx = np.dot(w, pts ** deg)
        exact = (1 - (-1.0) ** (deg + 1)) / (deg + 1)
        np.testing.assert_allclose(approx, exact, atol=5e-12)


def test_barycentric_interp(lib, monkeypatch):
    xc = np.array(_same("lgl_nodes_weights", 6)[0])
    xq = np.linspace(-1, 1, 23)
    L = _same("barycentric_interp_matrix", xc, xq)
    _against_fallback(monkeypatch, L, "interpolation_matrix", xc, xq)
    # Reproduces polynomials up to degree 5 exactly.
    for deg in range(6):
        np.testing.assert_allclose(L @ (xc ** deg), xq ** deg, atol=1e-13)
    # Identity at the nodes.
    Ln = _same("barycentric_interp_matrix", xc, xc)
    np.testing.assert_allclose(Ln, np.eye(6), atol=0)


def test_quadrature_module_uses_native(lib):
    """quadrature.scheme must produce native-accuracy tables at order 20,
    in both packages."""
    for nat, qd in _packages():
        qd.scheme.cache_clear()
        s = qd.scheme("lobatto", 20)
        pts, w = nat.lgl_nodes_weights(20)
        np.testing.assert_array_equal(s.points, pts)
        np.testing.assert_array_equal(s.weights, w)
    s = quad.scheme("lobatto", 20)
    deg = 2 * 20 - 3
    approx = np.dot(s.weights, s.points ** deg)
    exact = (1 - (-1.0) ** (deg + 1)) / (deg + 1)
    np.testing.assert_allclose(approx, exact, atol=1e-13)
