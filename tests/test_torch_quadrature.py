"""Twin of ``tests/unit/test_quadrature.py`` for the port.

Every case builds the port's scheme (``pycollo_tpu_torch.quadrature``) and
the JAX package's (``pycollo_tpu.quadrature``) for the same method and
order: points, weights, the differentiation and integration matrices (and
the interpolation matrix) must agree to ``TOL``.  The reference test's own
assertions are then kept on the port's tables, orders 2 to 20.  JAX is
imported inside the tests only.
"""

import numpy as np
import pytest
import torch

from pycollo_tpu_torch import quadrature as quad

torch.set_num_threads(2)

#: both packages compute the tables with the same float64 code
TOL = 1e-14
SCHEME_FIELDS = ("points", "weights", "integration", "differentiation")


def _scheme(method, order):
    """The port's scheme after checking it against the JAX package's."""
    from pycollo_tpu import quadrature as jax_quad
    s = quad.scheme(method, order)
    r = jax_quad.scheme(method, order)
    assert (s.method, s.order, s.num_collocation) \
        == (r.method, r.order, r.num_collocation)
    for name in SCHEME_FIELDS:
        np.testing.assert_allclose(getattr(s, name), getattr(r, name),
                                   rtol=TOL, atol=TOL, err_msg=name)
    return s


def test_lobatto_points_order_4():
    """LGL-4 points are [-1, -1/sqrt(5), 1/sqrt(5), 1]."""
    s = _scheme("lobatto", 4)
    expected = np.array([-1.0, -1.0 / np.sqrt(5), 1.0 / np.sqrt(5), 1.0])
    np.testing.assert_allclose(s.points, expected, atol=1e-14)


def test_lobatto_weights_order_4():
    """LGL-4 weights are [1/6, 5/6, 5/6, 1/6]."""
    s = _scheme("lobatto", 4)
    expected = np.array([1.0, 5.0, 5.0, 1.0]) / 6.0
    np.testing.assert_allclose(s.weights, expected, atol=1e-14)


def test_lobatto_points_order_3():
    s = _scheme("lobatto", 3)
    np.testing.assert_allclose(s.points, [-1.0, 0.0, 1.0], atol=1e-14)
    np.testing.assert_allclose(s.weights, [1 / 3, 4 / 3, 1 / 3],
                               atol=1e-14)


def test_radau_points_include_left_endpoint():
    for order in range(3, 11):
        s = _scheme("radau", order)
        assert s.points[0] == -1.0
        assert s.points[-1] == 1.0
        assert s.weights[-1] == 0.0
        assert s.num_collocation == order - 1


@pytest.mark.parametrize("order", range(2, 21))
def test_lobatto_weights_sum_to_two(order):
    s = _scheme("lobatto", order)
    np.testing.assert_allclose(s.weights.sum(), 2.0, rtol=1e-12)


@pytest.mark.parametrize("order", range(2, 21))
def test_radau_weights_sum_to_two(order):
    s = _scheme("radau", order)
    np.testing.assert_allclose(s.weights.sum(), 2.0, rtol=1e-10)


@pytest.mark.parametrize("order", range(2, 21))
def test_lobatto_quadrature_exactness(order):
    """Full-interval LGL quadrature is exact to degree 2n-3."""
    s = _scheme("lobatto", order)
    deg = 2 * order - 3
    approx = np.dot(s.weights, s.points ** deg)
    exact = (1 - (-1.0) ** (deg + 1)) / (deg + 1)
    np.testing.assert_allclose(approx, exact, atol=1e-9)


@pytest.mark.parametrize("order", range(2, 21))
def test_lobatto_integration_matrix_exactness(order):
    """Partial integrals are exact for polynomials of degree n-1."""
    s = _scheme("lobatto", order)
    deg = order - 1
    f = s.points ** deg
    exact = (s.points[1:] ** (deg + 1) - (-1.0) ** (deg + 1)) / (deg + 1)
    np.testing.assert_allclose(s.integration @ f, exact, atol=1e-9)


@pytest.mark.parametrize("order", range(2, 21))
def test_radau_integration_matrix_exactness(order):
    s = _scheme("radau", order)
    m = order - 1
    deg = m - 1
    f = s.points ** deg
    exact = (s.points[1:] ** (deg + 1) - (-1.0) ** (deg + 1)) / (deg + 1)
    np.testing.assert_allclose(s.integration @ f, exact, atol=1e-8)


def test_lobatto_integration_last_row_is_weights():
    for order in range(2, 15):
        s = _scheme("lobatto", order)
        np.testing.assert_allclose(s.integration[-1], s.weights,
                                   atol=1e-10)


def test_differentiation_matrix():
    """D applied to polynomial values gives derivative values."""
    s = _scheme("lobatto", 6)
    f = s.points ** 4
    df = 4 * s.points ** 3
    np.testing.assert_allclose(s.differentiation @ f, df, atol=1e-9)


def test_gauss_unsupported():
    from pycollo_tpu import quadrature as jax_quad
    for mod in (quad, jax_quad):
        with pytest.raises(ValueError, match="not currently supported"):
            mod.scheme("gauss", 4)


def test_order_out_of_range():
    from pycollo_tpu import quadrature as jax_quad
    for mod in (quad, jax_quad):
        with pytest.raises(ValueError):
            mod.scheme("lobatto", 21)
        with pytest.raises(ValueError):
            mod.scheme("lobatto", 1)


def test_interpolation_matrix_partition_of_unity():
    from pycollo_tpu import quadrature as jax_quad
    xc = quad.lobatto_points(5)
    np.testing.assert_allclose(xc, jax_quad.lobatto_points(5), rtol=TOL,
                               atol=TOL)
    xq = np.linspace(-1, 1, 17)
    L = quad.interpolation_matrix(xc, xq)
    np.testing.assert_allclose(L, jax_quad.interpolation_matrix(xc, xq),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(L.sum(axis=1), np.ones(17), atol=1e-12)
    # Interpolation reproduces values at the nodes.
    Ln = quad.interpolation_matrix(xc, xc)
    np.testing.assert_allclose(Ln, np.eye(5), atol=1e-10)
