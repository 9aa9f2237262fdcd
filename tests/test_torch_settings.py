"""Twin of ``tests/unit/test_settings.py`` for the port.

``pycollo_tpu_torch.Settings`` against the JAX package's ``Settings``: the
same defaults (but for the backend's name, ``"torch"`` where the JAX
package says ``"jax"``), the same accepted values and the same validation
errors.  JAX is imported inside the tests only.
"""

import pytest
import torch

from pycollo_tpu_torch import Settings

torch.set_num_threads(2)


def _both():
    from pycollo_tpu import Settings as JaxSettings
    return Settings(), JaxSettings()


def _both_raise(match, name, value):
    """Setting ``name`` to ``value`` raises the same error in both."""
    for s in _both():
        with pytest.raises(ValueError, match=match):
            setattr(s, name, value)


def test_defaults():
    s, r = _both()
    # every option, public or behind a property, but the backend's name
    options = {k: v for k, v in vars(s).items() if k != "_backend"}
    assert options == {k: v for k, v in vars(r).items() if k != "_backend"}
    assert (s.backend, r.backend) == ("torch", "jax")
    assert s.quadrature_method == "lobatto"
    assert s.collocation_matrix_form == "integral"
    assert s.mesh_tolerance == 1e-7
    assert s.max_mesh_iterations == 10
    assert s.collocation_points_min == 4
    assert s.collocation_points_max == 10
    assert s.scaling_method == "bounds"
    assert s.nlp_solver == "ipm"
    assert s.linear_solver == "condensed-cholesky"
    assert s.derivative_level == 2


def test_quadrature_options():
    for s in _both():
        s.quadrature_method = "radau"
        assert s.quadrature_method == "radau"
    _both_raise("not currently supported", "quadrature_method", "gauss")
    _both_raise("not a valid option", "quadrature_method", "simpson")


def test_unsupported_backends():
    _both_raise("not currently supported", "backend", "casadi")


def test_collocation_points_cross_validation():
    for s in _both():
        with pytest.raises(ValueError):
            s.collocation_points_min = 12   # above max (10)
        s.collocation_points_max = 15
        s.collocation_points_min = 12
        assert s.collocation_points_min == 12
        with pytest.raises(ValueError):
            s.collocation_points_max = 11   # below min
        with pytest.raises(ValueError):
            s.collocation_points_max = 21   # above hard bound


def test_tolerance_ranges():
    _both_raise(None, "mesh_tolerance", 2.0)
    _both_raise(None, "nlp_tolerance", -1.0)
    for s in _both():
        s.mesh_tolerance = 1e-6
        assert s.mesh_tolerance == 1e-6


def test_derivative_level():
    for s in _both():
        s.derivative_level = 1
        assert s.derivative_level == 1
    _both_raise(None, "derivative_level", 3)


def test_scaling_none_via_none_literal():
    for s in _both():
        s.scaling_method = None
        assert s.scaling_method == "none"
