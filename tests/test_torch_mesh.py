"""Twin of ``tests/unit/test_mesh.py`` for the port.

``pycollo_tpu_torch.mesh`` against the JAX package's ``pycollo_tpu.mesh``
on the same inputs: the mesh defaults, the section tables, the defect
operators E and I and the quadrature vector W equal to ``TOL``; the
reference test's own assertions kept on the port's output.  JAX is
imported inside the tests only.
"""

import numpy as np
import pytest
import torch

from pycollo_tpu_torch.mesh import PhaseMesh, build_phase_tables

torch.set_num_threads(2)

#: both packages run the same float64 numpy code
TOL = 1e-14
TABLE_FIELDS = ("tau", "h_sections", "E", "I", "W")


def _jax_mesh():
    from pycollo_tpu import mesh
    return mesh


def _tables(*args):
    """The port's tables after checking them against the JAX package's."""
    t = build_phase_tables(*args)
    r = _jax_mesh().build_phase_tables(*args)
    assert (t.method, t.K, t.N, t.num_defect) \
        == (r.method, r.K, r.N, r.num_defect)
    np.testing.assert_array_equal(t.section_nodes, r.section_nodes)
    np.testing.assert_array_equal(t.section_starts, r.section_starts)
    np.testing.assert_array_equal(t.collocation_mask, r.collocation_mask)
    for name in TABLE_FIELDS:
        np.testing.assert_allclose(getattr(t, name), getattr(r, name),
                                   rtol=TOL, atol=TOL, err_msg=name)
    return t


def _same_mesh(pm, rm):
    assert pm.number_mesh_sections == rm.number_mesh_sections
    np.testing.assert_array_equal(pm.mesh_section_sizes,
                                  rm.mesh_section_sizes)
    np.testing.assert_array_equal(pm.number_mesh_section_nodes,
                                  rm.number_mesh_section_nodes)


def test_phase_mesh_defaults():
    pm = PhaseMesh()
    _same_mesh(pm, _jax_mesh().PhaseMesh())
    assert pm.number_mesh_sections == 10
    np.testing.assert_allclose(pm.mesh_section_sizes, np.ones(10) / 10)
    np.testing.assert_array_equal(pm.number_mesh_section_nodes,
                                  np.full(10, 4))


def test_phase_mesh_sizes_normalized():
    kw = dict(number_mesh_sections=4, mesh_section_sizes=[1, 2, 3, 4])
    pm = PhaseMesh(**kw)
    _same_mesh(pm, _jax_mesh().PhaseMesh(**kw))
    np.testing.assert_allclose(pm.mesh_section_sizes.sum(), 1.0)
    np.testing.assert_allclose(pm.mesh_section_sizes,
                               np.array([1, 2, 3, 4]) / 10)


def test_phase_mesh_size_mismatch():
    for cls in (PhaseMesh, _jax_mesh().PhaseMesh):
        pm = cls(number_mesh_sections=3)
        with pytest.raises(ValueError):
            pm.mesh_section_sizes = [1, 2]


def test_tables_default_mesh():
    t = _tables("lobatto", np.ones(10) / 10, [4] * 10)
    assert t.N == 31
    assert t.num_defect == 30
    assert t.K == 10
    assert t.tau[0] == -1.0 and t.tau[-1] == 1.0
    np.testing.assert_allclose(t.W.sum(), 2.0, rtol=1e-12)
    np.testing.assert_array_equal(t.section_starts, np.arange(0, 30, 3))


def test_defect_operator_exact_on_polynomials():
    """E y + I f vanishes when y' = f exactly (polynomial dynamics)."""
    for method in ("lobatto", "radau"):
        t = _tables(method, [0.3, 0.2, 0.5], [4, 5, 6])
        y = t.tau ** 3 - 2 * t.tau
        f = 3 * t.tau ** 2 - 2
        np.testing.assert_allclose(t.E @ y + t.I @ f, 0.0, atol=1e-12)


def test_quadrature_vector_integrates():
    """W integrates functions over the tau domain."""
    t = _tables("lobatto", np.ones(5) / 5, [6] * 5)
    np.testing.assert_allclose(t.W @ (t.tau ** 4), 2.0 / 5, atol=1e-12)


def test_nonuniform_sections():
    sizes = [0.1, 0.4, 0.5]
    t = _tables("lobatto", sizes, [4, 4, 4])
    np.testing.assert_allclose(t.h_sections, np.array(sizes) * 2.0)
    boundaries = t.tau[t.section_starts]
    np.testing.assert_allclose(boundaries, [-1.0, -0.8, 0.0], atol=1e-14)
