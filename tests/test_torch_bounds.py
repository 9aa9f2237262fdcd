"""Twin of ``tests/unit/test_bounds.py`` for the port.

The same bound specifications go through ``pycollo_tpu_torch.bounds`` and
the JAX package's ``pycollo_tpu.bounds``: the arrays must be equal, and
where the reference raises, both raise the same error.  The reference
test's own assertions are kept on the port's output.  JAX is imported
inside the tests only.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pycollo_tpu_torch import bounds as port_bounds

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

torch.set_num_threads(2)

INF = 1e19


def _jax_bounds():
    from pycollo_tpu import bounds
    return bounds


def _both(name, *args):
    """``name`` of both packages' bounds modules on the same inputs: the
    port's result, after checking it equals the JAX package's."""
    out = getattr(port_bounds, name)(*args)
    ref = getattr(_jax_bounds(), name)(*args)
    np.testing.assert_array_equal(out, ref)
    return out


def _both_raise(match, name, *args):
    for mod in (port_bounds, _jax_bounds()):
        with pytest.raises(ValueError, match=match):
            getattr(mod, name)(*args)


def test_scalar_single_variable():
    out = _both("process_bounds_value", 5.0, 1, ["x"], INF, True)
    np.testing.assert_array_equal(out, [[5.0, 5.0]])


def test_pair_single_variable():
    out = _both("process_bounds_value", [1.0, 2.0], 1, ["x"], INF, True)
    np.testing.assert_array_equal(out, [[1.0, 2.0]])


def test_list_of_pairs():
    out = _both("process_bounds_value", [[0, 1], [2, 3]], 2, ["x", "y"],
                INF, True)
    np.testing.assert_array_equal(out, [[0, 1], [2, 3]])


def test_list_of_scalars():
    out = _both("process_bounds_value", [1.5, 2.5], 2, ["x", "y"], INF,
                True)
    np.testing.assert_array_equal(out, [[1.5, 1.5], [2.5, 2.5]])


def test_dict_by_name():
    out = _both("process_bounds_value", {"x": [0, 1], "y": 4}, 2,
                ["x", "y"], INF, True)
    np.testing.assert_array_equal(out, [[0, 1], [4, 4]])


def test_dict_missing_entry_gets_inf():
    out = _both("process_bounds_value", {"x": [0, 1]}, 2, ["x", "y"], INF,
                True)
    np.testing.assert_array_equal(out[1], [-INF, INF])


def test_dict_unknown_key_raises():
    _both_raise("Unknown variable", "process_bounds_value", {"z": 1}, 1,
                ["x"], INF, True)


def test_none_requires_assume_inf():
    _both_raise("assume_inf_bounds", "process_bounds_value", None, 1, ["x"],
                INF, False)
    out = _both("process_bounds_value", None, 1, ["x"], INF, True)
    np.testing.assert_array_equal(out, [[-INF, INF]])


def test_wrong_length_raises():
    _both_raise(None, "process_bounds_value", [[0, 1]], 2, ["x", "y"], INF,
                True)


def test_phase_bounds_processing():
    """End-to-end phase bounds of the brachistochrone, built through each
    package's example: needed masks and endpoint overrides."""
    from brachistochrone import build_problem as build_jax
    from brachistochrone_torch import build_problem as build_torch

    pt = build_torch()
    pj = build_jax()
    pb = port_bounds.process_phase_bounds(pt.phases[0], pt.settings)
    rb = _jax_bounds().process_phase_bounds(pj.phases[0], pj.settings)
    for name in ("y_bnd", "u_bnd", "q_bnd", "t0_bnd", "tF_bnd", "y_t0_bnd",
                 "y_tF_bnd", "path_bnd", "y_needed", "u_needed", "q_needed",
                 "t_needed"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(rb, name),
                                      err_msg=name)
    # t0 has equal bounds (0.0) -> not needed; tF is needed.
    np.testing.assert_array_equal(pb.t_needed, [False, True])
    # All states/controls needed (bounds are ranges).
    assert pb.y_needed.all() and pb.u_needed.all()
    # Initial state constraints pin all three states at node 0.
    np.testing.assert_array_equal(pb.y_t0_bnd, [[0, 0], [0, 0], [0, 0]])
    # Final state constraints pin x and y but leave v free (phase bounds).
    np.testing.assert_array_equal(pb.y_tF_bnd[0], [2, 2])
    np.testing.assert_array_equal(pb.y_tF_bnd[1], [2, 2])
    np.testing.assert_array_equal(pb.y_tF_bnd[2], [-50, 50])


def test_clash_tolerance_collapses():
    bnd = np.array([[1.0 + 1e-8, 1.0]])
    out = port_bounds._check_clashes(bnd.copy(), ["x"], "test", 1e-6, 1e-6)
    ref = _jax_bounds()._check_clashes(bnd.copy(), ["x"], "test", 1e-6,
                                       1e-6)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0] == out[0, 1]


def test_clash_error():
    _both_raise("exceeds upper", "_check_clashes", np.array([[2.0, 1.0]]),
                ["x"], "test", 1e-6, 1e-6)
