"""Port of the batched Cholesky-inverse kernel against the JAX package.

CPU: the port's plain version (``chol_inv_reference``, which ``chol_inv``
runs for CPU tensors) and ``blocked_chol_linv`` against the JAX Pallas
kernel run through its interpreter, on the same seeded numpy inputs.
CUDA (``cuda`` marker, skipped without a GPU): the hand-written kernel
against the plain version on the card.  The tolerance is the f32 one of
``tests/unit/test_ops_chol.py``.

JAX is imported inside the CPU tests only, so that the CUDA tests also run
on a machine without JAX:
``python -m pytest tests/test_torch_block_chol.py -m cuda --noconftest``.
"""

import numpy as np
import pytest
import torch

from pycollo_tpu_torch.ops.block_chol import (MAX_BLOCK_N, blocked_chol_linv,
                                              chol_inv, chol_inv_reference)

torch.set_num_threads(2)

#: f32 tolerance (tests/unit/test_ops_chol.py)
TOL = 2e-4


def _random_spd(rng, b, n, jitter=0.5):
    M = rng.standard_normal((b, n, n))
    return M @ np.swapaxes(M, -1, -2) + jitter * np.eye(n)


def _jax_kernel(A):
    """The JAX package's Pallas kernel, through its interpreter."""
    import jax.numpy as jnp
    from pycollo_tpu.ops.block_chol import batched_chol_inv
    return np.asarray(batched_chol_inv(jnp.asarray(A), interpret=True))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [3, 8, 15])
def test_plain_matches_jax_kernel(n):
    rng = np.random.default_rng(0)
    A = _random_spd(rng, 37, n)
    ref = _jax_kernel(A)
    out = chol_inv(torch.tensor(A))
    assert out.dtype == torch.float32 and out.shape == (37, n, n)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_strictly_lower_triangular_inverse():
    rng = np.random.default_rng(1)
    A = _random_spd(rng, 5, 9)
    out = chol_inv_reference(torch.tensor(A)).numpy()
    iu = np.triu_indices(9, k=1)
    assert np.all(out[:, iu[0], iu[1]] == 0.0)
    recon = out @ A.astype(np.float32) @ np.swapaxes(out, -1, -2)
    np.testing.assert_allclose(
        recon, np.broadcast_to(np.eye(9, dtype=np.float32), recon.shape),
        atol=5e-4)


def test_non_pd_flags_nan_in_that_instance_only():
    rng = np.random.default_rng(2)
    A = _random_spd(rng, 4, 6)
    A[2] -= 10.0 * np.eye(6)
    out = chol_inv_reference(torch.tensor(A)).numpy()
    jax_out = _jax_kernel(A)
    assert np.isnan(out[2]).any() and np.isnan(jax_out[2]).any()
    assert np.isfinite(out[[0, 1, 3]]).all()


def test_cpu_tensor_runs_the_plain_version_and_checks_shapes():
    rng = np.random.default_rng(3)
    before = chol_inv.launches
    A = torch.tensor(_random_spd(rng, 3, 5))
    torch.testing.assert_close(chol_inv(A), chol_inv_reference(A))
    assert chol_inv.launches == before
    with pytest.raises(ValueError):
        chol_inv(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        chol_inv(torch.eye(MAX_BLOCK_N + 1)[None])


def test_blocked_matches_jax():
    """n = 60 in blocks of 15: four diagonal blocks, panels and trailing
    updates; a leading (2, 3) batch is folded into the kernel batch."""
    import jax.numpy as jnp
    from pycollo_tpu.ops.block_chol import blocked_chol_linv as jax_blocked
    rng = np.random.default_rng(4)
    A = _random_spd(rng, 6, 60) / 60.0 + 0.5 * np.eye(60)
    dj, Lj = jax_blocked(jnp.asarray(A), block=15, interpret=True)
    A6 = torch.tensor(A).reshape(2, 3, 60, 60)
    d, L = blocked_chol_linv(A6, block=15)
    assert d.shape == (2, 3, 60) and L.shape == (2, 3, 60, 60)
    np.testing.assert_allclose(L.reshape(6, 60, 60).numpy(), np.asarray(Lj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d.reshape(6, 60).numpy(), np.asarray(dj),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 8, 15, 37, 48])
@pytest.mark.parametrize("B", [37, 1536])
def test_kernel_matches_plain_on_card(cuda_device, n, B):
    rng = np.random.default_rng(n)
    A = torch.tensor(_random_spd(rng, B, n), device=cuda_device)
    before = chol_inv.launches
    out = chol_inv(A)
    ref = chol_inv_reference(A)
    torch.cuda.synchronize()
    assert chol_inv.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    iu = torch.triu_indices(n, n, offset=1, device=cuda_device)
    assert bool((out[:, iu[0], iu[1]] == 0).all())


@pytest.mark.cuda
def test_kernel_nan_isolation_on_card(cuda_device):
    rng = np.random.default_rng(5)
    A = _random_spd(rng, 37, 37)
    A[5] -= 100.0 * np.eye(37)
    out = chol_inv(torch.tensor(A, device=cuda_device)).cpu().numpy()
    assert np.isnan(out[5]).any()
    assert np.isfinite(np.delete(out, 5, axis=0)).all()


@pytest.mark.cuda
def test_blocked_on_card_matches_f64(cuda_device):
    """The main path's shape: 256 instances x 6 ladder levels of 148."""
    rng = np.random.default_rng(6)
    A = _random_spd(rng, 1536, 148) / 148.0 + 0.5 * np.eye(148)
    A_d = torch.tensor(A, device=cuda_device)
    d, L = blocked_chol_linv(A_d.reshape(256, 6, 148, 148))
    L64 = torch.linalg.cholesky(A_d)
    eye = torch.eye(148, dtype=torch.float64, device=cuda_device)
    Linv64 = torch.linalg.solve_triangular(L64, eye.expand_as(A_d),
                                           upper=False)
    torch.testing.assert_close(L.reshape(1536, 148, 148).double(), Linv64,
                               rtol=TOL, atol=TOL)
