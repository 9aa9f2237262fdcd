"""Port of the batched Cholesky-inverse kernel against the JAX package.

CPU: the port's plain version (``chol_inv_reference``, which ``chol_inv``
runs for CPU tensors) and ``blocked_chol_linv`` against the JAX Pallas
kernel run through its interpreter, on the same seeded numpy inputs.
The plain version at the kernel's sizes (up to 160) against f64.  CUDA
(``cuda`` marker, skipped without a GPU): the hand-written kernel against
the plain version on the card, and ``blocked_chol_linv`` at the solver's
shapes, one launch at n = 148 and four at n = 628.  The tolerance is the
f32 one of ``tests/unit/test_ops_chol.py``.

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


def _equilibrated_spd(rng, b, n):
    """``M M^T / n + 0.5 I``: eigenvalues in about [0.5, 4.5], as for the
    solver's Jacobi-equilibrated matrices, at any n."""
    return _random_spd(rng, b, n, jitter=0.0) / n + 0.5 * np.eye(n)


def _f64_linv(A):
    L = np.linalg.cholesky(A)
    return np.linalg.inv(L), np.einsum("bii->bi", L)


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


def test_blocked_default_is_one_block_and_matches_jax(monkeypatch):
    """n = 60 with the default blocking: one block of 60 in the port (one
    kernel launch on a card), two blocks of 30 in the JAX package (its
    kernel takes at most 48).  The JAX package's diagonal blocks run its
    XLA reference: its Pallas interpreter traces the fully unrolled
    30 x 30 recurrence, which takes minutes on the CPU (the kernel itself
    is held against the interpreter at n <= 15 above)."""
    import jax.numpy as jnp
    from pycollo_tpu.ops import block_chol as jax_ops
    monkeypatch.setattr(jax_ops, "batched_chol_inv",
                        lambda A, interpret=None: jax_ops.chol_inv_reference(A))
    rng = np.random.default_rng(7)
    A = _equilibrated_spd(rng, 6, 60)
    dj, Lj = jax_ops.blocked_chol_linv(jnp.asarray(A))
    calls, launches = blocked_chol_linv.calls, chol_inv.launches
    d, L = blocked_chol_linv(torch.tensor(A).reshape(2, 3, 60, 60))
    assert blocked_chol_linv.calls == calls + 1
    assert chol_inv.launches == launches
    np.testing.assert_allclose(L.reshape(6, 60, 60).numpy(), np.asarray(Lj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(d.reshape(6, 60).numpy(), np.asarray(dj),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [148, 160])
def test_plain_at_the_kernel_sizes_matches_f64(n):
    rng = np.random.default_rng(n)
    A = _equilibrated_spd(rng, 4, n)
    Linv64, diag64 = _f64_linv(A)
    Linv, diag = chol_inv(torch.tensor(A), return_diag=True)
    assert Linv.dtype == torch.float32 and diag.shape == (4, n)
    np.testing.assert_allclose(Linv.numpy(), Linv64, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(diag.numpy(), diag64, rtol=TOL, atol=TOL)
    iu = np.triu_indices(n, k=1)
    assert np.all(Linv.numpy()[:, iu[0], iu[1]] == 0.0)


def test_plain_diag_is_nan_for_a_non_pd_instance():
    rng = np.random.default_rng(8)
    A = _equilibrated_spd(rng, 3, 20)
    A[1] -= 10.0 * np.eye(20)
    Linv, diag = chol_inv_reference(torch.tensor(A), return_diag=True)
    assert torch.isnan(diag[1]).all() and torch.isnan(Linv[1]).all()
    assert torch.isfinite(diag[[0, 2]]).all()


def test_kernel_limit_is_160():
    assert MAX_BLOCK_N == 160
    chol_inv(torch.eye(MAX_BLOCK_N, dtype=torch.float64)[None])
    with pytest.raises(ValueError):
        chol_inv(torch.eye(MAX_BLOCK_N + 1, dtype=torch.float64)[None])


def test_blocked_default_splits_into_the_fewest_blocks():
    """n = 330: three blocks of 110 (the refined mesh's 628 is four of
    157), the blocked algorithm with padding-free blocks, against f64."""
    rng = np.random.default_rng(9)
    A = _equilibrated_spd(rng, 2, 330)
    Linv64, diag64 = _f64_linv(A)
    d, L = blocked_chol_linv(torch.tensor(A))
    np.testing.assert_allclose(L.numpy(), Linv64, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(d.numpy(), diag64, rtol=TOL, atol=TOL)


def test_blocked_768_is_five_blocks_of_154_and_counts_them():
    """n = 768 (the shuttle benchmark's n_free): five blocks of 154, padded
    to 770 with the identity, against f64; the first diagonal block is the
    plain version's inverse of A's corner, bit for bit; the call counts 5
    blocks and 60 products (10
    panels, 20 trailing updates, 30 in the block inversion).  A matrix of
    one block counts 1 and 0."""
    rng = np.random.default_rng(768)
    A = _equilibrated_spd(rng, 2, 768)
    Linv64, diag64 = _f64_linv(A)
    before = (blocked_chol_linv.calls, blocked_chol_linv.blocks,
              blocked_chol_linv.products)
    d, L = blocked_chol_linv(torch.tensor(A))
    after = (blocked_chol_linv.calls, blocked_chol_linv.blocks,
             blocked_chol_linv.products)
    assert [a - b for a, b in zip(after, before)] == [1, 5, 60]
    np.testing.assert_allclose(L.numpy(), Linv64, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(d.numpy(), diag64, rtol=TOL, atol=TOL)
    corner = chol_inv_reference(torch.tensor(A[:, :154, :154]))
    assert torch.equal(L[:, :154, :154], corner)
    iu = np.triu_indices(768, k=1)
    assert np.all(L.numpy()[:, iu[0], iu[1]] == 0.0)
    before = after
    blocked_chol_linv(torch.tensor(A[:, :148, :148]))
    after = (blocked_chol_linv.calls, blocked_chol_linv.blocks,
             blocked_chol_linv.products)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 0]


class _PassOn:
    """A stand-in for ``blocked_chol_linv`` as ``chip_smoke.py``'s is: it
    takes the function's name in ``block_chol``, passes every call on and
    holds ``calls`` alone."""

    def __init__(self, blocked):
        self.blocked = blocked
        self.calls = 0

    def __call__(self, A, block=None):
        return self.blocked(A, block)


def test_block_counters_stay_on_the_function_under_a_stand_in(monkeypatch):
    """With a stand-in in its name, a call counts in the stand-in's
    ``calls`` and in the function's own ``blocks`` and ``products``,
    eagerly and through a replayed tape, at two blocks and at one."""
    from pycollo_tpu_torch import profiling
    from pycollo_tpu_torch.ops import block_chol
    rng = np.random.default_rng(192)
    wide = torch.tensor(_equilibrated_spd(rng, 2, 192))
    narrow = wide[:, :96, :96]
    fn = blocked_chol_linv
    stand_in = _PassOn(fn)
    monkeypatch.setattr(block_chol, "blocked_chol_linv", stand_in)

    def counts():
        return (stand_in.calls, fn.blocks, fn.products)

    before = counts()
    block_chol.blocked_chol_linv(wide)
    block_chol.blocked_chol_linv(narrow)
    eager = [a - b for a, b in zip(counts(), before)]
    assert eager == [2, 3, 4]
    with profiling.taping() as tape:
        block_chol.blocked_chol_linv(wide)
        block_chol.blocked_chol_linv(narrow)
    before = counts()
    profiling.replay(tape)
    assert [a - b for a, b in zip(counts(), before)] == eager


def test_bound_counts_the_lower_triangle_read():
    """The kernel reads n (n + 1) / 2 floats of each matrix and writes n^2
    (and n of diag(L)); 2 n^3 / 3 flops bound it only at large n."""
    from pycollo_tpu_torch.ops.bench_chol import (PEAK_BYTES_PER_S,
                                                  PEAK_F32_FLOPS, bound_ms)
    ms, by = bound_ms(1536, 148)
    assert by == "bytes"
    assert ms == pytest.approx(
        1e3 * 4 * 1536 * (148 * 149 / 2 + 148 ** 2) / PEAK_BYTES_PER_S)
    ms_d, _ = bound_ms(1536, 148, diag=True)
    assert ms_d - ms == pytest.approx(1e3 * 4 * 1536 * 148 / PEAK_BYTES_PER_S)
    ms, by = bound_ms(1536, 628, diag=True)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 1536 * 2 * 628 ** 3 / 3 / PEAK_F32_FLOPS)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 8, 15, 37, 45, 48, 100, 148, 157, 160])
@pytest.mark.parametrize("B", [37, 1536])
def test_kernel_matches_plain_on_card(cuda_device, n, B):
    rng = np.random.default_rng(n)
    spd = _random_spd if n <= 48 else _equilibrated_spd
    A = torch.tensor(spd(rng, B, n), device=cuda_device)
    before = chol_inv.launches
    out, diag = chol_inv(A, return_diag=True)
    ref, dref = chol_inv_reference(A, return_diag=True)
    torch.cuda.synchronize()
    assert chol_inv.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(diag, dref, rtol=TOL, atol=TOL)
    iu = torch.triu_indices(n, n, offset=1, device=cuda_device)
    assert bool((out[:, iu[0], iu[1]] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [37, 148])
def test_kernel_nan_isolation_on_card(cuda_device, n):
    rng = np.random.default_rng(5)
    A = _random_spd(rng, 37, n)
    A[5] -= 100.0 * np.eye(n) * (n if n > 48 else 1)
    out = chol_inv(torch.tensor(A, device=cuda_device)).cpu().numpy()
    assert np.isnan(out[5]).any()
    assert np.isfinite(np.delete(out, 5, axis=0)).all()


@pytest.mark.cuda
def test_blocked_on_card_matches_f64(cuda_device):
    """The main path's shape: 256 instances x 6 ladder levels of 148, one
    kernel launch."""
    rng = np.random.default_rng(6)
    A = _random_spd(rng, 1536, 148) / 148.0 + 0.5 * np.eye(148)
    A_d = torch.tensor(A, device=cuda_device)
    before = chol_inv.launches
    d, L = blocked_chol_linv(A_d.reshape(256, 6, 148, 148))
    assert chol_inv.launches == before + 1
    L64 = torch.linalg.cholesky(A_d)
    eye = torch.eye(148, dtype=torch.float64, device=cuda_device)
    Linv64 = torch.linalg.solve_triangular(L64, eye.expand_as(A_d),
                                           upper=False)
    torch.testing.assert_close(L.reshape(1536, 148, 148).double(), Linv64,
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(d.reshape(1536, 148).double(),
                               torch.diagonal(L64, dim1=-2, dim2=-1),
                               rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_blocked_on_card_628_is_four_launches(cuda_device):
    """The refined mesh's shape: four diagonal blocks of 157; the first 64
    instances against f64."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    M = torch.randn((1536, 628, 628), generator=gen, device=cuda_device)
    A = torch.baddbmm(torch.eye(628, device=cuda_device).expand(1536, -1, -1),
                      M, M.transpose(-1, -2), beta=0.5, alpha=1.0 / 628)
    del M
    before = chol_inv.launches
    d, L = blocked_chol_linv(A)
    assert chol_inv.launches == before + 4
    A64 = A[:64].double()
    L64 = torch.linalg.cholesky(A64)
    eye = torch.eye(628, dtype=torch.float64, device=cuda_device)
    Linv64 = torch.linalg.solve_triangular(L64, eye.expand_as(A64),
                                           upper=False)
    torch.testing.assert_close(L[:64].double(), Linv64, rtol=TOL, atol=TOL)
