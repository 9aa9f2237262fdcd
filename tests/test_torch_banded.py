"""The port's banded arrowhead factorization against the JAX package.

``pycollo_tpu_torch.solver.banded`` against ``pycollo_tpu.solver.banded``
and ``numpy.linalg.solve`` on random SPD block-tridiagonal stacks and
arrowhead systems made by numpy from a seed, in f64 on the CPU:

* ``btd_factor``, the half solves and ``btd_solve``: the factors and every
  solve equal JAX's to rtol 1e-10, the dense solve to 1e-8; JAX's factors
  carried across by ``interop.btd_factors_from_numpy`` solve the same;
* ``arrow_factor`` + ``arrow_solve`` at one phase, two phases and no
  low-rank rows: JAX to 1e-10, dense to 1e-8;
* ``dw`` lands on the real (mask 1) diagonal entries only;
* an indefinite block fails ``ok`` in its own instance only, and leaves
  the other instances' answers as they are alone (to 1e-12);
* a (B, levels) leading batch of blocks and ``dw`` equals JAX's
  ``vmap`` over the levels, instance by instance, to 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pycollo_tpu.solver import banded as jb
from pycollo_tpu_torch import interop
from pycollo_tpu_torch.solver import banded as tb

torch.set_num_threads(2)

#: port against JAX (same algorithm, f64) and against the dense solve
RTOL_JAX = 1e-10
RTOL_DENSE = 1e-8


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(1.0, scale))


def _random_btd(rng, K, MB, nz, jitter=3.0):
    """Random SPD block-tridiagonal matrix: (D, U) blocks and the dense A."""
    D = rng.standard_normal((K, MB, MB))
    D = 0.5 * (D + np.swapaxes(D, -1, -2))
    U = 0.3 * rng.standard_normal((K, MB, nz))
    U[0] = 0.0
    n = K * MB
    A = np.zeros((n, n))
    for k in range(K):
        A[k * MB:(k + 1) * MB, k * MB:(k + 1) * MB] = D[k]
        if k:
            cols = slice(k * MB - nz, k * MB)
            A[k * MB:(k + 1) * MB, cols] = U[k]
            A[cols, k * MB:(k + 1) * MB] = U[k].T
    shift = jitter + np.abs(A).sum(axis=1).max()    # diagonal dominance
    return D + shift * np.eye(MB)[None], U, A + shift * np.eye(n)


def _random_arrow(rng, phase_dims, nw, nr, zmask=None, wmask=None):
    """numpy ArrowBlocks (the JAX package's record, numpy leaves)."""
    phases = []
    for (K, MB, nz) in phase_dims:
        D, U, _ = _random_btd(rng, K, MB, nz, jitter=5.0 + MB)
        phases.append(jb.PhaseBand(
            Dblk=D, Ublk=U, Cblk=0.1 * rng.standard_normal((K, nw, MB)),
            Gz=0.2 * rng.standard_normal((K, MB, nr))))
    Bw = rng.standard_normal((nw, nw))
    Bw = Bw @ Bw.T + (5.0 + nw) * np.eye(nw)
    return jb.ArrowBlocks(
        phases=tuple(phases), B=Bw, Gw=0.2 * rng.standard_normal((nw, nr)),
        d_ib=rng.uniform(0.5, 2.0, nr),
        zmask=zmask or tuple(np.ones((K, MB)) for (K, MB, _) in phase_dims),
        wmask=np.ones(nw) if wmask is None else wmask)


def _dense_from_arrow(blocks, dw=0.0):
    """Dense K = M + G diag(1/d_ib) G^T + dw diag(mask)."""
    sizes = [pb.Dblk.shape[0] * pb.Dblk.shape[1] for pb in blocks.phases]
    nw = blocks.B.shape[0]
    n = sum(sizes) + nw
    A = np.zeros((n, n))
    off = 0
    G = []
    for pb in blocks.phases:
        K, MB, _ = pb.Dblk.shape
        nz = pb.Ublk.shape[-1]
        for k in range(K):
            sl = slice(off + k * MB, off + (k + 1) * MB)
            A[sl, sl] = pb.Dblk[k]
            if k:
                cols = slice(off + k * MB - nz, off + k * MB)
                A[sl, cols] = pb.Ublk[k]
                A[cols, sl] = pb.Ublk[k].T
            A[n - nw:, sl] += pb.Cblk[k]
            A[sl, n - nw:] += pb.Cblk[k].T
        G.append(pb.Gz.reshape(K * MB, -1))
        off += K * MB
    A[n - nw:, n - nw:] += blocks.B
    G = np.vstack(G + [blocks.Gw])
    A += G @ np.diag(1.0 / blocks.d_ib) @ G.T
    mask = np.concatenate([z.ravel() for z in blocks.zmask] + [blocks.wmask])
    return A + dw * np.diag(mask)


def _split(rhs, phase_dims):
    rz, off = [], 0
    for (K, MB, _) in phase_dims:
        rz.append(rhs[..., off:off + K * MB].reshape(rhs.shape[:-1]
                                                     + (K, MB)))
        off += K * MB
    return rz, rhs[..., off:]


def _flat(dz, dw):
    lead = dw.shape[:-1]
    return np.concatenate([np.asarray(z).reshape(lead + (-1,)) for z in dz]
                          + [np.asarray(dw)], axis=-1)


def _port_solve(blocks, dw, rhs, phase_dims):
    fac = tb.arrow_factor(interop.arrow_blocks_from_numpy(blocks),
                          torch.tensor(dw, dtype=torch.float64))
    rz, rw = _split(rhs, phase_dims)
    dz, dwv = tb.arrow_solve(fac, [_t(z) for z in rz], _t(rw))
    return fac, _flat([z.numpy() for z in dz], dwv.numpy())


def _jax_solve(blocks, dw, rhs, phase_dims):
    fac = jb.arrow_factor(blocks, jnp.asarray(dw))
    rz, rw = _split(rhs, phase_dims)
    dz, dwv = jb.arrow_solve(fac, [jnp.asarray(z) for z in rz],
                             jnp.asarray(rw))
    return fac, _flat(dz, dwv)


def test_btd_factor_and_solves_match_jax_and_dense():
    rng = np.random.default_rng(0)
    K, MB, nz = 6, 9, 3
    D, U, A = _random_btd(rng, K, MB, nz)
    rhs = rng.standard_normal((K, MB, 2))
    fj = jb.btd_factor(jnp.asarray(D), jnp.asarray(U))
    ft = tb.btd_factor(_t(D), _t(U))
    assert bool(ft.ok) and bool(fj.ok)
    _close(ft.L.numpy(), fj.L, RTOL_JAX)
    _close(ft.F.numpy(), fj.F, RTOL_JAX)
    y_j = jb.btd_half_fwd(fj, jnp.asarray(rhs))
    _close(tb.btd_half_fwd(ft, _t(rhs)).numpy(), y_j, RTOL_JAX)
    _close(tb.btd_half_bwd(ft, _t(np.asarray(y_j))).numpy(),
           jb.btd_half_bwd(fj, y_j), RTOL_JAX)
    x = tb.btd_solve(ft, _t(rhs)).numpy()
    _close(x, jb.btd_solve(fj, jnp.asarray(rhs)), RTOL_JAX)
    _close(x.reshape(K * MB, 2),
           np.linalg.solve(A, rhs.reshape(K * MB, 2)), RTOL_DENSE)
    # JAX's own factors, carried across, solve the same
    fc = interop.btd_factors_from_numpy(fj)
    _close(tb.btd_solve(fc, _t(rhs)).numpy(), x, RTOL_JAX)


def test_btd_indefinite_block_fails_its_instance_only():
    rng = np.random.default_rng(2)
    K, MB, nz = 3, 4, 2
    stacks = [_random_btd(rng, K, MB, nz) for _ in range(3)]
    D = np.stack([s[0] for s in stacks])
    U = np.stack([s[1] for s in stacks])
    D[1, 1, 0, 0] = -1e3                     # one block of instance 1
    ft = tb.btd_factor(_t(D), _t(U))
    ok_j = [bool(jb.btd_factor(jnp.asarray(D[b]), jnp.asarray(U[b])).ok)
            for b in range(3)]
    assert ok_j == [True, False, True]
    assert ft.ok.tolist() == ok_j
    rhs = rng.standard_normal((3, K, MB, 1))
    x = tb.btd_solve(ft, _t(rhs)).numpy()
    for b in (0, 2):
        _close(x[b].reshape(-1), np.linalg.solve(stacks[b][2],
                                                 rhs[b].reshape(-1)),
               RTOL_DENSE)


CASES = {
    "one phase": ([(5, 8, 2)], 4, 2),
    "two phases": ([(3, 6, 3), (4, 4, 2)], 5, 3),
    "no low-rank rows": ([(4, 6, 2)], 3, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_arrow_factor_solve_matches_jax_and_dense(case):
    phase_dims, nw, nr = CASES[case]
    rng = np.random.default_rng(42)
    blocks = _random_arrow(rng, phase_dims, nw, nr)
    A = _dense_from_arrow(blocks)
    rhs = rng.standard_normal(A.shape[0])
    ft, x = _port_solve(blocks, 0.0, rhs, phase_dims)
    fj, x_j = _jax_solve(blocks, 0.0, rhs, phase_dims)
    assert bool(ft.ok) and bool(fj.ok)
    for name in ("L11", "S12", "L22", "dwq", "dy"):
        _close(getattr(ft, name).numpy(), getattr(fj, name), RTOL_JAX)
    _close(x, x_j, RTOL_JAX)
    _close(x, np.linalg.solve(A, rhs), RTOL_DENSE)


def test_arrow_dw_lands_on_real_entries_only():
    rng = np.random.default_rng(3)
    zmask = np.ones((3, 4))
    zmask[0, 1] = zmask[2, 3] = 0.0
    wmask = np.array([1.0, 0.0, 1.0])
    blocks = _random_arrow(rng, [(3, 4, 2)], 3, 1, zmask=(zmask,),
                           wmask=wmask)
    dw = 7.5
    A = _dense_from_arrow(blocks, dw)
    rhs = rng.standard_normal(A.shape[0])
    _, x = _port_solve(blocks, dw, rhs, [(3, 4, 2)])
    _, x_j = _jax_solve(blocks, dw, rhs, [(3, 4, 2)])
    _close(x, x_j, RTOL_JAX)
    _close(x, np.linalg.solve(A, rhs), RTOL_DENSE)


def test_arrow_indefinite_border_fails_its_instance_only():
    dims = [(3, 4, 2)]
    insts = [_random_arrow(np.random.default_rng(s), dims, 3, 1)
             for s in range(3)]
    Bbad = insts[1].B.copy()
    Bbad[0, 0] = -1e3
    insts[1] = insts[1]._replace(B=Bbad)
    stacked = jb.ArrowBlocks(
        phases=(jb.PhaseBand(*(np.stack([getattr(b.phases[0], f)
                                         for b in insts])
                               for f in jb.PhaseBand._fields)),),
        B=np.stack([b.B for b in insts]), Gw=np.stack([b.Gw for b in insts]),
        d_ib=np.stack([b.d_ib for b in insts]), zmask=insts[0].zmask,
        wmask=insts[0].wmask)
    rhs = np.random.default_rng(9).standard_normal((3, 15))
    ft, x = _port_solve(stacked, np.zeros(3), rhs, dims)
    ok_j = [bool(jb.arrow_factor(b, jnp.asarray(0.0)).ok) for b in insts]
    assert ok_j == [True, False, True]
    assert ft.ok.tolist() == ok_j
    for b in (0, 2):
        _, alone = _port_solve(insts[b], 0.0, rhs[b], dims)
        _close(x[b], alone, 1e-12)
        _close(x[b], _jax_solve(insts[b], 0.0, rhs[b], dims)[1], RTOL_JAX)


def test_arrow_batch_over_instances_and_levels_matches_jax_vmap():
    """(B, levels) stacks in one call, as the solver's speculative ladder
    factors them; JAX vmaps over the levels of each instance."""
    dims = [(3, 4, 2), (2, 5, 2)]
    B, levels = 2, 3
    insts = [_random_arrow(np.random.default_rng(10 + b), dims, 4, 2)
             for b in range(B)]
    dws = np.array([[0.0, 1.0, 10.0], [0.5, 3.0, 30.0]])

    def lv(arrs):      # (B, levels, ...) with the blocks repeated
        return np.repeat(np.stack(arrs)[:, None], levels, axis=1)

    stacked = jb.ArrowBlocks(
        phases=tuple(jb.PhaseBand(*(lv([getattr(b.phases[p], f)
                                        for b in insts])
                                    for f in jb.PhaseBand._fields))
                     for p in range(len(dims))),
        B=lv([b.B for b in insts]), Gw=lv([b.Gw for b in insts]),
        d_ib=lv([b.d_ib for b in insts]), zmask=insts[0].zmask,
        wmask=insts[0].wmask)
    rng = np.random.default_rng(11)
    n = sum(K * MB for K, MB, _ in dims) + 4
    rhs = rng.standard_normal((B, levels, n))
    ft, x = _port_solve(stacked, dws, rhs, dims)
    assert ft.ok.shape == (B, levels) and bool(ft.ok.all())
    for b in range(B):
        rz, rw = _split(rhs[b], dims)
        facs = jax.vmap(lambda d: jb.arrow_factor(insts[b], d))(
            jnp.asarray(dws[b]))
        dz, dwv = jax.vmap(jb.arrow_solve)(
            facs, [jnp.asarray(z) for z in rz], jnp.asarray(rw))
        _close(x[b], _flat(dz, dwv), RTOL_JAX)
        for lvl in range(levels):
            A = _dense_from_arrow(insts[b], dws[b, lvl])
            _close(x[b, lvl], np.linalg.solve(A, rhs[b, lvl]), RTOL_DENSE)
