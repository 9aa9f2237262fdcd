"""The port's banded-arrowhead KKT operator against the JAX package.

For the problems of ``tests/unit/test_block_kkt.py`` (cart-pole, a
non-uniform mesh of [3, 5, 4, 6] nodes, brachistochrone, the multiphase
point move, the space shuttle's path constraints, a single-section phase,
and ``derivative_level=1``), each built by both packages, at two random
points per problem made by numpy from a seed (a perturbed guess, random
multipliers, barrier diagonal and dual regularization), batched as B = 2
in the port, in f64 on the CPU:

* ``BlockKKT.assemble``: the exact and the convexified blocks equal the
  JAX package's, instance by instance, to rtol 1e-9 (1e-6 for the
  shuttle, as in the reference test);
* ``kmul`` equals the dense condensed matrix built from the port's
  whole-matrix derivatives, ``K = H + diag(sigma) + dw I + J^T D^-1 J``;
* ``factor`` + ``solve`` on the JAX package's blocks, carried across by
  ``interop.arrow_blocks_from_numpy``, equal JAX's ``solve``, and on the
  port's own blocks the dense solve; the convexified blocks factor at
  dw = 1e-10 and solve consistently with ``kmul``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

from pycollo_tpu.solver.block_kkt import BlockKKT as JaxBlockKKT  # noqa: E402
from pycollo_tpu_torch import interop  # noqa: E402
from pycollo_tpu_torch.solver.block_kkt import BlockKKT  # noqa: E402

torch.set_num_threads(2)

B = 2


def _cart_pole(pkg):
    from importlib import import_module
    return import_module("cart_pole_swing_up" + pkg).build_problem()


def _nonuniform(pkg):
    problem = _cart_pole(pkg)
    mesh = problem.phases[0].mesh
    mesh.number_mesh_sections = 4
    mesh.mesh_section_sizes = [0.2, 0.3, 0.3, 0.2]
    mesh.number_mesh_section_nodes = [3, 5, 4, 6]
    return problem


def _single_section(pkg):
    problem = _cart_pole(pkg)
    problem.phases[0].mesh.number_mesh_sections = 1
    problem.phases[0].mesh.number_mesh_section_nodes = 6
    return problem


def _gauss_newton(pkg):
    problem = _cart_pole(pkg)
    problem.settings.derivative_level = 1
    return problem


def _example(name):
    def build(pkg):
        from importlib import import_module
        return import_module(name + pkg).build_problem()
    return build


#: case -> (function making the problem from "" or "_torch", seed, dw
#: floor, rtol)
CASES = {
    "cart_pole": (_cart_pole, 0, 0.5, 1e-9),
    "nonuniform_mesh": (_nonuniform, 1, 0.25, 1e-9),
    "brachistochrone": (_example("brachistochrone"), 2, 1.0, 1e-9),
    "multiphase_point_move": (_example("multiphase_point_move"), 3, 0.5,
                              1e-9),
    "space_shuttle": (_example("space_shuttle_reentry_trajectory"), 4, 1.0,
                      1e-6),
    "single_section": (_single_section, 5, 0.5, 1e-9),
    "derivative_level_1": (_gauss_newton, 6, 0.5, 1e-9),
}


def _iteration(problem):
    problem.settings.console_out_progress = False
    problem.initialise()
    return problem.backend.mesh_iterations[0]


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * max(1.0, scale))


def _leaves(blocks):
    """(name, array) of every field of ArrowBlocks."""
    out = []
    for p, pb in enumerate(blocks.phases):
        out += [(f"phase{p}.{f}", getattr(pb, f)) for f in pb._fields]
    out += [(f, getattr(blocks, f)) for f in ("B", "Gw", "d_ib", "wmask")]
    out += [(f"zmask{p}", z) for p, z in enumerate(blocks.zmask)]
    return out


def _points(it, seed):
    """B random points: x_full, lam, sig_free, dinv_rows (numpy)."""
    rng = np.random.default_rng(seed)
    n, m = it.n_free, it.layout.m_total
    pts = []
    for _ in range(B):
        x_full = np.array(it.x_full_guess)
        x_full[it.free_idx] += 0.01 * rng.standard_normal(n) \
            * np.maximum(1.0, np.abs(x_full[it.free_idx]))
        pts.append((x_full, rng.standard_normal(m), rng.uniform(0.1, 2.0, n),
                    rng.uniform(0.5, 3.0, m)))
    return [np.stack(a) for a in zip(*pts)]


def _dense_kkt(it, x_full, lam, sig_free, dinv_rows):
    """(B, n, n) dense condensed K at dw = 0 from the port's whole-matrix
    derivatives."""
    xs = ((x_full - it.r_full) / it.V_full)[:, it.free_idx]
    theta = np.where(it.free_mask, 0.0, x_full)
    xs_t, th_t = torch.tensor(xs), torch.tensor(theta)
    J = it.jac_c_scaled(xs_t, th_t).numpy()
    H = it.hess_lag_scaled(xs_t, torch.tensor(lam), th_t).numpy()
    K = H + np.stack([np.diag(s) for s in sig_free])
    return K + np.einsum("bri,br,brj->bij", J, dinv_rows, J)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_kkt_matches_jax(case):
    build, seed, dw_floor, rtol = CASES[case]
    itj = _iteration(build(""))
    itt = _iteration(build("_torch"))
    x_full, lam, sig_free, dinv_rows = _points(itt, seed)
    kt = BlockKKT(itt)
    kj = JaxBlockKKT(itj)
    f64 = dict(dtype=torch.float64)

    # ---- assembly ----------------------------------------------------
    port = kt.assemble(torch.tensor(x_full), torch.tensor(itt.W_c * lam),
                       torch.tensor(sig_free), torch.tensor(dinv_rows))
    ref_all = jax.jit(jax.vmap(kj.assemble))(
        jnp.asarray(x_full), jnp.asarray(itj.W_c * lam),
        jnp.asarray(sig_free), jnp.asarray(dinv_rows))
    ref = [jax.tree_util.tree_map(lambda a: np.asarray(a[b]), ref_all)
           for b in range(B)]
    for v in range(2):                       # exact, convexified
        for (name, got), *refs in zip(_leaves(port[v]),
                                      *(_leaves(r[v]) for r in ref)):
            for b, (_, want) in enumerate(refs):
                static = name.startswith(("zmask", "wmask"))
                try:
                    _close(got.numpy() if static else got[b].numpy(), want,
                           rtol)
                except AssertionError as err:
                    raise AssertionError(
                        f"{('exact', 'convex')[v]} {name}[{b}]") from err

    # ---- kmul against the dense K ------------------------------------
    K = _dense_kkt(itt, x_full, lam, sig_free, dinv_rows)
    dw = np.array([max(dw_floor, 1.0 - np.linalg.eigvalsh(K[b]).min())
                   for b in range(B)])
    K = K + dw[:, None, None] * np.eye(itt.n_free)
    rng = np.random.default_rng(100 + seed)
    v = rng.standard_normal((B, itt.n_free))
    _close(kt.kmul(port[0], torch.tensor(dw), torch.tensor(v)).numpy(),
           np.einsum("bij,bj->bi", K, v), rtol)

    # ---- factor + solve ----------------------------------------------
    rhs = rng.standard_normal((B, itt.n_free))
    fac = kt.factor(port[0], torch.tensor(dw))
    assert fac.ok.all(), "structured factorization not PD"
    _close(kt.solve(port[0], fac, torch.tensor(rhs)).numpy(),
           np.linalg.solve(K, rhs[..., None])[..., 0], max(rtol, 1e-8))
    ref_solve = jax.jit(jax.vmap(
        lambda blk, d, r: kj.solve(blk, kj.factor(blk, d), r)))(
            ref_all[0], jnp.asarray(dw), jnp.asarray(rhs))
    for b in range(B):
        carried = interop.arrow_blocks_from_numpy(ref[b][0])
        fc = kt.factor(carried, torch.tensor(dw[b], **f64))
        assert bool(fc.ok)
        got = kt.solve(carried, fc, torch.tensor(rhs[b:b + 1]))
        _close(got[0].numpy(), ref_solve[b], rtol)

    # ---- the convexified blocks at dw ~ 0 ------------------------------
    dw_c = torch.full((B,), 1e-10, **f64)
    fac_c = kt.factor(port[1], dw_c)
    assert fac_c.ok.all(), "convexified factorization not PD at dw ~ 0"
    dx_c = kt.solve(port[1], fac_c, torch.tensor(rhs))
    res = (kt.kmul(port[1], dw_c, dx_c) - torch.tensor(rhs)).abs().max()
    assert float(res) < 1e-6 * max(1.0, np.abs(rhs).max()), float(res)
