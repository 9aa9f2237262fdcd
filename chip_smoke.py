"""Smoke run of the PyTorch/CUDA port (``pycollo_tpu_torch``) on one GPU.

Run from the root of the repository, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: requires ``torch.cuda.is_available()`` (no CPU fallback) and
   prints the card's name and power limit as ``nvidia-smi`` reports them;
2. build: compiles ``pycollo_tpu_torch/csrc/chol_linv.cu`` with ``nvcc``;
3. kernel: holds the Cholesky-inverse kernel against its plain PyTorch
   version on the card at n from 3 to its limit of 160 (``KERNEL_NS``),
   with NaN isolation, the refusal of n = 161 and the one-launch
   factorization of an equilibrated (1536, 148, 148) stack against f64;
   then times it, its plain version and the library route at the paths'
   shapes, and ``blocked_chol_linv`` by default against the earlier
   blocking and the library route (``pycollo_tpu_torch/ops/bench_chol.py``);
4. slice: builds cart-pole swing-up on the default mesh through the port,
   solves a batch of 256 perturbed instances on the card through the
   kernel, one launch per factorization call of the (B * 6, 148, 148)
   ladder stack, and re-solves 8 of them on the CPU through the plain f64 path
   (no kernel, exact Newton steps), whose objectives at least 7 of the 8
   must match to 1e-4; the mixed path on the CPU (the kernel's plain
   version) is re-solved too, and its agreement printed;
5. refine: ``problem.solve(device="cuda")`` (the ph-adaptive mesh
   refinement loop, every NLP solve on the card in float64) on the
   brachistochrone, cart-pole swing-up and the hypersensitive problem at
   their published sizes, each held against its stored float64 oracle
   (``tests/data/trajectory_*.npz``: objective to 1e-6, states and controls
   to 1e-5, 1e-4 for the hypersensitive problem, see ``REFINE_PROBLEMS``),
   the brachistochrone also against GPOPS-II's 0.82434 (1e-4);
   then a batch of 256 perturbed cart-pole instances on the refined mesh
   through the kernel (mixed path; four diagonal blocks of 157, so four
   launches per factorization call), converging at least
   ``REFINED_CONVERGED_MIN``; the same batch through the f64 path on the
   card, whose first 8 instances are re-solved on the CPU in f64 (all
   converged, at least 7 of 8 objectives matching to 1e-4); and the mixed
   solve once more with the kernel's plain version in its place: the
   kernel's share of answers agreeing with the f64 path may fall short of
   the plain version's by at most ``REFINED_AGREE_MARGIN``;
6. banded: the block-banded path (``linear_solver="block-banded"``, f64,
   ``IPMOptions(tol=1e-6, max_iter=80)`` as ``bench.py`` builds it), which
   launches no hand-written kernel: a batch of 64 perturbed default-mesh
   cart-pole instances (at least ``BANDED_CONVERGED_MIN`` converged, KKT
   at most 1e-6 on those, and the first 8 re-solved on the CPU through the
   dense f64 path, at least 7 of 8 objectives matching to 1e-4), with
   launches per IPM iteration from ``torch.profiler`` over the first
   ``BANDED_PROFILE_ITERS`` iterations;
   ``problem.solve(device="cuda")`` on the brachistochrone (GPOPS-II's
   0.82434 to 1e-4, mesh tolerance met); and the first 64 instances of the
   refined-mesh batch, held against the dense f64 path on the card (at
   least ``BANDED_REFINED_REF - 1`` of the first 8 converged, the JAX
   package's count there from ``scripts/banded_refined_reference.py``, and
   at least 7 of the first 8 both converge agreeing to 1e-4);
7. multi: the multi-device layer (``pycollo_tpu_torch/parallel/``):
   (a) ``dryrun_multichip`` over four shards of the card (and over the
   distinct cards where there are several); (b) the slice's batch of 256
   in two shards on the card (threads, a stream each) through the kernel,
   at the slice's gates (converged >= 0.99, KKT p99 <= 1e-6), one launch
   per factorization call of either shard, its agreement with the
   unsharded slice run and solves/s of one shard and of two printed, and
   its first ``MULTI_F64`` instances through the f64 path sharded and
   unsharded, objectives equal to 1e-8; (c) two ranks of a gloo process
   group on the one card (``run_local_ranks`` starts this script with
   ``--rank``), 128 instances each through ``solve_batched_global``:
   both report the global batch and the same converged count, and rank
   0's objectives equal a single-process solve of its 128 on the card to
   1e-10; ``measure_multihost_scaling``'s two rates printed; (d) NCCL with
   one rank per card, rank 0 equal to the single-process solve.

Each phase prints its wall time.  The line before the last is a JSON
object describing every kernel of the path; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: f32 tolerance of the kernel against its plain version
KERNEL_TOL = 2e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(f"card: {card}", flush=True)
    return card


def phase_build():
    from pycollo_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load("chol_linv.cu")
    print(f"build: chol_linv.cu built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


#: block sizes held against the plain version: small blocks, the solver's
#: blocks (37 and 45 of the earlier blocking, 148 of the default mesh in
#: one block, 157 of the refined mesh), 48, 100 and the kernel's limit
KERNEL_NS = (3, 8, 15, 37, 45, 48, 100, 148, 157, 160)
KERNEL_BATCHES = (37, 1536)
#: the shapes the kernel is timed at: (1536, n, n) for these n
TIMED_NS = (37, 45, 148, 157)


def _spd(rng, b, n):
    """SPD stack ``M M^T + 0.5 I``; beyond n = 48 the product is divided
    by n, so the condition number stays about 10 as for the solver's
    Jacobi-equilibrated matrices (the unscaled one grows as 8 n)."""
    M = rng.standard_normal((b, n, n))
    A = M @ np.swapaxes(M, -1, -2)
    return (A / n if n > 48 else A) + 0.5 * np.eye(n)


def phase_kernel():
    import torch
    from pycollo_tpu_torch.ops import bench_chol
    from pycollo_tpu_torch.ops.block_chol import (MAX_BLOCK_N,
                                                  blocked_chol_linv, chol_inv,
                                                  chol_inv_reference)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n in KERNEL_NS:
        for B in KERNEL_BATCHES:
            A = torch.tensor(_spd(rng, B, n), device=dev)
            out, diag = chol_inv(A, return_diag=True)
            ref, dref = chol_inv_reference(A, return_diag=True)
            torch.cuda.synchronize()
            check(out.dtype == torch.float32 and out.shape == (B, n, n)
                  and diag.shape == (B, n),
                  f"chol_inv output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()),
                  f"chol_inv non-finite at B={B} n={n}")
            err = float((out - ref).abs().max())
            ok = torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)
            check(ok, f"chol_inv vs plain at B={B} n={n}: max err {err:.3e}")
            check(torch.allclose(diag, dref, rtol=KERNEL_TOL, atol=KERNEL_TOL),
                  f"chol_inv diag(L) vs plain at B={B} n={n}")
            iu = torch.triu_indices(n, n, offset=1, device=dev)
            check(bool((out[:, iu[0], iu[1]] == 0).all()),
                  f"chol_inv nonzero above the diagonal at B={B} n={n}")
            print(f"kernel: chol_inv B={B} n={n} max|kernel-plain| = "
                  f"{err:.3e}", flush=True)
    # Non-PD isolation: one indefinite instance, NaN there only.
    for n in (37, 148):
        A = _spd(rng, 37, n)
        A[5] -= 100.0 * np.eye(n)
        out = chol_inv(torch.tensor(A, device=dev)).cpu().numpy()
        check(np.isnan(out[5]).any(), f"indefinite instance not NaN, n={n}")
        check(np.isfinite(np.delete(out, 5, axis=0)).all(),
              f"NaN leaked outside the indefinite instance, n={n}")
    try:
        chol_inv(torch.eye(MAX_BLOCK_N + 1, device=dev)[None])
    except ValueError:
        pass
    else:
        raise SmokeFailure(f"chol_inv took n = {MAX_BLOCK_N + 1}")
    print(f"kernel: NaN isolation ok at n = 37 and 148; n = "
          f"{MAX_BLOCK_N + 1} refused", flush=True)

    # blocked_chol_linv at the main path's shape, against f64, after Jacobi
    # equilibration (what the solver factors): one kernel launch.
    A = _spd(rng, 1536, 148)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", A))
    A = A * d[:, :, None] * d[:, None, :]
    A_d = torch.tensor(A, device=dev)
    before = chol_inv.launches
    diag_L, Linv = blocked_chol_linv(A_d)
    check(chol_inv.launches - before == 1,
          f"blocked_chol_linv at n = 148 launched the kernel "
          f"{chol_inv.launches - before} times, not once")
    L64 = torch.linalg.cholesky(A_d)
    eye = torch.eye(148, dtype=torch.float64, device=dev).expand_as(A_d)
    Linv64 = torch.linalg.solve_triangular(L64, eye, upper=False)
    torch.cuda.synchronize()
    err_blk = float((Linv.double() - Linv64).abs().max())
    check(err_blk < KERNEL_TOL, f"blocked_chol_linv vs f64: {err_blk:.3e}")
    check(bool(torch.allclose(diag_L.double(),
                              torch.diagonal(L64, dim1=-2, dim2=-1),
                              rtol=KERNEL_TOL, atol=KERNEL_TOL)),
          "blocked_chol_linv diagonal vs f64")
    R = Linv.double() @ A_d @ Linv.double().transpose(-1, -2)
    err_id = float((R - eye).abs().max())
    check(err_id < 5e-4, f"blocked_chol_linv L^-1 A L^-T - I: {err_id:.3e}")
    print(f"kernel: blocked_chol_linv (1536,148,148) in one launch: "
          f"max|Linv-f64| = {err_blk:.3e}, max|L^-1 A L^-T - I| = "
          f"{err_id:.3e}", flush=True)

    # Times at the paths' shapes (ops/bench_chol.py), fresh inputs.
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {n: bench_chol.kernel_row(1536, n, gen) for n in TIMED_NS}
    for n in TIMED_NS:
        print(f"kernel: timing {bench_chol.format_kernel_row(rows[n])}",
              flush=True)
    for r in bench_chol.blocked_rows(gen):
        print(f"kernel: timing {bench_chol.format_blocked_row(r)}",
              flush=True)
    main = rows[148]
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by")}


#: the mixed-precision configuration ``bench.py`` scores
SLICE_OPTIONS = dict(tol=1e-6, max_iter=80, kkt_precision="mixed",
                     dc_floor=1e-7, dense_gmres_iters=12, eval_dtype="f32")
SLICE_BATCH = 256
#: instances re-solved on the CPU through the plain path
CPU_CHECK = 8
#: The problem is nonconvex, and the mixed path takes inexact Newton steps
#: whose rounding differs between the kernel and its plain version, so an
#: instance can settle in a neighbouring local solution (as in
#: tests/integration/test_mixed_precision.py): one of the 8 may differ.
CPU_AGREE = 7


def _theta_chunk(it, B, seed):
    """Perturbed initial states (the recipe of ``bench.py``): q1_0 in
    [-0.25, 0.25], q2_0 in [-0.3, 0.3]."""
    rng = np.random.default_rng(seed)
    pl = it.layout.phases[0]
    theta = np.tile(it.theta_default, (B, 1))
    theta[:, pl.y_off + 0 * pl.N] = rng.uniform(-0.25, 0.25, B)
    theta[:, pl.y_off + 1 * pl.N] = rng.uniform(-0.3, 0.3, B)
    return theta


def _slice_problem():
    """Cart-pole on the default mesh, its solver built with
    ``SLICE_OPTIONS``."""
    sys.path.insert(0, str(ROOT / "examples"))
    from cart_pole_swing_up_torch import build_problem
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.settings.nlp_tolerance = 1e-6
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    check(it.layout.phases[0].N == 31 and it.n_free == 148,
          f"unexpected cart-pole size N={it.layout.phases[0].N} "
          f"n={it.n_free}")
    it.build_solver(IPMOptions(**SLICE_OPTIONS))
    return problem, it


def phase_slice():
    import torch
    from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv, chol_inv
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    t0 = time.perf_counter()
    problem, it = _slice_problem()
    print(f"slice: cart-pole built (N=31, n=148) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cuda = [torch.device("cuda")]

    # Warm-up on a chunk that the measured run does not reuse.
    warm = solve_batched(problem.backend, devices=cuda,
                         theta_batch=_theta_chunk(it, SLICE_BATCH, 1000))
    print(f"slice: warm-up solve {warm.solve_time:.3f} s", flush=True)

    theta = _theta_chunk(it, SLICE_BATCH, 0)
    chol_inv.launches = 0
    blocked_chol_linv.calls = 0
    res = solve_batched(problem.backend, devices=cuda, theta_batch=theta)
    launches = chol_inv.launches
    calls = blocked_chol_linv.calls
    check(launches > 0, "the GPU solve launched the chol_inv kernel 0 times")
    # The (B * 6, 148, 148) ladder stack is one block: one launch per call.
    check(launches == calls,
          f"{launches} chol_inv launches for {calls} factorization calls")
    check(res.x_full.shape == (SLICE_BATCH, it.layout.n_full)
          and np.isfinite(res.x_full).all(),
          "non-finite or misshapen solutions")
    conv = float(res.converged.mean())
    iters = float(res.iterations.mean())
    kkt99 = float(np.quantile(res.kkt_error, 0.99))
    rate = SLICE_BATCH / res.solve_time
    check(conv >= 0.99, f"converged fraction {conv} < 0.99")

    def cpu_agreement(options):
        cpu = solve_batched(problem.backend, devices=[torch.device("cpu")],
                            theta_batch=theta[:CPU_CHECK],
                            options=IPMOptions(**options))
        check(cpu.converged.all(), f"CPU re-solve ({options}) not converged")
        rel = np.abs(cpu.objective - res.objective[:CPU_CHECK]) \
            / np.abs(cpu.objective)
        return int((rel < 1e-4).sum()), rel

    agree64, rel64 = cpu_agreement(dict(tol=1e-6, max_iter=80))
    agree_mx, rel_mx = cpu_agreement(SLICE_OPTIONS)
    print(f"slice: GPU objectives vs CPU f64 re-solves, relative: {rel64}",
          flush=True)
    print(f"slice: GPU objectives vs CPU mixed re-solves (plain version of "
          f"the kernel), relative: {rel_mx}", flush=True)
    check(agree64 >= CPU_AGREE,
          f"only {agree64}/{CPU_CHECK} CPU f64 re-solves agree to 1e-4")
    return dict(launches=launches, calls=calls, conv=conv, iters=iters,
                kkt99=kkt99, rate=rate, solve_s=res.solve_time,
                agree64=agree64, agree_mx=agree_mx, problem=problem,
                theta=theta, res=res)


#: (name, example module, stored oracle, trajectory tolerance) of the
#: refinement phase.  The tolerances are those of
#: tests/integration/test_trajectory_oracle.py (objective 1e-6, states and
#: controls 1e-5), except for the hypersensitive problem's trajectories:
#: its final-mesh NLP solved by the JAX package on the CPU and by the port
#: on the card differ by 2.2e-5 in the state near t = 9950, both at KKT
#: errors below 1e-8, and the JAX package's own CPU solve is 9.3e-6 off
#: the stored oracle; so they are held at 1e-4 (PERF.md, Findings).
REFINE_PROBLEMS = (
    ("brachistochrone", "brachistochrone_torch", "brachistochrone", 1e-5),
    ("cart-pole", "cart_pole_swing_up_torch", "cart_pole", 1e-5),
    ("hypersensitive", "hypersensitive_problem_torch", "hypersensitive",
     1e-4))
ORACLE_OBJ_RTOL = 1e-6
GPOPS_BRACHISTOCHRONE = 0.82434
#: least converged fraction of the refined-mesh batch (K=21, N=127,
#: n_free=628).  The JAX package's mixed path does not reach 0.99 there:
#: on the CPU it converges 167 of these 256 instances through its library
#: f32 Cholesky, and 37 through its blocked explicit-inverse factorization
#: (``blocked_chol_linv``, the route of its Pallas kernel, which
#: ``chol_inv`` ports).  The port is held to what the reference reaches on
#: the same route (PERF.md, Findings).
REFINED_CONVERGED_MIN = 37 / 256
#: On the refined mesh the mixed path settles in another local solution
#: than the f64 path on about a third of the instances both converge,
#: whatever the f32 factorization: on two batches of 256, 59-68 % agree
#: to 1e-4 through the kernel, through its plain version in the same
#: blocking and through cuSOLVER's whole-matrix Cholesky alike, and the
#: first 8 both converge agree 2-7 of 8 (scripts/escalation_probe_torch.py,
#: PERF.md, Findings).  So the kernel is held to its plain version there:
#: the batch is solved a second time with the plain version in place of the
#: kernel, and the kernel's share of instances agreeing with the f64 path
#: may fall short of the plain version's by at most this much (about two
#: standard deviations of the difference at ~190 instances).
REFINED_AGREE_MARGIN = 0.10


def _hold_to_oracle(name, solution, oracle, traj_tol):
    """Objective, end times, states and controls of phase 0 against a
    stored float64 oracle, normalised as test_trajectory_oracle.py does."""
    stored = np.load(ROOT / "tests" / "data" / f"trajectory_{oracle}.npz")
    obj_ref = float(stored["objective"])
    obj_err = abs(solution.objective - obj_ref) / abs(obj_ref)
    check(obj_err <= ORACLE_OBJ_RTOL,
          f"{name}: objective {solution.objective!r} vs oracle {obj_ref!r} "
          f"(relative {obj_err:.3e})")
    y_q, u_q = solution.interpolate_phase(0, stored["tau"])
    errs = {}
    for got, ref, label in ((y_q, stored["y"], "state"),
                            (u_q, stored["u"], "control")):
        check(got.shape == ref.shape and np.isfinite(got).all(),
              f"{name}: {label} trajectory {got.shape}, finite "
              f"{np.isfinite(got).all()}")
        scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1.0)
        err = np.abs(got - ref) / scale
        errs[label] = float(err.max())
        at = float(stored["tau"][err.max(axis=0).argmax()])
        check(errs[label] <= traj_tol,
              f"{name}: {label} trajectory off the oracle by "
              f"{errs[label]:.3e} (at tau {at:.3f})")
    for label, got, key in (("t0", solution.initial_time[0], "t0"),
                            ("tF", solution.final_time[0], "tF")):
        check(abs(float(got) - float(stored[key])) <= traj_tol,
              f"{name}: {label} {got} vs oracle {float(stored[key])}")
    return obj_err, errs


def _refine_one(name, module, oracle, traj_tol):
    import importlib

    import torch
    problem = importlib.import_module(module).build_problem()
    problem.settings.console_out_progress = False
    t0 = time.perf_counter()
    solution = problem.solve(device=torch.device("cuda"))
    wall = time.perf_counter() - t0
    check(problem.mesh_tolerance_met, f"{name}: mesh tolerance not met")
    for r in problem.mesh_iterations:
        it = r.iteration
        spans = it.profiler.spans
        solve_s = spans["NLP solve"].duration
        build_s = sum(sp.duration for key, sp in spans.items()
                      if key != "NLP solve")
        check(r.ipm_result.x.device.type == "cuda",
              f"{name}: mesh iteration {it.number} solved on "
              f"{r.ipm_result.x.device}")
        print(f"refine: {name} mesh iteration {it.number}: "
              f"K={[t.K for t in it.tables]} N={[t.N for t in it.tables]} "
              f"n_free={it.n_free} IPM iterations "
              f"{int(r.ipm_result.iterations)} KKT "
              f"{float(r.ipm_result.kkt_error):.3e} build {build_s:.3f} s "
              f"solve {solve_s:.3f} s", flush=True)
    obj_err, errs = _hold_to_oracle(name, solution, oracle, traj_tol)
    if name == "brachistochrone":
        gp = abs(solution.objective - GPOPS_BRACHISTOCHRONE) \
            / GPOPS_BRACHISTOCHRONE
        check(gp <= 1e-4, f"brachistochrone objective "
              f"{solution.objective} vs GPOPS-II 0.82434: {gp:.3e}")
    print(f"refine: {name}: {len(problem.mesh_iterations)} mesh iterations "
          f"in {wall:.3f} s on the card; objective {solution.objective!r} "
          f"(oracle relative {obj_err:.3e}); max trajectory error state "
          f"{errs['state']:.3e}, control {errs['control']:.3e}", flush=True)
    return problem


def _agreeing(a, b):
    """Per instance of a (the first len(a) of b): both converged, and the
    objectives agree to 1e-4 relative."""
    k = len(a.objective)
    return a.converged & b.converged[:k] & (
        np.abs(a.objective - b.objective[:k])
        < 1e-4 * np.abs(b.objective[:k]))


def _refined_batch(problem):
    """The kernel on the refined mesh: a batch of perturbed instances of
    the last mesh iteration through the mixed path, as phase_slice, held
    against the f64 path (on the card for the whole batch, confirmed on
    the CPU for the first CPU_CHECK instances) and against the same solve
    with the kernel's plain version."""
    import torch
    from pycollo_tpu_torch.ops import block_chol
    from pycollo_tpu_torch.ops.block_chol import (MAX_BLOCK_N,
                                                  blocked_chol_linv, chol_inv)
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    it = problem.backend.mesh_iterations[-1]
    theta = _theta_chunk(it, SLICE_BATCH, 0)
    cuda = [torch.device("cuda")]
    mixed = IPMOptions(**SLICE_OPTIONS)
    f64 = IPMOptions(tol=1e-6, max_iter=80)
    chol_inv.launches = 0
    blocked_chol_linv.calls = 0
    res = solve_batched(problem.backend, devices=cuda, theta_batch=theta,
                        options=mixed)
    launches = chol_inv.launches
    calls = blocked_chol_linv.calls
    nv = it._solver.dims["nv"]
    blocks = -(-nv // MAX_BLOCK_N)
    conv = float(res.converged.mean())
    print(f"refine: refined-mesh batch: K={it.tables[0].K} "
          f"N={it.tables[0].N} n_free={it.n_free}, "
          f"{blocks} diagonal blocks of the {nv}x{nv} condensed matrix; "
          f"batch {SLICE_BATCH} solved in {res.solve_time:.3f} s = "
          f"{SLICE_BATCH / res.solve_time:.2f} solves/s; converged "
          f"{conv:.4f}, mean iterations {float(res.iterations.mean()):.2f}, "
          f"max {int(res.iterations.max())}, KKT p99 "
          f"{float(np.quantile(res.kkt_error, 0.99)):.3e}; chol_inv "
          f"launches {launches} in {calls} factorization calls",
          flush=True)
    check(launches > 0, "the refined-mesh batch launched chol_inv 0 times")
    check(launches == blocks * calls,
          f"refined mesh: {launches} chol_inv launches for {calls} "
          f"factorization calls of {blocks} blocks")
    check(res.x_full.shape == (SLICE_BATCH, it.layout.n_full)
          and np.isfinite(res.x_full).all(),
          "refined-mesh batch: non-finite or misshapen solutions")
    check(conv >= REFINED_CONVERGED_MIN,
          f"refined-mesh batch: converged fraction {conv} < "
          f"{REFINED_CONVERGED_MIN}")

    # The f64 path from the same guess: on the card for the whole batch
    # (no kernel), and on the CPU for the first CPU_CHECK instances, which
    # must converge and agree with the card's.
    ref = solve_batched(problem.backend, devices=cuda, theta_batch=theta,
                        options=f64)
    cpu = solve_batched(problem.backend, devices=[torch.device("cpu")],
                        theta_batch=theta[:CPU_CHECK], options=f64)

    ref_cpu = _agreeing(cpu, ref)
    print(f"refine: refined-mesh f64 path on the card: converged "
          f"{float(ref.converged.mean()):.4f} in {ref.solve_time:.3f} s; "
          f"the first {CPU_CHECK} re-solved on the CPU in f64: converged "
          f"{int(cpu.converged.sum())}, agreeing to 1e-4 "
          f"{int(ref_cpu.sum())}", flush=True)
    check(cpu.converged.all(), "refined-mesh CPU f64 re-solve not converged")
    check(ref_cpu.sum() >= CPU_AGREE,
          f"refined mesh: only {int(ref_cpu.sum())}/{CPU_CHECK} CPU f64 "
          f"re-solves agree with the f64 path on the card")

    # The same mixed solve with the kernel's plain version in its place.
    saved = block_chol.chol_inv
    block_chol.chol_inv = block_chol.chol_inv_reference
    try:
        plain = solve_batched(problem.backend, devices=cuda,
                              theta_batch=theta, options=mixed)
    finally:
        block_chol.chol_inv = saved
    shares = {}
    for name, r in (("kernel", res), ("plain version", plain)):
        both = r.converged & ref.converged
        shares[name] = _agreeing(r, ref).sum() / both.sum()
        first = np.flatnonzero(both)[:CPU_CHECK]
        print(f"refine: refined-mesh batch through the {name}: converged "
              f"{float(r.converged.mean()):.4f} in {r.solve_time:.3f} s; "
              f"of {int(both.sum())} instances it and the f64 path both "
              f"converge, {int(_agreeing(r, ref).sum())} = "
              f"{shares[name]:.4f} agree to 1e-4 (first {CPU_CHECK} of "
              f"them: {int(_agreeing(r, ref)[first].sum())})", flush=True)
    check(shares["kernel"] >= shares["plain version"] - REFINED_AGREE_MARGIN,
          f"refined mesh: the kernel's share of answers agreeing with the "
          f"f64 path, {shares['kernel']:.4f}, falls short of the plain "
          f"version's {shares['plain version']:.4f} by more than "
          f"{REFINED_AGREE_MARGIN}")
    return dict(launches=launches, calls=calls, theta=theta, ref=ref)


def phase_refine():
    sys.path.insert(0, str(ROOT / "examples"))
    problems = {spec[0]: _refine_one(*spec) for spec in REFINE_PROBLEMS}
    return dict(_refined_batch(problems["cart-pole"]),
                problem=problems["cart-pole"])


#: the configuration ``bench.py`` builds the block-banded path with (f64)
BANDED_OPTIONS = dict(tol=1e-6, max_iter=80)
BANDED_BATCH = 64
#: least converged fraction of a default-mesh banded batch
#: (tests/integration/test_block_banded_solve.py:86)
BANDED_CONVERGED_MIN = 0.85
#: instances of the first 8 of the refined-mesh batch (K=21, N=127,
#: n_free=628) that the JAX package's banded path converges on the CPU
#: (scripts/banded_refined_reference.py; PERF.md, Findings); the card must
#: converge at least this many less one
BANDED_REFINED_REF = 8
#: profiler ranges of the structured step (solver/ipm.py)
BANDED_RANGES = ("banded.assemble", "banded.factor", "banded.gmres",
                 "banded.corrector", "banded.escalation")


#: IPM iterations of the profiled window: processing the trace takes
#: ~10 s per iteration on the default mesh and ~16 s on the refined one
#: (a whole batch's, minutes); the counts per iteration barely move (7,497
#: kernels per iteration over a whole batch, 7,517 over 6 iterations)
BANDED_PROFILE_ITERS = 3


def _banded_profile(problem, theta):
    """The first ``BANDED_PROFILE_ITERS`` IPM iterations of the batch under
    ``torch.profiler``: device operations (kernels and copies) and
    kernel-launch calls per iteration, the device's busy share of the window, host time and device
    span of each structured-step range, and the kernels that take the most
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions
    opts = IPMOptions(**dict(BANDED_OPTIONS, max_iter=BANDED_PROFILE_ITERS))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        res = solve_batched(problem.backend, theta_batch=theta,
                            devices=[torch.device("cuda")], options=opts)
    ka = prof.key_averages()
    total_s = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    cuda_ev = [e for e in ka if e.device_type == DeviceType.CUDA]
    n_it = int(res.iterations.max())
    kernels = sum(e.count for e in cuda_ev)
    api = sum(e.count for e in ka
              if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                           "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    ranges = {}
    for e in ka:
        if e.key in BANDED_RANGES:
            host, dev = ranges.get(e.key, (0.0, 0.0))
            if e.device_type == DeviceType.CUDA:
                dev = dev_us(e) / 1e6
            else:
                host = e.cpu_time_total / 1e6
            ranges[e.key] = (host, dev)
    top = sorted((e for e in cuda_ev if e.key not in BANDED_RANGES),
                 key=dev_us, reverse=True)[:8]
    return dict(kernels=kernels, api=api, n_it=n_it, total_s=total_s,
                busy_s=sum(dev_us(e) for e in cuda_ev
                           if e.key not in BANDED_RANGES) / 1e6,
                wall_s=res.solve_time, ranges=ranges,
                top=[(e.key, e.count, dev_us(e) / 1e6) for e in top])


def _print_profile(label, pr):
    n = pr["n_it"]
    print(f"banded: {label} under torch.profiler, the first {n} IPM "
          f"iterations: {pr['kernels']} device operations (kernels and "
          f"copies) = {pr['kernels'] / n:.1f} per iteration, {pr['api']} "
          f"kernel-launch calls = {pr['api'] / n:.1f} per iteration; "
          f"device busy {pr['busy_s']:.3f} s of the profiled "
          f"{pr['wall_s']:.3f} s ({pr['busy_s'] / pr['wall_s']:.4f}); "
          f"{pr['total_s']:.1f} s with the trace's processing", flush=True)
    for key, (host_s, dev_s) in sorted(pr["ranges"].items()):
        print(f"banded: {label} range {key}: host {host_s:.3f} s, device "
              f"span {dev_s:.3f} s", flush=True)
    for key, count, dev_s in pr["top"]:
        print(f"banded: {label} kernel {key[:70]}: {count} launches, "
              f"{dev_s * 1e3:.1f} ms, {dev_s / count * 1e6:.1f} us each",
              flush=True)


def _banded_batch(label, problem, theta, warm_theta=None):
    """Solve ``theta`` on the card through the banded path (after a
    warm-up on ``warm_theta``), then once more under the profiler."""
    import torch

    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions
    cuda = [torch.device("cuda")]
    problem.settings.linear_solver = "block-banded"
    it = problem.backend.mesh_iterations[-1]
    t0 = time.perf_counter()
    it.build_solver(IPMOptions(**BANDED_OPTIONS))
    check(it._solver._compute_step_structured is not None,
          f"{label}: the solver did not take the banded path")
    print(f"banded: {label} solver built in {time.perf_counter() - t0:.2f} "
          f"s", flush=True)
    if warm_theta is not None:
        warm = solve_batched(problem.backend, devices=cuda,
                             theta_batch=warm_theta)
        print(f"banded: {label} warm-up solve {warm.solve_time:.3f} s",
              flush=True)
    res = solve_batched(problem.backend, devices=cuda, theta_batch=theta)
    B = len(theta)
    check(res.x_full.shape == (B, it.layout.n_full)
          and np.isfinite(res.x_full).all(),
          f"{label}: non-finite or misshapen solutions")
    n_it = int(res.iterations.max())
    print(f"banded: {label}: K={it.tables[0].K} N={it.tables[0].N} "
          f"n_free={it.n_free}; batch {B} solved in {res.solve_time:.3f} s "
          f"= {B / res.solve_time:.2f} solves/s; converged "
          f"{float(res.converged.mean()):.4f}, mean iterations "
          f"{float(res.iterations.mean()):.2f}, max {n_it}; "
          f"{res.solve_time / n_it:.4f} s per batched IPM iteration; KKT "
          f"max over converged "
          f"{float(res.kkt_error[res.converged].max(initial=0.0)):.3e}",
          flush=True)
    _print_profile(label, _banded_profile(problem, theta))
    return res


def phase_banded(refined):
    """The block-banded path on the card: no hand-written kernel runs; the
    batches and the brachistochrone refinement are held to the dense f64
    path and to GPOPS-II."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch
    from cart_pole_swing_up_torch import build_problem as cart_pole
    from brachistochrone_torch import build_problem as brachistochrone
    from pycollo_tpu_torch.ops.block_chol import chol_inv
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    print("banded: the block-banded path launches no hand-written kernel: "
          "its f64 blocks are factored by cholesky_ex and applied by "
          "triangular substitution (solver/banded.py), where chol_inv "
          "gives an f32 explicit inverse", flush=True)
    chol_inv.launches = 0

    # Default-mesh cart-pole, B = 64, against the dense f64 path on the CPU.
    t0 = time.perf_counter()
    problem = cart_pole()
    problem.settings.console_out_progress = False
    problem.settings.nlp_tolerance = 1e-6
    problem.initialise()
    print(f"banded: default-mesh cart-pole initialised in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    it = problem.backend.mesh_iterations[0]
    theta = _theta_chunk(it, BANDED_BATCH, 0)
    res = _banded_batch("default mesh", problem, theta,
                        warm_theta=_theta_chunk(it, BANDED_BATCH, 1000))
    conv = float(res.converged.mean())
    check(conv >= BANDED_CONVERGED_MIN,
          f"default-mesh banded batch: converged {conv} < "
          f"{BANDED_CONVERGED_MIN}")
    check(bool((res.kkt_error[res.converged] <= 1e-6).all()),
          "default-mesh banded batch: KKT above 1e-6 on a converged instance")
    problem.settings.linear_solver = "condensed-cholesky"
    cpu = solve_batched(problem.backend, devices=[torch.device("cpu")],
                        theta_batch=theta[:CPU_CHECK],
                        options=IPMOptions(**BANDED_OPTIONS))
    agree = _agreeing(cpu, res)
    rel = np.abs(cpu.objective - res.objective[:CPU_CHECK]) \
        / np.abs(cpu.objective)
    print(f"banded: default mesh, GPU banded objectives vs CPU dense f64 "
          f"re-solves ({cpu.solve_time:.3f} s), relative: {rel}; agreeing "
          f"{int(agree.sum())}/{CPU_CHECK}", flush=True)
    check(agree.sum() >= CPU_AGREE,
          f"default-mesh banded batch: only {int(agree.sum())}/{CPU_CHECK} "
          f"agree with the CPU dense f64 path")

    # problem.solve() on the brachistochrone through the banded path.
    problem = brachistochrone()
    problem.settings.console_out_progress = False
    problem.settings.linear_solver = "block-banded"
    t0 = time.perf_counter()
    solution = problem.solve(device=torch.device("cuda"))
    wall = time.perf_counter() - t0
    for r in problem.mesh_iterations:
        check(r.ipm_result.x.device.type == "cuda",
              "brachistochrone (banded): solved off the card")
        print(f"banded: brachistochrone mesh iteration {r.iteration.number}"
              f": N={[t.N for t in r.iteration.tables]} IPM iterations "
              f"{int(r.ipm_result.iterations)} KKT "
              f"{float(r.ipm_result.kkt_error):.3e} solve "
              f"{r.iteration.profiler.spans['NLP solve'].duration:.3f} s",
              flush=True)
    gp = abs(solution.objective - GPOPS_BRACHISTOCHRONE) \
        / GPOPS_BRACHISTOCHRONE
    oracle = float(np.load(ROOT / "tests" / "data"
                           / "trajectory_brachistochrone.npz")["objective"])
    print(f"banded: brachistochrone problem.solve() in {wall:.3f} s: "
          f"objective {solution.objective!r}; GPOPS-II relative {gp:.3e}; "
          f"stored f64 oracle {oracle!r}, difference "
          f"{solution.objective - oracle:.3e}", flush=True)
    check(problem.mesh_tolerance_met,
          "brachistochrone (banded): mesh tolerance not met")
    check(gp <= 1e-4, f"brachistochrone (banded): objective "
          f"{solution.objective} vs GPOPS-II 0.82434: {gp:.3e}")

    # The refined cart-pole mesh, the first 64 of the refine phase's batch,
    # against the dense f64 path on the card on the same instances.
    theta = refined["theta"][:BANDED_BATCH]
    ref = refined["ref"]
    res = _banded_batch("refined mesh", refined["problem"], theta)
    first = int(res.converged[:CPU_CHECK].sum())
    both = np.flatnonzero(res.converged & ref.converged[:BANDED_BATCH])
    agree = _agreeing(res, ref)
    print(f"banded: refined mesh: the first {CPU_CHECK} converged {first} "
          f"(the JAX package's banded path on the CPU: "
          f"{BANDED_REFINED_REF}); dense f64 path on the card converged "
          f"{int(ref.converged[:BANDED_BATCH].sum())}/{BANDED_BATCH}; of "
          f"{len(both)} both converge {int(agree.sum())} agree to 1e-4 "
          f"(first {CPU_CHECK} of them: {int(agree[both[:CPU_CHECK]].sum())})",
          flush=True)
    check(first >= BANDED_REFINED_REF - 1,
          f"refined-mesh banded batch: {first} of the first {CPU_CHECK} "
          f"converged, the reference's same route {BANDED_REFINED_REF}")
    check(len(both) >= CPU_CHECK
          and agree[both[:CPU_CHECK]].sum() >= CPU_AGREE,
          f"refined-mesh banded batch: of the first {CPU_CHECK} instances "
          f"both paths converge, {int(agree[both[:CPU_CHECK]].sum())} agree "
          f"with the dense f64 path")
    check(chol_inv.launches == 0,
          f"the banded phase launched chol_inv {chol_inv.launches} times")


#: (b): instances of the slice's batch held sharded against unsharded on
#: the f64 path, whose objectives must agree to MULTI_F64_RTOL
MULTI_F64 = 64
MULTI_F64_RTOL = 1e-8
#: (c), (d): a rank's results against a single-process solve of the same
#: instances on the same card at the same batch size
MULTI_RANK_RTOL = 1e-10
#: timed reps of a rank's solve_batched_global
MULTI_RANK_REPS = 2
#: seconds a run of local ranks may take before every rank is killed
RANK_TIMEOUT = 300


def _rank_main(args):
    """One rank of the multi phase's process groups, started by
    ``run_local_ranks`` as ``chip_smoke.py --rank BACKEND SCALING RANK
    WORLD ADDRESS``: the slice's problem on this rank's card, its block
    of the slice's batch (``np.array_split`` over the ranks) through
    ``solve_batched_global``, and with SCALING ``scaling``,
    ``measure_multihost_scaling`` on the same block size."""
    import torch
    import torch.distributed as dist
    from pycollo_tpu_torch.parallel import multihost

    backend, scaling = args[0], args[1] == "scaling"
    rank, world, address = int(args[2]), int(args[3]), args[4]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = multihost.initialize(address, world, rank, backend=backend)
    try:
        _, it = _slice_problem()
        theta = np.array_split(_theta_chunk(it, SLICE_BATCH, 0), world)[rank]
        out = multihost.solve_batched_global(it, theta_local=theta,
                                             n_rep=MULTI_RANK_REPS)
        rates = (multihost.measure_multihost_scaling(
            it, per_host_batch=len(theta), n_rep=1) if scaling else None)
        multihost.report(dict(
            rank=rank, device=str(device), backend=dist.get_backend(),
            objective=out.local_objective.tolist(),
            converged=out.local_converged.tolist(),
            global_converged=out.global_converged,
            global_batch=out.global_batch, solve_time=out.solve_time,
            scaling=rates,
            imported=sorted(m for m in sys.modules if m.split(".")[0]
                            in ("jax", "jaxlib", "pycollo_tpu"))))
    finally:
        multihost.shutdown()


def _run_ranks(backend, world, scaling):
    from pycollo_tpu_torch.parallel.multihost import run_local_ranks
    t0 = time.perf_counter()
    outs = run_local_ranks(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", backend,
         "scaling" if scaling else "-"], world, RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    for o in outs:
        check(o["imported"] == [],
              f"rank {o['rank']} imported {o['imported']}")
        check(o["backend"] == backend,
              f"rank {o['rank']} ran {o['backend']}, not {backend}")
        check(o["global_batch"] == SLICE_BATCH,
              f"rank {o['rank']}: global batch {o['global_batch']}")
        check(o["global_converged"] == outs[0]["global_converged"],
              f"ranks disagree on the converged count: "
              f"{[x['global_converged'] for x in outs]}")
    return outs, wall


def _same_solve(label, got_objective, got_converged, ref):
    """A rank's block against the single-process solve of the same
    instances on the same card."""
    got = np.asarray(got_objective)
    check(got.shape == ref.objective.shape,
          f"{label}: {got.shape} objectives for {ref.objective.shape}")
    check(np.array_equal(np.asarray(got_converged), ref.converged),
          f"{label}: converged flags differ from the single-process solve")
    rel = float(np.max(np.abs(got - ref.objective) / np.abs(ref.objective)))
    check(rel <= MULTI_RANK_RTOL,
          f"{label}: objectives differ from the single-process solve by "
          f"{rel:.3e} relative")
    return rel


def phase_multi(sl):
    """The multi-device layer on the card: the dry run, two shards of the
    slice's batch on the card, two gloo ranks sharing it, NCCL with one
    rank per card."""
    import torch
    from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv, chol_inv
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.parallel.dryrun import dryrun_multichip
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    card = torch.device("cuda", 0)
    two = [card, card]
    n_cards = torch.cuda.device_count()

    # (a) the dry run: four shards of the card, then the distinct cards.
    dry = dryrun_multichip(4, devices=[card] * 4)
    if n_cards >= 2:
        dryrun_multichip(n_cards)

    # (b) the slice's batch in two shards on the card.
    problem, theta, slice_res = sl["problem"], sl["theta"], sl["res"]
    backend = problem.backend
    it = backend.mesh_iterations[0]
    mixed = IPMOptions(**SLICE_OPTIONS)
    it.build_solver(mixed)
    warm = solve_batched(backend, devices=two,
                         theta_batch=_theta_chunk(it, MULTI_F64, 1000))
    print(f"multi: two-shard warm-up solve {warm.solve_time:.3f} s",
          flush=True)
    times = {1: [], 2: []}
    runs = {}
    for k in (1, 2, 2, 1):
        counted = k == 2 and 2 not in runs
        if counted:
            chol_inv.launches = 0
            blocked_chol_linv.calls = 0
        r = solve_batched(backend, devices=[card] * k, theta_batch=theta)
        if counted:
            launches, calls = chol_inv.launches, blocked_chol_linv.calls
        runs.setdefault(k, r)
        times[k].append(r.solve_time)
    res = runs[2]
    check(launches > 0, "the two-shard solve launched chol_inv 0 times")
    check(launches == calls,
          f"two shards: {launches} chol_inv launches for {calls} "
          f"factorization calls")
    check(res.x_full.shape == (SLICE_BATCH, it.layout.n_full)
          and np.isfinite(res.x_full).all(),
          "two shards: non-finite or misshapen solutions")
    conv = float(res.converged.mean())
    kkt99 = float(np.quantile(res.kkt_error, 0.99))
    agree = _agreeing(res, slice_res)
    rates = {k: [SLICE_BATCH / t for t in times[k]] for k in times}
    print(f"multi: two shards of the card, batch {SLICE_BATCH}: converged "
          f"{conv:.4f}, mean iterations {float(res.iterations.mean()):.2f}, "
          f"max {int(res.iterations.max())}, KKT p99 {kkt99:.3e}; chol_inv "
          f"launches {launches} in {calls} factorization calls of both "
          f"shards (the unsharded slice run: {sl['calls']}); "
          f"{int(agree.sum())}/{SLICE_BATCH} = "
          f"{agree.sum() / SLICE_BATCH:.4f} converge with the unsharded "
          f"slice run and agree to 1e-4", flush=True)
    print(f"multi: solves/s in turns (one shard, two, two, one): "
          f"{rates[1][0]:.2f}, {rates[2][0]:.2f}, {rates[2][1]:.2f}, "
          f"{rates[1][1]:.2f} (solve times {times[1][0]:.3f}, "
          f"{times[2][0]:.3f}, {times[2][1]:.3f}, {times[1][1]:.3f} s)",
          flush=True)
    check(conv >= 0.99, f"two shards: converged fraction {conv} < 0.99")
    check(kkt99 <= 1e-6, f"two shards: KKT p99 {kkt99:.3e} > 1e-6")

    f64 = IPMOptions(tol=1e-6, max_iter=80)
    one64 = solve_batched(backend, devices=[card],
                          theta_batch=theta[:MULTI_F64], options=f64)
    two64 = solve_batched(backend, devices=two, theta_batch=theta[:MULTI_F64],
                          options=f64)
    rel64 = float(np.max(np.abs(two64.objective - one64.objective)
                         / np.abs(one64.objective)))
    print(f"multi: f64 path, the first {MULTI_F64} in two shards against "
          f"unsharded: converged {int(two64.converged.sum())} and "
          f"{int(one64.converged.sum())}, iterations equal "
          f"{int((two64.iterations == one64.iterations).sum())}/{MULTI_F64}, "
          f"objectives max relative difference {rel64:.3e}", flush=True)
    check(np.array_equal(two64.converged, one64.converged),
          "f64 path: sharded and unsharded converge on other instances")
    check(rel64 <= MULTI_F64_RTOL,
          f"f64 path: sharded objectives differ from unsharded by "
          f"{rel64:.3e} relative (limit {MULTI_F64_RTOL:g})")

    # (c) two gloo ranks sharing the card, 128 instances each.
    it.build_solver(mixed)
    half = SLICE_BATCH // 2
    ref_half = solve_batched(backend, devices=[card], theta_batch=theta[:half])
    outs, wall_c = _run_ranks("gloo", 2, scaling=True)
    rel_c = _same_solve("gloo rank 0", outs[0]["objective"],
                        outs[0]["converged"], ref_half)
    sc = outs[0]["scaling"]
    print(f"multi: two gloo ranks on {outs[0]['device']} and "
          f"{outs[1]['device']} ({wall_c:.1f} s with start-up): global "
          f"converged {outs[0]['global_converged']}/{SLICE_BATCH}; solve "
          f"(the slowest rank's, mean of {MULTI_RANK_REPS}) "
          f"{outs[0]['solve_time']:.3f} s = "
          f"{SLICE_BATCH / outs[0]['solve_time']:.2f} solves/s; rank 0 "
          f"against one process, same {half} instances: relative "
          f"{rel_c:.3e}; single-process solve of the {half}: "
          f"{half / ref_half.solve_time:.2f} solves/s", flush=True)
    print(f"multi: measure_multihost_scaling over the two ranks, {half} "
          f"copies of the unperturbed instance each (fewer IPM iterations "
          f"than the slice's batch): single-host "
          f"{sc['single_host_solves_per_sec']:.2f} solves/s, "
          f"multi-host {sc['multi_host_solves_per_sec']:.2f} solves/s, "
          f"efficiency {sc['efficiency']:.4f} (no gate: the ranks share "
          f"one card and one host)", flush=True)

    # (d) NCCL, one rank per card.
    outs_d, wall_d = _run_ranks("nccl", n_cards, scaling=False)
    rows0 = np.array_split(theta, n_cards)[0]
    ref_d = runs[1] if len(rows0) == SLICE_BATCH else solve_batched(
        backend, devices=[card], theta_batch=rows0)
    rel_d = _same_solve("nccl rank 0", outs_d[0]["objective"],
                        outs_d[0]["converged"], ref_d)
    print(f"multi: NCCL over {n_cards} rank(s), one per card "
          f"({wall_d:.1f} s with start-up): global converged "
          f"{outs_d[0]['global_converged']}/{SLICE_BATCH}, solve "
          f"{outs_d[0]['solve_time']:.3f} s; rank 0 against one process: "
          f"relative {rel_d:.3e}", flush=True)
    return dict(launches=launches, calls=calls, dry=dry, rates=rates)


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(sys.argv[2:])
        return
    card = _timed("device", phase_device)
    _timed("build", phase_build)
    kern = _timed("kernel", phase_kernel)
    sl = _timed("slice", phase_slice)
    print(f"slice: {card}: batch {SLICE_BATCH} solved in "
          f"{sl['solve_s']:.3f} s = {sl['rate']:.2f} solves/s; converged "
          f"{sl['conv']:.4f}, mean iterations {sl['iters']:.2f}, KKT p99 "
          f"{sl['kkt99']:.3e}; chol_inv launches {sl['launches']} in "
          f"{sl['calls']} factorization calls; CPU "
          f"re-solves agreeing to 1e-4: f64 {sl['agree64']}/{CPU_CHECK}, "
          f"mixed {sl['agree_mx']}/{CPU_CHECK}", flush=True)
    rf = _timed("refine", phase_refine)
    _timed("banded", phase_banded, rf)
    mu = _timed("multi", phase_multi, sl)
    import torch
    print(f"chol_inv launches per path: slice {sl['launches']} "
          f"({sl['launches'] / sl['calls']:g} per factorization call), "
          f"refined-mesh batch {rf['launches']} "
          f"({rf['launches'] / rf['calls']:g} per call), banded 0, two "
          f"shards {mu['launches']} ({mu['launches'] / mu['calls']:g} per "
          f"call)", flush=True)
    print(json.dumps({"kernels": [{
        "name": "chol_inv",
        "route": "cuda",
        "source": "pycollo_tpu_torch/csrc/chol_linv.cu",
        "replaces": "pycollo_tpu/ops/block_chol.py:63",
        "launches": sl["launches"] + rf["launches"] + mu["launches"],
        **kern,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
