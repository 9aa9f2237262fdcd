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
   the plain version's by at most ``REFINED_AGREE_MARGIN``.

The line before the last is a JSON object describing every kernel of the
path; the last line is ``{"ok": true, "device": {...}}``.
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


def phase_slice():
    import torch
    sys.path.insert(0, str(ROOT / "examples"))
    from cart_pole_swing_up_torch import build_problem
    from pycollo_tpu_torch.ops.block_chol import blocked_chol_linv, chol_inv
    from pycollo_tpu_torch.parallel.batch import solve_batched
    from pycollo_tpu_torch.solver.ipm import IPMOptions

    t0 = time.perf_counter()
    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.settings.nlp_tolerance = 1e-6
    problem.initialise()
    it = problem.backend.mesh_iterations[0]
    check(it.layout.phases[0].N == 31 and it.n_free == 148,
          f"unexpected cart-pole size N={it.layout.phases[0].N} "
          f"n={it.n_free}")
    it.build_solver(IPMOptions(**SLICE_OPTIONS))
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
                agree64=agree64, agree_mx=agree_mx)


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

    def agreeing(a, b):
        """Instances (of the first len(a)) both converged, with objectives
        agreeing to 1e-4."""
        k = len(a.objective)
        return a.converged & b.converged[:k] & (
            np.abs(a.objective - b.objective[:k])
            < 1e-4 * np.abs(b.objective[:k]))

    ref_cpu = agreeing(cpu, ref)
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
        shares[name] = agreeing(r, ref).sum() / both.sum()
        first = np.flatnonzero(both)[:CPU_CHECK]
        print(f"refine: refined-mesh batch through the {name}: converged "
              f"{float(r.converged.mean()):.4f} in {r.solve_time:.3f} s; "
              f"of {int(both.sum())} instances it and the f64 path both "
              f"converge, {int(agreeing(r, ref).sum())} = "
              f"{shares[name]:.4f} agree to 1e-4 (first {CPU_CHECK} of "
              f"them: {int(agreeing(r, ref)[first].sum())})", flush=True)
    check(shares["kernel"] >= shares["plain version"] - REFINED_AGREE_MARGIN,
          f"refined mesh: the kernel's share of answers agreeing with the "
          f"f64 path, {shares['kernel']:.4f}, falls short of the plain "
          f"version's {shares['plain version']:.4f} by more than "
          f"{REFINED_AGREE_MARGIN}")
    return dict(launches=launches, calls=calls)


def phase_refine():
    sys.path.insert(0, str(ROOT / "examples"))
    problems = {spec[0]: _refine_one(*spec) for spec in REFINE_PROBLEMS}
    return _refined_batch(problems["cart-pole"])


def main():
    sys.path.insert(0, str(ROOT))
    card = phase_device()
    phase_build()
    kern = phase_kernel()
    sl = phase_slice()
    print(f"slice: {card}: batch {SLICE_BATCH} solved in "
          f"{sl['solve_s']:.3f} s = {sl['rate']:.2f} solves/s; converged "
          f"{sl['conv']:.4f}, mean iterations {sl['iters']:.2f}, KKT p99 "
          f"{sl['kkt99']:.3e}; chol_inv launches {sl['launches']} in "
          f"{sl['calls']} factorization calls; CPU "
          f"re-solves agreeing to 1e-4: f64 {sl['agree64']}/{CPU_CHECK}, "
          f"mixed {sl['agree_mx']}/{CPU_CHECK}", flush=True)
    rf = phase_refine()
    import torch
    print(f"chol_inv launches per path: slice {sl['launches']} "
          f"({sl['launches'] / sl['calls']:g} per factorization call), "
          f"refined-mesh batch {rf['launches']} "
          f"({rf['launches'] / rf['calls']:g} per call)", flush=True)
    print(json.dumps({"kernels": [{
        "name": "chol_inv",
        "route": "cuda",
        "source": "pycollo_tpu_torch/csrc/chol_linv.cu",
        "replaces": "pycollo_tpu/ops/block_chol.py:63",
        "launches": sl["launches"] + rf["launches"],
        **kern,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
