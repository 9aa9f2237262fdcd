"""Why the refined-mesh batch escalates, and whether the kernel is the cause.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python3 scripts/escalation_probe_torch.py [--routes kernel plain ...]
        [--seeds 0 1] [--compare] [--batch 256] [--device cuda]

It refines cart-pole swing-up to its final mesh (N = 127, 628 free
variables) with ``problem.solve()``, then, for each seed, solves the batch
of perturbed instances that ``chip_smoke.py`` solves there (seed 0 is its
batch) once per route, with ``blocked_chol_linv`` swapped for the route:

- ``kernel``: the package's route, four diagonal blocks of 157 through the
  CUDA kernel;
- ``kernel45``: the same with fourteen blocks of 45 (the earlier blocking);
- ``plain``: four blocks of 157 with the kernel's plain version
  (``cholesky_ex`` + triangular solve) in place of the kernel;
- ``library``: ``cholesky_ex`` + triangular solve of the whole matrix;
- ``f64``: the f64 path (``cholesky_ex`` in f64, no kernel), solved first:
  every other route's objectives are held against it to 1e-4, over all
  instances both converge and over the first 8 of them.

For each route it prints the solve time, the converged fraction, the
iterations, the factorization calls split into ladder calls (one per IPM
iteration) and escalation trips, and which instances made the trips:
those whose every ladder level failed the solver's check (a NaN or a pivot
below 1e-16), and those whose first GMRES solve after a factorization came
out non-finite (the solver escalates on either), each split into finished
instances (frozen, but still computed by ``body``) and active ones.

``--compare`` holds every factorization call of the ``kernel`` route
against ``cholesky_ex`` on the same stack, instance by instance; factors
each instance on which the two disagree once more by the plain version in
the same blocking, by blocks of 45 and in f64, so a disagreement is
charged to the kernel, to the blocked algorithm or to the matrix; and
compares max|X A X^T - I| of the kernel's and the plain version's
X = L^{-1} on every ladder stack, for the leading 157 x 157 block and the
whole matrix.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "examples")]

from pycollo_tpu_torch.ops import block_chol  # noqa: E402
from pycollo_tpu_torch.parallel.batch import solve_batched  # noqa: E402
from pycollo_tpu_torch.solver import krylov  # noqa: E402
from pycollo_tpu_torch.solver.ipm import IPMOptions  # noqa: E402

#: the mixed-precision configuration of ``chip_smoke.py``
OPTIONS = dict(tol=1e-6, max_iter=80, kkt_precision="mixed", dc_floor=1e-7,
               dense_gmres_iters=12, eval_dtype="f32")
#: the solver's pivot floor on the mixed path (``solver/ipm.py``)
PIV_FLOOR = 1e-16
#: disagreeing instances factored again, at most, per route
MAX_RECHECK = 256


def flags(diag):
    """Per-instance failure as the solver reads it from diag(L)."""
    return ~(torch.isfinite(diag).all(-1) & ~(diag < PIV_FLOOR).any(-1))


def library_route(A, block=None):
    """``cholesky_ex`` + triangular solve of the whole matrix, f32."""
    A32 = A.to(torch.float32)
    L, info = torch.linalg.cholesky_ex(A32)
    eye = torch.eye(A.shape[-1], dtype=torch.float32, device=A.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(A32), upper=False)
    bad = (info != 0)
    Linv = torch.where(bad[..., None, None], float("nan"), Linv)
    diag = torch.where(bad[..., None], float("nan"),
                       torch.diagonal(L, dim1=-2, dim2=-1))
    block_chol.blocked_chol_linv.calls += 1
    return diag, Linv


class Watch:
    """Wraps ``blocked_chol_linv`` and records every call."""

    def __init__(self, route, compare):
        self.route = route
        self.compare = compare
        self.orig = block_chol.blocked_chol_linv
        self.calls = 0             # blocked_chol_linv counts itself here
        self.iteration = 0
        self.ncalls = 0
        self.last_kind = None
        self.ladder_fail = {}      # IPM iteration -> instances failing all levels
        self.trips = Counter()     # IPM iteration -> escalation trips
        self.trip_fail = Counter()  # instance -> trips in which it failed
        self.events = Counter()
        self.recheck = Counter()
        self.rechecked = 0
        self.residual = {}

    def __call__(self, A, block=None):
        if self.route == "library":
            diag, Linv = library_route(A)
        elif self.route == "kernel45":
            diag, Linv = self.orig(A, block=45)
        else:
            diag, Linv = self.orig(A, block)
        fail = flags(diag)
        self.ncalls += 1
        self.last_kind = "ladder" if A.dim() == 4 else "trip"
        if A.dim() == 4:
            self.iteration += 1
            every = fail.all(-1)
            self.ladder_fail[self.iteration] = \
                torch.nonzero(every).flatten().tolist()
        else:
            self.trips[self.iteration] += 1
            for i in torch.nonzero(fail).flatten().tolist():
                self.trip_fail[i] += 1
        if self.compare:
            self._compare(A, fail)
        return diag, Linv

    def _compare(self, A, fail_k):
        kind = "ladder" if A.dim() == 4 else "trip"
        n = A.shape[-1]
        A3 = A.reshape(-1, n, n).to(torch.float32)
        fk = fail_k.reshape(-1)
        L, info = torch.linalg.cholesky_ex(A3)
        fc = (info != 0) | flags(torch.diagonal(L, dim1=-2, dim2=-1))
        nonfinite = ~torch.isfinite(A3).all(-1).all(-1)
        for name, mask in (("both fail", fk & fc),
                           ("kernel route only", fk & ~fc),
                           ("cholesky_ex only", ~fk & fc),
                           ("non-finite K", nonfinite)):
            self.events[(kind, name)] += int(mask.sum())
        self.events[(kind, "instances")] += fk.numel()
        if kind == "ladder":
            self._accuracy(A3)
        odd = torch.nonzero(fk != fc).flatten()
        odd = odd[:max(0, MAX_RECHECK - self.rechecked)]
        if odd.numel() == 0:
            return
        self.rechecked += odd.numel()
        sub = A3[odd]
        f_plain = flags(self.orig(sub.cpu())[0])
        L64, info64 = torch.linalg.cholesky_ex(sub.double())
        f64 = (info64 != 0).cpu()
        f45 = flags(self.orig(sub, block=45)[0]).cpu()
        for j in range(odd.numel()):
            key = ("kernel route fails" if bool(fk[odd[j]])
                   else "cholesky_ex fails",
                   f"plain same blocking {'fails' if f_plain[j] else 'ok'}",
                   f"blocks of 45 {'fail' if f45[j] else 'ok'}",
                   f"f64 {'fails' if f64[j] else 'ok'}")
            self.recheck[key] += 1

    def _accuracy(self, A3):
        """max|X A X^T - I| (f64) of the kernel's and the plain version's
        X = L^{-1} on the same real stacks: the leading 157 x 157 block
        through chol_inv, and the whole matrix through blocked_chol_linv."""
        saved = block_chol.chol_inv
        for part, A in (("leading block", A3[:, :157, :157].contiguous()),
                        ("whole matrix", A3)):
            for route in ("kernel", "plain"):
                if route == "plain":
                    block_chol.chol_inv = block_chol.chol_inv_reference
                try:
                    X = block_chol.chol_inv(A) if part == "leading block" \
                        else self.orig(A)[1]
                finally:
                    block_chol.chol_inv = saved
                r = torch.empty(A.shape[0], dtype=torch.float64,
                                device=A.device)
                eye = torch.eye(A.shape[-1], dtype=torch.float64,
                                device=A.device)
                for c in range(0, A.shape[0], 256):
                    Xc = X[c:c + 256].double()
                    R = Xc @ A[c:c + 256].double() @ Xc.transpose(-1, -2)
                    r[c:c + 256] = (R - eye).abs().amax((-1, -2))
                self.residual.setdefault((part, route), []).append(r.cpu())

    def report_accuracy(self, route_name):
        for part in ("leading block", "whole matrix"):
            rk = torch.cat(self.residual[(part, "kernel")])
            rp = torch.cat(self.residual[(part, "plain")])
            both = torch.isfinite(rk) & torch.isfinite(rp)
            q = torch.tensor([0.5, 0.99], dtype=torch.float64)
            print(f"route {route_name}: {part}, max|X A X^T - I| over "
                  f"{int(both.sum())} ladder matrices finite in both: kernel "
                  f"median/p99/max {torch.quantile(rk[both], q).tolist()} / "
                  f"{float(rk[both].max()):.3e}, plain "
                  f"{torch.quantile(rp[both], q).tolist()} / "
                  f"{float(rp[both].max()):.3e}; kernel > 10 x plain on "
                  f"{int((rk[both] > 10 * rp[both]).sum())}, plain > 10 x "
                  f"kernel on {int((rp[both] > 10 * rk[both]).sum())}; "
                  f"non-finite only in the kernel's "
                  f"{int((~torch.isfinite(rk) & torch.isfinite(rp)).sum())},"
                  f" only in the plain version's "
                  f"{int((torch.isfinite(rk) & ~torch.isfinite(rp)).sum())}",
                  flush=True)


class GmresWatch:
    """Wraps ``gmres_right``: which instances come out non-finite in the
    first solve after each factorization call (the solve the escalation
    reads; later ones are second-order corrections)."""

    def __init__(self, watch):
        self.watch = watch
        self.orig = krylov.gmres_right
        self.seen = None
        self.bad = Counter()      # (kind, rhs finite, precond finite) -> count
        self.by_iter = {}         # IPM iteration -> bad instances of the ladder solve
        self.trip_bad = Counter()  # instance -> trips with a non-finite solve

    def __call__(self, matvec, precond, rhs, iters):
        x = self.orig(matvec, precond, rhs, iters)
        w = self.watch
        if w.ncalls == self.seen:
            return x
        self.seen = w.ncalls
        kind = w.last_kind
        bad = ~torch.isfinite(x).all(-1)
        idx = torch.nonzero(bad).flatten()
        if kind == "ladder":
            self.by_iter[w.iteration] = idx.tolist()
        else:
            for i in idx.tolist():
                self.trip_bad[i] += 1
        if idx.numel():
            rhs_ok = torch.isfinite(rhs[idx]).all(-1)
            pre_ok = torch.isfinite(precond(rhs)[idx]).all(-1)
            for a, b in zip(rhs_ok.tolist(), pre_ok.tolist()):
                self.bad[(kind, f"rhs {'finite' if a else 'non-finite'}",
                          f"preconditioned rhs {'finite' if b else 'non-finite'}")] += 1
        return x


def run(problem, route, theta, device, compare, ref):
    it = problem.backend.mesh_iterations[-1]
    watch = Watch(route, compare)
    options = IPMOptions(**(dict(tol=1e-6, max_iter=80) if route == "f64"
                            else OPTIONS))
    saved_blocked, saved_chol = block_chol.blocked_chol_linv, \
        block_chol.chol_inv
    block_chol.blocked_chol_linv = watch
    gw = krylov.gmres_right = GmresWatch(watch)
    if route == "plain":
        block_chol.chol_inv = block_chol.chol_inv_reference
    try:
        t0 = time.perf_counter()
        res = solve_batched(problem.backend, devices=[device],
                            theta_batch=theta, options=options)
        wall = time.perf_counter() - t0
    finally:
        block_chol.blocked_chol_linv = saved_blocked
        block_chol.chol_inv = saved_chol
        krylov.gmres_right = gw.orig
    iters = res.iterations
    trips = sum(watch.trips.values())
    print(f"route {route}: n_free {it.n_free}, batch {len(theta)} solved in "
          f"{res.solve_time:.3f} s ({wall:.3f} s with the watch); converged "
          f"{res.converged.mean():.4f}, mean iterations {iters.mean():.2f}, "
          f"max {iters.max()}; {watch.iteration} ladder calls, {trips} "
          f"escalation trips", flush=True)
    capped = [k for k, v in watch.trips.items() if v >= 29]
    print(f"route {route}: IPM iterations with trips "
          f"{len(watch.trips)}, at the cap of 29: {len(capped)}", flush=True)
    # Instances whose every ladder level failed, by IPM iteration; in IPM
    # iteration j an instance that stopped after k < j iterations is frozen.
    status = Counter()
    who = Counter()
    for j, inst in watch.ladder_fail.items():
        for i in inst:
            status["finished" if iters[i] < j else "active"] += 1
            who[i] += 1
    print(f"route {route}: instance-iterations with every ladder level "
          f"failing: {dict(status)}; by instance (index: iterations, its "
          f"IPM iterations, converged): "
          + ", ".join(f"{i}: {c}, {iters[i]}, {int(res.converged[i])}"
                      for i, c in who.most_common(12)), flush=True)
    print(f"route {route}: instances failing in escalation trips (index: "
          f"trips): {dict(watch.trip_fail.most_common(12))}", flush=True)
    solve = Counter()
    who = Counter()
    for j, inst in gw.by_iter.items():
        for i in inst:
            solve["finished" if iters[i] < j else "active"] += 1
            who[i] += 1
    print(f"route {route}: instance-iterations whose first solve came out "
          f"non-finite: {dict(solve)}; by instance (index: iterations, its "
          f"IPM iterations, converged): "
          + ", ".join(f"{i}: {c}, {iters[i]}, {int(res.converged[i])}"
                      for i, c in who.most_common(12))
          + f"; non-finite trip solves by instance "
          f"{dict(gw.trip_bad.most_common(8))}; kinds {dict(gw.bad)}",
          flush=True)
    if compare:
        for (kind, name), v in sorted(watch.events.items()):
            print(f"route {route}: {kind} calls, instances {name}: {v}",
                  flush=True)
        for key, v in watch.recheck.most_common():
            print(f"route {route}: disagreement rechecked: {', '.join(key)}: "
                  f"{v}", flush=True)
        watch.report_accuracy(route)
    if ref is not None:
        conv = res.converged & ref.converged
        rel = (res.objective - ref.objective) / np.abs(ref.objective)
        agree = conv & (np.abs(rel) < 1e-4)
        idx = np.flatnonzero(conv)[:8]
        print(f"route {route} vs the f64 route: both converged "
              f"{int(conv.sum())}, objectives agreeing to 1e-4 "
              f"{int(agree.sum())}; of the first 8 both converged "
              f"{idx.tolist()}: {int(agree[idx].sum())} agree; route minus "
              f"f64, relative, where they differ: "
              f"{np.round(rel[conv & ~agree], 4).tolist()}", flush=True)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    routes = ["kernel", "plain", "kernel45", "library", "f64"]
    parser.add_argument("--routes", nargs="+", default=routes, choices=routes)
    parser.add_argument("--compare", action="store_true",
                        help="hold every factorization call of the kernel "
                        "route against cholesky_ex and the plain version")
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    from cart_pole_swing_up_torch import build_problem
    problem = build_problem()
    problem.settings.console_out_progress = False
    problem.solve(device=device)
    it = problem.backend.mesh_iterations[-1]
    pl = it.layout.phases[0]
    # the f64 route first: the others are held against it
    order = sorted(args.routes, key=lambda r: r != "f64")
    for seed in args.seeds:
        # Perturbed initial states, as chip_smoke.py and bench.py make them.
        rng = np.random.default_rng(seed)
        theta = np.tile(it.theta_default, (args.batch, 1))
        theta[:, pl.y_off] = rng.uniform(-0.25, 0.25, args.batch)
        theta[:, pl.y_off + pl.N] = rng.uniform(-0.3, 0.3, args.batch)
        print(f"seed {seed}", flush=True)
        ref = None
        for route in order:
            res = run(problem, route, theta, device,
                      args.compare and route == "kernel", ref)
            if route == "f64":
                ref = res


if __name__ == "__main__":
    main()
