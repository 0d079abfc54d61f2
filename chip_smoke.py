#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run, B = 32768
    python3 chip_smoke.py --batch N  # the same phases at a smaller batch

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build: compiles ``diffopt_tpu_torch/csrc/*.cu`` with ``nvcc`` (first use);
3. kernels against their plain PyTorch versions on the card, at the shapes the
   two paths give them (fused solver and LDL' pair: n = 64, m = 32, p = 16,
   N = 112, k = 1; Cholesky pair: n = 64 and 16, k = 1 and 16), f32 at the
   full batch and f64 at a smaller one, plus the fused solver's unstaged mode,
   the routes past 128 rows, matrices that are not positive definite, and a
   batch on which the fused solver runs on with mu == 0; each kernel is timed
   beside its plain version and, where one PyTorch call computes the same
   function, beside that call (a yardstick only);
4. main path: ``solve_qp_batched`` forward + backward on a random batch of
   dense QPs at full width, a warm-up and three timed steps; checks finite
   outputs and gradients, the converged share, the relative KKT residuals, the
   launch counts of every kernel, and the gradients of a 512-instance subset
   against the same call routed through the plain versions;
5. staged path: ``solve_qp`` (staged interior-point solver on the Cholesky
   kernels, default KKT route) forward + backward on the same kind of batch at
   full width; checks the launch counts, the scale-relative KKT metrics, the
   solutions against the fused solver's and the gradients against the LDL'
   route; then, smaller, the p = 0 route of ``solve_qp_batched``, an LP batch
   through ``method="auto"``, the forward rule against a finite difference,
   ``QPDiffContext`` against the uncached verbs, and the n = 100 solve + VJP;
6. prints one JSON line ``{"kernels": [...]}``, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import torch

N_VARS, N_INEQ, N_EQ = 64, 32, 16
N_KKT = N_VARS + N_INEQ + N_EQ
STEPS = 3
DEVICE = "cuda"
# published peaks of one H100 SXM: device memory rate, f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# tolerances of the kernel-vs-plain comparisons (same algorithm, other summation order):
# LDL' of a quasi-definite KKT matrix has no pivoting, so rounding differences grow with the
# element growth of the factorisation; L is compared relative to its largest entry, d entry by
# entry (its entries span twelve decades: slack / lam on inactive rows)
TOL_LDL = {torch.float32: 2e-3, torch.float64: 1e-9}
# the solve is compared on the residual of the system it solves, relative to |rhs|
TOL_SOLVE = {torch.float32: 2e-3, torch.float64: 1e-9}
# fused solver, per instance and relative to 1 + the largest entry. In f64 the two agree on every
# instance. In f32 an interior-point iterate is only determined to the solver's tolerance (5e-6
# relative residual): on near-degenerate instances a different summation order moves a step length
# or the exit by one iteration, and lam of a weakly active row moves with it. So the f32 comparison
# is on the distribution: half of the instances to rounding, 99% to a few 1e-2, none far off.
TOL_PDIP = {
    torch.float32: {"median": 1e-5, "q99": 3e-2, "max": 0.5},
    torch.float64: {"median": 1e-9, "q99": 1e-7, "max": 1e-6},
}
# gradients of the main path against the plain route, relative to the largest gradient entry
TOL_GRAD = 5e-3
# Cholesky factor against its plain version (same elimination order, other summation order), relative
# to the largest entry of L; H = Q + G'G + reg I of the bench distribution has condition ~10
TOL_CHOL = {torch.float32: 1e-5, torch.float64: 1e-13}
# Cholesky solve, relative to the largest entry of x (error grows with the condition of L L')
TOL_CHOL_SOLVE = {torch.float32: 1e-4, torch.float64: 1e-12}
# staged solver against the fused one on the same f32 batch, per instance and relative to 1 + |z|: two
# interior-point methods with different termination rules end on different iterates, each determined
# only to the f32 complementarity floor; the comparison is on the distribution, as for TOL_PDIP
TOL_STAGED_VS_FUSED = {"median": 1e-4, "q99": 3e-2, "max": 0.5}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, flops):
    """Least time for the work: each needed input read once and each output written once at the
    memory rate, against the operations at the f32 rate; the larger of the two, and which."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pdip_flops_per_iteration(n, m, p):
    """Operations of one interior-point body as the kernel arranges it (the init factors once and
    solves once, and is counted as one more body)."""
    factor = n * (n + 1) * m + n**3 / 3 + n * n * p + p * (p + 1) * n + p**3 / 3
    direction = 2 * n * n + 2 * p * p + 4 * n * p + 4 * m * n
    residuals = 2 * n * n + 4 * m * n + 4 * p * n
    return factor + 2 * direction + residuals


@contextlib.contextmanager
def plain_kernels():
    """Route the port through the plain versions of its kernels (for the comparison run only;
    the wrappers themselves never take a plain version for a CUDA tensor)."""
    from diffopt_tpu_torch.ops.cuda import chol, pdip

    # (the staged solver binds the Cholesky pair by name at import and is not rerouted here)
    saved = (chol.ldl_batched, chol.ldl_solve_batched, pdip.solve_batched_fused)
    chol.ldl_batched = chol.ldl_batched_plain
    chol.ldl_solve_batched = chol.ldl_solve_batched_plain
    pdip.solve_batched_fused = pdip.solve_batched_fused_plain
    try:
        yield
    finally:
        chol.ldl_batched, chol.ldl_solve_batched, pdip.solve_batched_fused = saved


def phase_build():
    from diffopt_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    for name in ("chol", "ldl", "pdip"):
        _build.load(name)
    print(f"[build] nvcc, {time.perf_counter() - t0:.1f} s (into {_build.build_dir()})")
    for log in sorted(_build.build_dir().glob("*.nvcc.log")):
        for line in log.read_text().splitlines():
            if "Used" in line or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
                print(f"[build] {log.name}: {line.strip()}")


def kkt_systems(qp, sol):
    """Symmetrised quasi-definite KKT matrices of solved instances (what the VJP factors)."""
    from diffopt_tpu_torch.ops import kkt

    from diffopt_tpu_torch import get_config

    cfg = get_config()
    K, _ = kkt._kkt_symmetric(qp, sol, cfg.ldl_lam_floor(qp.Q.dtype), cfg.ldl_reg(qp.Q.dtype))
    return K.contiguous()


def phase_kernels(batch, gen):
    """Each kernel against its plain version; returns the entries of the ``kernels`` line."""
    from diffopt_tpu_torch.ops.cuda import chol, pdip
    from diffopt_tpu_torch.utils.testing import make_batch

    n, m, p, N = N_VARS, N_INEQ, N_EQ, N_KKT
    entries = {}
    for dtype, B in ((torch.float32, batch), (torch.float64, min(batch, 4096))):
        tag = "f32" if dtype == torch.float32 else "f64"
        main = dtype == torch.float32
        qp = make_batch(B, n, m, p, dtype, DEVICE, gen)

        # --- K1: fused PDIP ---------------------------------------------------
        sol, its = pdip.solve_batched_fused(qp, max_iters=25, return_iters=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psol, pits = pdip.solve_batched_fused_plain(qp, max_iters=25, return_iters=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        # per-instance error over z, lam, nu, relative to 1 + the largest entry of the plain result
        inst_err = torch.stack([
            (getattr(sol, k) - getattr(psol, k)).abs().amax(dim=1) / (1.0 + getattr(psol, k).abs().amax(dim=1))
            for k in ("z", "lam", "nu")
        ]).amax(dim=0)
        max_abs = max(float((getattr(sol, k) - getattr(psol, k)).abs().max()) for k in ("z", "lam", "nu"))
        med, q99, worst = (float(torch.quantile(inst_err, q)) for q in (0.5, 0.99, 1.0))
        moved = float((its != pits).float().mean())
        far = float(((its - pits).abs() > 1).float().mean())
        tol = TOL_PDIP[dtype]
        print(
            f"[kernels] pdip_fused {tag} B={B}: max abs diff {max_abs:.3e}; per-instance relative diff median {med:.3e}"
            f" (tol {tol['median']:.0e}), 99% {q99:.3e} (tol {tol['q99']:.0e}), max {worst:.3e} (tol {tol['max']:.0e});"
            f" iterations mean {float(its.float().mean()):.2f} vs plain {float(pits.float().mean()):.2f},"
            f" differ on {moved:.4%} of instances, by more than one on {far:.4%}"
        )
        check(all(torch.isfinite(getattr(sol, k)).all() for k in ("z", "lam", "nu")), "pdip_fused: non-finite output")
        check(
            med <= tol["median"] and q99 <= tol["q99"] and worst <= tol["max"],
            f"pdip_fused {tag} disagrees with its plain version: median {med:.3e}, 99% {q99:.3e}, max {worst:.3e}",
        )
        check(far <= 0.01, f"pdip_fused {tag}: iteration counts differ by more than one on {far:.3%}")
        if main:
            item = qp.Q.element_size()
            ms = time_ms(lambda: pdip.solve_batched_fused(qp, max_iters=25), reps=3)
            bytes_moved = B * item * (n * n + (m + p) * (n + 1) + n + (n + 2 * m + p) + 1)
            flops = float((its.double() + 1).sum()) * pdip_flops_per_iteration(n, m, p)
            b_ms, b_by = bound(bytes_moved, flops)
            entries["pdip_fused"] = dict(
                name="pdip_fused", route="cuda", source="diffopt_tpu_torch/csrc/pdip.cu",
                replaces="diffopt_tpu/ops/pallas/pdip.py:204", max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
            )

        # --- K2: LDL' factor --------------------------------------------------
        K = kkt_systems(qp, sol)
        rhs = torch.randn(B, N, dtype=dtype, device=DEVICE, generator=gen)
        del qp, sol, psol
        L, d = chol.ldl_batched(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Lp, dp = chol.ldl_batched_plain(K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err_f = float((L - Lp).abs().max())
        lscale = float(Lp.abs().max())
        err_d = float(((d - dp) / dp).abs().max())
        recon = float((L @ (d[:, :, None] * L.transpose(1, 2)) - K).abs().max() / K.abs().max())
        print(
            f"[kernels] ldl_factor {tag} B={B} N={N}: max|dL| = {err_f:.3e} (largest entry {lscale:.3e}), max|dd/d| ="
            f" {err_d:.3e} (tol {TOL_LDL[dtype]:.0e}, relative); |L D L' - K| / |K| = {recon:.3e}"
        )
        check(bool(torch.isfinite(L).all() and torch.isfinite(d).all()), "ldl_factor: non-finite output")
        check(err_f <= TOL_LDL[dtype] * lscale, f"ldl_factor {tag}: L disagrees with its plain version")
        check(err_d <= TOL_LDL[dtype], f"ldl_factor {tag}: d disagrees with its plain version")
        check(recon <= TOL_LDL[dtype], f"ldl_factor {tag} does not reconstruct K")
        if main:
            ms = time_ms(lambda: chol.ldl_batched(K), reps=5)
            lib_ms = time_ms(lambda: torch.linalg.lu_factor(K), reps=2)
            # K is symmetric: its lower triangle is all the function needs; L (with its zeroed upper
            # triangle) and d are written in full
            b_ms, b_by = bound(B * K.element_size() * (N * (N + 1) // 2 + N * N + N), B * N**3 / 3)
            entries["ldl_factor"] = dict(
                name="ldl_factor", route="cuda", source="diffopt_tpu_torch/csrc/ldl.cu",
                replaces="diffopt_tpu/ops/pallas/chol.py:171", max_abs_err=err_f, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            )

        # --- K3: LDL' solve ---------------------------------------------------
        x = chol.ldl_solve_batched(L, d, rhs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xp = chol.ldl_solve_batched_plain(L, d, rhs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err_s = float((x - xp).abs().max())
        xscale = float(xp.abs().max())
        # residual of the factored system (L D L') x = rhs, in f64
        Ld = L.double()
        resid = torch.einsum("bij,bj->bi", Ld, d.double() * torch.einsum("bji,bj->bi", Ld, x.double())) - rhs.double()
        rel_res = float(resid.abs().max() / rhs.abs().max())
        print(
            f"[kernels] ldl_solve {tag} B={B} N={N} k=1: max|dx| = {err_s:.3e} (largest entry {xscale:.3e},"
            f" tol {TOL_SOLVE[dtype]:.0e} of it); |L D L' x - rhs| / |rhs| = {rel_res:.3e}"
        )
        check(bool(torch.isfinite(x).all()), "ldl_solve: non-finite output")
        check(err_s <= TOL_SOLVE[dtype] * xscale, f"ldl_solve {tag} disagrees with its plain version")
        if main:
            ms = time_ms(lambda: chol.ldl_solve_batched(L, d, rhs), reps=5)
            lu, piv = torch.linalg.lu_factor(K)
            lib_ms = time_ms(lambda: torch.linalg.lu_solve(lu, piv, rhs[..., None]), reps=2)
            del lu, piv
            # the strict lower triangle of L, d and rhs read, x written
            b_ms, b_by = bound(B * L.element_size() * (N * (N - 1) // 2 + 3 * N), B * 2 * N * N)
            entries["ldl_solve"] = dict(
                name="ldl_solve", route="cuda", source="diffopt_tpu_torch/csrc/ldl.cu",
                replaces="diffopt_tpu/ops/pallas/chol.py:188", max_abs_err=err_s, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            )
        # several right-hand sides at once
        rhs3 = torch.randn(min(B, 512), N, 3, dtype=dtype, device=DEVICE, generator=gen)
        x3 = chol.ldl_solve_batched(L[:512], d[:512], rhs3)
        x3p = chol.ldl_solve_batched_plain(L[:512], d[:512], rhs3)
        check(
            float((x3 - x3p).abs().max()) <= TOL_SOLVE[dtype] * float(x3p.abs().max()),
            f"ldl_solve {tag} k=3 disagrees with its plain version",
        )
        del K, L, d, Lp, dp, x, xp, rhs, Ld, resid
        torch.cuda.empty_cache()

    # --- K2 / K3 past N = 128, where the factor works in shared memory, not in register tiles ---
    Nbig = 160
    Kb = torch.randn(256, Nbig, Nbig, dtype=torch.float32, device=DEVICE, generator=gen)
    Kb = Kb @ Kb.transpose(1, 2) / Nbig + torch.eye(Nbig, device=DEVICE)
    Kb[:, Nbig // 2:, Nbig // 2:] *= -1.0  # quasi-definite: [[P, C'], [C, -R]]
    Kb = torch.tril(Kb) + torch.tril(Kb, -1).transpose(1, 2)
    Lb, db = chol.ldl_batched(Kb)
    Lbp, dbp = chol.ldl_batched_plain(Kb)
    err_b = max(float((Lb - Lbp).abs().max() / Lbp.abs().max()), float(((db - dbp) / dbp).abs().max()))
    rb = torch.randn(256, Nbig, dtype=torch.float32, device=DEVICE, generator=gen)
    xb, xbp = chol.ldl_solve_batched(Lb, db, rb), chol.ldl_solve_batched_plain(Lb, db, rb)
    err_x = float((xb - xbp).abs().max() / xbp.abs().max())
    print(f"[kernels] ldl_factor / ldl_solve f32 N={Nbig} B=256: relative diff {err_b:.3e} / {err_x:.3e} (tol 2e-3)")
    check(err_b <= TOL_LDL[torch.float32] and err_x <= TOL_SOLVE[torch.float32], "LDL' past N = 128 disagrees with plain")

    # --- K1 off the main path's shape: Q, G, A left in device memory (working set too large to
    # stage beside H in f64) ---
    n2, m2, p2, B2 = 100, 48, 24, 256
    check(pdip.smem_bytes(n2, m2, p2, 8, stage=True) > pdip.MAX_SMEM_BYTES, "unexpected staging mode")
    qp = make_batch(B2, n2, m2, p2, torch.float64, DEVICE, gen)
    sol = pdip.solve_batched_fused(qp, max_iters=25)
    psol = pdip.solve_batched_fused_plain(qp, max_iters=25)
    worst = float(torch.stack([
        (getattr(sol, k) - getattr(psol, k)).abs().amax(dim=1) / (1.0 + getattr(psol, k).abs().amax(dim=1))
        for k in ("z", "lam", "nu")
    ]).max())
    print(f"[kernels] pdip_fused f64 unstaged B={B2} n={n2} m={m2} p={p2}: max per-instance relative diff {worst:.3e}"
          " (tol 1e-06)")
    check(worst <= 1e-6, f"pdip_fused at n = {n2} disagrees with its plain version")
    return entries


def wall_ms(fn):
    """Host-clock time of one call that ends in a synchronise (for the plain versions: hundreds of
    launches, timed once)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def rel_err(a, b):
    """max |a - b| over the entries where b is finite, relative to the largest such |b|."""
    fin = torch.isfinite(b)
    return float((a - b)[fin].abs().max() / b[fin].abs().max())


def phase_kernels_chol(batch, gen):
    """K4 / K5 against their plain versions at the shapes the staged solver gives them; returns the
    entries of the ``kernels`` line."""
    from diffopt_tpu_torch.ops.cuda import chol
    from diffopt_tpu_torch.utils.testing import make_batch

    n, m, p = N_VARS, N_INEQ, N_EQ
    entries = {}
    for dtype, B in ((torch.float32, batch), (torch.float64, min(batch, 4096))):
        tag = "f32" if dtype == torch.float32 else "f64"
        main = dtype == torch.float32
        item = 4 if main else 8
        qp = make_batch(B, n, m, p, dtype, DEVICE, gen)
        reg = 1e-7 if main else 1e-11
        # the matrices of the staged solver's start: H = Q + G'G + reg I, S = A H^-1 A' + reg I
        H = (qp.Q + qp.G.transpose(1, 2) @ qp.G + reg * torch.eye(n, dtype=dtype, device=DEVICE)).contiguous()
        At = qp.A.transpose(1, 2).contiguous()

        # --- K4 at n = 64 ---------------------------------------------------------
        Lh = chol.cholesky_batched(H)
        Lhp, plain_ms = wall_ms(lambda: chol.cholesky_batched_plain(H))
        err = rel_err(Lh, Lhp)
        recon = float((Lh @ Lh.transpose(1, 2) - H).abs().max() / H.abs().max())
        upper = float(torch.triu(Lh, 1).abs().max())
        print(f"[kernels] chol_factor {tag} B={B} n={n}: max|dL| / max|L| = {err:.3e} (tol {TOL_CHOL[dtype]:.0e});"
              f" |L L' - H| / |H| = {recon:.3e}; above the diagonal {upper:.1e}")
        check(bool(torch.isfinite(Lh).all()), f"chol_factor {tag}: non-finite output")
        check(err <= TOL_CHOL[dtype] and recon <= 10 * TOL_CHOL[dtype] and upper == 0.0,
              f"chol_factor {tag} n={n} disagrees with its plain version")
        if main:
            ms = time_ms(lambda: chol.cholesky_batched(H), reps=5)
            lib_ms = time_ms(lambda: torch.linalg.cholesky_ex(H), reps=2)
            # the lower triangle of H read, L written in full (zeros above the diagonal included)
            b_ms, b_by = bound(B * item * (n * (n + 1) // 2 + n * n), B * n**3 / 3)
            entries["chol_factor"] = dict(
                name="chol_factor", route="cuda", source="diffopt_tpu_torch/csrc/chol.cu",
                replaces="diffopt_tpu/ops/pallas/chol.py:42", max_abs_err=float((Lh - Lhp).abs().max()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            )

        # --- K5 at n = 64: k = 16 (H^-1 A') and k = 1 ---------------------------------
        rhs1 = torch.randn(B, n, dtype=dtype, device=DEVICE, generator=gen)
        for k, rhs in ((p, At), (1, rhs1)):
            x = chol.cholesky_solve_batched(Lh, rhs)
            xp, plain_ms = wall_ms(lambda: chol.cholesky_solve_batched_plain(Lh, rhs))
            err = rel_err(x, xp)
            r2 = rhs if rhs.ndim == 3 else rhs[..., None]
            x2 = x if x.ndim == 3 else x[..., None]
            resid = float((H.double() @ x2.double() - r2.double()).abs().max() / r2.abs().max())
            ms = time_ms(lambda: chol.cholesky_solve_batched(Lh, rhs), reps=5) if main else float("nan")
            print(f"[kernels] chol_solve {tag} B={B} n={n} k={k}: max|dx| / max|x| = {err:.3e} (tol"
                  f" {TOL_CHOL_SOLVE[dtype]:.0e}); |H x - rhs| / |rhs| = {resid:.3e}; {ms:.3f} ms, plain {plain_ms:.1f} ms")
            check(bool(torch.isfinite(x).all()), f"chol_solve {tag}: non-finite output")
            check(err <= TOL_CHOL_SOLVE[dtype], f"chol_solve {tag} n={n} k={k} disagrees with its plain version")
            if main and k == 1:
                lib_ms = time_ms(lambda: torch.cholesky_solve(rhs[..., None], Lh), reps=2)
                # the lower triangle of L and rhs read, x written
                b_ms, b_by = bound(B * item * (n * (n + 1) // 2 + 2 * n * k), B * 2 * n * n * k)
                entries["chol_solve"] = dict(
                    name="chol_solve", route="cuda", source="diffopt_tpu_torch/csrc/chol.cu",
                    replaces="diffopt_tpu/ops/pallas/chol.py:59", max_abs_err=float((x - xp).abs().max()), ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                )
            if k == p:
                HiAt = x

        # --- K4 / K5 at n = 16: the Schur complement -----------------------------------
        S = (qp.A @ HiAt + reg * torch.eye(p, dtype=dtype, device=DEVICE)).contiguous()
        Ls, Lsp = chol.cholesky_batched(S), chol.cholesky_batched_plain(S)
        err = rel_err(Ls, Lsp)
        ms4 = time_ms(lambda: chol.cholesky_batched(S), reps=5) if main else float("nan")
        check(bool(torch.isfinite(Ls).all()) and err <= TOL_CHOL[dtype], f"chol_factor {tag} n={p} disagrees with plain")
        errs = []
        for k in (1, p):
            rhs = torch.randn(*((B, p) if k == 1 else (B, p, k)), dtype=dtype, device=DEVICE, generator=gen)
            xs, xsp = chol.cholesky_solve_batched(Ls, rhs), chol.cholesky_solve_batched_plain(Ls, rhs)
            errs.append(rel_err(xs, xsp))
            if k == 1:
                ms5 = time_ms(lambda: chol.cholesky_solve_batched(Ls, rhs), reps=5) if main else float("nan")
        print(f"[kernels] chol_factor / chol_solve {tag} B={B} n={p}: relative diff {err:.3e} / k=1 {errs[0]:.3e},"
              f" k={p} {errs[1]:.3e}; {ms4:.3f} ms / {ms5:.3f} ms (k=1)")
        check(max(errs) <= TOL_CHOL_SOLVE[dtype], f"chol_solve {tag} n={p} disagrees with its plain version")
        del qp, H, At, Lh, Lhp, HiAt, S, Ls, Lsp
        torch.cuda.empty_cache()

    # --- past n = 128: the factor works in shared memory ----------------------------
    nbig, Bb = 160, 256
    X = torch.randn(Bb, nbig, nbig, dtype=torch.float32, device=DEVICE, generator=gen)
    Hb = X @ X.transpose(1, 2) / nbig + torch.eye(nbig, device=DEVICE)
    Lb, Lbp = chol.cholesky_batched(Hb), chol.cholesky_batched_plain(Hb)
    rb = torch.randn(Bb, nbig, 3, dtype=torch.float32, device=DEVICE, generator=gen)
    xb, xbp = chol.cholesky_solve_batched(Lb, rb), chol.cholesky_solve_batched_plain(Lb, rb)
    err_b, err_x = rel_err(Lb, Lbp), rel_err(xb, xbp)
    print(f"[kernels] chol_factor / chol_solve f32 n={nbig} B={Bb} k=3: relative diff {err_b:.3e} / {err_x:.3e}"
          f" (tol {TOL_CHOL[torch.float32]:.0e} / {TOL_CHOL_SOLVE[torch.float32]:.0e})")
    check(err_b <= TOL_CHOL[torch.float32] and err_x <= TOL_CHOL_SOLVE[torch.float32], "Cholesky past n = 128 disagrees")

    # --- matrices that are not positive definite: NaN from the failing pivot on, in kernel, plain version
    # and library route alike, and no error ------------------------------------------------
    for nn in (N_VARS, nbig):
        X = torch.randn(64, nn, nn, dtype=torch.float32, device=DEVICE, generator=gen)
        Hn = X @ X.transpose(1, 2) / nn + torch.eye(nn, device=DEVICE)
        Hn[3] = -Hn[3]  # fails at pivot 0
        Hn[5, nn // 2, nn // 2] = -1.0  # fails half way
        Hn[9, nn - 1, nn - 1] = -1.0  # fails at the last pivot
        Ln, Lnp, Lnl = chol.cholesky_batched(Hn), chol.cholesky_batched_plain(Hn), chol._cholesky_library(Hn)
        torch.cuda.synchronize()
        fin = torch.isfinite(Lnp)
        bad = sorted((~fin).flatten(1).any(dim=1).nonzero().flatten().tolist())
        xn = chol.cholesky_solve_batched(Ln, torch.ones(64, nn, device=DEVICE))
        nan_rows = sorted(torch.isnan(xn).all(dim=1).nonzero().flatten().tolist())
        print(f"[kernels] chol_factor f32 n={nn}, 3 of 64 matrices not positive definite: NaN instances {bad} in the"
              f" plain version, same NaN pattern in the kernel {bool((torch.isfinite(Ln) == fin).all())} and the library"
              f" route {bool((torch.isfinite(Lnl) == fin).all())}; solves all-NaN on {nan_rows}")
        check(bad == [3, 5, 9] and nan_rows == [3, 5, 9], "non-positive-definite matrices: wrong instances are NaN")
        check(bool((torch.isfinite(Ln) == fin).all()) and bool((torch.isfinite(Lnl) == fin).all()),
              "non-positive-definite matrices: NaN patterns differ")
        check(rel_err(Ln, Lnp) <= TOL_CHOL[torch.float32], "finite part of the factor disagrees with the plain version")
    return entries


def phase_k1_mu_zero(gen):
    """K1 on a batch where mu underflows to exactly 0 while the loop runs on: every inequality row is far
    inactive (h + 1000), so lam shrinks a hundredfold per body until it is 0, and tol = 0 keeps the
    instances from ever being 'done'. The kernel latches a freeze; its plain version re-evaluates it in
    every body, as the reference does. They agree if the re-evaluation never un-freezes an instance."""
    from diffopt_tpu_torch import QuadProgram
    from diffopt_tpu_torch.ops.cuda import pdip
    from diffopt_tpu_torch.utils.testing import make_batch

    qp = make_batch(2048, N_VARS, N_INEQ, N_EQ, torch.float32, DEVICE, gen)
    qp = QuadProgram(qp.Q, qp.q, qp.A, qp.b, qp.G, qp.h + 1000.0)
    sol, its = pdip.solve_batched_fused(qp, max_iters=80, tol=0.0, return_iters=True)
    psol, pits = pdip.solve_batched_fused_plain(qp, max_iters=80, tol=0.0, return_iters=True)
    torch.cuda.synchronize()
    lam_zero = float((sol.lam == 0).all(dim=1).float().mean())
    plam_zero = float((psol.lam == 0).all(dim=1).float().mean())
    zerr = (sol.z - psol.z).abs().amax(dim=1) / (1.0 + psol.z.abs().amax(dim=1))
    nuerr = (sol.nu - psol.nu).abs().amax(dim=1) / (1.0 + psol.nu.abs().amax(dim=1))
    worst = float(torch.maximum(zerr, nuerr).max())
    far = float(((its - pits).abs() > 1).float().mean())
    print(
        f"[kernels] pdip_fused f32 B=2048, rows far inactive, tol=0, 80 bodies: lam == 0 (mu == 0) at the exit on"
        f" {lam_zero:.2%} of instances (plain {plam_zero:.2%}); iterations mean {float(its.float().mean()):.2f} vs plain"
        f" {float(pits.float().mean()):.2f}, differ by more than one on {far:.3%}; max relative diff of z, nu {worst:.3e}"
        " (tol 1e-04)"
    )
    check(all(bool(torch.isfinite(t).all()) for t in sol.tensors()), "pdip_fused with mu == 0: non-finite output")
    check(lam_zero >= 0.5 and plam_zero >= 0.5, "the batch did not reach mu == 0")
    check(worst <= 1e-4 and far <= 0.01, "pdip_fused and its plain version part ways once mu == 0")


def phase_main(batch, gen):
    """solve_qp_batched forward + backward at full width; returns launch counts and the rate."""
    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.ops import kkt
    from diffopt_tpu_torch.ops.cuda import chol, pdip
    from diffopt_tpu_torch.utils.testing import make_batch

    n, m, p = N_VARS, N_INEQ, N_EQ
    qp = make_batch(batch, n, m, p, torch.float32, DEVICE, gen).map(lambda t: t.requires_grad_())

    def step():
        for t in qp.tensors():
            t.grad = None
        sol, info = dtt.solve_qp_batched(qp, max_iters=25, with_info=True)
        loss = (sol.z**2).sum()
        loss.backward()
        return sol, info, loss

    wrappers = reset_counts()
    step()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        sol, info, loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: w.launches for k, w in wrappers.items()}

    steps = STEPS + 1
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"[main] launches over {steps} steps: {launches} (per step {per_step})")
    check(per_step == {"pdip_fused": 1, "ldl_factor": 2, "ldl_solve": 6, "chol_factor": 0, "chol_solve": 0},
          f"unexpected launch counts {per_step}")

    grads = [t.grad for t in qp.tensors()]
    check(all(g is not None and g.shape == t.shape for g, t in zip(grads, qp.tensors())), "missing gradient")
    check(all(bool(torch.isfinite(t).all()) for t in sol.tensors()), "non-finite solution")
    check(all(bool(torch.isfinite(g).all()) for g in grads), "non-finite gradient")
    check(sol.z.shape == (batch, n) and sol.lam.shape == (batch, m) and sol.nu.shape == (batch, p), "wrong shapes")
    conv = float(info.converged.float().mean())
    res = float(torch.maximum(info.primal_residual, info.dual_residual).max())
    its = info.iterations.float()
    print(
        f"[main] B={batch} n={n} m={m} p={p} f32: loss {loss.item():.6e}, converged {conv:.4%}, max relative KKT"
        f" residual {res:.3e}, iterations mean {float(its.mean()):.2f} max {int(its.max())}"
    )
    check(conv >= 0.99, f"only {conv:.3%} of the instances converged")
    # `converged` allows 10 x the solver's tolerance (5e-5); an unconverged instance sits a little above
    check(res <= 1e-3, f"relative KKT residual {res:.3e}: an instance is far from solved")
    check(int(its.min()) >= 1 and int(its.max()) <= 25, "iteration counts out of range")

    # gradients of a subset against the same call routed through the plain versions
    sub = min(batch, 512)
    qs = dtt.QuadProgram(*(t.detach()[:sub].clone().requires_grad_() for t in qp.tensors()))
    with plain_kernels():
        before = dict(launches)
        psol = dtt.solve_qp_batched(qs, max_iters=25)
        (psol.z**2).sum().backward()
        check({k: w.launches for k, w in wrappers.items()} == before, "plain route launched a kernel")
    worst = 0.0
    for name, t, g in zip("QqAbGh", qs.tensors(), grads):
        scale = float(t.grad.abs().max())
        # compare per instance: an instance whose active set sits on the fence can be classified
        # differently by the two f32 runs, so a share of instances is allowed to differ
        diff = (g[:sub] - t.grad).abs().flatten(1).amax(dim=1) / scale
        share_off = float((diff > TOL_GRAD).float().mean())
        worst = max(worst, float(diff.median()))
        print(
            f"[main] grad d{name}: median relative diff to the plain route {float(diff.median()):.3e},"
            f" max {float(diff.max()):.3e}, above {TOL_GRAD:.0e} on {share_off:.3%} of {sub} instances"
        )
        check(share_off <= 0.02, f"gradient d{name} differs from the plain route on {share_off:.3%} of instances")
    # and the f32 solutions against the plain version run in f64 on the same subset
    q64 = dtt.QuadProgram(*(t.detach()[:sub].double() for t in qp.tensors()))
    ref = kkt.qp_polish(q64, pdip.solve_batched_fused_plain(q64, max_iters=30))
    zerr = (sol.z[:sub].double() - ref.z).abs().amax(dim=1) / (1.0 + ref.z.abs().amax(dim=1))
    print(f"[main] z against the f64 plain solve: median {zerr.median().item():.3e}, max {zerr.max().item():.3e}")
    check(
        zerr.median().item() <= 1e-4 and (zerr > 1e-2).float().mean().item() <= 0.01,
        "f32 solutions off the f64 reference",
    )

    med = sorted(times)[len(times) // 2]
    return launches, batch / med, med


def reset_counts():
    """Every launch counter and host-sync counter of the port to 0; returns the objects that carry them."""
    from diffopt_tpu_torch.ops import kkt
    from diffopt_tpu_torch.ops.cuda import chol, pdip
    from diffopt_tpu_torch.solvers import qp as qpsolver

    wrappers = {
        "pdip_fused": pdip.solve_batched_fused,
        "ldl_factor": chol.ldl_batched,
        "ldl_solve": chol.ldl_solve_batched,
        "chol_factor": chol.cholesky_batched,
        "chol_solve": chol.cholesky_solve_batched,
    }
    for w in wrappers.values():
        w.launches = 0
    qpsolver.solve_batched.host_syncs = 0
    kkt._auto_solve.host_syncs = 0
    return wrappers


def grad_diff_share(grads, ref_grads, label, tag):
    """Per-instance difference of two sets of data gradients, relative to the largest entry of the
    reference; prints one line per tensor and fails if more than 2% of the instances are off by more
    than TOL_GRAD (an instance whose active set sits on the fence is classified differently by two f32
    runs, so a share of instances is allowed to differ)."""
    for name, g, r in zip("QqAbGh", grads, ref_grads):
        if r.numel() == 0:
            continue
        scale = float(r.abs().max())
        diff = (g.to(r.dtype) - r).abs().flatten(1).amax(dim=1) / scale
        share_off = float((diff > TOL_GRAD).float().mean())
        print(f"[{tag}] grad d{name}: median relative diff to {label} {float(diff.median()):.3e},"
              f" max {float(diff.max()):.3e}, above {TOL_GRAD:.0e} on {share_off:.3%} of {len(diff)} instances")
        check(bool(torch.isfinite(g).all()), f"{tag}: non-finite gradient d{name}")
        check(share_off <= 0.02, f"{tag}: gradient d{name} differs from {label} on {share_off:.3%} of instances")


def phase_staged(batch, gen):
    """solve_qp (staged solver, defaults) forward + backward at full width; returns launch counts and
    the figures of the ``staged`` line."""
    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.ops import kkt
    from diffopt_tpu_torch.ops.cuda import pdip
    from diffopt_tpu_torch.solvers import qp as qpsolver

    from diffopt_tpu_torch.utils.testing import make_batch

    n, m, p = N_VARS, N_INEQ, N_EQ
    qp = make_batch(batch, n, m, p, torch.float32, DEVICE, gen).map(lambda t: t.requires_grad_())

    def step():
        for t in qp.tensors():
            t.grad = None
        sol, info = dtt.solve_qp(qp, with_info=True)  # max_iters, tol, reg, method: the config's defaults
        loss = (sol.z**2).sum()
        loss.backward()
        return sol, info, loss

    wrappers = reset_counts()
    step()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        sol, info, loss = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    steps = STEPS + 1
    launches = {k: w.launches for k, w in wrappers.items()}
    syncs = (qpsolver.solve_batched.host_syncs + kkt._auto_solve.host_syncs) / steps
    bodies = int(info.iterations.max())
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"[staged] launches over {steps} steps: {launches}; per step {per_step}; {bodies} interior-point bodies and"
          f" {syncs:.0f} device-to-host copies per step")
    # the start factors H and S and solves four times; a body factors both and solves seven times
    # (one of them with k = p right-hand sides); the default KKT route ('auto' -> LU) launches none
    expect = {"pdip_fused": 0, "ldl_factor": 0, "ldl_solve": 0, "chol_factor": 2 + 2 * bodies, "chol_solve": 4 + 7 * bodies}
    check(per_step == expect, f"staged path: launch counts per step {per_step}, expected {expect}")
    check(syncs == bodies + 1, f"staged path: {syncs} host syncs per step, expected {bodies + 1}")

    grads = [t.grad for t in qp.tensors()]
    check(all(g is not None and g.shape == t.shape for g, t in zip(grads, qp.tensors())), "staged: missing gradient")
    check(sol.z.shape == (batch, n) and sol.lam.shape == (batch, m) and sol.nu.shape == (batch, p), "staged: wrong shapes")
    check(all(bool(torch.isfinite(t).all()) for t in sol.tensors()), "staged: non-finite solution")
    own = float(info.converged.float().mean())
    its = info.iterations.float()
    # the solver's own flag is absolute (pres, dres, mu < 10 / 10 / 100 tol) and out of reach in f32 at this
    # scale; the scale-relative metrics are what judges the f32 solve
    rel = dtt.kkt_metrics(qp.map(torch.Tensor.detach), sol.map(torch.Tensor.detach))
    conv = float(rel.converged.float().mean())
    resid = torch.maximum(rel.primal_residual, rel.dual_residual)
    res, far = float(resid.max()), float((resid > 1e-3).float().mean())
    print(f"[staged] B={batch} n={n} m={m} p={p} f32: loss {loss.item():.6e}; iterations mean {float(its.mean()):.2f}"
          f" max {bodies}; the solver's own (absolute) flag says converged on {own:.4%}; scale-relative kkt_metrics:"
          f" converged {conv:.4%}, relative KKT residual median {float(resid.median()):.3e}, max {res:.3e}, above 1e-03"
          f" on {far:.4%}")
    # the staged f32 solve has no stall exit and no best-iterate tracking: an instance that cannot meet the
    # absolute test runs on until its condensed system breaks down in f32, and is frozen by the NaN guard at
    # its last finite iterate, which on about a tenth of this distribution sits a little above 10 x tol
    check(conv >= 0.85, f"staged: only {conv:.3%} of the instances meet the scale-relative criterion")
    check(far <= 0.02, f"staged: {far:.3%} of the instances are left with a relative KKT residual above 1e-3")

    # z against the fused solver's on the same batch
    fused = pdip.solve_batched_fused(qp.map(torch.Tensor.detach), max_iters=25)
    zerr = (sol.z.detach() - fused.z).abs().amax(dim=1) / (1.0 + fused.z.abs().amax(dim=1))
    med, q99, worst = (float(torch.quantile(zerr[:65536], q)) for q in (0.5, 0.99, 1.0))
    tol = TOL_STAGED_VS_FUSED
    print(f"[staged] z against the fused solver's: per-instance relative diff median {med:.3e} (tol {tol['median']:.0e}),"
          f" 99% {q99:.3e} (tol {tol['q99']:.0e}), max {worst:.3e} (tol {tol['max']:.0e})")
    check(med <= tol["median"] and q99 <= tol["q99"] and worst <= tol["max"], "staged and fused solutions disagree")

    # gradients of a subset against the LDL' route (kernels K2 / K3) on the same staged solutions
    sub = min(batch, 512)
    qs = dtt.QuadProgram(*(t.detach()[:sub].clone().requires_grad_() for t in qp.tensors()))
    (dtt.solve_qp(qs, method="ldl").z ** 2).sum().backward()
    grad_diff_share([g[:sub] for g in grads], [t.grad for t in qs.tensors()], "the LDL' route", "staged")

    # in f64 the absolute test is within reach: the solver's own flag is the judge
    B64 = min(batch, 4096)
    sol64, info64 = dtt.solve_qp(make_batch(B64, n, m, p, torch.float64, DEVICE, gen), with_info=True)
    own64 = float(info64.converged.float().mean())
    print(f"[staged] f64 B={B64}: the solver's own flag says converged on {own64:.4%}; iterations mean"
          f" {float(info64.iterations.float().mean()):.2f} max {int(info64.iterations.max())}")
    check(own64 >= 0.999 and bool(torch.isfinite(sol64.z).all()), f"staged f64: only {own64:.3%} converged")

    med_t = sorted(times)[len(times) // 2]
    stats = {
        "solves_vjps_per_s": batch / med_t, "step_ms": med_t * 1e3, "batch": batch,
        "chol_factor_launches_per_step": per_step["chol_factor"], "chol_solve_launches_per_step": per_step["chol_solve"],
        "host_syncs_per_step": syncs, "mean_iterations": float(its.mean()), "bodies": bodies,
        "converged_share_own_flag": own, "converged_share_scale_relative": conv,
    }
    return launches, stats


def phase_routes(batch, gen):
    """The other routes of the slice at a smaller batch: p = 0 through solve_qp_batched, an LP batch through
    method='auto', the forward rule against a finite difference, QPDiffContext against the uncached verbs."""
    import torch.autograd.forward_ad as fwAD

    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.ops import kkt
    from diffopt_tpu_torch.utils.testing import make_batch

    B = min(batch, 4096)
    n, m, p = N_VARS, N_INEQ, N_EQ
    sub = min(B, 512)

    # --- p = 0: the fused entry routes to the staged solver by shape -------------------------
    qp0 = make_batch(B, n, m, 0, torch.float32, DEVICE, gen).map(lambda t: t.requires_grad_())
    wrappers = reset_counts()
    sol, info = dtt.solve_qp_batched(qp0, with_info=True)
    (sol.z**2).sum().backward()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    conv = float(info.converged.float().mean())
    print(f"[routes] p = 0 through solve_qp_batched, B={B} n={n} m={m} f32: launches {launches}; converged"
          f" (scale-relative) {conv:.4%}; iterations mean {float(info.iterations.float().mean()):.2f}")
    check(launches["pdip_fused"] == 0 and launches["chol_factor"] > 0 and launches["chol_solve"] > 0
          and launches["ldl_factor"] == 2 and launches["ldl_solve"] == 6, f"p = 0 route: unexpected launches {launches}")
    check(conv >= 0.99 and bool(torch.isfinite(sol.z).all()), f"p = 0 route: converged share {conv:.3%}")
    q64 = dtt.QuadProgram(*(t.detach()[:sub].double().requires_grad_() for t in qp0.tensors()))
    (dtt.solve_qp_batched(q64).z ** 2).sum().backward()
    grad_diff_share([t.grad[:sub] for t in qp0.tensors()], [t.grad for t in q64.tensors()], "the f64 run", "routes p=0")

    # --- an LP batch (Q = 0) in a box, through method='auto' ---------------------------------------
    nl, ml = 16, 8
    box = torch.eye(nl, device=DEVICE)
    G = torch.cat([torch.randn(B, ml, nl, device=DEVICE, generator=gen), box.expand(B, nl, nl), -box.expand(B, nl, nl)], dim=1)
    h = torch.cat([torch.rand(B, ml, device=DEVICE, generator=gen) + 0.5, torch.ones(B, 2 * nl, device=DEVICE)], dim=1)
    lp = dtt.QuadProgram(
        torch.zeros(B, nl, nl, device=DEVICE), torch.randn(B, nl, device=DEVICE, generator=gen),
        torch.zeros(B, 0, nl, device=DEVICE), torch.zeros(B, 0, device=DEVICE), G, h,
    )
    out = {}
    for dtype in (torch.float32, torch.float64):
        q = lp.map(lambda t: t.detach().to(dtype).clone().requires_grad_())
        sol, info = dtt.solve_qp(q, with_info=True)  # method=None -> 'auto': every instance is an LP -> lstsq
        (sol.z**2).sum().backward()
        out[dtype] = (sol.z.detach(), q.q.grad, q.h.grad, info, sol.lam.detach())
    torch.cuda.synchronize()
    z32, gq32, gh32, info32, _ = out[torch.float32]
    z64, gq64, gh64, info64, _ = out[torch.float64]
    conv64 = float(info64.converged.float().mean())
    zerr = (z32.double() - z64).abs().amax(dim=1)
    print(f"[routes] LP batch B={B} n={nl} m={ml + 2 * nl} through 'auto': f64 converged {conv64:.4%} (own flag), iterations"
          f" mean {float(info64.iterations.float().mean()):.2f}; f32 z against f64: median {float(zerr.median()):.3e},"
          f" 99% {float(torch.quantile(zerr, 0.99)):.3e}")
    check(conv64 >= 0.99, f"LP batch: only {conv64:.3%} converged in f64")
    check(bool(torch.isfinite(gh64).all() and torch.isfinite(gq64).all()), "LP batch: non-finite f64 gradient (LU of a singular KKT matrix?)")
    check(float(zerr.median()) <= 1e-4, "LP batch: f32 solutions off the f64 ones")
    # f64 against the closed form: at a nondegenerate vertex exactly n rows are active, z = Ga^-1 ha, so for
    # the loss sum(z^2) the gradient with respect to the active entries of h is Ga^-T (2 z), and 0 elsewhere
    act = out[torch.float64][4] > 1e-6
    nondeg = act.sum(dim=1) == nl
    idx = torch.argsort(act.to(torch.int8), dim=1, descending=True, stable=True)[nondeg, :nl]  # the active rows
    G64, h64 = lp.G.double()[nondeg], lp.h.double()[nondeg]
    Ga = torch.gather(G64, 1, idx[:, :, None].expand(-1, -1, nl))
    za = torch.linalg.solve(Ga, torch.gather(h64, 1, idx)[..., None])
    want = torch.zeros_like(h64).scatter(1, idx, torch.linalg.solve(Ga.transpose(1, 2), 2 * za)[..., 0])
    aerr = float((gh64[nondeg] - want).abs().max() / want.abs().max())
    print(f"[routes] LP grad dh, f64 against the closed form at the vertex on the {float(nondeg.float().mean()):.2%} of"
          f" instances with exactly {nl} active rows: relative diff {aerr:.3e} (tol 1e-05)")
    check(float(nondeg.float().mean()) >= 0.9 and aerr <= 1e-5, "LP batch: f64 gradient off the closed form")
    # In f32 the interior-point iterate sits 1e-6 off the vertex and the least-squares route forms J'J, whose
    # eigenvalues below eps * N * the largest are dropped: singular values of J below 3e-3 of the largest are
    # treated as null. The f32 gradient is right on the median instance and wrong on the ill-conditioned tail
    # (the reference's algorithm; LPs want f64). Reported per instance, relative to max(1, the instance's
    # largest f64 entry); the check holds the median and bounds the tail.
    for name, g32, g64 in (("dh", gh32, gh64), ("dq", gq32, gq64)):
        diff = (g32.double() - g64).abs().amax(dim=1) / torch.clamp(g64.abs().amax(dim=1), min=1.0)
        med, q75 = float(diff.median()), float(torch.quantile(diff, 0.75))
        off = float((diff > 0.5).float().mean())
        print(f"[routes] LP grad {name}: f32 against f64, per instance: median {med:.3e} (tol 1e-02), 75% {q75:.3e},"
              f" above 0.5 on {off:.3%} of {B} instances (tol 40%); largest f64 entry {float(g64.abs().max()):.3e}")
        check(bool(torch.isfinite(g32).all()), f"LP batch: non-finite f32 gradient {name}")
        check(med <= 1e-2 and off <= 0.40, f"LP batch: f32 gradient {name} off the f64 one")

    # --- forward rule against a central finite difference, f64 ---------------------------------
    Bj = min(B, 256)
    base = make_batch(Bj, n, m, p, torch.float64, DEVICE, gen)
    tan = base.map(lambda t: 0.1 * torch.randn(t.shape, dtype=t.dtype, device=DEVICE, generator=gen))
    tan = dtt.QuadProgram(0.5 * (tan.Q + tan.Q.transpose(1, 2)), *tan.tensors()[1:])
    with fwAD.dual_level():
        dual = dtt.QuadProgram(*(fwAD.make_dual(x, d) for x, d in zip(base.tensors(), tan.tensors())))
        dz = fwAD.unpack_dual(dtt.solve_qp(dual, mode="jvp").z).tangent
    eps = 1e-5
    shifted = lambda sgn: dtt.QuadProgram(*(x + sgn * eps * d for x, d in zip(base.tensors(), tan.tensors())))
    fd = (dtt.solve_qp(shifted(+1)).z - dtt.solve_qp(shifted(-1)).z) / (2 * eps)
    # per instance, relative to the largest entry of the difference quotient; an instance with a weakly active
    # row has a kink within eps of its data, where a difference quotient is no derivative
    jerr = (dz - fd).abs().amax(dim=1) / fd.abs().max()
    jmed, jq95, jmax = (float(torch.quantile(jerr, q)) for q in (0.5, 0.95, 1.0))
    print(f"[routes] solve_qp(mode='jvp') against a central difference (eps {eps:.0e}), f64 B={Bj}: per-instance relative"
          f" diff median {jmed:.3e} (tol 1e-07), 95% {jq95:.3e} (tol 1e-05), max {jmax:.3e} (tol 1e-02)")
    check(jmed <= 1e-7 and jq95 <= 1e-5 and jmax <= 1e-2, "forward rule disagrees with the finite difference")

    # --- QPDiffContext: cached LU against the uncached verbs ---------------------------------------
    ctx = dtt.QPDiffContext(base)
    dqp = dtt.QPTangent(*tan.tensors())
    seeds = [torch.randn(Bj, k, dtype=torch.float64, device=DEVICE, generator=gen) for k in (n, m, p)]
    fwd, fwd_ref = ctx.forward(dqp), kkt.qp_forward(base, ctx.sol, dqp, method="lu")
    t_fwd = ctx.differentiate_time_sec
    rev, (rev_ref, _) = ctx.reverse(*seeds), kkt.qp_reverse(base, ctx.sol, *seeds, method="lu")
    cerr = max(
        max(rel_err(a, b) for a, b in zip(fwd, fwd_ref)),
        max(rel_err(a, b) for a, b in zip(rev.tensors(), rev_ref.tensors())),
    )
    print(f"[routes] QPDiffContext.forward / reverse against qp_forward / qp_reverse, f64 B={Bj}: relative diff {cerr:.3e}"
          f" (tol 1e-09); differentiate_time_sec {t_fwd:.2e} / {ctx.differentiate_time_sec:.2e}")
    check(cerr <= 1e-9 and t_fwd > 0 and ctx.differentiate_time_sec > 0, "QPDiffContext disagrees with the uncached verbs")


def phase_qp100(batch, gen):
    """n = 100, m = 48, p = 24 (N = 172) solve + VJP: fused forward, LDL' VJP past the register tiles."""
    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.utils.testing import make_batch

    B = min(batch, 8192)
    n, m, p = 100, 48, 24
    qp = make_batch(B, n, m, p, torch.float32, DEVICE, gen).map(lambda t: t.requires_grad_())

    def step():
        for t in qp.tensors():
            t.grad = None
        sol, info = dtt.solve_qp_batched(qp, max_iters=25, with_info=True)
        (sol.z**2).sum().backward()
        return sol, info

    wrappers = reset_counts()
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        sol, info = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: w.launches / (STEPS + 1) for k, w in wrappers.items()}
    check(launches == {"pdip_fused": 1, "ldl_factor": 2, "ldl_solve": 6, "chol_factor": 0, "chol_solve": 0},
          f"qp100: unexpected launches per step {launches}")
    conv = float(info.converged.float().mean())
    med = sorted(times)[len(times) // 2]
    print(f"[qp100] B={B} n={n} m={m} p={p} (N={n + m + p}) f32 solve + VJP: {B / med:.1f} solves+VJPs per second (median step"
          f" {med * 1e3:.2f} ms); converged {conv:.4%}; iterations mean {float(info.iterations.float().mean()):.2f}")
    check(conv >= 0.99 and bool(torch.isfinite(sol.z).all()), f"qp100: converged share {conv:.3%}")
    sub = min(B, 512)
    qs = dtt.QuadProgram(*(t.detach()[:sub].clone().requires_grad_() for t in qp.tensors()))
    (dtt.solve_qp_batched(qs, max_iters=25, method="lu").z ** 2).sum().backward()
    grad_diff_share([t.grad[:sub] for t in qp.tensors()], [t.grad for t in qs.tensors()], "the LU route", "qp100")
    return {"solves_vjps_per_s": B / med, "step_ms": med * 1e3, "batch": B}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32768, help="instances in the batch (default: the full size)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import diffopt_tpu_torch  # noqa: F401  (fails here when run outside the repository)

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(args.seed)

    t_start = time.perf_counter()
    phase_build()
    entries = phase_kernels(args.batch, gen)
    entries.update(phase_kernels_chol(args.batch, gen))
    phase_k1_mu_zero(gen)
    launches, rate, step_s = phase_main(args.batch, gen)
    staged_launches, staged = phase_staged(args.batch, gen)
    # each kernel's count is read from the run of its own path: K1-K3 the main path's, K4 / K5 the staged one's
    for name, e in entries.items():
        e["launches"] = (staged_launches if name.startswith("chol_") else launches)[name]
        check(e["launches"] > 0, f"{name} was not launched on its path")
    phase_routes(args.batch, gen)
    qp100 = phase_qp100(args.batch, gen)
    print(
        f"[main] {rate:.1f} QP solves+VJPs per second (median step {step_s * 1e3:.2f} ms, B = {args.batch}) on {card}"
    )
    print(
        f"[staged] {staged['solves_vjps_per_s']:.1f} QP solves+VJPs per second (median step {staged['step_ms']:.2f} ms,"
        f" B = {args.batch}) on {card}: {rate / staged['solves_vjps_per_s']:.1f} x slower than the main path"
    )
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the device check")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"main": {"solves_vjps_per_s": rate, "step_ms": step_s * 1e3, "batch": args.batch, "card": card}}))
    print(json.dumps({"staged": {**staged, "card": card}}))
    print(json.dumps({"qp100": {**qp100, "card": card}}))
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
