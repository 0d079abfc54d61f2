#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run, B = 32768
    python3 chip_smoke.py --batch N  # the same phases at a smaller batch

Phases, each of which fails the run (non-zero exit) if it fails:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them;
2. build: compiles ``diffopt_tpu_torch/csrc/*.cu`` with ``nvcc`` (first use);
3. kernels against their plain PyTorch versions on the card, at the shapes the
   main path gives them (n = 64, m = 32, p = 16, N = 112, k = 1), f32 at the
   full batch and f64 at a smaller one, plus the fused solver's unstaged mode;
   each kernel is timed beside its plain version and, where one PyTorch call
   computes the same function, beside that call (a yardstick only);
4. main path: ``solve_qp_batched`` forward + backward on a random batch of
   dense QPs at full width, a warm-up and three timed steps; checks finite
   outputs and gradients, the converged share, the relative KKT residuals, the
   launch counts of every kernel, and the gradients of a 512-instance subset
   against the same call routed through the plain versions;
5. prints one JSON line ``{"kernels": [...]}``, the card's name and power
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
    for name in ("ldl", "pdip"):
        _build.load(name)
    print(f"[build] nvcc, {time.perf_counter() - t0:.1f} s (into {_build.build_dir()})")
    for log in sorted(_build.build_dir().glob("*.nvcc.log")):
        for line in log.read_text().splitlines():
            if "Used" in line or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line):
                print(f"[build] {log.name}: {line.strip()}")


def kkt_systems(qp, sol):
    """Symmetrised quasi-definite KKT matrices of solved instances (what the VJP factors)."""
    from diffopt_tpu_torch.ops import kkt

    f64 = qp.Q.dtype == torch.float64
    K, _ = kkt._kkt_symmetric(qp, sol, 1e-12 if f64 else 1e-6, 1e-11 if f64 else 1e-6)
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


def phase_main(batch, gen):
    """solve_qp_batched forward + backward at full width; returns launch counts and the rate."""
    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.ops import kkt
    from diffopt_tpu_torch.ops.cuda import chol, pdip
    from diffopt_tpu_torch.utils.testing import make_batch

    n, m, p = N_VARS, N_INEQ, N_EQ
    qp = make_batch(batch, n, m, p, torch.float32, DEVICE, gen).map(lambda t: t.requires_grad_())
    wrappers = {
        "pdip_fused": pdip.solve_batched_fused,
        "ldl_factor": chol.ldl_batched,
        "ldl_solve": chol.ldl_solve_batched,
    }

    def step():
        for t in qp.tensors():
            t.grad = None
        sol, info = dtt.solve_qp_batched(qp, max_iters=25, with_info=True)
        loss = (sol.z**2).sum()
        loss.backward()
        return sol, info, loss

    for w in wrappers.values():
        w.launches = 0
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
    check(per_step == {"pdip_fused": 1, "ldl_factor": 2, "ldl_solve": 6}, f"unexpected launch counts {per_step}")

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
    launches, rate, step_s = phase_main(args.batch, gen)
    for name, e in entries.items():
        e["launches"] = launches[name]
        check(e["launches"] > 0, f"{name} was not launched on the main path")
    print(
        f"[main] {rate:.1f} QP solves+VJPs per second (median step {step_s * 1e3:.2f} ms, B = {args.batch}) on {card}"
    )
    print(f"[done] {time.perf_counter() - t_start:.1f} s after the device check")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"main": {"solves_vjps_per_s": rate, "step_ms": step_s * 1e3, "batch": args.batch, "card": card}}))
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
