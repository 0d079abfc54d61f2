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
   N = 112, k = 1), f32 at the full batch and f64 at a smaller one; the LDL'
   pair (K2 / K3) also at ``[qp100]``'s N = 172 (B = 8192, f32; N = 169, the
   end of the f64 envelope, in f64), at N = 24, 64 and 100 (a small N for each
   team the rule picks), and at N = 160, each at every team that takes it,
   with a tail batch, timed by team; the
   Cholesky pair (K4 / K5) at every shape a path here launches it at and a
   few beside them (factor n = 3, 6, 16, 17, 18, 34, 44, 64, 144, 160; solve
   (n, k) = (3, 1), (6, 1), (16, 1), (16, 16), (17, 1), (18, 1), (34, 1),
   (44, 1), (64, 1), (64, 16), (144, 1), (160, 3)) at every team that takes
   each, with a tail batch, timed by team; the fused solver (K1) at every team
   size that takes each shape (the headline: two and eight warps; n = 100,
   m = 48, p = 24: eight; n = 32, m = 16, p = 8 and n = 40, m = 20, p = 10:
   one, two and eight), timed by team, and a team that does not take a shape
   refused; the routes past 128 rows, matrices that are not
   positive definite, and a batch on which the fused solver runs on with
   mu == 0; each kernel is timed beside its plain version and, where one
   PyTorch call computes the same function, beside that call (a yardstick
   only);
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
6. the symmetric-cone path: the fused conic IPM (K6) against its plain
   version (the SOCP of BASELINE config 3 in f32 at the full batch and in
   f64, the SDP side 4 in f32 and f64, a layout with every symmetric kind on
   four draws and a psd side-8 batch in f64), then ``solve_conic_batched`` forward + backward
   on that SOCP at full width (B = 32768, n = 16, SOC(17), f32; launch counts,
   converged share, f32 gradients of 512 instances against f64), the SDP
   family at psd sides 4, 8 and 16 (B = 4096), and at small batches
   ``solve_conic`` (staged IPM) against K6, its forward rule against a central
   difference, ``ConicDiffContext``, ``lsqr`` past the LSQR threshold on the
   staged solver's condensed route, ``ParametricProgram(kind="conic")`` and an
   exp-cone program against its analytic solution;
7. the nonsymmetric-cone path: the fused dual-scaling IPM (K7) at every team
   size that takes each layout (the same bits at every team) against its
   plain version (the entropy family of the exp benchmark in f32 at B = 16384
   and in f64, the pow family and a dual_exp layout in f64: f32 as a stated
   distribution, f64 exactly through the first 8 bodies and, to the
   tolerance, within the plain version's own spread under a one-ulp change of
   the data), then ``[exp]``: ``solve_conic_batched`` forward + backward of
   ``sum(x**2)`` on the entropy family (B = 16384, k = 3, f32; launch counts,
   converged share, f32 gradients of 512 instances against f64), and
   ``[ns-routes]`` at small batches in f64: the staged nonsymmetric IPM
   against K7 and on a psd + exp layout, the forward rule against a central
   difference, ``ConicDiffContext``, the DR splitting on an equality-only
   program and on the entropy family, the exp / pow DPi against a central
   difference of Pi, and a padded heterogeneous exp / pow batch;
8. the NLP path: ``[nlp]`` at the shape of the JAX package's NLP benchmark
   (BASELINE config 4: n = 16, nc = 8 equalities, B = 16384, f32,
   ``max_iters=40, tol=1e-6``): the bench's step (the embedded solver, its
   Newton systems on K2 / K3 at N = 24, then the forward sensitivity dx) and
   ``solve_nlp`` forward + backward of ``sum(x**2)``, each a warm-up and three
   timed steps (launch counts by shape, host syncs, converged share), 512
   instances of the path against the same calls through the plain K2 / K3 in
   f64 and f32, K2 / K3 held and timed on the path's own Newton systems, and
   the same instances going non-finite in K2 / K3 and their plain versions
   on systems with a zero pivot;
   then ``[nlp-routes]`` at small batches in f64, each call on the card against
   the same call on the host: the solver with every constraint kind and finite
   bounds, min and max, ``solve_nlp``'s reverse and forward rules,
   ``NLPDiffContext``, ``ParametricProgram(kind="nlp")``, the route past 128
   rows, an inertia-corrected singular KKT matrix and ``bridges.qp_via_conic``
   with its gradient against ``solve_qp``; the f32 NLP routes (K2 / K3 and
   their plain versions) are each held against the f64 solution of the same
   512 instances;
9. the two-stage Schur path (``[two-stage]``, BASELINE config 5): the JAX
   package's two-stage bench's step (``solve_two_stage``, then
   ``two_stage_forward_sensitivity`` along the data, loss ``sum(z**2) +
   sum(dxs**2)``; n = 8, m = 4, p = 2, c = 4, f32) at S = 8192 and S = 100,000,
   a warm-up and three timed steps each (launch counts by shape: one K2 and
   K3 at k = c, 1, 1 a Schur solve, one Schur solve to start and two a body,
   one for the sensitivity; host syncs; the global converged flag, the
   residuals and bodies; z and xs of the solution and of the sensitivity
   against the f64 step on the same data, whose solve must converge), K2 at
   N = 10 / 14 and K3 at (10, 4), (10, 1), (14, 4), (14, 1) held and timed on the path's own
   systems (S = 8192), and the same step in a one-process NCCL group, which
   must give the ``group=None`` run's bits;
10. the compile gate (``[entry]``): ``graft_entry.entry()``'s step (the fused QP
   solver at n = 16 and 100 with its LDL' VJP, the fused conic solvers on a
   SOCP, an SDP, an N = 90 layout with every symmetric kind and an exp / pow
   layout, B = 8) in f32 and f64: finite value and gradient, K1-K7 each
   launched, and each kernel held against its plain version, with the checks
   of the kernels phase, on the inputs of its first launch at each of the
   step's shapes (captured around the wrappers); then ``[dryrun]``:
   ``graft_entry.dryrun_multichip`` over every card of the machine, one
   process a card in one NCCL group, each part held against the one-process
   result, K1-K6 launched inside the group;
11. ``[native]``: the C++ packer builds and agrees with ``np.add.at``, its
   batches on the card;
12. ``[examples]``: every ``examples/*_torch.py`` on the card at its file's
   sizes, held to its closed form (ReLU and its gradient, the dispatch and
   ridge sensitivities, Higham's nearest correlation matrix, the
   unit-commitment prices, softmax and its Jacobian), its outputs on the card;
13. prints the JSON lines ``main``, ``staged``, ``qp100``, ``conic``, ``sdp``,
   ``exp``, ``nlp``, ``two_stage``, ``entry``, ``dryrun``, ``k6_teams``, ``k7_teams``, ``k1_teams``,
   ``chol_teams``, ``ldl_teams`` and
   ``{"kernels": [...]}`` (K1-K7; K2 and K3 at N = 112, 172, 24, 10 and 14, K4 and K5 one
   entry per shape a path launched them at, with its launches per step on
   each path; the gate's shapes as ``entry_*`` with their launches on its f32 step),
   the card's name and power limit, and as the last line ``{"ok": true,
   "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
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


def graph_ms(fn, reps=10):
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA graph, replayed and timed by
    CUDA events. Launched one by one through its wrapper, a kernel of a few microseconds waits on the
    host (the wrapper's Python), and CUDA events around back-to-back calls would time the host."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
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
    for name in ("chol", "conic_pdip", "ldl", "ns_pdip", "pdip"):
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


def k1_hold(qp, tag):
    """K1 at every team size that takes the batch's shape, each against its plain version (run once), at
    TOL_PDIP and with iteration counts more than one apart on at most 1%. Returns ``{team: (sol,
    iterations, max abs diff)}``, the plain ``(sol, iterations)`` and the plain version's wall ms."""
    from diffopt_tpu_torch.ops.cuda import pdip

    B, n, m, p, item = qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq, qp.Q.element_size()
    tol = TOL_PDIP[qp.Q.dtype]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psol, pits = pdip.solve_batched_fused_plain(qp, max_iters=25, return_iters=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    held = {}
    for team in (t for t in pdip.TEAMS if pdip.team_takes(n, m, p, item, t)):
        sol, its = pdip.solve_batched_fused(qp, max_iters=25, return_iters=True, team=team)
        # per-instance error over z, lam, nu, relative to 1 + the largest entry of the plain result
        inst_err = torch.stack([
            (getattr(sol, k) - getattr(psol, k)).abs().amax(dim=1) / (1.0 + getattr(psol, k).abs().amax(dim=1))
            for k in ("z", "lam", "nu")
        ]).amax(dim=0)
        max_abs = max(float((getattr(sol, k) - getattr(psol, k)).abs().max()) for k in ("z", "lam", "nu"))
        med, q99, worst = (float(torch.quantile(inst_err.double(), q)) for q in (0.5, 0.99, 1.0))
        moved = float((its != pits).float().mean())
        far = float(((its - pits).abs() > 1).float().mean())
        label = f"pdip_fused {tag} n={n} m={m} p={p} team {team}"
        print(
            f"[kernels] {label} B={B} ({'staged' if pdip.stage_for(n, m, p, item, team) else 'unstaged'}): max abs diff"
            f" {max_abs:.3e}; per-instance relative diff median {med:.3e} (tol {tol['median']:.0e}), 99% {q99:.3e}"
            f" (tol {tol['q99']:.0e}), max {worst:.3e} (tol {tol['max']:.0e}); iterations mean"
            f" {float(its.float().mean()):.2f} vs plain {float(pits.float().mean()):.2f}, differ on {moved:.4%} of"
            f" instances, by more than one on {far:.4%}"
        )
        check(all(torch.isfinite(getattr(sol, k)).all() for k in ("z", "lam", "nu")), f"{label}: non-finite output")
        check(
            med <= tol["median"] and q99 <= tol["q99"] and worst <= tol["max"],
            f"{label} disagrees with its plain version: median {med:.3e}, 99% {q99:.3e}, max {worst:.3e}",
        )
        check(far <= 0.01, f"{label}: iteration counts differ by more than one on {far:.3%}")
        held[team] = (sol, its, max_abs)
    check(pdip.team_for(n, m, p, item) in held, f"pdip_fused {tag}: the launch rule's team does not take the shape")
    return held, (psol, pits), plain_ms


def k1_bound(qp, its):
    """K1's bound on the batch ``qp``: Q, q, A, b, G, h read, z, lam, nu and the counts written; the operations of
    the bodies this run's instances ran (``its``), the init counted as one more."""
    B, n, m, p, item = qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq, qp.Q.element_size()
    return bound(B * item * (n * n + (m + p) * (n + 1) + n + (n + 2 * m + p) + 1),
                 float((its.double() + 1).sum()) * pdip_flops_per_iteration(n, m, p))


def k1_shape_record(n, m, p, B, team, ms_by_team, plain_ms):
    """One shape's entry of the k1_teams line: K1's ms and resident teams per SM by team (f32)."""
    from diffopt_tpu_torch.ops.cuda import pdip

    return {"n": n, "m": m, "p": p, "B": B, "team": team, "plain_ms": plain_ms,
            "ms_by_team": {str(t): v for t, v in ms_by_team.items()},
            "resident_by_team": {str(t): pdip.blocks_per_sm(n, m, p, torch.float32, t) for t in ms_by_team},
            "staged_by_team": {str(t): pdip.stage_for(n, m, p, 4, t) for t in ms_by_team}}


def k1_teams_text(n, m, p, ms_by_team):
    from diffopt_tpu_torch.ops.cuda import pdip

    return ", ".join(f"{t}: {ms:.3f} ({pdip.blocks_per_sm(n, m, p, torch.float32, t)} resident per SM,"
                     f" {pdip.instances_per_sm(n, m, p, 4, t, pdip.stage_for(n, m, p, 4, t))} by the model)"
                     for t, ms in ms_by_team.items())


def phase_k1_teams(batch, gen):
    """K1 at the shapes where its launch rule picks the other teams, each team that takes the shape against
    the plain version in f32 and f64 and timed in f32: n = 100, m = 48, p = 24 (eight warps), n = 32,
    m = 16, p = 8 (one warp; two and eight, which stage Q, G and A, take it too) and n = 40, m = 20,
    p = 10 (the most rows one warp takes, where one and two warps meet). Then that a team which
    does not take a shape is refused. Data from a generator of its own, so that the phases after this one
    see the same data as without it. Returns the shapes' entries of the k1_teams line."""
    from diffopt_tpu_torch.ops.cuda import pdip
    from diffopt_tpu_torch.utils.testing import make_batch

    tgen = torch.Generator(device=DEVICE)
    tgen.manual_seed(gen.initial_seed() + 2)
    record = {}
    shapes = (("n100", (100, 48, 24), min(batch, 8192)), ("small", (32, 16, 8), min(batch, 4096)),
              ("n40", (40, 20, 10), min(batch, 4096)))
    for name, (n, m, p), B in shapes:
        for dtype, Bd in ((torch.float32, B), (torch.float64, min(B, 1024))):
            qp = make_batch(Bd, n, m, p, dtype, DEVICE, tgen)
            held, _, plain_ms = k1_hold(qp, "f32" if dtype == torch.float32 else "f64")
            if dtype == torch.float32:
                team = pdip.team_for(n, m, p, 4)
                ms_by_team = {t: time_ms(lambda: pdip.solve_batched_fused(qp, max_iters=25, team=t), reps=3)
                              for t in held}
                record[name] = k1_shape_record(n, m, p, B, team, ms_by_team, plain_ms)
                print(f"[kernels] pdip_fused {name} f32 B={B} n={n} m={m} p={p}: ms by team "
                      + k1_teams_text(n, m, p, ms_by_team) + f"; the launch rule picks {team}")
            del qp, held
    # a team that does not take a shape is refused, never replaced: n = 64 is past one warp's tiles
    qp = make_batch(4, N_VARS, N_INEQ, N_EQ, torch.float32, DEVICE, tgen)
    refused = False
    try:
        pdip.solve_batched_fused(qp, team=1)
    except ValueError:
        refused = True
    check(refused, "pdip_fused: a team of one warp took n = 64")
    print("[kernels] pdip_fused: a team of one warp at n = 64 is refused (ValueError), as it must be")
    return record


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

        # --- K1: fused PDIP, at every team size that takes the shape -----------
        held, (psol, pits), plain_ms = k1_hold(qp, tag)
        team = pdip.team_for(n, m, p, qp.Q.element_size())
        sol, its, max_abs = held[team]
        if main:
            ms_by_team = {t: time_ms(lambda: pdip.solve_batched_fused(qp, max_iters=25, team=t), reps=3) for t in held}
            b_ms, b_by = k1_bound(qp, its)
            entries["pdip_fused"] = dict(
                name="pdip_fused", route="cuda", source="diffopt_tpu_torch/csrc/pdip.cu",
                replaces="diffopt_tpu/ops/pallas/pdip.py:204", max_abs_err=max_abs, ms=ms_by_team[team],
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, team_warps=team,
                ms_by_team={str(t): v for t, v in ms_by_team.items()},
                k1_headline=k1_shape_record(n, m, p, B, team, ms_by_team, plain_ms),
            )
            print(f"[kernels] pdip_fused {tag} B={B}: {ms_by_team[team]:.3f} ms with a team of {team} warps (bound"
                  f" {b_ms:.3f} ms by {b_by}); ms by team " + k1_teams_text(n, m, p, ms_by_team))
        del held

        # --- K2 / K3: LDL' factor and solve on the path's KKT systems, at every team that takes N ----------
        K = kkt_systems(qp, sol)
        rhs = torch.randn(B, N, dtype=dtype, device=DEVICE, generator=gen)
        del qp, sol, psol
        recs = _hold_ldl(chol, K, rhs, main)
        # several right-hand sides at once
        rhs3 = torch.randn(min(B, 512), N, 3, dtype=dtype, device=DEVICE, generator=gen)
        _hold_ldl(chol, K[:512].contiguous(), rhs3, False, solve_only=True)
        if main:  # the main path's entries keep their names
            entries["ldl_factor"], entries["ldl_solve"] = (dict(r, name=nm) for r, nm in zip(recs, ("ldl_factor", "ldl_solve")))
            entries["ldl_teams_main"] = ldl_teams_records(recs)
        del K, rhs, rhs3
        torch.cuda.empty_cache()

    # --- K2 / K3 at N = 160 (eight warps, the register tiles' largest cover in f32) ---
    Nbig = 160
    Kb = torch.randn(256, Nbig, Nbig, dtype=torch.float32, device=DEVICE, generator=gen)
    Kb = Kb @ Kb.transpose(1, 2) / Nbig + torch.eye(Nbig, device=DEVICE)
    Kb[:, Nbig // 2:, Nbig // 2:] *= -1.0  # quasi-definite: [[P, C'], [C, -R]]
    Kb = torch.tril(Kb) + torch.tril(Kb, -1).transpose(1, 2)
    rb = torch.randn(256, Nbig, dtype=torch.float32, device=DEVICE, generator=gen)
    _hold_ldl(chol, Kb, rb, False)

    # --- K1 off the main path's shape: Q, G, A left in device memory (working set too large to
    # stage beside H in f64) ---
    n2, m2, p2, B2 = 100, 48, 24, 256
    check(not pdip.stage_for(n2, m2, p2, 8, pdip.team_for(n2, m2, p2, 8)), "unexpected staging mode")
    qp = make_batch(B2, n2, m2, p2, torch.float64, DEVICE, gen)
    sol = pdip.solve_batched_fused(qp, max_iters=25)
    psol = pdip.solve_batched_fused_plain(qp, max_iters=25)
    worst = float(torch.stack([
        (getattr(sol, k) - getattr(psol, k)).abs().amax(dim=1) / (1.0 + getattr(psol, k).abs().amax(dim=1))
        for k in ("z", "lam", "nu")
    ]).max())
    print(f"[kernels] pdip_fused f64 unstaged B={B2} n={n2} m={m2} p={p2} (a team of {pdip.team_for(n2, m2, p2, 8)}"
          f" warps): max per-instance relative diff {worst:.3e}"
          " (tol 1e-06)")
    check(worst <= 1e-6, f"pdip_fused at n = {n2} disagrees with its plain version")
    return entries


def _quasi_definite(B, N, dtype, g):
    """[[P, C'], [C, -R]] with P, R positive definite, the first 58% of the rows positive (the QP paths'
    n of N), symmetric, on the card."""
    M = torch.randn(B, N, N, dtype=dtype, device=DEVICE, generator=g)
    K = M @ M.transpose(1, 2) / N + torch.eye(N, dtype=dtype, device=DEVICE)
    n1 = (N * 58 + 99) // 100
    K[:, n1:, n1:] *= -1.0
    return (torch.tril(K) + torch.tril(K, -1).transpose(1, 2)).contiguous()


def _ldl_teams_run(chol, op, N, k, item, run, ref_check, args, outs_of, B, dtype, main, tag):
    """Every team that takes the shape: its output held by ref_check, the same bits at every team, a tail
    batch of B - 3 through the library; device ms by team (CUDA graph) and instances per SM where main.
    Returns (the rule's output, its team and per block, ms by team, instances per SM, teams)."""
    kk = 0 if op == "factor" else k
    teams = [t for t in (chol.FACTOR_TEAMS if op == "factor" else chol.LDL_SOLVE_TEAMS) if chol.ldl_team_takes(N, kk, item, t)]
    rule = chol.ldl_team_for(N, kk, item)
    check(rule[0] in teams, f"ldl {op} {tag}: the rule's team {rule[0]} does not take the shape")
    outs, ms_by, resident = {}, {}, {}
    for t in teams:
        out = run(team=t)
        ref_check(out, t)
        outs[t] = out
        Bt = B - 3 if B > 3 else B
        bufs = [torch.full_like(o, 7.0) for o in outs_of(out)]
        _raw_tail(chol._ldl_lib(), "ldl", op, args, bufs, Bt, N, k, t)
        check(all(torch.equal(bf[:Bt], o[:Bt]) and bool((bf[Bt:] == 7.0).all()) for bf, o in zip(bufs, outs_of(out))),
              f"ldl {op} {tag} team {t}: a tail batch of {Bt} differs or writes past its end")
        if main:
            ms_by[str(t)] = graph_ms(lambda: run(team=t))
            resident[str(t)] = chol.ldl_blocks_per_sm(N, kk, dtype, t)
            torch.cuda.empty_cache()
    same = all(all(torch.equal(a, b) for a, b in zip(outs_of(o), outs_of(outs[rule[0]]))) for o in outs.values())
    check(same, f"ldl {op} {tag}: teams {teams} give different bits")
    return outs[rule[0]], rule, ms_by, resident, teams


def _hold_ldl(chol, K, rhs, main, solve_only=False):
    """K2 on the quasi-definite batch K and K3 with its factor and the right-hand sides rhs, against their
    plain versions at the unchanged TOL_LDL / TOL_SOLVE, at every team that takes the shape (the same bits
    at every team), each with a tail batch; where main (f32 at a path's batch): device ms and instances per
    SM by team, and the records of the ``kernels`` line (bound, plain and library ms). Returns the two
    records (None where not main)."""
    B, N, dtype = K.shape[0], K.shape[1], K.dtype
    item = K.element_size()
    k = 1 if rhs.ndim == 2 else rhs.shape[2]
    tag = ("f32" if dtype == torch.float32 else "f64") + f" B={B} N={N}"
    (Lp, dp), plain_f = wall_ms(lambda: chol.ldl_batched_plain(K))
    lscale = float(Lp.abs().max())
    recs = [None, None]
    if not solve_only:
        def factor_check(out, t):
            L, d = out
            err_f, err_d = float((L - Lp).abs().max()), float(((d - dp) / dp).abs().max())
            check(bool(torch.isfinite(L).all() and torch.isfinite(d).all()), f"ldl_factor {tag} team {t}: non-finite output")
            check(err_f <= TOL_LDL[dtype] * lscale, f"ldl_factor {tag} team {t}: L {err_f:.3e} from its plain version")
            check(err_d <= TOL_LDL[dtype], f"ldl_factor {tag} team {t}: d {err_d:.3e} from its plain version")
            check(float(torch.triu(L, 1).abs().max()) == 0.0 and bool((torch.diagonal(L, dim1=1, dim2=2) == 1).all()),
                  f"ldl_factor {tag} team {t}: L is not unit-lower with zeros above the diagonal")
        (L, d), rule, ms_by, resident, teams = _ldl_teams_run(
            chol, "factor", N, 0, item, lambda **kw: chol.ldl_batched(K, **kw), factor_check, (K,), lambda o: o,
            B, dtype, main, tag)
        err_f = float((L - Lp).abs().max())
        err_d = float(((d - dp) / dp).abs().max())
        recon = float((L @ (d[:, :, None] * L.transpose(1, 2)) - K).abs().max() / K.abs().max())
        check(recon <= TOL_LDL[dtype], f"ldl_factor {tag} does not reconstruct K")
        print(f"[kernels] ldl_factor {tag}: max|dL| = {err_f:.3e} (largest entry {lscale:.3e}), max|dd/d| = {err_d:.3e}"
              f" (tol {TOL_LDL[dtype]:.0e}, relative); |L D L' - K| / |K| = {recon:.3e}; teams {teams} (rule"
              f" {_launch_tag(rule)}), tail batches exact, the same bits at every team; plain {plain_f:.1f} ms"
              + (f"; device ms by team (CUDA graph) {ms_by}, instances per SM {resident}" if main else ""))
        if main:
            lib_ms = time_ms(lambda: torch.linalg.lu_factor(K), reps=2)
            # K is symmetric: its lower triangle is all the function needs; L (with its zeroed upper
            # triangle) and d are written in full
            b_ms, b_by = bound(B * item * (N * (N + 1) // 2 + N * N + N), B * N**3 / 3)
            recs[0] = dict(name=f"ldl_factor_N{N}", route="cuda",
                           source="diffopt_tpu_torch/csrc/ldl.cu", replaces="diffopt_tpu/ops/pallas/chol.py:171",
                           max_abs_err=err_f, ms=ms_by[str(rule[0])], plain_ms=plain_f, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, batch=B, team_warps=rule[0], per_block=rule[1], ms_by_team=ms_by,
                           instances_per_sm=resident)
    else:
        L, d = Lp, dp
    (xp, plain_s) = wall_ms(lambda: chol.ldl_solve_batched_plain(L, d, rhs))
    xscale = float(xp.abs().max())

    def solve_check(x, t):
        err_s = float((x - xp).abs().max())
        check(bool(torch.isfinite(x).all()), f"ldl_solve {tag} k={k} team {t}: non-finite output")
        check(err_s <= TOL_SOLVE[dtype] * xscale, f"ldl_solve {tag} k={k} team {t}: {err_s:.3e} from its plain version")
    x, rule, ms_by, resident, teams = _ldl_teams_run(
        chol, "solve", N, k, item, lambda **kw: chol.ldl_solve_batched(L, d, rhs, **kw), solve_check, (L, d, rhs),
        lambda o: (o,), B, dtype, main, tag + f" k={k}")
    err_s = float((x - xp).abs().max())
    # residual of the factored system (L D L') x = rhs, in f64
    Ld, xd = L.double(), x.double() if k > 1 else x.double()[..., None]
    resid = Ld @ (d.double()[..., None] * (Ld.transpose(1, 2) @ xd)) - (rhs.double() if k > 1 else rhs.double()[..., None])
    rel_res = float(resid.abs().max() / rhs.abs().max())
    del Ld, xd, resid
    print(f"[kernels] ldl_solve {tag} k={k}: max|dx| = {err_s:.3e} (largest entry {xscale:.3e}, tol"
          f" {TOL_SOLVE[dtype]:.0e} of it); |L D L' x - rhs| / |rhs| = {rel_res:.3e}; teams {teams} (rule"
          f" {_launch_tag(rule)}), tail batches exact, the same bits at every team; plain {plain_s:.1f} ms"
          + (f"; device ms by team (CUDA graph) {ms_by}, instances per SM {resident}" if main else ""))
    if main:
        lu, piv = torch.linalg.lu_factor(K)
        lib_ms = time_ms(lambda: torch.linalg.lu_solve(lu, piv, rhs if k > 1 else rhs[..., None]), reps=2)
        del lu, piv
        # the strict lower triangle of L, d and rhs read, x written
        b_ms, b_by = bound(B * item * (N * (N - 1) // 2 + N + 2 * N * k), B * 2 * N * N * k)
        recs[1] = dict(name=f"ldl_solve_N{N}_k{k}", route="cuda",
                       source="diffopt_tpu_torch/csrc/ldl.cu", replaces="diffopt_tpu/ops/pallas/chol.py:188",
                       max_abs_err=err_s, ms=ms_by[str(rule[0])], plain_ms=plain_s, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms, batch=B, team_warps=rule[0], per_block=rule[1], ms_by_team=ms_by,
                       instances_per_sm=resident)
    return recs


def ldl_teams_records(recs):
    """The ``ldl_teams`` line's records of kernels-line records: ms and instances per SM by team."""
    return {r["name"]: dict(rule=_launch_tag((r["team_warps"], r["per_block"])), batch=r["batch"],
                            ms_by_team=r["ms_by_team"], instances_per_sm=r["instances_per_sm"], bound_ms=r["bound_ms"],
                            plain_ms=r["plain_ms"], library_ms=r["library_ms"]) for r in recs}


QP100 = (100, 48, 24)  # the [qp100] path: N = 172


def phase_kernels_ldl(batch, gen):
    """K2 / K3 beside the main path's N = 112 (held in phase_kernels): [qp100]'s N = 172 at its batch in f32
    (eight warps in registers) and N = 169, the end of the f64 envelope, in f64 (the packed shared-memory
    route), and a small N for each team the rule picks (factor: 24 one warp, 64 two warps, 100 two warps
    in f32 and eight in f64; solve: one warp at 24 and 64, four at 100), each at every team that takes it,
    with k = 1 and, at 172, k = 3; teams that do not take a shape refused.
    Inputs from a generator of this phase's own. Returns the kernels-line entries for N = 172 and the
    ``ldl_teams`` record."""
    from diffopt_tpu_torch.ops.cuda import chol

    own = torch.Generator(device=DEVICE)
    own.manual_seed(gen.initial_seed() + 11)
    N100 = sum(QP100)
    entries, teams = {}, {}
    for N, dtype, B in ((N100, torch.float32, min(batch, 8192)), (169, torch.float64, min(batch, 1024)),
                        (24, torch.float32, min(batch, 4096)), (24, torch.float64, min(batch, 1024)),
                        (64, torch.float32, min(batch, 4096)), (64, torch.float64, min(batch, 1024)),
                        (100, torch.float32, min(batch, 4096)), (100, torch.float64, min(batch, 1024))):
        K = _quasi_definite(B, N, dtype, own)
        rhs = torch.randn(B, N, dtype=dtype, device=DEVICE, generator=own)
        main = dtype == torch.float32
        recs = _hold_ldl(chol, K, rhs, main)
        if N == N100 and main:
            entries.update({r["name"]: r for r in recs})
            rhs3 = torch.randn(min(B, 512), N, 3, dtype=dtype, device=DEVICE, generator=own)
            _hold_ldl(chol, K[:512].contiguous(), rhs3, False, solve_only=True)
        if main:
            teams.update(ldl_teams_records(recs))
        del K, rhs
        torch.cuda.empty_cache()
    # teams that do not take a shape are refused, never replaced by another
    K = _quasi_definite(8, N_KKT, torch.float32, own)
    Kb = _quasi_definite(8, N100, torch.float32, own)
    for what, call in (("a one-warp factor at N = 112", lambda: chol.ldl_batched(K, team=1)),
                       ("a four-warp factor team", lambda: chol.ldl_batched(K, team=4)),
                       ("a two-warp factor past 128 rows", lambda: chol.ldl_batched(Kb, team=2)),
                       ("a three-warp solve team for one right-hand side",
                        lambda: chol.ldl_solve_batched(K, K[:, 0], K[:, :, 0], team=3)),
                       ("a one-warp solve for 3 right-hand sides",
                        lambda: chol.ldl_solve_batched(K, K[:, 0], K[:, :, :3], team=1))):
        try:
            call()
        except ValueError:
            continue
        check(False, f"ldl: {what} was not refused")
    print("[kernels] ldl: teams that do not take a shape are refused (a one-warp factor at N = 112, a four-warp factor"
          " team, a two-warp factor past 128 rows, three warps for one right-hand side, one warp for three)")
    return entries, teams


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


# the shapes the port launches K4 / K5 at, with the batch of the path that launches each: the staged QP
# path (n = 64: H, its k = 1 solves and H^-1 A' at k = p = 16; n = 16: the Schur complement S and its
# k = 1 solves), the gram route of the conic polish and VJP (n = n + m + 1 of the HSDE map: 34 on the
# SOCP, 17 on the [exp] entropy family, 18 / 44 / 144 on the [sdp] sides 4 / 8 / 16) and the condensed
# route of the staged conic solver on the [sdp] side 16 (n = 3, the variables). Held beside them, and
# launched by no path driven here: n = 6 (a small gram system), (16, 16) (k > 1 at n <= 32), and n = 160
# with (160, 3) at B = 256 (a factor and a k > 1 solve past 128 rows, which the staged solvers reach with
# more than 128 variables). In f32 the factors at n = 144 and 160 run in eight warps' registers, in f64
# in shared memory (ops/cuda/chol.py::chol_tile_max_n)
CHOL_FACTOR_SHAPES = {3: 4096, 6: 16384, 16: 32768, 17: 16384, 18: 4096, 34: 32768, 44: 4096, 64: 32768,
                      144: 4096, 160: 256}
CHOL_SOLVE_SHAPES = {(3, 1): 4096, (6, 1): 16384, (16, 1): 32768, (16, 16): 32768, (17, 1): 16384,
                     (18, 1): 4096, (34, 1): 32768, (44, 1): 4096, (64, 1): 32768, (64, 16): 32768,
                     (144, 1): 4096, (160, 3): 256}


def _spd(B, n, dtype, gen):
    X = torch.randn(B, n, n, dtype=dtype, device=DEVICE, generator=gen)
    return (X @ X.transpose(1, 2) / n + torch.eye(n, dtype=dtype, device=DEVICE)).contiguous()


def _launch_tag(launch):
    return f"{launch[0]}x{launch[1]}"


def _raw_tail(lib, pair, op, ins, outs, B, n, k, team):
    """Launch K2-K5 (``pair`` 'ldl' or 'chol') through the library itself on the first B instances while
    the output buffers hold more: what a kernel writes past B shows as a changed entry there."""
    sfx = "f32" if outs[0].dtype == torch.float32 else "f64"
    sizes = (B, n) if op == "factor" else (B, n, k)
    code = getattr(lib, f"{pair}_{op}_{sfx}")(*(t.data_ptr() for t in (*ins, *outs)), *sizes, team,
                                             torch.cuda.current_stream().cuda_stream)
    check(code == 0, f"{pair} {op} n={n} k={k} team {team}: CUDA error {code} on a tail batch")
    torch.cuda.synchronize()


def _hold_chol(chol, op, H, rhs, main):
    """K4 (op 'factor', on the SPD batch H) or K5 ('solve', with the factor of H and the right-hand sides
    rhs) against its plain version, at every team that takes the shape (each with the rule's instances
    per block); a tail batch at each; returns the record of the shape (device times by team where
    main)."""
    B, n, dtype = H.shape[0], H.shape[1], H.dtype
    k = 0 if op == "factor" else (1 if rhs.ndim == 2 else rhs.shape[2])
    item = 4 if dtype == torch.float32 else 8
    kk = 0 if op == "factor" else k
    tag = ("f32" if main else "f64") + f" B={B} n={n}" + (f" k={k}" if k else "")
    if op == "factor":
        args = (H,)
        run = lambda **kw: chol.cholesky_batched(H, **kw)
        ref, plain_ms = wall_ms(lambda: chol.cholesky_batched_plain(H))
        tol = TOL_CHOL[dtype]
    else:
        L = chol.cholesky_batched_plain(H)
        args = (L, rhs)
        run = lambda **kw: chol.cholesky_solve_batched(L, rhs, **kw)
        ref, plain_ms = wall_ms(lambda: chol.cholesky_solve_batched_plain(L, rhs))
        tol = TOL_CHOL_SOLVE[dtype]
    teams = [t for t in (chol.FACTOR_TEAMS if op == "factor" else chol.SOLVE_TEAMS) if chol.team_takes(n, kk, item, t)]
    rule = chol.team_for(n, kk, item)
    check(rule[0] in teams, f"chol {op} {tag}: the rule's team {rule[0]} does not take the shape")
    outs, ms_by, resident, worst = {}, {}, {}, 0.0
    for t in teams:
        out = run(team=t)
        err = rel_err(out, ref)
        worst = max(worst, err)
        check(bool(torch.isfinite(out).all()), f"chol {op} {tag} team {t}: non-finite output")
        check(err <= tol, f"chol {op} {tag} team {t}: {err:.3e} from its plain version (tol {tol:.0e})")
        if op == "factor":
            check(float(torch.triu(out, 1).abs().max()) == 0.0, f"chol factor {tag} team {t}: entries above the diagonal")
            recon = float((out @ out.transpose(1, 2) - H).abs().max() / H.abs().max())
            check(recon <= 10 * tol, f"chol factor {tag} team {t}: |L L' - H| / |H| = {recon:.3e}")
        outs[t] = out
        # a batch that is not a multiple of the instances per block: the same instances, nothing past them
        Bt = B - 3 if B > 3 else B
        buf = torch.full((B,) + tuple(out.shape[1:]), 7.0, dtype=dtype, device=DEVICE)
        _raw_tail(chol._chol_lib(), "chol", op, args, (buf,), Bt, n, k, t)
        check(torch.equal(buf[:Bt], out[:Bt]) and bool((buf[Bt:] == 7.0).all()),
              f"chol {op} {tag} team {t}: a tail batch of {Bt} differs or writes past its end")
        if main:
            ms_by[str(t)] = graph_ms(lambda: run(team=t))
            resident[str(t)] = chol.blocks_per_sm(n, kk, dtype, t)
            torch.cuda.empty_cache()
    same = all(torch.equal(o, outs[rule[0]]) for o in outs.values())
    print(f"[kernels] chol_{op} {tag}: max relative diff to the plain version {worst:.3e} (tol {tol:.0e}) over teams"
          f" {teams} (rule {_launch_tag(rule)}: team x instances per block), tail batches exact, the same bits at"
          f" every team {same}; plain {plain_ms:.1f} ms"
          + (f"; device ms by team (CUDA graph) {ms_by}, instances per SM {resident}" if main else ""))
    if not main:
        return None
    out = outs[rule[0]]
    eager_ms = time_ms(lambda: run(), reps=10)  # one wrapper call after another: the host's time where it is longer
    if op == "factor":
        lib_ms = time_ms(lambda: torch.linalg.cholesky_ex(H), reps=3)
        nbytes, flops = B * item * (n * (n + 1) // 2 + n * n), B * n**3 / 3
    else:
        r3 = rhs[..., None] if k == 1 else rhs
        lib_ms = time_ms(lambda: torch.cholesky_solve(r3, L), reps=3)
        nbytes, flops = B * item * (n * (n + 1) // 2 + 2 * n * k), B * 2 * n * n * k
    b_ms, b_by = bound(nbytes, flops)
    return dict(name=f"chol_{op}_n{n}" + (f"_k{k}" if k else ""), route="cuda",
                source="diffopt_tpu_torch/csrc/chol.cu",
                replaces="diffopt_tpu/ops/pallas/chol.py:42" if op == "factor" else "diffopt_tpu/ops/pallas/chol.py:59",
                max_abs_err=float((out - ref).abs().max()), ms=ms_by[str(rule[0])], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, batch=B, team_warps=rule[0], per_block=rule[1],
                ms_by_team=ms_by, instances_per_sm=resident, eager_ms=eager_ms)


def phase_kernels_chol(batch, gen):
    """K4 / K5 against their plain versions at every shape the port launches them at (CHOL_FACTOR_SHAPES,
    CHOL_SOLVE_SHAPES), each at every team that takes it, f32 at the path's batch and f64 at a smaller
    one, with a tail batch each; timed by team (the ``chol_teams`` line); teams that do not take a
    shape refused; matrices that are not positive definite at every factor team. Returns the
    per-shape entries of the ``kernels`` line and the ``chol_teams`` record.

    Inputs: the staged QP solver's start matrices (H = Q + G'G + reg I with H^-1 A' and a vector, S =
    A H^-1 A' + reg I with one and p right-hand sides), the conic gram route's n = 34 system, the
    n = 160 system and the indefinite n = 64 and 160 batches in f32 come from the shared generator, in
    that order; every other input from a generator of this phase's own, so that a shape held here moves
    no later phase's data."""
    from diffopt_tpu_torch.ops.cuda import chol
    from diffopt_tpu_torch.utils.testing import make_batch

    own = torch.Generator(device=DEVICE)
    own.manual_seed(gen.initial_seed() + 7)
    entries, teams = {}, {}

    def hold(op, H, rhs=None):
        main = H.dtype == torch.float32
        rec = _hold_chol(chol, op, H, rhs, main)
        if rec is not None:
            entries[rec["name"]] = rec
            n = H.shape[1]
            route = "registers" if op == "solve" or n <= chol.chol_tile_max_n(8, 4) else "shared memory"
            teams[rec["name"]] = dict(rule=_launch_tag((rec["team_warps"], rec["per_block"])), batch=H.shape[0],
                                      route=route,
                                      ms_by_team=rec["ms_by_team"], instances_per_sm=rec["instances_per_sm"],
                                      eager_ms=rec.pop("eager_ms"), bound_ms=rec["bound_ms"],
                                      plain_ms=rec["plain_ms"], library_ms=rec["library_ms"])

    n, m, p = N_VARS, N_INEQ, N_EQ
    for dtype, B in ((torch.float32, min(batch, CHOL_FACTOR_SHAPES[n])), (torch.float64, min(batch, 4096))):
        qp = make_batch(B, n, m, p, dtype, DEVICE, gen)
        reg = 1e-7 if dtype == torch.float32 else 1e-11
        H = (qp.Q + qp.G.transpose(1, 2) @ qp.G + reg * torch.eye(n, dtype=dtype, device=DEVICE)).contiguous()
        At = qp.A.transpose(1, 2).contiguous()
        rhs1 = torch.randn(B, n, dtype=dtype, device=DEVICE, generator=gen)
        S = (qp.A @ chol.cholesky_solve_batched(chol.cholesky_batched(H), At)
             + reg * torch.eye(p, dtype=dtype, device=DEVICE)).contiguous()
        s1 = torch.randn(B, p, dtype=dtype, device=DEVICE, generator=gen)
        sp = torch.randn(B, p, p, dtype=dtype, device=DEVICE, generator=gen)
        del qp
        hold("factor", H)
        hold("solve", H, At)
        hold("solve", H, rhs1)
        hold("factor", S)
        hold("solve", S, s1)
        hold("solve", S, sp)
        del H, At, rhs1, S, s1, sp
        torch.cuda.empty_cache()
    for nn, kn, g32 in ((34, 1, True), (160, 3, True), (6, 1, False), (17, 1, False), (3, 1, False), (18, 1, False),
                        (44, 1, False), (144, 1, False)):
        for dtype in (torch.float32, torch.float64):
            g = gen if (g32 and dtype == torch.float32) else own
            B = min(batch, CHOL_FACTOR_SHAPES[nn]) if dtype == torch.float32 else min(batch, CHOL_FACTOR_SHAPES[nn], 4096)
            H = _spd(B, nn, dtype, g)
            rhs = torch.randn(*((B, nn) if kn == 1 else (B, nn, kn)), dtype=dtype, device=DEVICE, generator=g)
            hold("factor", H)
            hold("solve", H, rhs)
            del H, rhs
            torch.cuda.empty_cache()
    held = {f"chol_factor_n{nn}" for nn in CHOL_FACTOR_SHAPES} | {f"chol_solve_n{nn}_k{kn}" for nn, kn in CHOL_SOLVE_SHAPES}
    check(set(entries) == held, f"chol: the shapes held {sorted(entries)} are not those listed {sorted(held)}")

    # teams that do not take a shape are refused, never replaced by another
    for what, call in (("a one-warp factor at n = 64", lambda H: chol.cholesky_batched(H, team=1)),
                       ("a four-warp factor team", lambda H: chol.cholesky_batched(H, team=4)),
                       ("a two-warp solve team for one right-hand side",
                        lambda H: chol.cholesky_solve_batched(H, H[:, :, 0], team=2)),
                       ("a one-warp solve for 16 right-hand sides",
                        lambda H: chol.cholesky_solve_batched(H, H[:, :, :16], team=1))):
        try:
            call(_spd(8, 64, torch.float32, own))
        except ValueError:
            continue
        check(False, f"chol: {what} was not refused")
    print("[kernels] chol: teams that do not take a shape are refused (a one-warp factor at n = 64, a four-warp"
          " factor team, a two-warp team for one right-hand side, one warp for 16 right-hand sides)")

    # --- matrices that are not positive definite: NaN from the failing pivot on, in kernel (every team
    # that takes the shape), plain version and library route alike, and no error ---------------------------
    for nn in (16, 64, 160):
        X = torch.randn(64, nn, nn, dtype=torch.float32, device=DEVICE, generator=own if nn == 16 else gen)
        Hn = X @ X.transpose(1, 2) / nn + torch.eye(nn, device=DEVICE)
        Hn[3] = -Hn[3]  # fails at pivot 0
        Hn[5, nn // 2, nn // 2] = -1.0  # fails half way
        Hn[9, nn - 1, nn - 1] = -1.0  # fails at the last pivot
        Lnp, Lnl = chol.cholesky_batched_plain(Hn), chol._cholesky_library(Hn)
        fin = torch.isfinite(Lnp)
        bad = sorted((~fin).flatten(1).any(dim=1).nonzero().flatten().tolist())
        check(bad == [3, 5, 9] and bool((torch.isfinite(Lnl) == fin).all()),
              "non-positive-definite matrices: plain version and library route differ")
        factor_teams = [t for t in chol.FACTOR_TEAMS if chol.team_takes(nn, 0, 4, t)]
        for t in factor_teams:
            Ln = chol.cholesky_batched(Hn, team=t)
            torch.cuda.synchronize()
            check(bool((torch.isfinite(Ln) == fin).all()), f"non-positive-definite matrices: NaN patterns differ (n = {nn}, team {t})")
            check(rel_err(Ln, Lnp) <= TOL_CHOL[torch.float32], "finite part of the factor disagrees with the plain version")
        Ln = chol.cholesky_batched(Hn)
        xn = chol.cholesky_solve_batched(Ln, torch.ones(64, nn, device=DEVICE))
        nan_rows = sorted(torch.isnan(xn).all(dim=1).nonzero().flatten().tolist())
        check(nan_rows == [3, 5, 9] and bool(torch.isfinite(xn[[i for i in range(64) if i not in (3, 5, 9)]]).all()),
              f"non-positive-definite matrices: solves are NaN on {nan_rows}")
        print(f"[kernels] chol_factor f32 n={nn}, 3 of 64 matrices not positive definite: NaN instances {bad} in the"
              f" plain version, the same NaN pattern in the kernel at teams {factor_teams} and the library route;"
              f" solves all-NaN on [3, 5, 9]")
    gram = entries["chol_factor_n34"], entries["chol_solve_n34_k1"]
    gram34 = dict(n=34, chol_factor_ms=gram[0]["ms"], chol_solve_ms=gram[1]["ms"],
                  chol_factor_plain_ms=gram[0]["plain_ms"], chol_solve_plain_ms=gram[1]["plain_ms"],
                  chol_factor_library_ms=gram[0]["library_ms"], chol_solve_library_ms=gram[1]["library_ms"],
                  chol_factor_bound_ms=gram[0]["bound_ms"], chol_solve_bound_ms=gram[1]["bound_ms"])
    return {**entries, "gram34": gram34, "chol_teams": teams}


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
    check(per_step == {"pdip_fused": 1, "ldl_factor": 2, "ldl_solve": 6, "chol_factor": 0, "chol_solve": 0,
                       "conic_pdip": 0, "ns_pdip": 0}, f"unexpected launch counts {per_step}")
    check(ldl_shape_launches() == {f"ldl_factor_N{N_KKT}": 2 * steps, f"ldl_solve_N{N_KKT}_k1": 6 * steps},
          f"[main]: K2 / K3 launched at {ldl_shape_launches()}")

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
    from diffopt_tpu_torch.ops.cuda import chol, conic_pdip, ns_pdip, pdip
    from diffopt_tpu_torch.solvers import conic, conic_ipm, conic_nsipm
    from diffopt_tpu_torch.solvers import qp as qpsolver

    wrappers = {
        "pdip_fused": pdip.solve_batched_fused,
        "ldl_factor": chol.ldl_batched,
        "ldl_solve": chol.ldl_solve_batched,
        "chol_factor": chol.cholesky_batched,
        "chol_solve": chol.cholesky_solve_batched,
        "conic_pdip": conic_pdip.solve_tile_fused,
        "ns_pdip": ns_pdip.solve_tile_fused_ns,
    }
    for w in wrappers.values():
        w.launches = 0
    for w in (chol.cholesky_batched, chol.cholesky_solve_batched, chol.ldl_batched, chol.ldl_solve_batched):
        w.launches_by_shape.clear()
    qpsolver.solve_batched.host_syncs = 0
    conic_ipm.solve_batched.host_syncs = 0
    conic_nsipm.solve_batched.host_syncs = 0
    conic.solve_batched.host_syncs = 0
    kkt._auto_solve.host_syncs = 0
    return wrappers


def ldl_shape_launches():
    """K2's and K3's launches since the counters were set to 0, by shape, under the names of their
    ``kernels`` entries past the main path's N."""
    from diffopt_tpu_torch.ops.cuda import chol

    out = {f"ldl_factor_N{n}": c for (n, _), c in chol.ldl_batched.launches_by_shape.items()}
    out.update({f"ldl_solve_N{n}_k{k}": c for (n, k), c in chol.ldl_solve_batched.launches_by_shape.items()})
    return out


def chol_shape_launches():
    """K4's and K5's launches since the counters were set to 0, by shape, under the names of their
    ``kernels`` entries."""
    from diffopt_tpu_torch.ops.cuda import chol

    out = {f"chol_factor_n{n}": c for (n, _), c in chol.cholesky_batched.launches_by_shape.items()}
    out.update({f"chol_solve_n{n}_k{k}": c for (n, k), c in chol.cholesky_solve_batched.launches_by_shape.items()})
    return out


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
    by_shape = chol_shape_launches()
    syncs = (qpsolver.solve_batched.host_syncs + kkt._auto_solve.host_syncs) / steps
    bodies = int(info.iterations.max())
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"[staged] launches over {steps} steps: {launches}; per step {per_step}; {bodies} interior-point bodies and"
          f" {syncs:.0f} device-to-host copies per step")
    # the start factors H and S and solves four times; a body factors both and solves seven times
    # (one of them with k = p right-hand sides); the default KKT route ('auto' -> LU) launches none
    expect = {"pdip_fused": 0, "ldl_factor": 0, "ldl_solve": 0, "chol_factor": 2 + 2 * bodies, "chol_solve": 4 + 7 * bodies,
              "conic_pdip": 0, "ns_pdip": 0}
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
        "chol_launches_by_shape": by_shape,
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
    n, m, p = QP100
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
    ldl_launches = ldl_shape_launches()
    check(launches == {"pdip_fused": 1, "ldl_factor": 2, "ldl_solve": 6, "chol_factor": 0, "chol_solve": 0,
                       "conic_pdip": 0, "ns_pdip": 0}, f"qp100: unexpected launches per step {launches}")
    check(ldl_launches == {f"ldl_factor_N{n + m + p}": 2 * (STEPS + 1), f"ldl_solve_N{n + m + p}_k1": 6 * (STEPS + 1)},
          f"qp100: K2 / K3 launched at {ldl_launches}")
    conv = float(info.converged.float().mean())
    med = sorted(times)[len(times) // 2]
    print(f"[qp100] B={B} n={n} m={m} p={p} (N={n + m + p}) f32 solve + VJP: {B / med:.1f} solves+VJPs per second (median step"
          f" {med * 1e3:.2f} ms); converged {conv:.4%}; iterations mean {float(info.iterations.float().mean()):.2f}")
    check(conv >= 0.99 and bool(torch.isfinite(sol.z).all()), f"qp100: converged share {conv:.3%}")
    sub = min(B, 512)
    qs = dtt.QuadProgram(*(t.detach()[:sub].clone().requires_grad_() for t in qp.tensors()))
    (dtt.solve_qp_batched(qs, max_iters=25, method="lu").z ** 2).sum().backward()
    grad_diff_share([t.grad[:sub] for t in qp.tensors()], [t.grad for t in qs.tensors()], "the LU route", "qp100")
    return {"solves_vjps_per_s": B / med, "step_ms": med * 1e3, "batch": B, "ldl_launches_by_shape": ldl_launches}


# ---------------------------------------------------------------------------
# The symmetric-cone path: K6 and solve_conic_batched
# ---------------------------------------------------------------------------

# K6 against its plain version, per instance over x, yE, yC, s, relative to 1 + the largest entry of the plain result.
# In f32 an interior-point iterate is determined only to the solver's tolerance, so the comparison is on the
# distribution, as for TOL_PDIP. In f64 the SOCP agrees to rounding on every instance. On layouts with psd blocks
# the two agree to a few 1e-9 where they take the same number of steps: those instances are held at 5e-9. A rare
# instance there parts further (up to 8.9e-9 on the mixed layout, 1 in 512 on three of eight draws) where the
# plain version itself sits on a rounding edge: a one-ulp change of its data moves the plain version by as much,
# and the kernel by 1e-15 (tools/k6_divergence.py --mixed; PERF.md, Findings). Such an instance passes only
# where the plain version, on one of `ulp_draws` one-ulp draws of that instance's data, comes within 5e-9 of
# the kernel's result, and such instances are at most `witnessed_share` of the batch. On the rare instance
# whose error lands on the two sides of tol = 1e-9 in the two runs (1 of 1024 in the side-4 batch), one run
# takes one step more, and on a degenerate instance that step moves the dual by up to 1e-5; the share of such
# instances and their distance are held apart (one-ulp changes of the data move either version as far).
TOL_K6_F32 = {"median": 1e-4, "q99": 3e-2, "max": 0.5}
TOL_K6_F64 = 1e-9
TOL_K6_F64_PSD = {"same_iterations": 5e-9, "witnessed_share": 0.01, "ulp_draws": 32, "iterations_differ": 0.01,
                  "max": 1e-4}
# f32 gradients of the [conic] path against the same instances in f64, per instance relative to the largest entry
TOL_CONIC_GRAD = {"median": 1e-3, "share_above_1e-2": 0.02}
CONIC_N = 16  # the SOCP of BASELINE config 3: n = 16, one SOC block of dimension 17
SDP_SIDES = (4, 8, 16)


def _conic_pdip_flops(n, p, l, soc_dims, psd_sides, dtype):
    """(body, metrics, init) operations of the fused conic IPM for one instance, counted as
    csrc/conic_pdip.cu does the work. A body: the NT scaling, the LDL' of K (its -W^2 block computed
    entry by entry), lam and its psd eigendecompositions, two direction solves (each one LDL' solve
    plus 1 refinement pass, 2 with a psd block, whose residual rhs - K sol takes the W^2 blocks and
    the AC, AC' and AE products), eleven W applications, four step lengths, two Jordan products, one
    Jordan solve and the update. The metrics: the residuals and the sums of the scale-relative
    criterion. The init: the identity scaling, one factor, one direction solve, s0 = bC - AC x and
    the shift into the interior. A Jacobi rotation of a d x d block costs its angle (16) and 6 d per
    row pair, column pair and eigenvector pair; a d x d product 2 d^3."""
    from diffopt_tpu_torch.ops.smalleig import _sweeps_for

    mC = l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides)
    N = n + p + mC
    passes = 2 if psd_sides else 1
    jac = lambda d, vec: _sweeps_for(d, dtype) * d * (d - 1) // 2 * (16 + (18 if vec else 12) * d)
    # per block: (nt scaling, one W application, one Jordan product, the Jordan solve, one step
    # length, the lam eigendecomposition, the init shift, cost of one W^2 entry)
    blocks = []
    if l:
        blocks.append((l, (2 * l, l, l, l, 2 * l, 0, 2 * l, 1)))
    for d in soc_dims:
        blocks.append((d, (13 * d + 30, 6 * d, 5 * d, 7 * d + 10, 6 * d + 20, 0, 2 * d, 4)))
    for d in psd_sides:
        t, d2, d3 = d * (d + 1) // 2, d * d, 2 * d**3
        blocks.append((t, (3 * jac(d, True) + 8 * d3 + 4 * d2 + 6 * d, 2 * d3 + 2 * d2 + 2 * t, d3 + 2 * d2 + 2 * t,
                           4 * d3 + 5 * d2 + d, 2 * d3 + jac(d, False) + 2 * d2, jac(d, True) + d3 + 2 * d,
                           jac(d, False) + t, 6)))
    nt = sum(b[0] for _, b in blocks)
    w_apply = sum(b[1] for _, b in blocks)
    jmul = sum(b[2] for _, b in blocks)
    jsolve = sum(b[3] for _, b in blocks)
    step = sum(b[4] for _, b in blocks)
    lam_eigs = sum(b[5] for _, b in blocks)
    shift = sum(b[6] for _, b in blocks)
    w2 = sum(dim * dim * cost for dim, (*_, cost) in blocks)  # every entry of the -W^2 blocks, once
    factor = N**3 / 3 + N * N + w2 / 2  # the elimination, L = t / d, the lower half of the W^2 blocks
    ldl_solve = 2 * N * N - N
    residual = w2 + 2 * sum(dim * dim for dim, _ in blocks) + 4 * mC * n + 4 * p * n + 3 * N
    solve = 3 * w_apply + (1 + passes) * ldl_solve + passes * (residual + N) + 3 * mC
    body = nt + factor + w_apply + lam_eigs + 2 * solve + 4 * w_apply + 4 * step + 2 * jmul + jsolve
    body += 8 * mC + 2 * (n + p + 2 * mC)  # mu_aff, the corrector's target, the update
    metrics = 4 * n * (mC + p) + 14 * mC + 10 * p + 11 * n
    init = nt + factor + solve + 2 * mC * n + shift
    return body, metrics, init


def conic_pdip_flops_per_iteration(n, p, l, soc_dims, psd_sides, dtype=torch.float32):
    """Operations of one body of the fused conic IPM with the metrics that open it
    (:func:`_conic_pdip_flops`)."""
    body, metrics, _ = _conic_pdip_flops(n, p, l, soc_dims, psd_sides, dtype)
    return body + metrics


def conic_pdip_flops(n, p, l, soc_dims, psd_sides, iterations, dtype=torch.float32):
    """Operations of one launch of the fused conic IPM on a batch whose instances ran ``iterations``
    bodies each: every body with its metrics, and per instance the init and the three metric
    evaluations outside the loop (the one that finds the instance converged, the exit scoring, the
    metrics of the returned state). An instance that stalls is charged one body more than it ran."""
    body, metrics, init = _conic_pdip_flops(n, p, l, soc_dims, psd_sides, dtype)
    its = iterations.double()
    return float(its.sum()) * (body + metrics) + its.numel() * (init + 3 * metrics)


def internal_batch(cp):
    """The fused kernel's inputs for a ConeProgram batch: rows through the static transform R."""
    from diffopt_tpu_torch.solvers.conic_ipm import internal_rows

    return internal_rows(cp)[:2]


def k6_run(args, lay, kw):
    """K6 at every team size that takes the layout, and its plain version once, on the fused kernel's inputs
    ``args`` with the settings ``kw``. Returns ``{team: kernel outputs}``, the plain outputs, ``{team:
    per-instance relative differences}`` over x, yE (where there are equality rows), yC and s, and the plain
    version's wall time."""
    from diffopt_tpu_torch.ops.cuda import conic_pdip

    n, (p, l, socs, psds) = args[0].shape[1], lay
    teams = [t for t in conic_pdip.TEAMS if conic_pdip.team_takes(n, p, l, socs, psds, args[0].element_size(), t)]
    outs = {t: conic_pdip.solve_tile_fused(*args, lay, **kw, team=t) for t in teams}
    ref, plain_ms = wall_ms(lambda: conic_pdip.solve_tile_fused_plain(*args, lay, **kw))
    insts = {t: torch.stack([(a - b).abs().amax(-1) / (1.0 + b.abs().amax(-1))
                             for a, b in zip(out[:4], ref[:4]) if a.shape[-1]]).amax(0).double()
             for t, out in outs.items()}
    return outs, ref, insts, plain_ms


def k6_compare(cp, tol, max_iters=50):
    """:func:`k6_run` on a ConeProgram batch at ``tol`` and ``max_iters``; returns its results and the inputs."""
    args, lay = internal_batch(cp)
    f64 = cp.A.dtype == torch.float64
    kw = dict(max_iters=max_iters, tol=tol, reg=1e-11 if f64 else 1e-7, eps=1e-14 if f64 else 1e-7)
    return (*k6_run(args, lay, kw), (args, lay, kw))


def k6_bound(args, lay, its):
    """K6's bound on the inputs ``args``: c, b, A read, x, y, s, the counts and residuals written; the operations
    of the bodies this run's instances ran (``its``)."""
    B, n, (p, l, socs, psds), mC = args[0].shape[0], args[0].shape[1], lay, args[2].shape[1]
    return bound(B * args[0].element_size() * ((p + mC) * (n + 1) + n + (n + p + 2 * mC + 2) + 1),
                 conic_pdip_flops(n, p, l, socs, psds, its))


def k6_plain_reach(inputs, out, idx, draws):
    """For the instances ``idx`` of one K6 run (``inputs`` = (args, lay, kw) of ``k6_compare``, ``out`` the
    kernel's result): the smallest per-instance relative difference between the kernel's result and the
    plain version run on ``draws`` one-ulp draws of that instance's data."""
    from diffopt_tpu_torch.ops.cuda import conic_pdip

    args, lay, kw = inputs
    ugen = torch.Generator(device=DEVICE)
    ugen.manual_seed(17)
    runs = conic_pdip.solve_tile_fused_plain(*_ulp_draws(args, idx, draws, ugen), lay, **kw)
    parts = []
    for a, r in zip(out[:4], runs[:4]):
        if a.shape[-1]:
            r = r.reshape(len(idx), draws, -1)
            parts.append((a[idx][:, None] - r).abs().amax(-1) / (1.0 + r.abs().amax(-1)))
    return torch.stack(parts).amax(0).amin(1).double()


def check_k6(label, out, ref, inst, tol, f64, psd, inputs=None):
    """The checks of one K6 run against its plain version, at the tolerances TOL_K6_*; returns the largest
    absolute difference. ``inputs`` (args, lay, kw) lets a psd layout's f64 check ask the plain version
    on one-ulp draws of an instance's data (TOL_K6_F64_PSD)."""
    B = ref[0].shape[0]
    conv_k = torch.maximum(out[5], out[6]) < 10 * tol
    conv_p = torch.maximum(ref[5], ref[6]) < 10 * tol
    both = conv_k & conv_p
    moved = float((out[4] != ref[4])[both].float().mean()) if bool(both.any()) else 0.0
    med, q99, worst = (float(torch.quantile(inst, q)) for q in (0.5, 0.99, 1.0))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(out[:4], ref[:4]) if a.numel())
    print(f"[kernels] conic_pdip {label}: per-instance relative diff median {med:.3e}, 99% {q99:.3e}, max"
          f" {worst:.3e}; converged {float(conv_k.float().mean()):.4%} (plain {float(conv_p.float().mean()):.4%});"
          f" iterations mean {float(out[4].float().mean()):.2f} vs plain {float(ref[4].float().mean()):.2f}, differ"
          f" on {moved:.3%} of the instances both converged")
    check(all(bool(torch.isfinite(t).all()) for t in out[:4]), f"conic_pdip {label}: non-finite output")
    if f64 and not psd:
        check(worst <= TOL_K6_F64, f"conic_pdip {label} disagrees with its plain version: max {worst:.3e}")
        check(moved == 0.0, f"conic_pdip {label}: iteration counts differ on {moved:.3%}")
    elif f64:
        tolp = TOL_K6_F64_PSD
        same = out[4] == ref[4]
        worst_same = float(inst[same].max()) if bool(same.any()) else 0.0
        worst_apart = float(inst[~same].max()) if bool((~same).any()) else 0.0
        print(f"[kernels] conic_pdip {label}: same iteration count on {int(same.sum())} of {B}, max diff there"
              f" {worst_same:.3e}; on the other {int((~same).sum())} max {worst_apart:.3e}")
        over = same & (inst > tolp["same_iterations"])
        if bool(over.any()) and inputs is not None:
            idx = over.nonzero().flatten()
            reach = k6_plain_reach(inputs, out, idx, tolp["ulp_draws"])
            print(f"[kernels] conic_pdip {label}: {len(idx)} instance(s) past {tolp['same_iterations']:.0e} at the same"
                  f" step count ({', '.join(f'{float(v):.3e}' for v in inst[idx])}); the plain version on"
                  f" {tolp['ulp_draws']} one-ulp draws of each one's data comes within"
                  f" {', '.join(f'{float(v):.3e}' for v in reach)} of the kernel's result")
            check(len(idx) <= tolp["witnessed_share"] * B,
                  f"conic_pdip {label}: {len(idx)} instances past {tolp['same_iterations']:.0e} at the same step count")
            check(bool((reach <= tolp["same_iterations"]).all()),
                  f"conic_pdip {label}: an instance past {tolp['same_iterations']:.0e} at the same step count is not"
                  " one the plain version reaches under a one-ulp change of its data")
            worst_same = float(inst[same & ~over].max()) if bool((same & ~over).any()) else 0.0
        check(worst_same <= tolp["same_iterations"],
              f"conic_pdip {label} disagrees with its plain version where both took the same steps: {worst_same:.3e}")
        check(moved <= tolp["iterations_differ"], f"conic_pdip {label}: iteration counts differ on {moved:.3%}")
        check(worst_apart <= tolp["max"], f"conic_pdip {label}: a step apart, the two end {worst_apart:.3e} apart")
    else:
        tolf = TOL_K6_F32
        check(med <= tolf["median"] and q99 <= tolf["q99"] and worst <= tolf["max"],
              f"conic_pdip {label} disagrees with its plain version: median {med:.3e}, 99% {q99:.3e}, max {worst:.3e}")
        check(abs(float(conv_k.float().mean()) - float(conv_p.float().mean())) <= 0.01,
              f"conic_pdip {label}: converged shares differ")
    return max_abs


def k6_timing_layouts(batch, gen):
    """The layouts K6 is timed at by team size, f32: the SOCP of [conic], the SDP of psd side 4 and side 8
    at the [sdp] batch, the mixed layout, and a SOCP of N = 57 (n = 28, SOC(29)), past one warp's tiles,
    where the teams of two and eight warps compete."""
    from diffopt_tpu_torch.utils.testing import make_mixed_batch, make_sdp_batch, make_socp_batch

    Bs = min(batch, 4096)
    return [
        ("socp", make_socp_batch(batch, n=CONIC_N, seed=1, device=DEVICE)),
        ("sdp4", make_sdp_batch(Bs, 4, seed=3, device=DEVICE)),
        ("sdp8", make_sdp_batch(Bs, 8, seed=6, device=DEVICE)),
        ("mixed", make_mixed_batch(Bs, torch.float32, DEVICE, gen)),
        ("socp57", make_socp_batch(Bs, n=28, seed=8, device=DEVICE)),
    ]


def phase_kernels_conic(batch, gen):
    """K6 against its plain version, at every team size that takes each layout: the SOCP of the [conic]
    path in f32 at the full batch and in f64, the SDP side 4 in f32 and f64, a layout with every symmetric
    kind in f64 (the shared generator's draw and three of generators seeded 1, 2, 3), and a batch past the
    reference's envelope (psd side 8) in f64. Then K6's time by team size
    on the SOCP, the SDP sides 4 and 8 and the mixed layout in f32, and that a team which does not take a
    layout is refused. Returns the entry of the ``kernels`` line."""
    from diffopt_tpu_torch.ops.cuda import conic_pdip
    from diffopt_tpu_torch.utils.testing import make_mixed_batch, make_sdp_batch, make_socp_batch

    def seeded(seed):
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed)
        return g

    entry = None
    cases = [
        ("SOCP f32", make_socp_batch(batch, n=CONIC_N, seed=1, device=DEVICE), 5e-6),
        ("SOCP f64", make_socp_batch(min(batch, 4096), n=CONIC_N, seed=2, dtype=torch.float64, device=DEVICE), 1e-9),
        ("SDP side 4 f32", make_sdp_batch(min(batch, 4096), 4, seed=3, device=DEVICE), 5e-6),
        ("SDP side 4 f64", make_sdp_batch(min(batch, 1024), 4, seed=4, dtype=torch.float64, device=DEVICE), 1e-9),
        ("mixed f64", make_mixed_batch(min(batch, 512), torch.float64, DEVICE, gen), 1e-9),
        # the same layout on draws of generators of their own, which no other phase's draws move
        *((f"mixed f64 seed {sd}", make_mixed_batch(min(batch, 512), torch.float64, DEVICE, seeded(sd)), 1e-9)
          for sd in (1, 2, 3)),
        ("SDP side 8 f64", make_sdp_batch(min(batch, 256), 8, seed=5, dtype=torch.float64, device=DEVICE), 1e-9),
    ]
    for label, cp, tol in cases:
        cp = cp.map(lambda t: t.to(DEVICE))
        outs, ref, insts, plain_ms, (args, lay, kw) = k6_compare(cp, tol)
        B, f64, item = cp.batch_size, cp.A.dtype == torch.float64, cp.A.element_size()
        n, (p, l, socs, psds) = cp.num_vars, lay
        chosen = conic_pdip.team_for(n, p, l, socs, psds, item)
        print(f"[kernels] conic_pdip {label} B={B} layout {lay} tol {tol:.0e}: teams {sorted(outs)}, the launch rule"
              f" picks {chosen}; plain {plain_ms:.0f} ms")
        check(chosen in outs, f"conic_pdip {label}: the launch rule's team {chosen} does not take the layout")
        max_abs = {t: check_k6(f"{label} team {t}", out, ref, insts[t], tol, f64, bool(psds), (args, lay, kw))
                   for t, out in outs.items()}
        if label == "SOCP f32":
            entry = dict(
                name="conic_pdip", route="cuda", source="diffopt_tpu_torch/csrc/conic_pdip.cu",
                replaces="diffopt_tpu/ops/pallas/conic_pdip.py:396", max_abs_err=max_abs[chosen],
                plain_ms=plain_ms, library_ms=None, team_warps=chosen,
            )
            socp = (args, lay, kw, outs[chosen][4])
        elif label == "SDP side 4 f32":
            entry["sdp4_plain_ms"] = plain_ms
            sdp4 = (args, lay, kw, outs[chosen][4])
        del outs, ref, cp
        torch.cuda.empty_cache()

    # K6's time by team size (the kernel alone, CUDA events, f32), on data from a generator of its own, so
    # that the phases after this one see the same data as without it
    tgen = torch.Generator(device=DEVICE)
    tgen.manual_seed(gen.initial_seed() + 1)
    by_layout = {}
    for name, cp in k6_timing_layouts(batch, tgen):
        args, lay = internal_batch(cp)
        kw = dict(max_iters=50, tol=5e-6, reg=1e-7, eps=1e-7)
        n, (p, l, socs, psds) = cp.num_vars, lay
        chosen = conic_pdip.team_for(n, p, l, socs, psds, 4)
        row = {}
        for t in conic_pdip.TEAMS:
            if conic_pdip.team_takes(n, p, l, socs, psds, 4, t):
                ms = time_ms(lambda: conic_pdip.solve_tile_fused(*args, lay, **kw, team=t), reps=3)
                row[t] = (ms, conic_pdip.blocks_per_sm(n, p, l, socs, psds, torch.float32, t),
                          conic_pdip.instances_per_sm(n, p, l, socs, psds, 4, t))
        by_layout[name] = {"team": chosen, "B": cp.batch_size, "N": n + p + args[2].shape[1],
                           "ms_by_team": {str(t): v[0] for t, v in row.items()},
                           "resident_by_team": {str(t): v[1] for t, v in row.items()}}
        print(f"[kernels] conic_pdip {name} f32 B={cp.batch_size} layout {lay}: ms by team "
              + ", ".join(f"{t}: {ms:.3f} ({res} resident per SM, {smem} by shared memory)"
                          for t, (ms, res, smem) in row.items()) + f"; the launch rule picks {chosen}")
        del cp, args
    torch.cuda.empty_cache()
    for name, (args, lay, kw, its) in (("socp", socp), ("sdp4", sdp4)):
        B, n, (p, l, socs, psds) = args[0].shape[0], args[0].shape[1], lay
        flops = conic_pdip_flops(n, p, l, socs, psds, its)
        b_ms, b_by = k6_bound(args, lay, its)
        ms = by_layout[name]["ms_by_team"][str(by_layout[name]["team"])]
        print(f"[kernels] conic_pdip {name} f32 B={B}: {ms:.3f} ms with a team of {by_layout[name]['team']} warps"
              f" (bound {b_ms:.3f} ms by {b_by}: {flops / B:.0f} flops per instance)")
        if name == "socp":
            entry.update(ms=ms, bound_ms=b_ms, bound_by=b_by, ms_by_team=by_layout[name]["ms_by_team"])
        else:
            entry.update(sdp4_ms=ms, sdp4_bound_ms=b_ms, sdp4_ms_by_team=by_layout[name]["ms_by_team"])
    entry["k6_teams"] = by_layout

    # a team that does not take a layout is refused, never replaced: N = 53 is past one warp's tiles
    cp = make_socp_batch(4, n=26, seed=7, device=DEVICE)
    args, lay = internal_batch(cp)
    refused = False
    try:
        conic_pdip.solve_tile_fused(*args, lay, team=1)
    except ValueError:
        refused = True
    check(refused, "conic_pdip: a team of one warp took a layout of N = 53")
    print("[kernels] conic_pdip: a team of one warp at N = 53 is refused (ValueError), as it must be")
    return {"conic_pdip": entry}


def conic_step_runner(cp, **kw):
    """One solve_conic_batched forward + backward of sum(x^2) (the conic benchmark's step)."""
    import diffopt_tpu_torch as dtt

    def step():
        for t in cp.tensors():
            t.grad = None
        sol, info = dtt.solve_conic_batched(cp, with_info=True, **kw)
        loss = (sol.x**2).sum()
        loss.backward()
        return sol, info, loss

    return step


def timed_steps(step, steps):
    step()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, sorted(times)[len(times) // 2]


def phase_conic(batch):
    """The slice's main path at full width: solve_conic_batched (K6 forward, gram polish, gram VJP on
    K4 / K5) forward + backward on the SOCP of BASELINE config 3, a warm-up and three timed steps;
    launch counts, converged share, residuals, and the f32 gradients of 512 instances against the same
    instances solved and differentiated in f64."""
    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.utils.testing import make_socp_batch

    cp = make_socp_batch(batch, n=CONIC_N, seed=0, device=DEVICE).map(lambda t: t.requires_grad_())
    kw = dict(max_iters=50, tol=1e-5, method="gram")
    wrappers = reset_counts()
    (sol, info, loss), med = timed_steps(conic_step_runner(cp, **kw), STEPS)
    launches = {k: w.launches for k, w in wrappers.items()}
    by_shape = chol_shape_launches()
    per_step = {k: v / (STEPS + 1) for k, v in launches.items()}
    print(f"[conic] launches over {STEPS + 1} steps: {launches} (per step {per_step})")
    check(per_step["conic_pdip"] == 1, f"[conic]: K6 launched {per_step['conic_pdip']} times per step, expected 1")
    check(per_step["chol_factor"] > 0 and per_step["chol_solve"] > 0, "[conic]: the gram route launched no K4 / K5")
    check(per_step["pdip_fused"] == 0 and per_step["ldl_factor"] == 0, "[conic]: a QP kernel was launched")
    grads = [t.grad for t in cp.tensors()]
    check(all(bool(torch.isfinite(t).all()) for t in sol.tensors()), "[conic]: non-finite solution")
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads), "[conic]: non-finite gradient")
    check(sol.x.shape == (batch, CONIC_N) and sol.y.shape == (batch, CONIC_N + 1), "[conic]: wrong shapes")
    conv = float(info.converged.float().mean())
    res = float(torch.maximum(info.primal_residual, info.dual_residual).max())
    its = info.iterations.float()
    print(f"[conic] B={batch} n={CONIC_N} SOC({CONIC_N + 1}) f32: loss {loss.item():.6e}, converged {conv:.4%}, max"
          f" relative KKT residual {res:.3e}, iterations mean {float(its.mean()):.2f} max {int(its.max())}")
    check(conv >= 0.99, f"[conic]: only {conv:.3%} of the instances converged")
    check(res <= 1e-3, f"[conic]: relative KKT residual {res:.3e}: an instance is far from solved")
    # the f32 gradients of a subset against the same instances in f64 (K6, polish and VJP in f64)
    sub = min(batch, 512)
    c64 = cp.map(lambda t: t.detach()[:sub].double().requires_grad_())
    s64 = dtt.solve_conic_batched(c64, method="gram")  # the f64 default tolerance, 1e-9
    (s64.x**2).sum().backward()
    for name, g, r in zip("Abc", grads, c64.tensors()):
        diff = (g[:sub].double() - r.grad).abs().flatten(1).amax(1) / float(r.grad.abs().max())
        share = float((diff > 1e-2).float().mean())
        print(f"[conic] grad d{name} f32 against f64: per-instance relative diff median {float(diff.median()):.3e},"
              f" 99% {float(torch.quantile(diff, 0.99)):.3e}, max {float(diff.max()):.3e}, above 1e-2 on {share:.3%}")
        check(float(diff.median()) <= TOL_CONIC_GRAD["median"] and share <= TOL_CONIC_GRAD["share_above_1e-2"],
              f"[conic]: f32 gradient d{name} off the f64 one")
    rate = batch / med
    return launches, dict(solves_vjps_per_s=rate, step_ms=med * 1e3, batch=batch, converged=conv,
                          max_kkt_residual=res, mean_iterations=float(its.mean()),
                          conic_pdip_per_step=per_step["conic_pdip"], chol_factor_per_step=per_step["chol_factor"],
                          chol_solve_per_step=per_step["chol_solve"], chol_launches_by_shape=by_shape)


def phase_sdp(batch):
    """solve_conic_batched with its defaults on the SDP family, psd sides 4, 8 and 16, B = 4096, n = 3, f32:
    rate, route, converged share, and K4's and K5's launches by shape over the side's runs (the gram
    route's and, on the staged route, the condensed route's)."""
    from diffopt_tpu_torch.ops.cuda import conic_pdip
    from diffopt_tpu_torch.utils.testing import make_sdp_batch

    out = []
    B = min(batch, 4096)
    for side in SDP_SIDES:
        cp = make_sdp_batch(B, side, n=3, seed=side, device=DEVICE).map(lambda t: t.requires_grad_())
        tri = side * (side + 1) // 2
        route = "K6" if conic_pdip.in_envelope(3, 0, 0, (4,), (side,), 4) else "staged"
        wrappers = reset_counts()
        steps = STEPS if side < 16 else 1
        (sol, info, _), med = timed_steps(conic_step_runner(cp), steps)
        k6 = wrappers["conic_pdip"].launches
        check((k6 > 0) == (route == "K6"), f"[sdp] side {side}: K6 launches {k6} on the {route} route")
        finite = torch.stack([torch.isfinite(t.grad).flatten(1).all(1) for t in cp.tensors()]).all(0)
        conv = float(info.converged.float().mean())
        line = dict(side=side, batch=B, n=3, rows=tri + 4, route=route, solves_vjps_per_s=B / med, step_ms=med * 1e3,
                    converged=conv, mean_iterations=float(info.iterations.float().mean()),
                    finite_gradients=float(finite.float().mean()), runs=1 + steps,
                    chol_launches_by_shape=chol_shape_launches())
        print(f"[sdp] side {side} (N = {3 + tri + 4}) B={B} f32: {B / med:.1f} solves+VJPs per second (step"
              f" {med * 1e3:.2f} ms), route {route}, converged {conv:.4%}, iterations mean {line['mean_iterations']:.2f},"
              f" finite gradients on {line['finite_gradients']:.4%}")
        check(bool(finite[info.converged].all()), f"[sdp] side {side}: a converged instance has a non-finite gradient")
        out.append(line)
        del cp, sol, info
        torch.cuda.empty_cache()
    return out


def phase_conic_routes(gen):
    """The other entry points and routes of the slice at small batches, f64: solve_conic (staged IPM)
    against K6's solution, the forward rule against a central difference, ConicDiffContext against the
    uncached verbs, 'lsqr' against 'lstsq' past the LSQR threshold (which also takes the staged solver's
    condensed route, N > 128), ParametricProgram(kind='conic'), and an exp-cone program that now solves."""
    import torch.autograd.forward_ad as fwAD

    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch import conic_diff
    from diffopt_tpu_torch.solvers import conic_ipm
    from diffopt_tpu_torch.utils.testing import make_socp_batch

    cp = make_socp_batch(512, n=CONIC_N, seed=6, dtype=torch.float64, device=DEVICE)
    wrappers = reset_counts()
    staged = dtt.solve_conic(cp, solver="ipm", polish=0)
    fused = dtt.solve_conic_batched(cp, polish=0)
    err = float(((staged.x - fused.x).abs().amax(1) / (1.0 + fused.x.abs().amax(1))).max())
    print(f"[conic-routes] solve_conic(solver='ipm') against K6, SOCP f64 B=512: max per-instance relative diff of x"
          f" {err:.3e} (tol 1e-6); launches {dict((k, w.launches) for k, w in wrappers.items())},"
          f" {conic_ipm.solve_batched.host_syncs} host syncs in the staged loop")
    check(err <= 1e-6, "solve_conic (staged) and K6 disagree")
    check(wrappers["ldl_factor"].launches > 0 and wrappers["conic_pdip"].launches == 1, "[conic-routes]: wrong kernels")

    # the forward rule against a central difference of the solution map (staged solver, f64, solved tightly)
    sub = cp.map(lambda t: t[:64])
    dA, db, dc = (0.1 * torch.randn(t.shape, dtype=t.dtype, device=DEVICE, generator=gen) for t in sub.tensors())
    with fwAD.dual_level():
        dual = dtt.ConeProgram(fwAD.make_dual(sub.A, dA), fwAD.make_dual(sub.b, db), fwAD.make_dual(sub.c, dc), sub.cones)
        jx = fwAD.unpack_dual(dtt.solve_conic(dual, mode="jvp", tol=1e-12).x).tangent
    eps = 1e-6
    shift = lambda sgn: dtt.ConeProgram(sub.A + sgn * eps * dA, sub.b + sgn * eps * db, sub.c + sgn * eps * dc, sub.cones)
    fd = (dtt.solve_conic(shift(1), tol=1e-12).x - dtt.solve_conic(shift(-1), tol=1e-12).x) / (2 * eps)
    jerr = (jx - fd).abs().amax(1) / (1.0 + fd.abs().amax(1))
    print(f"[conic-routes] solve_conic(mode='jvp') against a central difference (eps {eps:.0e}), f64 B=64: per-instance"
          f" relative diff median {float(jerr.median()):.3e}, max {float(jerr.max()):.3e} (tol: median 1e-6, max 1e-4;"
          " the difference quotient carries the solver's tolerance over eps)")
    check(float(jerr.median()) <= 1e-6 and float(jerr.max()) <= 1e-4,
          "the conic forward rule disagrees with a central difference")

    # ConicDiffContext against the uncached verbs
    ctx = dtt.ConicDiffContext(sub)
    seeds = [torch.randn(t.shape, dtype=t.dtype, device=DEVICE, generator=gen) for t in ctx.sol.tensors()]
    cr = ctx.reverse(*seeds)
    ur = conic_diff.reverse_differentiate(sub, ctx.sol, *seeds, method="lstsq", refine_iters=2)
    cf = ctx.forward(dtt.ConeTangent(dA, db, dc))
    uf = conic_diff.forward_differentiate(sub, ctx.sol, dtt.ConeTangent(dA, db, dc), method="lstsq", refine_iters=2)
    cerr = max(rel_err(a, b) for a, b in list(zip(cr.tensors(), ur.tensors())) + list(zip(cf, uf)))
    print(f"[conic-routes] ConicDiffContext.forward / reverse against the uncached verbs, f64 B=64: relative diff"
          f" {cerr:.3e} (tol 1e-8)")
    check(cerr <= 1e-8, "ConicDiffContext disagrees with the uncached verbs")

    # past the LSQR threshold (dim M = n + m + 1 > 500): 'auto' takes LSQR; the solve takes the condensed route.
    # M is singular at a solution and LSQR has no reorthogonalisation: on some instances its iterate drifts into
    # the null space (norm ~1e6, ~150 iterations), in the JAX package as here (ROADMAP.md, section 3); it is held
    # against the dense least-squares route on the median instance and on at least half of them
    Bl = 16
    big = make_socp_batch(Bl, n=250, seed=7, dtype=torch.float64, device=DEVICE)
    check(big.num_vars + big.num_rows > 128 and conic_diff.resolve_method(big, "auto") == "lsqr", "not past the thresholds")
    reset_counts()
    bsol, binfo = conic_ipm.solve_batched(big)
    check(bool(binfo.converged.all()), "condensed staged route: not converged")
    check(wrappers["ldl_factor"].launches == 0, "the condensed route launched the LDL' kernel")
    bseed = torch.randn(Bl, 250, dtype=torch.float64, device=DEVICE, generator=gen)
    g_lsqr = conic_diff.reverse_differentiate(big, bsol, bseed, method="auto")
    g_dense = conic_diff.reverse_differentiate(big, bsol, bseed, method="lstsq")
    ldiff = torch.stack([(a - b).abs().flatten(1).amax(1) / b.abs().flatten(1).amax(1)
                         for a, b in zip(g_lsqr.tensors(), g_dense.tensors())]).amax(0)
    agree = float((ldiff <= 1e-6).float().mean())
    print(f"[conic-routes] SOCP n=250 SOC(251) f64 B={Bl} (N = {big.num_vars + big.num_rows}): staged condensed route"
          f" converged in {float(binfo.iterations.float().mean()):.1f} iterations; reverse through 'auto' (LSQR) against"
          f" 'lstsq': per-instance relative diff median {float(ldiff.median()):.3e}, within 1e-6 on {agree:.2%}"
          f" (the rest drifted into the null space of M: max {float(ldiff.max()):.3e})")
    check(float(ldiff.median()) <= 1e-6 and agree >= 0.5, "LSQR and the dense least-squares route disagree")

    # ParametricProgram(kind='conic'): theta scales b; d loss / d theta = <grad_b, b> by the chain rule
    layer = dtt.ParametricProgram(lambda th: dtt.ConeProgram(sub.A, th * sub.b, sub.c, sub.cones), kind="conic")
    one = torch.tensor(1.0, dtype=torch.float64, device=DEVICE)
    dth = layer.reverse_differentiate(one, dx=seeds[0])
    b = sub.b.clone().requires_grad_()
    (dtt.solve_conic(dtt.ConeProgram(sub.A, b, sub.c, sub.cones)).x * seeds[0]).sum().backward()
    perr = abs(float(dth) - float((b.grad * sub.b).sum())) / (1.0 + abs(float(dth)))
    print(f"[conic-routes] ParametricProgram(kind='conic') on the card: d/dtheta {float(dth):.6e}, chain-rule diff {perr:.3e}")
    check(perr <= 1e-8, "ParametricProgram(kind='conic') disagrees with the chain rule")

    # an exp-cone program solves (the equal-weight entropy program: x_i = 1/k, t_i = (1/k) log k)
    from diffopt_tpu_torch.utils.testing import make_entropy_batch

    ent = make_entropy_batch(2, k=3, dtype=torch.float64, device=DEVICE)
    ent = dtt.ConeProgram(ent.A, ent.b, torch.cat([ent.c[:, :3] * 0, -torch.ones_like(ent.c[:, 3:])], 1), ent.cones)
    esol, einfo = dtt.solve_conic_batched(ent, with_info=True)
    want = torch.tensor([1 / 3] * 3 + [math.log(3) / 3] * 3, dtype=torch.float64, device=DEVICE)
    eerr = float((esol.x - want).abs().max())
    print(f"[conic-routes] an exp-cone program solves: converged {bool(einfo.converged.all())}, |x - x*| {eerr:.3e}")
    check(bool(einfo.converged.all()) and eerr <= 1e-7, "an exp-cone program did not solve to its analytic solution")


# ---- the nonsymmetric-cone path: kernel K7, [exp], [ns-routes] ------------------------------------------

EXP_K = 3  # the exp benchmark: entropy with k = 3 exp blocks, n = 6, one zero row, N = 16
FULL_BATCH = 32768  # --batch's default: the full run
EXP_BATCH = 16384
# K7 against its plain version. f32 at the full width: a stated distribution, as for K6. f64: the
# dual-scaling Hessian conditions like 1/mu^2 and the searches choose their steps on grids, so after
# about eight bodies a change of one ulp in the data moves a grid choice on about half of the instances
# (the plain version against itself: iteration counts moved on 46% of an f64 entropy batch, iterates by
# up to 2e-7; PERF.md, Findings). Two versions that round differently cannot agree better than that.
# So f64 is held in two parts: (1) capped at 8 bodies with tol 0, before the steps part, the kernel and
# its plain version compute the same thing: 99% of the instances to 1e-9, and at most 1% apart (an
# instance whose grid choice sits on a knife's edge can flip early: 1 of the 4096 of the f64 entropy
# batch, 2 of the 1024 of the dual_exp one); (2) run to the tolerance, both converge and the
# kernel stays as close to the plain version as the plain version stays to itself under a one-ulp change
# of c: median and 99% within 10 times that, the share with different iteration counts within 0.15 of
# it, and no instance further than 1e-4 (a single instance's tail, as for K6's psd layouts) unless it
# is a stall the algorithm makes under rounding: the kernel reports it unconverged, and the plain
# version, on the instance's data moved by one ulp (every nonzero entry up or down at random,
# K7_ULP_DRAWS draws), also stalls unconverged at the kernel's primal point (x and s within 1e-4) on
# at least one draw; at most 1% of the batch. A few dual_exp instances sit on such a knife's edge (the
# plain version stalls there on some one-ulp draws of their data, and the kernel did on the data
# itself on 2 of 1024: PERF.md, Findings); the dual_exp layout runs on four draws.
TOL_K7_F32 = {"median": 1e-4, "q99": 1e-2}
TOL_K7_CAPPED = {"q99": 1e-9, "share": 0.01}
K7_CAPPED_BODIES = 8
TOL_K7_F64_SPREAD = {"factor": 10.0, "floor": 1e-8, "share_margin": 0.15, "max": 1e-4, "far_share": 0.01}
K7_ULP_DRAWS = 64
K7_DUAL_EXP_SEEDS = (11, 12, 13)  # the dual_exp draws beside the shared generator's


def ns_pdip_flops(n, p, l, soc_dims, ns_blocks, iterations, dtype=torch.float32):
    """Operations of one launch of the fused nonsymmetric IPM on a batch whose instances ran ``iterations``
    bodies each, counted as csrc/ns_pdip.cu does the work; each log, exp and sqrt counts as one operation.
    A body: the metrics; grad F; the per-block Hbar data (per ns block its closed-form gradient and
    Hessian, a 3 x 3 Jacobi of 6 sweeps, 8 in f64, of 3 rotations, the floored inverse); the LDL' of K (its
    cone block computed entry by entry); the affine probe (one solve, 9 feasibility candidates, mu_aff); the
    predictor (two solves with the refinement residuals of the unsquared block system, 18 candidates with
    the proximity test); the update. A solve: Hbar^-1 applied twice, the LDL' substitutions, the right-hand
    side. A candidate: the point s + a ds, y + a dy, the interiority of every block, and (with the
    proximity) mu and per block the proximity term, per ns block its gradient, Hessian and the scaled 3 x 3
    Cramer solve. The centering step (a solve and 7 candidates) runs only where the predictor's step is
    below 0.05, which the run does not report, and is not counted. Per instance: the init (grad F) and
    three metric evaluations outside the loop."""
    from diffopt_tpu_torch.ops.smalleig import _sweeps_for

    nns = len(ns_blocks)
    mC = l + sum(soc_dims) + 3 * nns
    N = n + p + mC
    sweeps = _sweeps_for(3, dtype)
    grad_hess = 50  # one ns block's margin, gradient and Hessian (a log or an exp and a log, 45-60 operations)
    metrics = 4 * n * (mC + p) + 14 * mC + 10 * p + 11 * n
    grad = 2 * l + sum(5 * d + 4 for d in soc_dims) + 25 * nns
    hbar = sum(2 * d + 4 for d in soc_dims) + nns * (grad_hess + sweeps * 3 * 70 + 6 + 81 + 18)
    entries = l * 3 + sum(d * d * 6 for d in soc_dims) + nns * 9 * 2  # one cone-block entry of Hbar or Hbar^-1
    factor = N**3 / 3 + N * N + entries / 2
    apply = 2 * (l + sum(d * d for d in soc_dims) + 9 * nns) + entries
    solve_once = 2 * apply + 2 * N * N + N + 2 * mC
    residuals = apply + 4 * mC * n + 4 * p * n + 2 * n + p + 5 * mC
    solve_dir = 2 * solve_once + residuals + 2 * (n + p + 2 * mC)
    point = 4 * mC
    interior = l + sum(2 * d + 2 for d in soc_dims) + nns * 24
    prox = 2 * mC + 3 * l + sum(14 * d + 8 for d in soc_dims) + nns * (grad_hess + 80)
    cand_feasible, cand_prox = point + interior, 2 * point + interior + prox
    body = grad + hbar + factor + solve_once + 9 * cand_feasible + 5 * mC + 3 * mC + solve_dir
    body += 18 * cand_prox + 2 * (n + p + 2 * mC)
    its = iterations.double()
    return float(its.sum()) * (body + metrics) + its.numel() * (grad + 3 * metrics)


def k7_bound(args, lay, its):
    """K7's bound on the inputs ``args``: c, b, A read, x, y, s, the counts and the three residuals written; the
    operations of the bodies this run's instances ran (``its``)."""
    B, n, (p, l, socs, ns), mC = args[0].shape[0], args[0].shape[1], lay, args[2].shape[1]
    return bound(B * args[0].element_size() * ((p + mC) * (n + 1) + n + (n + p + 2 * mC + 4)),
                 ns_pdip_flops(n, p, l, socs, ns, its))


def _inst_diff(out, ref):
    """Per-instance relative difference over x, yE, yC and s."""
    return torch.stack([(a - b).abs().amax(-1) / (1.0 + b.abs().amax(-1))
                        for a, b in zip(out[:4], ref[:4]) if a.shape[-1]]).amax(0).double()


def _dist(x):
    return tuple(float(torch.quantile(x, q)) for q in (0.5, 0.99, 1.0))


def _ulp_draws(args, idx, draws, gen):
    """The instances ``idx`` of K7's inputs, each repeated ``draws`` times with every nonzero entry moved
    one ulp up or down at random."""
    out = []
    for t in args:
        t = t[idx].repeat_interleave(draws, 0)
        up = torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype) < 0.5
        moved = torch.where(up, torch.nextafter(t, torch.full_like(t, float("inf"))),
                            torch.nextafter(t, torch.full_like(t, float("-inf"))))
        out.append(torch.where(t == 0, t, moved))
    return out


def _hold_k7(label, out, ref, args, lay, kw, tol, f64, shared, ugen):
    """K7's outputs ``out`` (one team's) against its plain version ``ref`` with the TOL_K7_* checks; the plain
    runs they need beyond ``ref`` (capped, one ulp of c, the one-ulp draws of far instances) are computed
    once per batch into ``shared``. Returns the agreement record."""
    from diffopt_tpu_torch.ops.cuda import ns_pdip

    B = args[0].shape[0]
    inst = _inst_diff(out, ref)
    conv = lambda o: float((torch.maximum(torch.maximum(o[5], o[6]), o[7]) < 10 * tol).float().mean())
    differ = float((out[4] != ref[4]).float().mean())
    med, q99, worst = _dist(inst)
    max_abs = max(float((a - b).abs().max()) for a, b in zip(out[:4], ref[:4]) if a.numel())
    print(f"[kernels] ns_pdip {label} B={B} layout {lay} tol {tol:.0e}: per-instance relative diff median"
          f" {med:.3e}, 99% {q99:.3e}, max {worst:.3e}; converged {conv(out):.4%} (plain {conv(ref):.4%});"
          f" iterations mean {float(out[4].float().mean()):.2f} vs plain {float(ref[4].float().mean()):.2f},"
          f" differ on {differ:.3%}; plain {shared['plain_ms']:.0f} ms")
    check(all(bool(torch.isfinite(t).all()) for t in out[:4]), f"ns_pdip {label}: non-finite output")
    check(conv(out) >= 0.99 and conv(ref) >= 0.99, f"ns_pdip {label}: converged shares {conv(out)}, {conv(ref)}")
    dist = dict(median=med, q99=q99, max=worst, iterations_differ=differ, converged=conv(out),
                plain_converged=conv(ref), max_abs_err=max_abs)
    if not f64:
        check(med <= TOL_K7_F32["median"] and q99 <= TOL_K7_F32["q99"],
              f"ns_pdip {label} disagrees with its plain version: median {med:.3e}, 99% {q99:.3e}")
        return dist
    same = out[4] == ref[4]
    dist["max_same_iterations"] = float(inst[same].max()) if bool(same.any()) else 0.0
    # (1) the first bodies: the same computation
    capped = dict(kw, max_iters=K7_CAPPED_BODIES, tol=0.0)
    if "capped" not in shared:
        shared["capped"] = ns_pdip.solve_tile_fused_ns_plain(*args, lay, **capped)
    cap = _inst_diff(ns_pdip.solve_tile_fused_ns(*args, lay, team=shared["team"], **capped), shared["capped"])
    cap_share = float((cap > TOL_K7_CAPPED["q99"]).float().mean())
    dist.update(capped_q99=float(torch.quantile(cap, 0.99)), capped_share_apart=cap_share)
    # (2) to the tolerance: against the plain version's own spread under one ulp of c
    if "ulp" not in shared:
        c_ulp = args[0] * (1.0 + torch.finfo(args[0].dtype).eps)
        shared["ulp"] = ns_pdip.solve_tile_fused_ns_plain(c_ulp, *args[1:], lay, **kw)
    ulp = shared["ulp"]
    ulp_inst = _inst_diff(ulp, ref)
    u_med, u_q99, u_max = _dist(ulp_inst)
    u_differ = float((ulp[4] != ref[4]).float().mean())
    dist.update(ulp_median=u_med, ulp_q99=u_q99, ulp_max=u_max, ulp_iterations_differ=u_differ)
    # an instance further than sp["max"]: a stall the plain version makes at the kernel's point on the
    # instance's data moved by one ulp?
    sp = TOL_K7_F64_SPREAD
    err = lambda o: torch.maximum(torch.maximum(o[5], o[6]), o[7])
    far = (inst > sp["max"]).nonzero()[:, 0]
    hits, far_unconverged = [], bool((err(out)[far] >= 10 * tol).all())
    if len(far):
        R = K7_ULP_DRAWS
        key = tuple(far.tolist())
        if key not in shared:
            shared[key] = ns_pdip.solve_tile_fused_ns_plain(*_ulp_draws(args, far, R, ugen), lay, **kw)
        runs = shared[key]
        primal = _inst_diff([out[0][far].repeat_interleave(R, 0), out[3][far].repeat_interleave(R, 0)],
                            [runs[0], runs[3]])
        stalled_there = (primal <= sp["max"]) & (err(runs) >= 10 * tol)
        hits = [int(h) for h in stalled_there.view(len(far), R).sum(1)]
    dist.update(far=len(far), far_ulp_stalls=hits, far_instances=[int(i) for i in far])
    print(f"[kernels] ns_pdip {label}: capped at {K7_CAPPED_BODIES} bodies diff median {float(cap.median()):.3e},"
          f" 99% {dist['capped_q99']:.3e}, above {TOL_K7_CAPPED['q99']:.0e} on {cap_share:.3%}; where both took the same"
          f" steps max {dist['max_same_iterations']:.3e}; the plain version against itself with c moved by one ulp:"
          f" median {u_med:.3e}, 99% {u_q99:.3e}, max {u_max:.3e}, iteration counts differ on {u_differ:.3%};"
          f" {len(far)} instances further than {sp['max']:.0e}"
          + (f" ({[int(i) for i in far]}; the kernel reports {'all' if far_unconverged else 'not all'} of them"
             f" unconverged), on whose data moved by one ulp the plain version stalls at the kernel's primal point"
             f" in {hits} of {K7_ULP_DRAWS} draws" if len(far) else ""))
    if len(far):  # their data, exactly (float.hex), so that an instance can be kept as a test case
        dist["far_data"] = [dict(c=[v.hex() for v in args[0][i].tolist()], bE=[v.hex() for v in args[1][i].tolist()],
                                 bC=[v.hex() for v in args[2][i].tolist()]) for i in far.tolist()]
        print(f"[kernels] ns_pdip {label}: the far instances' c, bE, bC: {json.dumps(dist['far_data'])}")
    check(dist["capped_q99"] <= TOL_K7_CAPPED["q99"] and cap_share <= TOL_K7_CAPPED["share"],
          f"ns_pdip {label}: the first bodies disagree (99% {dist['capped_q99']:.3e}, apart on {cap_share:.3%})")
    lim = lambda u: sp["factor"] * max(u, sp["floor"])
    check(med <= lim(u_med) and q99 <= lim(u_q99),
          f"ns_pdip {label}: kernel and plain part further than one ulp of the data moves the plain version")
    check(len(far) <= sp["far_share"] * B and far_unconverged and all(h > 0 for h in hits),
          f"ns_pdip {label}: {len(far)} instances further than {sp['max']:.0e} from the plain version"
          f" (reported unconverged: {far_unconverged}), which stalls there on one-ulp moves of their data"
          f" in {hits} of {K7_ULP_DRAWS} draws")
    check(differ <= u_differ + sp["share_margin"], f"ns_pdip {label}: iteration counts differ on {differ:.3%}")
    return dist


def phase_kernels_ns(batch, gen):
    """K7 against its plain version at every team that takes each layout: the entropy family of [exp] in
    f32 at the full width and in f64, the pow family and a dual_exp layout in f64; every team must give
    the same bits. Times by team and residency for the first four (the ``k7_teams`` line). Returns the
    entry of the ``kernels`` line."""
    from diffopt_tpu_torch.ops.cuda import ns_pdip
    from diffopt_tpu_torch.utils.testing import make_dual_exp_batch, make_entropy_batch, make_pow_batch, ns_internal_rows

    Bf = min(batch, EXP_BATCH)
    cases = [
        ("entropy f32", make_entropy_batch(Bf, k=EXP_K, seed=1, device=DEVICE), 5e-6),
        ("entropy f64", make_entropy_batch(min(batch, 4096), k=EXP_K, seed=2, dtype=torch.float64, device=DEVICE), 1e-8),
        ("pow f64", make_pow_batch(min(batch, 1024), seed=3, device=DEVICE), 1e-8),
        ("dual_exp f64", make_dual_exp_batch(min(batch, 1024), device=DEVICE, generator=gen), 1e-8),
    ]
    timed_cases = {label for label, _, _ in cases}
    for seed in K7_DUAL_EXP_SEEDS:
        dgen = torch.Generator(device=DEVICE)
        dgen.manual_seed(seed)
        cases.append((f"dual_exp f64 seed {seed}", make_dual_exp_batch(min(batch, 1024), device=DEVICE, generator=dgen), 1e-8))
    ugen = torch.Generator(device=DEVICE)  # the one-ulp draws, apart from the generator later phases share
    ugen.manual_seed(0)
    entry, dists, by_layout = None, {}, {}
    for label, cp, tol in cases:
        args, lay = ns_internal_rows(cp)
        B, f64 = cp.batch_size, cp.A.dtype == torch.float64
        kw = dict(max_iters=150, tol=tol, reg=1e-11 if f64 else 1e-7, eps=1e-15 if f64 else 1e-7)
        n, (p, l, socs, ns) = cp.num_vars, lay
        item = cp.A.element_size()
        rule = ns_pdip.team_for(n, p, l, socs, ns, item)
        teams = [t for t in ns_pdip.TEAMS if ns_pdip.team_takes(n, p, l, socs, ns, item, t)]
        check(rule in teams, f"ns_pdip {label}: the rule's team {rule} does not take the layout")
        ref, plain_ms = wall_ms(lambda: ns_pdip.solve_tile_fused_ns_plain(*args, lay, **kw))
        shared = dict(plain_ms=plain_ms, team=rule)
        outs, per_team = {}, {}
        for t in teams:
            outs[t] = ns_pdip.solve_tile_fused_ns(*args, lay, team=t, **kw)
            shared["team"] = t
            per_team[t] = _hold_k7(f"{label} team {t}", outs[t], ref, args, lay, kw, tol, f64, shared, ugen)
        same = all(all(torch.equal(a, b) for a, b in zip(outs[t], outs[rule])) for t in teams)
        check(same, f"ns_pdip {label}: the teams {teams} do not give the same bits")
        rec = dict(team=rule, B=B, N=n + p + args[2].shape[1], same_bits=same)
        if label in timed_cases:
            rec["ms_by_team"] = {str(t): time_ms(lambda t=t: ns_pdip.solve_tile_fused_ns(*args, lay, team=t, **kw),
                                                 reps=3) for t in teams}
            rec["resident_by_team"] = {str(t): ns_pdip.blocks_per_sm(n, p, l, socs, ns, cp.A.dtype, t) for t in teams}
            print(f"[kernels] ns_pdip {label}: the same bits at teams {teams}; device ms by team {rec['ms_by_team']},"
                  f" teams resident per SM {rec['resident_by_team']}")
        by_layout[label] = rec
        dists[label] = per_team[rule]
        if not f64:
            out = outs[rule]
            ms = rec["ms_by_team"][str(rule)]
            flops = ns_pdip_flops(n, p, l, socs, ns, out[4])
            b_ms, b_by = k7_bound(args, lay, out[4])
            print(f"[kernels] ns_pdip {label} B={B}: {ms:.3f} ms on the rule's team of {rule} warps (bound {b_ms:.3f} ms"
                  f" by {b_by}: {flops / B:.0f} operations per instance; plain {plain_ms:.0f} ms)")
            entry = dict(name="ns_pdip", route="cuda", source="diffopt_tpu_torch/csrc/ns_pdip.cu",
                         replaces="diffopt_tpu/ops/pallas/ns_pdip.py:224", max_abs_err=per_team[rule]["max_abs_err"],
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None, team_warps=rule,
                         ms_by_team=rec["ms_by_team"])
        del outs, ref, cp, shared
        torch.cuda.empty_cache()
    entry["agreement"] = dists
    entry["k7_teams"] = by_layout
    return {"ns_pdip": entry}


def phase_exp(batch):
    """The slice's main path at full width: solve_conic_batched (K7 forward, gram polish, gram VJP on
    K4 / K5) forward + backward of sum(x**2) on the entropy family of the JAX package's exp benchmark
    (B = 16384, k = 3, f32), a warm-up and three timed steps; launch counts, converged share, residuals,
    and the f32 gradients of 512 instances against the same instances solved and differentiated in f64."""
    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.utils.testing import make_entropy_batch

    B = min(batch, EXP_BATCH)
    cp = make_entropy_batch(B, k=EXP_K, seed=0, device=DEVICE).map(lambda t: t.requires_grad_())
    wrappers = reset_counts()
    (sol, info, loss), med = timed_steps(conic_step_runner(cp), STEPS)
    launches = {k: w.launches for k, w in wrappers.items()}
    by_shape = chol_shape_launches()
    per_step = {k: v / (STEPS + 1) for k, v in launches.items()}
    print(f"[exp] launches over {STEPS + 1} steps: {launches} (per step {per_step})")
    check(per_step["ns_pdip"] == 1, f"[exp]: K7 launched {per_step['ns_pdip']} times per step, expected 1")
    check(per_step["chol_factor"] > 0 and per_step["chol_solve"] > 0, "[exp]: the gram route launched no K4 / K5")
    check(per_step["conic_pdip"] == 0 and per_step["pdip_fused"] == 0, "[exp]: a kernel of another path was launched")
    grads = [t.grad for t in cp.tensors()]
    check(all(bool(torch.isfinite(t).all()) for t in sol.tensors()), "[exp]: non-finite solution")
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads), "[exp]: non-finite gradient")
    check(sol.x.shape == (B, 2 * EXP_K) and sol.y.shape == (B, 1 + 3 * EXP_K), "[exp]: wrong shapes")
    conv = float(info.converged.float().mean())
    res = float(torch.maximum(info.primal_residual, info.dual_residual).max())
    its = info.iterations.float()
    print(f"[exp] B={B} k={EXP_K} (n = {2 * EXP_K}, N = {3 * EXP_K + 1 + 2 * EXP_K}) f32: loss {loss.item():.6e},"
          f" converged {conv:.4%}, max relative residual {res:.3e}, iterations mean {float(its.mean()):.2f}"
          f" max {int(its.max())}")
    check(conv >= 0.99, f"[exp]: only {conv:.3%} of the instances converged")
    check(res <= 1e-3, f"[exp]: relative residual {res:.3e}: an instance is far from solved")
    sub = min(B, 512)
    c64 = cp.map(lambda t: t.detach()[:sub].double().requires_grad_())
    s64 = dtt.solve_conic_batched(c64)  # the f64 default tolerance, 1e-8
    (s64.x**2).sum().backward()
    worst = {}
    for name, g, r in zip("Abc", grads, c64.tensors()):
        diff = (g[:sub].double() - r.grad).abs().flatten(1).amax(1) / float(r.grad.abs().max())
        share = float((diff > 1e-2).float().mean())
        worst[name] = (float(diff.median()), float(diff.max()), share)
        print(f"[exp] grad d{name} f32 against f64: per-instance relative diff median {float(diff.median()):.3e},"
              f" 99% {float(torch.quantile(diff, 0.99)):.3e}, max {float(diff.max()):.3e}, above 1e-2 on {share:.3%}")
        check(float(diff.median()) <= TOL_CONIC_GRAD["median"] and share <= TOL_CONIC_GRAD["share_above_1e-2"],
              f"[exp]: f32 gradient d{name} off the f64 one")
    return launches, dict(solves_vjps_per_s=B / med, step_ms=med * 1e3, batch=B, k=EXP_K, converged=conv,
                          max_residual=res, mean_iterations=float(its.mean()), ns_pdip_per_step=per_step["ns_pdip"],
                          chol_factor_per_step=per_step["chol_factor"], chol_solve_per_step=per_step["chol_solve"],
                          chol_launches_by_shape=by_shape, grad_f32_vs_f64={k: dict(median=v[0], max=v[1], share_above_1e_2=v[2]) for k, v in worst.items()})


def phase_ns_routes(gen):
    """The other entry points and routes of the slice at small batches, f64: solve_conic(solver='nsipm')
    (staged) against K7, the staged solver on a psd + exp layout, the forward rule against a central
    difference, ConicDiffContext against the uncached verbs, the DR splitting on an equality-only program
    and on the entropy program, the exp / pow DPi against a central difference of Pi, and a heterogeneous
    padded exp / pow batch against per-instance solves."""
    import torch.autograd.forward_ad as fwAD

    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch import cones, conic_diff
    from diffopt_tpu_torch.solvers import conic_nsipm
    from diffopt_tpu_torch.utils import batching
    from diffopt_tpu_torch.utils.testing import make_entropy_batch

    f64 = torch.float64
    ent = make_entropy_batch(256, k=EXP_K, seed=6, dtype=f64, device=DEVICE)
    wrappers = reset_counts()
    staged, sinfo = dtt.solve_conic(ent, solver="nsipm", with_info=True)
    fused, finfo = dtt.solve_conic_batched(ent, with_info=True)
    err = (staged.x - fused.x).abs().amax(1) / (1.0 + fused.x.abs().amax(1))
    print(f"[ns-routes] solve_conic(solver='nsipm') against K7, entropy f64 B=256: per-instance relative diff of x"
          f" median {float(err.median()):.3e}, max {float(err.max()):.3e} (tol 1e-6: two runs that met tol 1e-8);"
          f" converged {float(sinfo.converged.float().mean()):.2%} / {float(finfo.converged.float().mean()):.2%};"
          f" launches {dict((k, w.launches) for k, w in wrappers.items())},"
          f" {conic_nsipm.solve_batched.host_syncs} host syncs in the staged loop")
    check(float(err.max()) <= 1e-6 and bool(sinfo.converged.all()) and bool(finfo.converged.all()),
          "solve_conic (staged nsipm) and K7 disagree")
    check(wrappers["ldl_factor"].launches > 0 and wrappers["ns_pdip"].launches == 1, "[ns-routes]: wrong kernels")

    # a psd + exp layout, which only the staged solver takes: entropy plus 2 I + sum_j x_j G_j >= 0 (side 2)
    Bp = 64
    G = 0.3 * torch.randn(Bp, 2 * EXP_K, 2, 2, dtype=f64, device=DEVICE, generator=gen)
    G = (G + G.transpose(-1, -2)) / 2
    svec = lambda X: torch.stack([X[..., 0, 0], 2**0.5 * X[..., 0, 1], X[..., 1, 1]], -1)
    base = ent.map(lambda t: t[:Bp])
    pe = dtt.ConeProgram(torch.cat([base.A, -svec(G).transpose(1, 2)], 1),
                         torch.cat([base.b, svec(2 * torch.eye(2, dtype=f64, device=DEVICE)).expand(Bp, 3)], 1), base.c,
                         dtt.ConeSpec(list(base.cones.blocks) + [("psd", 3)]))
    reset_counts()
    psol, pinfo = dtt.solve_conic(pe, solver="nsipm", with_info=True)
    print(f"[ns-routes] solve_conic(solver='nsipm') on entropy + psd(side 2), f64 B={Bp}: converged"
          f" {float(pinfo.converged.float().mean()):.2%}, iterations mean {float(pinfo.iterations.float().mean()):.2f};"
          f" K7 launches {wrappers['ns_pdip'].launches}, LDL' launches {wrappers['ldl_factor'].launches}")
    check(bool(pinfo.converged.all()) and wrappers["ns_pdip"].launches == 0 and wrappers["ldl_factor"].launches > 0,
          "[ns-routes]: the psd + exp layout did not take the staged solver, or did not converge")

    # the forward rule against a central difference of the solution map (polished to the HSDE's precision)
    sub = ent.map(lambda t: t[:64].clone())
    dA, db, dc = (0.1 * torch.randn(t.shape, dtype=f64, device=DEVICE, generator=gen) for t in sub.tensors())
    dA = dA * (sub.A != 0)  # perturb the entries the family has
    with fwAD.dual_level():
        dual = dtt.ConeProgram(fwAD.make_dual(sub.A, dA), fwAD.make_dual(sub.b, db), fwAD.make_dual(sub.c, dc), sub.cones)
        jx = fwAD.unpack_dual(dtt.solve_conic(dual, mode="jvp", polish=3).x).tangent
    eps = 1e-6
    shift = lambda sgn: dtt.ConeProgram(sub.A + sgn * eps * dA, sub.b + sgn * eps * db, sub.c + sgn * eps * dc, sub.cones)
    fd = (dtt.solve_conic(shift(1), polish=3).x - dtt.solve_conic(shift(-1), polish=3).x) / (2 * eps)
    jerr = (jx - fd).abs().amax(1) / (1.0 + fd.abs().amax(1))
    print(f"[ns-routes] solve_conic(mode='jvp') on the entropy family against a central difference (eps {eps:.0e},"
          f" 3 polish steps), f64 B=64: per-instance relative diff median {float(jerr.median()):.3e}, max"
          f" {float(jerr.max()):.3e} (tol: median 1e-5, max 1e-3)")
    check(float(jerr.median()) <= 1e-5 and float(jerr.max()) <= 1e-3,
          "the forward rule on the exp family disagrees with a central difference")

    # ConicDiffContext against the uncached verbs
    ctx = dtt.ConicDiffContext(sub)
    seeds = [torch.randn(t.shape, dtype=f64, device=DEVICE, generator=gen) for t in ctx.sol.tensors()]
    cr = ctx.reverse(*seeds)
    ur = conic_diff.reverse_differentiate(sub, ctx.sol, *seeds, method="lstsq", refine_iters=2)
    cf = ctx.forward(dtt.ConeTangent(dA, db, dc))
    uf = conic_diff.forward_differentiate(sub, ctx.sol, dtt.ConeTangent(dA, db, dc), method="lstsq", refine_iters=2)
    cerr = max(rel_err(a, b) for a, b in list(zip(cr.tensors(), ur.tensors())) + list(zip(cf, uf)))
    print(f"[ns-routes] ConicDiffContext on the entropy family against the uncached verbs, f64 B=64: relative diff"
          f" {cerr:.3e} (tol 1e-8)")
    check(cerr <= 1e-8, "ConicDiffContext disagrees with the uncached verbs on an exp program")

    # the DR splitting: an equality-only program (x* on A x = b, objective -y0'b) and the entropy program
    Ae = torch.randn(32, 3, 5, dtype=f64, device=DEVICE, generator=gen)
    y0 = torch.randn(32, 3, dtype=f64, device=DEVICE, generator=gen)
    be = torch.randn(32, 3, dtype=f64, device=DEVICE, generator=gen)
    eq = dtt.ConeProgram(Ae, be, -torch.einsum("bij,bi->bj", Ae, y0), dtt.ConeSpec([("zero", 3)]))
    esol, einfo = dtt.solve_conic(eq, with_info=True)  # 'auto' takes DR
    feas = float((torch.einsum("bij,bj->bi", Ae, esol.x) - be).abs().max())
    obj = float(((eq.c * esol.x).sum(-1) + (y0 * be).sum(-1)).abs().max())
    dsol, dinfo = dtt.solve_conic(sub, solver="dr", with_info=True)
    derr = (dsol.x - fused.x[:64]).abs().amax(1) / (1.0 + fused.x[:64].abs().amax(1))
    print(f"[ns-routes] DR: equality-only f64 B=32 converged {float(einfo.converged.float().mean()):.2%} in"
          f" {float(einfo.iterations.float().mean()):.0f} iterations, |A x - b| {feas:.3e}, objective off by {obj:.3e};"
          f" entropy f64 B=64 converged {float(dinfo.converged.float().mean()):.2%} in"
          f" {float(dinfo.iterations.float().mean()):.0f} iterations, x against K7 max {float(derr.max()):.3e} (tol 1e-6)")
    check(bool(einfo.converged.all()) and feas <= 1e-8 and obj <= 1e-8, "[ns-routes]: DR on the equality-only program")
    check(bool(dinfo.converged.all()) and float(derr.max()) <= 1e-6, "[ns-routes]: DR and the nonsymmetric IPM disagree")

    # DPi of the exp / pow kinds against a central difference of Pi
    for kind, a in (("exp", None), ("dual_exp", None), ("pow", 0.3), ("dual_pow", 0.6)):
        spec = cones.ConeSpec([(kind, 3) if a is None else (kind, 3, a)])
        v = 2.0 * torch.randn(4096, 3, dtype=f64, device=DEVICE, generator=gen)
        dv = torch.randn(4096, 3, dtype=f64, device=DEVICE, generator=gen)
        h = 1e-6
        fdp = (cones.pi(spec, v + h * dv) - cones.pi(spec, v - h * dv)) / (2 * h)
        perr = (cones.dpi_apply(spec, v, dv) - fdp).abs().amax(1) / (1.0 + fdp.abs().amax(1))
        print(f"[ns-routes] DPi {kind} against a central difference of Pi (h {h:.0e}), f64 4096 points: median"
              f" {float(perr.median()):.3e}, 99% {float(torch.quantile(perr, 0.99)):.3e} (tol: median 1e-7, 99% 1e-4;"
              " the points near a region's edge see the kink)")
        check(float(perr.median()) <= 1e-7 and float(torch.quantile(perr, 0.99)) <= 1e-4, f"DPi {kind} disagrees")

    # a heterogeneous batch: entropy instances, and the same with an appended pow block, padded to one spec
    one = make_entropy_batch(16, k=EXP_K, seed=8, dtype=f64, device=DEVICE)
    insts = []
    for i in range(16):
        A, b, c = (t[i] for t in one.tensors())
        if i % 2:
            insts.append(dtt.ConeProgram(torch.cat([A, torch.zeros(3, A.shape[1], dtype=f64, device=DEVICE)]),
                                         torch.cat([b, torch.tensor([1.0, 1.0, 0.0], dtype=f64, device=DEVICE)]), c,
                                         dtt.ConeSpec(list(one.cones.blocks) + [("pow", 3, 0.3)])))
        else:
            insts.append(dtt.ConeProgram(A, b, c, one.cones))
    padded, specs = batching.pad_and_stack_cones(insts)
    reset_counts()
    hsol, hinfo = dtt.solve_conic_batched(padded, with_info=True)
    parts = batching.unpad_cone_solution(hsol, specs, padded.cones)
    herr = max(float((part.x - dtt.solve_conic_batched(ci.map(lambda t: t[None])).x[0]).abs().max())
               for part, ci in zip(parts, insts))
    print(f"[ns-routes] padded exp/pow batch of 16 ({padded.cones.blocks[-1]} appended to half) against per-instance"
          f" solves: max |x diff| {herr:.3e} (tol 1e-6), converged {float(hinfo.converged.float().mean()):.2%},"
          f" K7 launches {wrappers['ns_pdip'].launches}")
    check(herr <= 1e-6 and bool(hinfo.converged.all()) and wrappers["ns_pdip"].launches == 17,
          "[ns-routes]: the padded exp/pow batch disagrees with per-instance solves")


# ---- the NLP path: [nlp] (K2 / K3 at N = 24), [nlp-routes] -------------------------------------------------

NLP_MAX_ITERS, NLP_TOL = 40, 1e-6  # the JAX package's NLP benchmark (benchmarks/nlp_bench.py)
# the [nlp] path against the same calls routed through the plain versions of K2 / K3, per instance and relative to
# 1 + the instance's largest entry: at most `share` of the 512 instances past `tol`, none past `max`. f64 solves stop
# after 3-4 bodies below the 1e-6 KKT tolerance and the routes differ by rounding (an instance whose error sat at the
# tolerance, so that one route took one more body, would part by far more and fail the run: none does on this
# batch, whose iteration counts agree on every instance); f32 solves run to the 40-body cap near the f32 floor, where the
# f32 solution itself sits within a few 1e-7 (x) and 1e-6 (dx) of the f64 one on this batch. The limits are stated
# multiples of the H100's readings on this batch: f64 x max 4.2e-16, dx 2.4e-15; f32 x 2.1e-7, dx 1.1e-6
TOL_NLP = {
    torch.float64: {"x": (1e-13, 1e-12), "dx": (1e-12, 1e-11), "share": 0.01},  # max: >= 2,000x the readings
    torch.float32: {"x": (1e-6, 1e-5), "dx": (1e-5, 1e-4), "share": 0.01},  # max: 48x and 90x the readings
}
# each f32 route against the f64 solution of the same 512 instances, relative to 1 + the instance's largest entry (an
# f32 solve stops at a KKT error of 1e-6): the H100 read x 1.55e-7 / 1.57e-7 and dx 1.37e-6 / 1.37e-6 at most on the
# kernel / plain route; the limits are 64x and 73x that, as TOL_NLP's f32 maxima
TOL_NLP_F32_VS_F64 = {"x": 1e-5, "dx": 1e-4}
# the card against the host on the same small f64 calls ([nlp-routes]), relative to 1 + the largest entry
TOL_NLP_ROUTES = 1e-8
# ... and for qp_via_conic, whose conic IPM ends at its floor near tol=1e-11 (see phase_nlp_routes): 5x the larger
# of the H100's readings on an earlier draw of the same shape, 3.7e-7 and 8.1e-7; its residuals at most 1e-9, the
# converged test of tol=1e-10 (the host reads 1.4e-10 at most on the draw held)
TOL_QP_VIA_CONIC = 4e-6
QP_VIA_CONIC_RESID = 1e-9


def _nlp_bench_step(nlp, p, dp):
    """The NLP benchmark's step: the embedded solver, then the forward sensitivity dx along dp."""
    from diffopt_tpu_torch import nlp_diff
    from diffopt_tpu_torch.solvers import nlp as nlpsolver

    def step():
        sol, info = nlpsolver.solve(nlp, p, max_iters=NLP_MAX_ITERS, tol=NLP_TOL)
        return sol, info, nlp_diff.forward_differentiate(nlp, sol, p, dp).dx

    return step


def _nlp_vjp_step(nlp, p):
    """solve_nlp forward + backward of sum(x**2); returns the solution, info and d loss / d p."""
    import diffopt_tpu_torch as dtt

    def step():
        pr = p.detach().clone().requires_grad_()
        sol, info = dtt.solve_nlp(nlp, pr, max_iters=NLP_MAX_ITERS, tol=NLP_TOL, with_info=True)
        (sol.x**2).sum().backward()
        return sol, info, pr.grad

    return step


def _capture_ldl_calls(run):
    """The LDL' pair's inputs on a path: the last matrix ``run`` factorised and the right-hand sides solved with its
    factor, in order (captured around the wrappers, which still launch and count)."""
    from diffopt_tpu_torch.ops.cuda import chol

    seen = {}
    factor, solve = chol.ldl_batched, chol.ldl_solve_batched

    def f(K, **kw):
        seen["K"], seen["rhs"] = K, []
        return factor(K, **kw)

    def s(L, d, rhs, **kw):
        seen["rhs"].append(rhs)
        return solve(L, d, rhs, **kw)

    # the wrappers count on whatever the module's names hold: give the stand-ins counters of their own
    for w in (f, s):
        w.launches, w.launches_by_shape = 0, collections.Counter()
    chol.ldl_batched, chol.ldl_solve_batched = f, s
    try:
        run()
    finally:
        chol.ldl_batched, chol.ldl_solve_batched = factor, solve
    return seen["K"].contiguous(), [r.contiguous() for r in seen["rhs"]]


def _count_syncs(fn):
    """Calls that made the host wait on the card during ``fn()``, as CUDA's sync debug mode reports them."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def _inst_rel(a, b):
    """Per-instance max |a - b| relative to 1 + the instance's largest |b|, in f64."""
    a, b = a.detach().double().flatten(1), b.detach().double().flatten(1)
    return (a - b).abs().amax(1) / (1.0 + b.abs().amax(1))


def phase_nlp(batch, gen):
    """The NLP path at the shape of the JAX package's NLP benchmark (BASELINE config 4: n = 16, nc = 8 equalities,
    B = 16384, f32, max_iters = 40, tol = 1e-6): the bench's step (solver + forward sensitivity dx) and solve_nlp
    forward + backward of sum(x**2), a warm-up and three timed steps each; launch counts by shape, host syncs,
    converged share; 512 instances of the path against the same calls routed through the plain K2 / K3 in f64 and
    f32; and K2 / K3 held and timed on the path's own Newton systems (N = 24). Returns the kernels-line entries of
    K2 at N = 24 and K3 at (24, 1), and the ``nlp`` line."""
    from diffopt_tpu_torch import nlp_diff
    from diffopt_tpu_torch.ops.cuda import chol
    from diffopt_tpu_torch.solvers import nlp as nlpsolver
    from diffopt_tpu_torch.utils.testing import NLP_BENCH_BATCH, NLP_BENCH_N, NLP_BENCH_NC, make_nlp_bench

    B = min(batch, NLP_BENCH_BATCH)
    N = NLP_BENCH_N + NLP_BENCH_NC
    nlp, p, dp = make_nlp_bench(B, torch.float32, DEVICE)

    # the path's own Newton systems: body 5's (at the first body every instance's matrix is the same, x = 0)
    K, (rhs, *_) = _capture_ldl_calls(lambda: nlpsolver.solve(nlp, p, max_iters=5, tol=NLP_TOL))
    check(K.shape == (B, N, N) and rhs.shape == (B, N), f"[nlp]: captured Newton systems of shape {tuple(K.shape)}")

    wrappers = reset_counts()
    nlp_diff.factorize_with_inertia.host_syncs = nlpsolver.solve.host_syncs = 0
    (sol, info, dx), med = timed_steps(_nlp_bench_step(nlp, p, dp), STEPS)
    runs = STEPS + 1
    launches = {k: w.launches for k, w in wrappers.items()}
    by_shape = ldl_shape_launches()
    syncs = (nlpsolver.solve.host_syncs + nlp_diff.factorize_with_inertia.host_syncs) / runs
    print(f"[nlp] launches over {runs} bench steps: {launches}; K2 / K3 by shape {by_shape}; {syncs:.1f} host syncs a"
          " step in the solver's loop and the inertia loop")
    bodies = by_shape.get(f"ldl_factor_N{N}", 0)
    check(set(by_shape) == {f"ldl_factor_N{N}", f"ldl_solve_N{N}_k1"}, f"[nlp]: K2 / K3 launched at {by_shape}")
    check(bodies > 0 and by_shape[f"ldl_solve_N{N}_k1"] == 2 * bodies, "[nlp]: not one K2 and two K3 launches a body")
    check(all(v == 0 for k, v in launches.items() if k not in ("ldl_factor", "ldl_solve")),
          "[nlp]: a kernel of another path was launched")
    check(all(bool(torch.isfinite(t).all()) for t in (*sol, dx)), "[nlp]: non-finite solution or sensitivity")
    check(sol.x.shape == (B, NLP_BENCH_N) and sol.y.shape == (B, NLP_BENCH_NC) and dx.shape == (B, NLP_BENCH_N),
          "[nlp]: wrong shapes")
    conv = float(info.converged.float().mean())
    its = info.iterations.float()
    check(int(its.max()) * runs <= bodies, "[nlp]: an instance ran more bodies than K2 was launched")
    print(f"[nlp] B={B} n={NLP_BENCH_N} nc={NLP_BENCH_NC} (N = {N}) f32: converged {conv:.4%}, max KKT error"
          f" {float(info.kkt_residual.max()):.3e}, iterations mean {float(its.mean()):.2f} max {int(its.max())}")
    check(conv >= 0.99, f"[nlp]: only {conv:.3%} of the instances converged")
    sync_debug = _count_syncs(_nlp_bench_step(nlp, p, dp))

    wrappers = reset_counts()
    (vsol, vinfo, grad), vmed = timed_steps(_nlp_vjp_step(nlp, p), STEPS)
    vby_shape = ldl_shape_launches()
    check(all(bool(torch.isfinite(t).all()) for t in (*vsol, grad)), "[nlp]: non-finite solve_nlp output or gradient")
    check(vby_shape.get(f"ldl_factor_N{N}", 0) > 0, "[nlp]: solve_nlp launched no K2")
    check(float(_inst_rel(vsol.x, sol.x).max()) <= 1e-6, "[nlp]: solve_nlp and the solver differ on the same batch")

    # the path against the same calls routed through the plain K2 / K3, on 512 instances, f64 and f32
    sub = min(B, 512)
    agreement, routes = {}, {}
    for dtype in (torch.float64, torch.float32):
        tag = "f64" if dtype == torch.float64 else "f32"
        nlp_d = make_nlp_bench(1, dtype, DEVICE)[0]
        ps, dps = p[:sub].to(dtype), dp[:sub].to(dtype)
        wrappers = reset_counts()
        ksol, kinfo, kdx = _nlp_bench_step(nlp_d, ps, dps)()
        check(wrappers["ldl_factor"].launches > 0, f"[nlp] {tag}: the kernel route launched no K2")
        with plain_kernels():
            before = {k: w.launches for k, w in wrappers.items()}
            psol, pinfo, pdx = _nlp_bench_step(nlp_d, ps, dps)()
            check({k: w.launches for k, w in wrappers.items()} == before, "[nlp]: the plain route launched a kernel")
        tol = TOL_NLP[dtype]
        rec = {}
        for name, a, b in (("x", ksol.x, psol.x), ("dx", kdx, pdx)):
            d = _inst_rel(a, b)
            share = float((d > tol[name][0]).float().mean())
            rec[name] = dict(median=float(d.median()), max=float(d.max()), share_past_tol=share)
            check(share <= tol["share"] and float(d.max()) <= tol[name][1],
                  f"[nlp] {tag}: {name} parts from the plain route (past {tol[name][0]:.0e} on {share:.2%}, max"
                  f" {float(d.max()):.3e})")
        routes[tag] = {"kernel": (ksol.x, kdx), "plain": (psol.x, pdx)}
        its_diff = float((kinfo.iterations != pinfo.iterations).float().mean())
        agreement[tag] = dict(rec, iterations_differ=its_diff, converged=float(kinfo.converged.float().mean()),
                              converged_plain=float(pinfo.converged.float().mean()))
        print(f"[nlp] {tag} B={sub}: kernel route against the plain K2 / K3: x median {rec['x']['median']:.3e} max"
              f" {rec['x']['max']:.3e} (past {tol['x'][0]:.0e} on {rec['x']['share_past_tol']:.2%}); dx median"
              f" {rec['dx']['median']:.3e} max {rec['dx']['max']:.3e} (past {tol['dx'][0]:.0e} on"
              f" {rec['dx']['share_past_tol']:.2%}); iteration counts differ on {its_diff:.2%}; converged"
              f" {agreement[tag]['converged']:.2%} / {agreement[tag]['converged_plain']:.2%} (tol: at most"
              f" {tol['share']:.0%} past, none past {tol['x'][1]:.0e} / {tol['dx'][1]:.0e})")

    # is either f32 route less accurate? Both against the f64 kernel route's solution on the same 512 instances (the
    # f64 routes agree to 1e-15): the two error distributions side by side
    x64, dx64 = routes["f64"]["kernel"]
    f32_vs_f64 = {}
    for route, (x, dxr) in routes["f32"].items():
        f32_vs_f64[route] = {name: dict(zip(("median", "q99", "max"), _dist(_inst_rel(a, b))))
                             for name, a, b in (("x", x, x64), ("dx", dxr, dx64))}
    agreement["f32_vs_f64"] = f32_vs_f64
    for route, rec in f32_vs_f64.items():
        print(f"[nlp] f32 {route} route against the f64 solution, B={sub}: " + "; ".join(
            f"{name} median {d['median']:.3e} q99 {d['q99']:.3e} max {d['max']:.3e}" for name, d in rec.items()))
    for name in ("x", "dx"):
        for route in f32_vs_f64:
            check(f32_vs_f64[route][name]["max"] <= TOL_NLP_F32_VS_F64[name],
                  f"[nlp]: the f32 {route} route's {name} is {f32_vs_f64[route][name]['max']:.3e} from the f64 solution")

    # K2 at N = 24 and K3 at (24, 1) on the path's own systems: held at every team, timed by CUDA-graph replay
    recs = _hold_ldl(chol, K, rhs, True)
    entries = {r["name"]: r for r in recs}

    # an unpivoted LDL' of a Newton system with a zero pivot (what an indefinite Wt can give before the Levenberg
    # shift grows) goes non-finite rather than raising, and the kernel and its plain version do so on the same
    # instances: rows and columns 0, 7 and 20 of instances 3, 5 and 9 zeroed
    Kz = K[:64].clone()
    for i, j in ((3, 0), (5, 7), (9, 20)):
        Kz[i, j, :] = 0.0
        Kz[i, :, j] = 0.0
    off = lambda L, d: ~(torch.isfinite(torch.tril(L, -1)).flatten(1).all(1) & torch.isfinite(d).all(1))
    Lz, dz = chol.ldl_batched(Kz)
    Lzp, dzp = chol.ldl_batched_plain(Kz)
    xz, xzp = chol.ldl_solve_batched(Lz, dz, rhs[:64]), chol.ldl_solve_batched_plain(Lzp, dzp, rhs[:64])
    bad = [off(Lz, dz), off(Lzp, dzp), ~torch.isfinite(xz).all(1), ~torch.isfinite(xzp).all(1)]
    print(f"[nlp] K2 / K3 on 64 Newton systems, three with a zero pivot: non-finite instances "
          f"{[sorted(b.nonzero().flatten().tolist()) for b in bad]} (kernel factor, plain factor, kernel solve, plain solve)")
    check(all(sorted(b.nonzero().flatten().tolist()) == [3, 5, 9] for b in bad),
          "[nlp]: K2 / K3 and their plain versions part on which instances go non-finite")
    line = dict(instances_per_s=B / med, step_ms=med * 1e3, vjp_instances_per_s=B / vmed, vjp_step_ms=vmed * 1e3,
                batch=B, n=NLP_BENCH_N, nc=NLP_BENCH_NC, converged=conv, mean_iterations=float(its.mean()),
                max_iterations=int(its.max()), ldl_launches_per_step={k: v / runs for k, v in by_shape.items()},
                host_syncs_per_step=syncs, host_syncs_sync_debug=sync_debug, agreement=agreement, runs=runs,
                ldl_launches_by_shape=by_shape)
    print(f"[nlp] one bench step under CUDA's sync debug mode: {sync_debug} calls made the host wait on the card")
    return entries, line


def _nlp_mixed(sense, device):
    """A small NLP with every block of the KKT system: an equality, a <= and a >= row, finite lower and upper
    bounds; the objective's sign follows the sense."""
    import diffopt_tpu_torch as dtt

    s = 1.0 if sense == "min" else -1.0
    inf = float("inf")
    return dtt.NLPProblem(
        lambda x, p: s * (((x - p[:4]) ** 2).sum() + 0.1 * (x**4).sum() + 0.2 * x[0] * x[1] * p[6]),
        lambda x, p: torch.stack([x.sum() - p[4], x[0] ** 2 + x[1] ** 2 - p[5], x[2] - x[3] - p[6]]),
        ("eq", "leq", "geq"), 4, lb=[-1.0, -inf, 0.0, -inf], ub=[inf, 0.5, inf, 3.0], sense=sense, device=device)


def phase_nlp_routes(gen):
    """The NLP path's other entry points and routes at small batches, f64, each call on the card against the same
    call on the host: the solver with every constraint kind and finite bounds, min and max, from x0; solve_nlp's
    reverse and forward rules; NLPDiffContext; ParametricProgram(kind='nlp'); the route past 128 rows (the
    library solve, no K2); an inertia-corrected singular KKT matrix; and bridges.qp_via_conic with its gradient
    against solve_qp."""
    import numpy as np
    import torch.autograd.forward_ad as fwAD

    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch import bridges, nlp_diff
    from diffopt_tpu_torch.solvers import nlp as nlpsolver

    f64 = torch.float64
    worst = {}

    def hold(label, run, tol=TOL_NLP_ROUTES):
        """run(device) -> tensors; the card's against the host's."""
        on_card = [t.detach().cpu() for t in run(DEVICE)]
        on_host = [t.detach() for t in run("cpu")]
        err = max(float((a.double() - b.double()).abs().max() / (1.0 + b.double().abs().max()))
                  for a, b in zip(on_card, on_host) if b.numel())
        worst[label] = err
        check(err <= tol, f"[nlp-routes] {label}: the card parts from the host by {err:.3e} (tol {tol:.0e})")
        return on_card

    rng = np.random.default_rng(1)
    B = 16
    P = np.concatenate([2.5 * rng.normal(size=(B, 4)) + np.array([-1.5, 1.0, 0.0, 0.0]),
                        rng.uniform(-1.0, 1.0, size=(B, 1)), rng.uniform(0.2, 1.5, size=(B, 1)),
                        rng.normal(size=(B, 1))], axis=1)
    dP, seed = rng.normal(size=P.shape), rng.normal(size=(B, 4))
    x0 = np.array([0.0, 0.0, 0.5, 0.5])
    T = lambda a, dev: torch.tensor(a, dtype=f64, device=dev)
    wrappers = reset_counts()
    for sense in ("min", "max"):
        def solve(dev):
            sol, info = nlpsolver.solve(_nlp_mixed(sense, dev), T(P, dev), T(x0, dev), max_iters=60, tol=1e-10)
            check(bool(info.converged.all()), f"[nlp-routes] {sense}: not converged on {dev}")
            return (*sol, info.iterations.double())
        hold(f"solver {sense}", solve)

        def vjp(dev):
            p = T(P, dev).requires_grad_()
            sol = dtt.solve_nlp(_nlp_mixed(sense, dev), p, T(x0, dev), tol=1e-10)
            ((sol.x**2).sum() + (sol.y**2).sum()).backward()
            return (p.grad,)
        hold(f"solve_nlp VJP {sense}", vjp)

        def jvp(dev):
            with fwAD.dual_level():
                out = dtt.solve_nlp(_nlp_mixed(sense, dev), fwAD.make_dual(T(P, dev), T(dP, dev)), T(x0, dev),
                                    tol=1e-10, mode="jvp")
                return tuple(fwAD.unpack_dual(t).tangent for t in out)
        hold(f"solve_nlp JVP {sense}", jvp)
    check("ldl_factor_N9" in ldl_shape_launches(), f"[nlp-routes]: K2 not launched at N = 9 ({ldl_shape_launches()})")

    def context(dev):
        ctx = dtt.NLPDiffContext(_nlp_mixed("min", dev), T(P, dev), solver_kwargs=dict(tol=1e-10))
        return (*ctx.forward(T(dP, dev))[:4], *ctx.jacobian()[:4], ctx.reverse(dx=T(seed, dev)))
    hold("NLPDiffContext forward / jacobian / reverse", context)

    def layer(dev):
        scale = T([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0], dev)
        lay = dtt.ParametricProgram(lambda th: th * scale, kind="nlp", nlp=_nlp_mixed("min", dev), x0=T(x0, dev),
                                    tol=1e-10)
        th = T(P, dev)
        return (lay.solve(th).x, lay.forward_differentiate(th, T(dP, dev)).x,
                lay.reverse_differentiate(th, dx=T(seed, dev)))
    hold("ParametricProgram(kind='nlp')", layer)

    # past 128 rows: 100 variables, 10 >= rows, 10 equalities (len_w + nc = 130): the library solve on the card
    n, ng, ne = 100, 10, 10
    Am = np.random.default_rng(5).normal(size=(ng + ne, n)) / np.sqrt(n)
    Pb = np.concatenate([rng.normal(size=(4, n)), 0.3 * rng.normal(size=(4, ng + ne))], axis=1)

    def big(dev):
        A = T(Am, dev)
        nlp = dtt.NLPProblem(lambda x, p: ((x - p[:n]) ** 2).sum() + 0.05 * (x**4).sum(), lambda x, p: A @ x - p[n:],
                             ("geq",) * ng + ("eq",) * ne, n, device=dev)
        before = wrappers["ldl_factor"].launches
        sol, info = nlpsolver.solve(nlp, T(Pb, dev), max_iters=30, tol=1e-10)
        check(wrappers["ldl_factor"].launches == before, "[nlp-routes]: K2 was launched past 128 rows")
        check(bool(info.converged.all()), f"[nlp-routes]: the route past 128 did not converge on {dev}")
        return (*sol, info.iterations.double(), nlp_diff.forward_differentiate(nlp, sol, T(Pb, dev), T(Pb, dev)).dx)
    hold("route past 128 rows (N = 130, library solve)", big)

    # an inertia-corrected singular KKT matrix (duplicated active rows) beside a regular instance
    def singular(dev):
        nlp = dtt.NLPProblem(lambda x, p: x[0] ** 2, lambda x, p: torch.stack([x[0] - p[0], x[0] - p[1]]),
                             ("geq", "geq"), 1, device=dev)
        sol = dtt.NLPSolution(T([[2.0], [2.0]], dev), T([[2.0, 2.0], [4.0, 0.0]], dev), T([[0.0], [0.0]], dev),
                              T([[0.0], [0.0]], dev))
        Pi = T([[2.0, 2.0], [2.0, 1.0]], dev)
        M, _, layout = nlp_diff.build_sensitivity_system(nlp, sol, Pi)
        first = torch.linalg.lu_factor_ex(M)[0]
        lu, piv, sing = nlp_diff.factorize_with_inertia(M, layout)
        check(nlp_diff._is_singular(first, layout["total"]).tolist() == [True, False] and not bool(sing.any())
              and torch.equal(lu[1], first[1]), f"[nlp-routes]: the inertia correction went wrong on {dev}")
        fwd = nlp_diff.forward_differentiate(nlp, sol, Pi, torch.ones_like(Pi))
        return lu, fwd.dx, fwd.dy
    hold("inertia-corrected singular M", singular)

    # bridges.qp_via_conic on the card against solve_qp on the card, and against itself on the host. At tol=1e-11
    # the epigraph lowering's conic IPM ends at its floor, in the JAX package as here: its stall exit stops some
    # instances with residuals of 1e-10 or a little more, just past the converged test (10 tol), and which ones
    # depends on rounding (the card and the host part on two of these eight). So each conic solve, on the card and
    # on the host, must end with primal and dual residuals under QP_VIA_CONIC_RESID; and two runs that round
    # differently (the card's K2 / K3, the host's plain versions) are held at TOL_QP_VIA_CONIC.
    # tests/test_torch_bridges.py holds the port and the JAX package on the same draw (made on the host) to both
    from diffopt_tpu_torch.utils.testing import make_batch

    qp = make_batch(8, 4, 3, 2, f64, "cpu", torch.Generator().manual_seed(gen.initial_seed())).map(
        lambda t: t.to(DEVICE))
    resid, flags = {}, {}

    def via(dev):
        q = qp.map(lambda t: t.detach().to(dev).requires_grad_())
        sol = bridges.qp_via_conic(q, quadratic=True, tol=1e-11)
        (sol.z**2).sum().backward()
        _, info = dtt.solve_conic(bridges.qp_to_cone(q.map(torch.Tensor.detach), quadratic=True), tol=1e-11,
                                  with_info=True)
        resid[dev] = float(torch.maximum(info.primal_residual, info.dual_residual).max())
        flags[dev] = info.converged.tolist()
        return (*sol.tensors(), *(t.grad for t in q.tensors()))
    cone = hold("bridges.qp_via_conic and its gradient", via, tol=TOL_QP_VIA_CONIC)
    for dev, r in resid.items():
        check(r < QP_VIA_CONIC_RESID, f"[nlp-routes] qp_via_conic: a conic solve on {dev} ended with a residual of"
                                      f" {r:.3e} (limit {QP_VIA_CONIC_RESID:.0e})")
    q = qp.map(lambda t: t.detach().clone().requires_grad_())
    ref = dtt.solve_qp(q, tol=1e-11)
    (ref.z**2).sum().backward()
    zerr = float((cone[0] - ref.z.detach().cpu()).abs().max())
    gerr = max(float((g - t.grad.cpu()).abs().max() / (1.0 + t.grad.abs().max().cpu())) for g, t in zip(cone[3:], q.tensors()))
    print(f"[nlp-routes] bridges.qp_via_conic against solve_qp on the card, f64 B=8: |dz| {zerr:.3e} (tol 1e-5),"
          f" gradients {gerr:.3e} relative (tol 2e-5); the conic solves' largest residual {resid[DEVICE]:.3e} on the"
          f" card, {resid['cpu']:.3e} on the host (limit {QP_VIA_CONIC_RESID:.0e}), converged at tol 1e-11 on"
          f" {flags[DEVICE]} and {flags['cpu']}")
    check(zerr <= 1e-5 and gerr <= 2e-5, "[nlp-routes]: qp_via_conic disagrees with solve_qp")
    print("[nlp-routes] the card against the host, f64, relative to 1 + the largest entry (tol "
          f"{TOL_NLP_ROUTES:.0e}; qp_via_conic {TOL_QP_VIA_CONIC:.0e}): "
          + "; ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


# ---------------------------------------------------------------------------------------------------------------
# The two-stage Schur path (BASELINE config 5), the native packer and the examples
# ---------------------------------------------------------------------------------------------------------------

TWO_STAGE_SIZES = (8192, 100_000)  # the JAX package's two-stage bench, and BASELINE config 5's 10^5 scenarios
# The f32 step against the f64 step on the same data, which must converge: the solution's z and xs and the forward
# sensitivity's z and xs, relative to 1 + the largest |entry|; z whole, xs per scenario at its 99th percentile, the
# share of scenarios past 1e-3, and its max. The same limits for the solution and its sensitivity (a linear solve
# at it), set before the first reading.
TOL_TWO_STAGE_F32 = {"z": 1e-3, "xs_q99": 1e-3, "xs_share_past_1e-3": 0.01, "xs_max": 1e-2}


def _two_stage_step(ts, group=None):
    """The two-stage bench's step (benchmarks/two_stage_bench.py:60-63): the coupled solve, the forward sensitivity
    along the data itself, and the loss sum(z**2) + sum(dxs**2)."""
    from diffopt_tpu_torch.parallel import schur

    def step():
        sol, info = schur.solve_two_stage(ts, group=group)
        fwd = schur.two_stage_forward_sensitivity(ts, sol, ts, group=group)
        return sol, info, fwd, (sol.z**2).sum() + (fwd.xs**2).sum()

    return step


def phase_two_stage(batch):
    """The two-stage Schur path at the JAX package's bench shape (n = 8, m = 4, p = 2, c = 4, f32) at S = 8192
    and S = 100,000: a warm-up and three timed steps each, launch counts by shape, host syncs, the global converged
    flag, residuals and bodies, and z and xs of the solution and the sensitivity against the f64 step on the same
    data, whose solve must converge; K2 at N = 10 / 14 and K3 at (10, 4), (10, 1), (14, 4), (14, 1) held and timed on the path's
    own systems (S = 8192); and the collective path in a one-process NCCL group against the group=None run.
    Returns the kernels-line entries and the ``two_stage`` line."""
    import socket

    import torch.distributed as dist

    from diffopt_tpu_torch.ops.cuda import chol
    from diffopt_tpu_torch.parallel import schur
    from diffopt_tpu_torch.utils.testing import TWO_STAGE_BENCH, make_two_stage_bench

    n, m, p, c = (TWO_STAGE_BENCH[k] for k in "nmpc")
    Ns, Nf = n + p, n + m + p  # the solver's blocks, the sensitivity's
    runs = STEPS + 1
    line, entries = {}, {}
    # the full run (the default --batch) takes both sizes; a smaller --batch caps them
    sizes = sorted({s if batch >= FULL_BATCH else min(batch, s) for s in TWO_STAGE_SIZES})
    for S in sizes:
        ts = make_two_stage_bench(S, dtype=torch.float32, device=DEVICE)
        wrappers = reset_counts()
        schur.solve_two_stage.host_syncs = 0
        (sol, info, fwd, loss), med = timed_steps(_two_stage_step(ts), STEPS)
        by_shape = ldl_shape_launches()
        launches = {k: w.launches for k, w in wrappers.items()}
        syncs = schur.solve_two_stage.host_syncs / runs
        bodies = int(info.iterations)
        tag = f"[two-stage] S={S}"
        print(f"{tag}: launches over {runs} steps {launches}; K2 / K3 by shape {by_shape}; {syncs:.1f} host syncs a step")
        # each Schur solve factors once and solves with k = c, 1 and 1 right-hand sides; the solver makes one Schur
        # solve to start and two a body, the forward sensitivity one
        want = {f"ldl_factor_N{Ns}": runs * (2 * bodies + 1), f"ldl_solve_N{Ns}_k{c}": runs * (2 * bodies + 1),
                f"ldl_solve_N{Ns}_k1": runs * 2 * (2 * bodies + 1), f"ldl_factor_N{Nf}": runs,
                f"ldl_solve_N{Nf}_k{c}": runs, f"ldl_solve_N{Nf}_k1": 2 * runs}
        check(by_shape == want, f"{tag}: K2 / K3 launched {by_shape}, not one factor and three solves a Schur solve"
                                f" ({want})")
        check(all(v == 0 for k, v in launches.items() if k not in ("ldl_factor", "ldl_solve")),
              f"{tag}: a kernel of another path was launched")
        check(syncs == bodies, f"{tag}: {syncs} host syncs a step for {bodies} bodies")
        outs = (*sol, *fwd, loss)
        check(all(bool(torch.isfinite(t).all()) for t in outs), f"{tag}: non-finite solution, sensitivity or loss")
        check(sol.xs.shape == (S, n) and sol.lams.shape == (S, m) and sol.nus.shape == (S, p) and sol.z.shape == (c,)
              and fwd.xs.shape == (S, n) and all(t.device.type == torch.device(DEVICE).type for t in outs),
              f"{tag}: wrong shapes or device")
        res = {k: float(getattr(info, k)) for k in ("primal_residual", "dual_residual", "duality_gap")}
        rec = dict(scenarios_per_s=S / med, step_ms=med * 1e3, converged=bool(info.converged), bodies=bodies,
                   **res, host_syncs_per_step=syncs, ldl_launches_per_step={k: v / runs for k, v in by_shape.items()},
                   ldl_launches=by_shape, loss=float(loss))
        print(f"{tag} f32: {S / med:.1f} scenarios / s (median step {med * 1e3:.2f} ms); converged {bool(info.converged)}"
              f" after {bodies} bodies; primal {res['primal_residual']:.3e}, dual {res['dual_residual']:.3e},"
              f" gap {res['duality_gap']:.3e}")
        # the f32 step against the f64 step on the same data (drawn in f64), which must converge
        ts64 = make_two_stage_bench(S, dtype=torch.float64, device=DEVICE)
        sol64, info64, fwd64, _ = _two_stage_step(ts64)()
        check(all(bool(torch.isfinite(t).all()) for t in (*sol64, *fwd64)), f"{tag}: the f64 step is not finite")
        f64 = {k: float(getattr(info64, k)) for k in ("primal_residual", "dual_residual", "duality_gap")}
        held = {}
        for what, a, b in (("solution", sol, sol64), ("sensitivity", fwd, fwd64)):
            xs_err = _inst_rel(a.xs, b.xs)
            held[what] = dict(z=float((a.z.double() - b.z).abs().max() / (1.0 + b.z.abs().max())),
                              xs=dict(zip(("median", "q99", "max"), _dist(xs_err)),
                                      share_past_1e_3=float((xs_err > 1e-3).float().mean())))
        rec["f32_vs_f64"] = dict(**held, f64_bodies=int(info64.iterations), f64_converged=bool(info64.converged),
                                 **{f"f64_{k}": v for k, v in f64.items()})
        print(f"{tag}: against the f64 step ({int(info64.iterations)} bodies, converged {bool(info64.converged)},"
              f" primal {f64['primal_residual']:.3e}, dual {f64['dual_residual']:.3e}, gap {f64['duality_gap']:.3e}): "
              + "; ".join(f"{what} z {h['z']:.3e}, xs per scenario median {h['xs']['median']:.3e} q99"
                          f" {h['xs']['q99']:.3e} max {h['xs']['max']:.3e}, past 1e-3 on {h['xs']['share_past_1e_3']:.3%}"
                          for what, h in held.items()) + f" (tol {TOL_TWO_STAGE_F32})")
        check(bool(info64.converged), f"{tag}: the f64 solve did not converge")
        check(all(h["z"] <= TOL_TWO_STAGE_F32["z"] and h["xs"]["q99"] <= TOL_TWO_STAGE_F32["xs_q99"]
                  and h["xs"]["share_past_1e_3"] <= TOL_TWO_STAGE_F32["xs_share_past_1e-3"]
                  and h["xs"]["max"] <= TOL_TWO_STAGE_F32["xs_max"] for h in held.values()),
              f"{tag}: the f32 solution or sensitivity is off the f64 one")
        del ts64, sol64, fwd64
        line[str(S)] = rec
        if S == sizes[0]:
            # K2 / K3 on the path's own systems: the Schur solve of body 5's corrector and the sensitivity's
            K, (C, rloc, _) = _capture_ldl_calls(lambda: schur.solve_two_stage(ts, max_iters=5))
            Kf, (Cf, rf, _) = _capture_ldl_calls(lambda: schur.two_stage_forward_sensitivity(ts, sol, ts))
            for KK, CC, rr, N in ((K, C, rloc, Ns), (Kf, Cf, rf, Nf)):
                check(KK.shape == (S, N, N) and CC.shape == (S, N, c) and rr.shape == (S, N)
                      and bool(torch.isfinite(KK).all()), f"{tag}: captured systems of shape {tuple(KK.shape)}")
                for r in _hold_ldl(chol, KK, rr, True) + _hold_ldl(chol, KK, CC, True, solve_only=True)[1:]:
                    entries[r["name"]] = r
            nccl = (sol, fwd)
    # the collective path: the same step in a one-process NCCL group, every reduction an all_reduce
    S = sizes[0]
    ts = make_two_stage_bench(S, dtype=torch.float32, device=DEVICE)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        (gsol, ginfo, gfwd, _), gmed = timed_steps(_two_stage_step(ts, group=dist.group.WORLD), 1)
    finally:
        dist.destroy_process_group()
    sol, fwd = nccl
    diffs = {name: float((a - b).abs().max()) for name, a, b in
             (("z", gsol.z, sol.z), ("xs", gsol.xs, sol.xs), ("dxs", gfwd.xs, fwd.xs), ("dz", gfwd.z, fwd.z))}
    print(f"[two-stage] one-process NCCL group, S={S}: max |difference| from the group=None run {diffs} (must be 0);"
          f" step {gmed * 1e3:.2f} ms, {int(ginfo.iterations)} bodies")
    check(all(v == 0.0 for v in diffs.values()) and int(ginfo.iterations) == line[str(S)]["bodies"],
          "[two-stage]: the NCCL group's run differs from the group=None run")
    line["nccl_one_process"] = dict(max_abs_diff=diffs, step_ms=gmed * 1e3, bodies=int(ginfo.iterations))
    line.update(n=n, m=m, p=p, c=c, runs=runs)
    return entries, line


# ---------------------------------------------------------------------------------------------------------------
# The compile gate (graft_entry.entry) and the multi-process dry run (graft_entry.dryrun_multichip)
# ---------------------------------------------------------------------------------------------------------------


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return x.map(lambda t: t.detach().clone()) if hasattr(x, "map") else x


@contextlib.contextmanager
def capture_kernel_calls():
    """K1-K7's launches while the block runs, by kernel and shape: the inputs of the first call at each shape
    (for K3 / K5 with the matrix whose factor they solve with) and the launches at each shape as the wrappers
    count them. The stand-ins delegate to the wrappers, which count on whatever the module's names hold: the
    stand-ins carry the counters while they are bound (as in _capture_ldl_calls). Yields ``(calls, launches,
    totals)``; ``totals`` (launches by kernel) is filled when the block ends."""
    from diffopt_tpu_torch.ops.cuda import chol, conic_pdip, ns_pdip, pdip

    calls, launches, totals, factored = {}, collections.Counter(), {}, {}
    k_of = lambda rhs: 1 if rhs.ndim == 2 else rhs.shape[2]
    layout_of = lambda c, bE, bC, AE, AC, layout, **_: (c.shape[1], layout)
    specs = [
        ("K1", pdip, "solve_batched_fused", lambda qp, **_: (qp.num_vars, qp.num_ineq, qp.num_eq)),
        ("K2", chol, "ldl_batched", lambda K, **_: K.shape[1]),
        ("K3", chol, "ldl_solve_batched", lambda L, d, rhs, **_: (L.shape[1], k_of(rhs))),
        ("K4", chol, "cholesky_batched", lambda H, **_: H.shape[1]),
        ("K5", chol, "cholesky_solve_batched", lambda L, rhs, **_: (L.shape[1], k_of(rhs))),
        ("K6", conic_pdip, "solve_tile_fused", layout_of),
        ("K7", ns_pdip, "solve_tile_fused_ns", layout_of),
    ]
    saved = []

    def stand_in(kernel, orig, shape_of):
        def f(*args, **kw):
            key = (kernel, shape_of(*args, **kw))
            before = f.launches
            if key not in calls:
                inputs = tuple(_clone(a) for a in args)
                if kernel in ("K3", "K5"):  # the matrix the factor came from, in place of the factor
                    check(args[0].data_ptr() in factored, f"{kernel} {key[1]}: a solve with a factor not made here")
                    inputs = (factored[args[0].data_ptr()],) + inputs[1:]
                calls[key] = (inputs, dict(kw))
            out = orig(*args, **kw)
            launches[key] += f.launches - before
            if kernel in ("K2", "K4"):
                factored[(out[0] if kernel == "K2" else out).data_ptr()] = args[0].detach().clone()
            return out

        f.launches, f.launches_by_shape = 0, collections.Counter()
        return f

    for kernel, module, name, shape_of in specs:
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, stand_in(kernel, getattr(module, name), shape_of))
    try:
        yield calls, launches, totals
    finally:
        for (kernel, module, name, _), (_, _, orig) in zip(specs, saved):
            totals[kernel] = getattr(module, name).launches
            setattr(module, name, orig)


ENTRY_REPLACES = {"K1": "diffopt_tpu/ops/pallas/pdip.py:204", "K6": "diffopt_tpu/ops/pallas/conic_pdip.py:396",
                  "K7": "diffopt_tpu/ops/pallas/ns_pdip.py:224"}


def _entry_k1(qp, tag, main):
    """K1 on one of the gate's QP batches, held at every team by k1_hold; the record where main."""
    from diffopt_tpu_torch.ops.cuda import pdip

    B, n, m, p = qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq
    held, _, plain_ms = k1_hold(qp, f"{tag} [entry]")
    team = pdip.team_for(n, m, p, qp.Q.element_size())
    _, its, max_abs = held[team]
    if not main:
        return None
    ms = time_ms(lambda: pdip.solve_batched_fused(qp, max_iters=25), reps=10)
    b_ms, b_by = k1_bound(qp, its)
    print(f"[entry] pdip_fused n={n} m={m} p={p} B={B}: {ms:.4f} ms with a team of {team} warps (bound {b_ms:.6f} ms by"
          f" {b_by}; plain {plain_ms:.1f} ms)")
    return dict(name=f"entry_pdip_fused_n{n}_m{m}_p{p}", route="cuda", source="diffopt_tpu_torch/csrc/pdip.cu",
                replaces=ENTRY_REPLACES["K1"], max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, team_warps=team, batch=B)


def _entry_k6(args, lay, kw, tag, main):
    """K6 on one of the gate's conic launches (its own inputs and settings), every team that takes the layout
    against the plain version by check_k6; the record where main."""
    from diffopt_tpu_torch.ops.cuda import conic_pdip

    B, n, (p, l, socs, psds) = args[0].shape[0], args[0].shape[1], lay
    mC, f64 = args[2].shape[1], args[0].dtype == torch.float64
    rule = conic_pdip.team_for(n, p, l, socs, psds, args[0].element_size())
    outs, ref, insts, plain_ms = k6_run(args, lay, kw)
    check(rule in outs, f"conic_pdip {tag}: the launch rule's team does not take the layout")
    max_abs = {t: check_k6(f"{tag} N={n + p + mC} team {t} [entry]", out, ref, insts[t], kw["tol"], f64, bool(psds),
                           (args, lay, kw))
               for t, out in outs.items()}
    if not main:
        return None
    ms = time_ms(lambda: conic_pdip.solve_tile_fused(*args, lay, **kw), reps=10)
    b_ms, b_by = k6_bound(args, lay, outs[rule][4])
    print(f"[entry] conic_pdip layout {lay} n={n} B={B}: {ms:.4f} ms with a team of {rule} warps (bound {b_ms:.6f} ms"
          f" by {b_by}; plain {plain_ms:.1f} ms)")
    return dict(name=f"entry_conic_pdip_N{n + p + mC}", route="cuda", source="diffopt_tpu_torch/csrc/conic_pdip.cu",
                replaces=ENTRY_REPLACES["K6"], max_abs_err=max_abs[rule], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, team_warps=rule, batch=B)


def _entry_k7(args, lay, kw, tag, main):
    """K7 on the gate's exp / pow launch, every team that takes the layout against the plain version by
    _hold_k7 (the same bits at every team); the record where main."""
    from diffopt_tpu_torch.ops.cuda import ns_pdip

    B, n, (p, l, socs, ns) = args[0].shape[0], args[0].shape[1], lay
    mC, item, f64 = args[2].shape[1], args[0].element_size(), args[0].dtype == torch.float64
    teams = [t for t in ns_pdip.TEAMS if ns_pdip.team_takes(n, p, l, socs, ns, item, t)]
    rule = ns_pdip.team_for(n, p, l, socs, ns, item)
    check(rule in teams, f"ns_pdip {tag}: the rule's team {rule} does not take the layout")
    ref, plain_ms = wall_ms(lambda: ns_pdip.solve_tile_fused_ns_plain(*args, lay, **kw))
    shared = dict(plain_ms=plain_ms, team=rule)
    ugen = torch.Generator(device=DEVICE)
    ugen.manual_seed(0)
    outs, dist = {}, {}
    for t in teams:
        outs[t] = ns_pdip.solve_tile_fused_ns(*args, lay, team=t, **kw)
        shared["team"] = t
        dist[t] = _hold_k7(f"{tag} team {t} [entry]", outs[t], ref, args, lay, kw, kw["tol"], f64, shared, ugen)
    check(all(all(torch.equal(a, b) for a, b in zip(outs[t], outs[rule])) for t in teams),
          f"ns_pdip {tag} [entry]: the teams {teams} do not give the same bits")
    if not main:
        return None
    ms = time_ms(lambda: ns_pdip.solve_tile_fused_ns(*args, lay, **kw), reps=10)
    b_ms, b_by = k7_bound(args, lay, outs[rule][4])
    print(f"[entry] ns_pdip layout {lay} n={n} B={B}: {ms:.4f} ms with a team of {rule} warps (bound {b_ms:.6f} ms by"
          f" {b_by}; plain {plain_ms:.1f} ms)")
    return dict(name=f"entry_ns_pdip_N{n + p + mC}", route="cuda", source="diffopt_tpu_torch/csrc/ns_pdip.cu",
                replaces=ENTRY_REPLACES["K7"], max_abs_err=dist[rule]["max_abs_err"], ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None, team_warps=rule, batch=B)


def _entry_gram_systems(chol, H, tag):
    """K4 on the gate's own gram systems (M'M of the HSDE map at the solution) beside its plain version: the
    condition number, the difference relative to the largest entry of L, and each one's |L L' - H| / |H|. The
    factor is backward stable: the difference grows with the condition, the residuals stay at rounding."""
    L, Lp = chol.cholesky_batched(H), chol.cholesky_batched_plain(H)
    recon = lambda X: float((X @ X.transpose(1, 2) - H).abs().max() / H.abs().max())
    cond = float(torch.linalg.cond(H.double()).max())
    print(f"[entry] chol_factor {tag} on the path's own gram systems, n={H.shape[1]}: condition up to {cond:.3e};"
          f" relative difference from the plain version {rel_err(L, Lp):.3e}; |L L' - H| / |H| {recon(L):.3e} (plain"
          f" {recon(Lp):.3e})")
    check(bool(torch.isfinite(L).all()), f"chol_factor {tag} n={H.shape[1]}: non-finite factor of the path's system")


def phase_entry():
    """The compile gate: graft_entry.entry()'s step (the fused QP solver at n = 16 and 100 with its LDL' VJP,
    the fused conic solvers on the SOCP, SDP, N = 90 and exp / pow layouts with their gram polish and VJP) on
    the card in f32 and f64, a warm-up and three timed steps each; finite value and gradient, K1-K7 each
    launched, and each kernel held against its plain version on the inputs of its first launch at each of the
    step's shapes, with the checks and tolerances of the kernels phases. Returns the kernels-line records (f32),
    their launches on the f32 step, and the ``entry`` line."""
    from diffopt_tpu_torch import graft_entry
    from diffopt_tpu_torch.ops.cuda import chol

    line, entries, counts = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        tag, main = ("f32" if dtype == torch.float32 else "f64"), dtype == torch.float32
        fn, args = graft_entry.entry(dtype=dtype)
        check(all(t.device.type == "cuda" for a in args for t in a.tensors()), "[entry]: entry() did not build on the card")
        reset_counts()
        with capture_kernel_calls() as (calls, launches, totals):
            (val, gq), first_s = wall_ms(lambda: fn(*args))  # the first call: the libraries loaded, nothing built
            (val, gq), med = timed_steps(lambda: fn(*args), STEPS - 1)
        first_s /= 1e3
        runs = STEPS + 1
        print(f"[entry] {tag}: value {float(val):.6e}; launches over {runs} steps {totals}; by shape"
              f" {dict(sorted((f'{k} {s}', c) for (k, s), c in launches.items()))}")
        check(bool(torch.isfinite(val)) and bool(torch.isfinite(gq).all()) and gq.shape == args[0].q.shape
              and gq.device.type == "cuda", f"[entry] {tag}: the step's value or gradient is not finite or misplaced")
        check(all(totals[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7")),
              f"[entry] {tag}: a kernel was not launched on the gate's step: {totals}")
        check(sum(c for (k, _), c in launches.items() if k == "K1") == totals["K1"] == 2 * runs,
              f"[entry] {tag}: K1 launched {totals['K1']} times, not twice a step")
        line[tag] = dict(value=float(val), step_ms=med * 1e3, first_call_s=first_s, runs=runs, launches=totals,
                         launches_by_shape={f"{k} {s}": c for (k, s), c in launches.items()})
        print(f"[entry] {tag}: the step in {med * 1e3:.2f} ms (median of {STEPS - 1} after a warm-up; the first call"
              f" {first_s:.3f} s)"
              f" on {card_line()}")
        # each kernel against its plain version at the step's shapes
        recs = []
        cgen = torch.Generator(device=DEVICE)
        cgen.manual_seed(12)
        for (kernel, shape), (inputs, kw) in sorted(calls.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
            if kernel == "K1":
                recs.append(((kernel, shape), _entry_k1(inputs[0], tag, main)))
            elif kernel == "K6":
                recs.append(((kernel, shape), _entry_k6(inputs[:5], inputs[5], kw, tag, main)))
            elif kernel == "K7":
                recs.append(((kernel, shape), _entry_k7(inputs[:5], inputs[5], kw, tag, main)))
            elif kernel == "K2":
                N = shape
                rhs_keys = sorted(k for (kk, k) in calls if kk == "K3" and k[0] == N)
                check(bool(rhs_keys), f"[entry] {tag}: K2 at N = {N} without a K3 launch")
                first = (N, 1) if (N, 1) in rhs_keys else rhs_keys[0]
                K, rhs = inputs[0], calls[("K3", first)][0][2]
                held = _hold_ldl(chol, K, rhs, main)
                recs += [(("K2", N), held[0]), (("K3", first), held[1])]
                for other in rhs_keys:
                    if other != first:
                        recs.append((("K3", other), _hold_ldl(chol, calls[("K3", other)][0][0], calls[("K3", other)][0][2],
                                                               main, solve_only=True)[1]))
            elif kernel == "K4":
                # held as phase_kernels_chol holds every shape: on random SPD matrices of the launch's shape and
                # batch (TOL_CHOL is set for condition ~10); the path's own gram systems reported beside them
                _entry_gram_systems(chol, inputs[0], tag)
                recs.append(((kernel, shape), _hold_chol(chol, "factor", _spd(*inputs[0].shape[:2], dtype, cgen), None,
                                                         main)))
            elif kernel == "K5":
                rhs = torch.randn(inputs[1].shape, dtype=dtype, device=DEVICE, generator=cgen)
                recs.append(((kernel, shape), _hold_chol(chol, "solve", _spd(*inputs[0].shape[:2], dtype, cgen), rhs,
                                                         main)))
        if main:
            for key, rec in recs:
                name = "entry_" + rec["name"] if not rec["name"].startswith("entry_") else rec["name"]
                entries[name] = dict(rec, name=name)
                counts[name] = launches[key]
        del fn, args, calls
        torch.cuda.empty_cache()
    line["runs"] = STEPS + 1
    return entries, counts, line


def phase_dryrun():
    """graft_entry.dryrun_multichip over every card of the machine, NCCL: one process a card, each part's sharded
    result against the one-process result of the same data (the dry run raises where one is off), the fused
    kernels K1-K6 launched inside the group in every process. Returns the ``dryrun`` line."""
    from diffopt_tpu_torch import graft_entry

    n = torch.cuda.device_count()
    torch.cuda.empty_cache()
    rep = graft_entry.dryrun_multichip(n)
    for r in rep["ranks"]:
        parts = {k: v for k, v in r.items() if isinstance(v, dict) and k != "b_launches"}
        print(f"[dryrun] rank {r['rank']} of {r['world']} ({r['backend']}, {r.get('card')}): the fused path's launches"
              f" inside the group {r['b_launches']}; largest relative difference from the one-process run by part"
              f" {{{', '.join(f'{k}: {max(v.values()):.3e}' for k, v in parts.items())}}} (tol"
              f" {graft_entry.DRYRUN_TOL:.0e}); two-stage bodies {r['d_bodies']}")
        check("nccl" in r["backend"] and r["world"] == n, f"[dryrun]: rank {r['rank']} is not in an NCCL group of {n}")
        check(all(r["b_launches"][k] > 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")),
              f"[dryrun]: rank {r['rank']} did not launch every kernel of the fused path inside the group")
        check(all(max(v.values()) <= graft_entry.DRYRUN_TOL for v in parts.values()), "[dryrun]: a part is off")
    print(f"[dryrun] {n} process(es) over NCCL, every part held, in {rep['seconds']:.1f} s (the processes' start"
          f" included) on {card_line()}")
    return rep


def phase_native():
    """The native packer on the machine with the card: compiled (not the numpy fallback), against np.add.at, its
    batch on the card."""
    import numpy as np

    from diffopt_tpu_torch import native

    check(native.native_available(), "[native]: the C++ packer did not build")
    rng = np.random.default_rng(0)
    triplets = [(rng.integers(0, 12, k), rng.integers(0, 9, k), rng.normal(size=k)) for k in rng.integers(0, 40, 64)]
    t0 = time.perf_counter()
    out = native.pack_coo_batch(triplets, 12, 9, device=DEVICE)
    ms = (time.perf_counter() - t0) * 1e3
    ref = np.zeros((len(triplets), 12, 9))
    for i, (r, c_, v) in enumerate(triplets):
        np.add.at(ref[i], (r, c_), v)
    err = float(np.abs(out.cpu().numpy() - ref).max())
    vec = native.pack_vec_batch([np.arange(3.0), np.ones(5)], 6, fill=-1.0, device=DEVICE)
    print(f"[native] C++ packer built ({native.build_dir().name}); 64 instances packed in {ms:.2f} ms, max |dx| from"
          f" np.add.at {err:.1e}, on {out.device}")
    check(err <= 1e-14 and out.device.type == vec.device.type == torch.device(DEVICE).type
          and vec.cpu().tolist() == [[0, 1, 2, -1, -1, -1], [1, 1, 1, 1, 1, -1]], "[native]: the packer is wrong")


def phase_examples():
    """Each examples/*_torch.py on the card at its file's sizes, held to its closed form, its outputs on the card.
    Returns the seconds each took."""
    import pathlib

    import numpy as np
    import torch.autograd.forward_ad as fwAD

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "examples"))
    import autotuning_ridge_torch as ridge
    import entropic_projection_torch as entropic
    import nearest_correlation_torch as ncm
    import qp_layers_torch as layers
    import sensitivity_analysis_torch as sens
    import unit_commitment_torch as uc

    on_card = lambda *ts: all(t.device.type == torch.device(DEVICE).type for t in ts)
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    def qp_layers():
        y = torch.tensor([-1.5, -0.3, 0.4, 2.0], dtype=torch.float64, device=DEVICE, requires_grad=True)
        z = layers.qp_relu(y)
        z.sum().backward()
        with fwAD.dual_level():
            jac = fwAD.unpack_dual(layers.qp_relu(fwAD.make_dual(y.detach().expand(4, 4).contiguous(),
                                                                 torch.eye(4, dtype=torch.float64, device=DEVICE)))).tangent
        mask = (y.detach() > 0).double()
        check(on_card(z, y.grad, jac) and float((z.detach() - y.detach().clamp(min=0)).abs().max()) <= 1e-4
              and float((y.grad - mask).abs().max()) <= 1e-5 and float((jac - torch.diag(mask)).abs().max()) <= 1e-5,
              "[examples] qp_layers: the QP layer is not ReLU or its gradient not the active mask")
        mlp, poly = layers.train_qp_relu_mlp(steps=25, device=DEVICE), layers.learn_polytope(steps=30, device=DEVICE)
        check(mlp[-1] < 0.5 * mlp[0] and poly[-1] < 0.5 * poly[0], f"[examples] qp_layers: training did not converge")

    def autotuning():
        hist = ridge.autotune(steps=30, device=DEVICE)
        check(hist[-1][1] <= hist[0][1], "[examples] autotuning_ridge: the validation loss rose")

    def sensitivity():
        g, price, dg = sens.economic_dispatch_prices(demand=10.0, device=DEVICE)
        z, manual, port = sens.matrix_inversion_manual_check(device=DEVICE)
        w, b, dw, X = sens.ridge_data_sensitivity(device=DEVICE)
        w_svm, dw_svm = sens.svm_hyperplane_sensitivity(device=DEVICE)
        check(np.abs(g - [6.0, 4.0]).max() <= 1e-5 and abs(price - 3.0) <= 1e-5 and np.abs(dg - [0.0, 1.0]).max() <= 1e-4
              and np.abs(port - manual).max() <= 1e-7 and np.corrcoef(dw, X - X.mean())[0, 1] > 0.99
              and w_svm[0] > 0 and w_svm[1] > 0, "[examples] sensitivity_analysis: a closed form does not hold")

    def correlation():
        A = np.array([[1.0, 0.9, -0.9], [0.9, 1.0, 0.3], [-0.9, 0.3, 1.0]])
        X = ncm.nearest_correlation(A, device=DEVICE)
        check(on_card(X) and float(np.abs(X.cpu().numpy() - ncm.higham(A)).max()) <= 2e-3,
              "[examples] nearest_correlation: not Higham's matrix")

    def unit_commitment():
        cost, prices = uc.marginal_prices(device=DEVICE)
        check(on_card(prices) and bool((prices > 0.5).all()) and int(prices.argmax()) == 2,
              f"[examples] unit_commitment: prices {prices.tolist()}")

    def entropic_projection():
        q = torch.tensor([0.3, -0.2, 0.1, 0.0], dtype=torch.float64, device=DEVICE)
        target = torch.tensor(entropic.TARGET, dtype=torch.float64, device=DEVICE)
        p = entropic.entropic_projection(q)
        g_layer, g_analytic = entropic.softmax_gradient_check(q, target)
        check(on_card(p, g_layer) and float((p - torch.softmax(q, 0)).abs().max()) <= 1e-6
              and float((g_layer - g_analytic).abs().max()) <= 1e-6,
              "[examples] entropic_projection: not softmax or not its gradient")

    for name, fn in (("qp_layers", qp_layers), ("autotuning_ridge", autotuning), ("sensitivity_analysis", sensitivity),
                     ("nearest_correlation", correlation), ("unit_commitment", unit_commitment),
                     ("entropic_projection", entropic_projection)):
        timed(name, fn)
    print(f"[examples] every examples/*_torch.py on the card, held to its closed form; seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=FULL_BATCH, help="instances in the batch (default: the full size)")
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
    k1_teams = {"headline": entries["pdip_fused"].pop("k1_headline"), **phase_k1_teams(args.batch, gen)}
    ldl_entries, ldl_teams = phase_kernels_ldl(args.batch, gen)
    ldl_teams = {**entries.pop("ldl_teams_main"), **ldl_teams}
    entries.update(ldl_entries)
    entries.update(phase_kernels_chol(args.batch, gen))
    entries.update(phase_kernels_conic(args.batch, gen))
    entries.update(phase_kernels_ns(args.batch, gen))
    gram34, chol_teams = entries.pop("gram34"), entries.pop("chol_teams")
    phase_k1_mu_zero(gen)
    launches, rate, step_s = phase_main(args.batch, gen)
    _, staged = phase_staged(args.batch, gen)
    phase_routes(args.batch, gen)
    qp100 = phase_qp100(args.batch, gen)
    conic_launches, conic = phase_conic(args.batch)
    sdp = phase_sdp(args.batch)
    phase_conic_routes(gen)
    exp_launches, exp = phase_exp(args.batch)
    phase_ns_routes(gen)
    nlp_entries, nlp = phase_nlp(args.batch, gen)
    nlp_routes = phase_nlp_routes(gen)
    entries.update(nlp_entries)
    two_stage_entries, two_stage = phase_two_stage(args.batch)
    entries.update(two_stage_entries)
    entry_entries, entry_counts, entry = phase_entry()
    entries.update(entry_entries)
    dryrun = phase_dryrun()
    phase_native()
    example_seconds = phase_examples()
    # each kernel's count is read from the run of its own path: K1-K3 the QP main path's (K2 / K3 at N = 172:
    # the [qp100] path's; at N = 24 the [nlp] path's), K6 the conic path's, K7 the exp path's
    own = {"conic_pdip": conic_launches, "ns_pdip": exp_launches, **{nm: qp100["ldl_launches_by_shape"] for nm in ldl_entries},
           **{nm: nlp["ldl_launches_by_shape"] for nm in nlp_entries}}
    # K2 / K3 at N = 10 / 14: the counts of the two-stage path's run at the bench's S = 8192
    ts_runs = {S: rec["ldl_launches"] for S, rec in two_stage.items() if isinstance(rec, dict) and "ldl_launches" in rec}
    own.update({nm: ts_runs[min(ts_runs, key=int)] for nm in two_stage_entries})
    # the [entry] shapes: their launches on the gate's f32 step
    own.update({nm: entry_counts for nm in entry_entries})
    # K4 / K5: one entry for each shape a path launched them at, with the count of the paths that did (the
    # staged QP path: n = 64 and 16; the gram route: n = 34 on [conic], 17 on [exp], 18 / 44 / 144 on
    # [sdp]; the condensed route on the [sdp] side 16: n = 3), and its launches per step on each; the
    # other shapes held above are in the chol_teams line only
    chol_runs = [("staged", staged["chol_launches_by_shape"], STEPS + 1),
                 ("conic", conic["chol_launches_by_shape"], STEPS + 1),
                 ("exp", exp["chol_launches_by_shape"], STEPS + 1)]
    chol_runs += [(f"sdp{line['side']}", line["chol_launches_by_shape"], line["runs"]) for line in sdp]
    by_shape, per_step = {}, {}
    for path, counts, runs in chol_runs:
        for name, c in counts.items():
            check(name in entries, f"{name}: a shape the {path} path launched K4 / K5 at is not held against its"
                                   " plain version")
            by_shape[name] = by_shape.get(name, 0) + c
            per_step.setdefault(name, {})[path] = c / runs
    for name in [nm for nm in entries if nm.startswith("chol_") and nm not in by_shape]:
        entries.pop(name)
    for name, e in entries.items():
        e["launches"] = by_shape[name] if name.startswith("chol_") else own.get(name, launches)[name]
        check(e["launches"] > 0, f"{name} was not launched on its path")
        if name.startswith("chol_"):
            e["launches_per_step"] = per_step[name]
        if name in nlp_entries:
            e["launches_per_step"] = {"nlp": e["launches"] / nlp["runs"]}
        if name in two_stage_entries:
            e["launches_per_step"] = {f"two_stage S={S}": c[name] / two_stage["runs"] for S, c in ts_runs.items()}
        if name in entry_entries:
            e["launches_per_step"] = {"entry": e["launches"] / entry["runs"]}
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
    print(f"[conic] {conic['solves_vjps_per_s']:.1f} SOCP solves+VJPs per second (median step {conic['step_ms']:.2f} ms,"
          f" B = {args.batch}) on {card}")
    print(json.dumps({"qp100": {**qp100, "card": card}}))
    print(json.dumps({"conic": {**conic, "gram_route_kernels": gram34, "card": card}}))
    print(json.dumps({"sdp": sdp, "card": card}))
    print(f"[exp] {exp['solves_vjps_per_s']:.1f} entropy solves+VJPs per second (median step {exp['step_ms']:.2f} ms,"
          f" B = {exp['batch']}) on {card}")
    print(json.dumps({"exp": {**exp, "ns_pdip_agreement": entries["ns_pdip"].pop("agreement"), "card": card}}))
    print(f"[nlp] {nlp['instances_per_s']:.1f} NLP solves+sensitivities per second (median step {nlp['step_ms']:.2f} ms,"
          f" B = {nlp['batch']}), {nlp['vjp_instances_per_s']:.1f} solve_nlp solves+VJPs per second (median step"
          f" {nlp['vjp_step_ms']:.2f} ms) on {card}")
    print(json.dumps({"nlp": {**{k: v for k, v in nlp.items() if k != "ldl_launches_by_shape"},
                              "routes_card_vs_host": nlp_routes, "card": card}}))
    for S, rec in two_stage.items():
        if isinstance(rec, dict) and "scenarios_per_s" in rec:
            print(f"[two-stage] {rec['scenarios_per_s']:.1f} scenario solves+sensitivities per second at S = {S} (median"
                  f" step {rec['step_ms']:.2f} ms, {rec['bodies']} bodies, converged {rec['converged']}) on {card}")
    print(json.dumps({"two_stage": {**two_stage, "examples_seconds": example_seconds, "card": card}}))
    print(json.dumps({"entry": {**entry, "card": card}}))
    print(json.dumps({"dryrun": {**dryrun, "card": card}}))
    print(json.dumps({"k6_teams": {**entries["conic_pdip"].pop("k6_teams"), "card": card}}))
    print(json.dumps({"k7_teams": {**entries["ns_pdip"].pop("k7_teams"), "card": card}}))
    print(json.dumps({"k1_teams": {**k1_teams, "card": card}}))
    print(json.dumps({"chol_teams": {**chol_teams, "card": card}}))
    print(json.dumps({"ldl_teams": {**ldl_teams, "card": card}}))
    # K1's, K4's, K5's, K6's and K7's launch rule and their time at every team size
    team_keys = ("team_warps", "ms_by_team", "per_block", "launches_per_step")
    print(json.dumps({"kernels": [{k: e[k] for k in keys + team_keys if k in keys or k in e} for e in entries.values()]}))
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
