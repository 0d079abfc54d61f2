"""Batched conic interior-point solver (Nesterov-Todd scaled Mehrotra PDIPM)
for the symmetric cones. Counterpart of ``diffopt_tpu/solvers/conic_ipm.py``.

Problem form (SCS geometric form, :class:`~diffopt_tpu_torch.ir.ConeProgram`)::

    min c'x   s.t.  Ax + s = b,  s in K,   dual y in K* = K

Rows are permuted/rotated by a static orthogonal map R into ``[zero | nonneg |
soc... | psd...]`` layout (nonpos rows negated, rsoc blocks rotated onto soc);
zero rows become equality constraints with free duals. Each iteration builds
the NT scaling W per cone block (lam = W y = W^-1 s), solves the Newton
system, and takes a Mehrotra predictor-corrector step with the
Jordan-algebra second-order correction.

Two solvers:

* :func:`solve_batched` — the staged solver, batch-first (the JAX module's
  ``vmap`` of a per-instance ``while_loop``, written out): every
  factorisation and substitution of an iteration is ONE launch of a batched
  kernel over the whole batch — the quasi-definite ``[cone | x | eq]`` LDL'
  (K2/K3, ``ops/cuda/chol.py``) while ``n + p + mC <= 128``, the condensed
  normal-equations Cholesky (K4/K5) past that — with plain PyTorch between
  launches. An instance that is done keeps its state by select.
* :func:`solve_batched_fused` — the fused single-kernel IPM (K6,
  ``ops/cuda/conic_pdip.py``) for batches inside its envelope, the staged
  solver past it, chosen by shape.

:func:`solve_batched_fused` sends programs with exp/pow blocks to the
nonsymmetric IPM (``solvers/conic_nsipm.py``, kernel K7) and equality-only
programs (``mC == 0``, no cone to scale) to the DR splitting
(``solvers/conic.py``), as the JAX module does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..cones import _tri_side
from ..ir import ConeProgram, ConeSolution
from ..ops import jordan
from ..ops.cuda import chol, conic_pdip
from ..utils.config import get_config
from ..utils.precision import full_precision
from .conic import ConicSolveInfo

Tensor = torch.Tensor

_IPM_KINDS = ("zero", "nonneg", "nonpos", "soc", "rsoc", "psd")


def supports(cones) -> bool:
    """True when every block is a symmetric cone this IPM handles."""
    return all(k in _IPM_KINDS for k, _, _ in cones.blocks)


def internal_rows(cp):
    """A batch's data in the internal row order: ``(c, bE, bC, AE, AC)`` with
    the rows through the static transform R of :func:`_row_transform`, the
    internal layout ``(p, l, soc_dims, psd_sides)``, and R as a tensor."""
    R_np, p, l, soc_dims, psd_sides = _row_transform(cp.cones)
    R = torch.as_tensor(R_np, dtype=cp.A.dtype, device=cp.A.device)
    A = torch.einsum("ij,bjk->bik", R, cp.A)
    b = cp.b @ R.T
    return (cp.c, b[:, :p], b[:, p:], A[:, :p], A[:, p:]), (p, l, soc_dims, psd_sides), R


def _check_supported(cones) -> None:
    if not supports(cones):
        raise ValueError(
            f"conic_ipm supports zero/nonneg/nonpos/soc/rsoc/psd cones; got {cones!r} (exp/pow blocks take "
            "solvers/conic_nsipm.py)"
        )
    if all(k == "zero" for k, _, _ in cones.blocks):
        raise ValueError("conic_ipm: an equality-only program has no cone to scale; use solvers.conic")


def _row_transform(cones, allow_ns: bool = False):
    """Static orthogonal R (dense numpy) and the internal layout (p zero rows,
    l nonneg rows, soc dims, psd sides) with rows ordered ``[zero | nonneg |
    soc... | psd...]``. ``R A x + R s = R b`` with ``R s`` in the internal
    cone; duals map back as ``y = R' y_int``. PSD rows pass through.

    With ``allow_ns=True`` (the nonsymmetric IPM), exp/pow blocks pass through
    unchanged at the end, ``[zero | nonneg | soc... | psd... | ns...]``, and a
    sixth value lists them as ``(kind, alpha)`` (``alpha`` None for exp)."""
    m = cones.total_dim
    R = np.zeros((m, m))
    zero_rows, soc_blocks, psd_blocks, ns_src = [], [], [], []
    for kind, off, dim, prm in cones.offsets_params():
        if kind == "zero":
            zero_rows.extend(range(off, off + dim))
        elif kind in ("soc", "rsoc"):
            soc_blocks.append((kind, off, dim))
        elif kind == "psd":
            psd_blocks.append((off, dim))
        elif allow_ns and kind in ("exp", "pow", "dual_exp", "dual_pow"):
            ns_src.append((kind, off, prm))
        elif kind not in ("nonneg", "nonpos"):  # exhaustive: never silently rotate an unknown kind
            raise ValueError(f"_row_transform: unsupported cone kind {kind!r}")
    row = 0
    for r in zero_rows:
        R[row, r] = 1.0
        row += 1
    p = len(zero_rows)
    for kind, off, dim in cones.offsets():
        if kind in ("nonneg", "nonpos"):
            for r in range(off, off + dim):
                R[row, r] = 1.0 if kind == "nonneg" else -1.0
                row += 1
    l = row - p
    soc_dims, psd_sides = [], []
    isq = 1.0 / np.sqrt(2.0)
    for kind, off, dim in soc_blocks:
        if kind == "soc":
            for j in range(dim):
                R[row + j, off + j] = 1.0
        else:  # rsoc: T = [[isq, isq], [isq, -isq]] (+ I) maps rsoc onto soc
            R[row, off] = R[row, off + 1] = R[row + 1, off] = isq
            R[row + 1, off + 1] = -isq
            for j in range(2, dim):
                R[row + j, off + j] = 1.0
        soc_dims.append(dim)
        row += dim
    for off, dim in psd_blocks:
        for j in range(dim):
            R[row + j, off + j] = 1.0
        psd_sides.append(_tri_side(dim))
        row += dim
    ns_blocks = []
    for kind, off, prm in ns_src:
        for j in range(3):
            R[row + j, off + j] = 1.0
        ns_blocks.append((kind, None if prm is None else float(prm)))
        row += 3
    assert row == m
    if allow_ns:
        return R, p, l, tuple(soc_dims), tuple(psd_sides), tuple(ns_blocks)
    return R, p, l, tuple(soc_dims), tuple(psd_sides)


# --- the staged solver --------------------------------------------------------


@full_precision
def solve_batched(
    cp: ConeProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    reg: float | None = None,
    refine_iters: int | None = None,
    step_frac: float = 0.99,
) -> Tuple[ConeSolution, ConicSolveInfo]:
    """Solve a ``(B, ...)`` batch of symmetric-cone programs with the staged
    NT-scaled IPM. ``max_iters``/``tol``/``reg`` default from the active
    config (per dtype; an f32 ``tol`` is raised to ``ipm_tol_f32``).
    ``info.iterations`` is per instance: the bodies it ran, including the one
    that found it converged. Each body costs one device-to-host copy
    (``done.all()``), counted in ``solve_batched.host_syncs``."""
    _check_supported(cp.cones)
    cfg = get_config()
    dt, dev = cp.A.dtype, cp.A.device
    if max_iters is None:
        max_iters = cfg.ipm_max_iters
    if tol is None:
        tol = cfg.ipm_tol(dt)
    elif dt != torch.float64:
        # complementarity products can't resolve below ~sqrt(eps_f32)
        tol = max(tol, cfg.ipm_tol_f32)
    if reg is None:
        reg = cfg.ipm_reg(dt)
    B, n = cp.c.shape
    (c, bE, bC, AE, AC), (p, l, soc_dims, psd_sides), R = internal_rows(cp)
    mC = AC.shape[1]
    cones = (l, soc_dims, psd_sides)
    nu_deg = max(l + len(soc_dims) + sum(psd_sides), 1)
    e = jordan.identity_elem(*cones, dt, dev).expand(B, mC)
    eyen = torch.eye(n, dtype=dt, device=dev)
    eyep = torch.eye(p, dtype=dt, device=dev)
    eps_sc = jordan.eps_for(dt)
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    W = lambda sc, u: jordan.w_apply(*cones, sc, u, inv=False)
    Winv = lambda sc, u: jordan.w_apply(*cones, sc, u, inv=True)
    residuals = lambda x, yE, yC, s: jordan.residuals(c, AE, bE, AC, bC, x, yE, yC, s)
    metrics = lambda x, yE, yC, s, rd, rpE, rpC: jordan.metrics(c, bE, bC, x, yE, yC, s, rd, rpE, rpC)

    use_ldl = (n + p + mC) <= 128
    if use_ldl:
        # Newton system in [cone | x | eq] order, unsquared: the unpivoted
        # LDL' eliminates the O(1) -W^2 block first (with x first the tiny
        # reg pivots wipe out W^2 in f32)

        def factor(sc):
            N = n + p + mC
            K = torch.zeros(B, N, N, dtype=dt, device=dev)
            K[:, :mC, :mC] = -jordan.w2_dense(*cones, sc)
            K[:, :mC, mC:mC + n] = AC
            K[:, mC:mC + n, :mC] = AC.transpose(1, 2)
            K[:, mC:mC + n, mC:mC + n] = reg * eyen
            if p:
                K[:, mC:mC + n, mC + n:] = AE.transpose(1, 2)
                K[:, mC + n:, mC:mC + n] = AE
                K[:, mC + n:, mC + n:] = -reg * eyep
            return chol.ldl_batched(K)

        def solve_dir_once(F, sc, rd, rpE, rpC, g):
            L, dvec = F
            sol = chol.ldl_solve_batched(L, dvec, torch.cat([-rpC + W(sc, g), -rd, -rpE], dim=-1))
            dyC, dx, dyE = sol[:, :mC], sol[:, mC:mC + n], sol[:, mC + n:]
            return dx, dyE, dyC, -W(sc, g + W(sc, dyC))

    else:
        # condensed normal equations on the Cholesky kernels past 128 rows

        def factor(sc):
            Bm = Winv(sc, AC.transpose(1, 2)).transpose(1, 2)  # W^-1 applied to each column of AC
            Lh = chol.cholesky_batched(Bm.transpose(1, 2) @ Bm + reg * eyen)
            if p:
                HiAt = chol.cholesky_solve_batched(Lh, AE.transpose(1, 2))
                Ls = chol.cholesky_batched(AE @ HiAt + reg * eyep)
            else:
                Ls = None
            return Lh, Ls, Bm

        def solve_dir_once(F, sc, rd, rpE, rpC, g):
            """Newton direction for the scaled complementarity target g (W dyC + W^-1 ds = -g)."""
            Lh, Ls, Bm = F
            wirp = Winv(sc, rpC)
            x1 = chol.cholesky_solve_batched(Lh, -rd - rmv(Bm, wirp - g))
            if p:
                dyE = chol.cholesky_solve_batched(Ls, mv(AE, x1) + rpE)
                dx = x1 - chol.cholesky_solve_batched(Lh, rmv(AE, dyE))
            else:
                dyE = rpE.new_zeros(B, 0)
                dx = x1
            dyC = Winv(sc, mv(Bm, dx) + wirp - g)
            return dx, dyE, dyC, -W(sc, g + W(sc, dyC))

    if refine_iters is None:
        refine_iters = 0 if dt == torch.float64 else 1
        if psd_sides:
            # psd W^2 blocks condition far worse than soc ones: one refinement
            # pass against the exact block system recovers the direction
            refine_iters = max(refine_iters, 1)

    def solve_dir(F, sc, rd, rpE, rpC, g):
        """Direction with iterative refinement against the unsquared Newton system."""
        d = solve_dir_once(F, sc, rd, rpE, rpC, g)
        for _ in range(refine_iters):
            dx, dyE, dyC, ds = d
            r1 = -rd - (rmv(AC, dyC) + rmv(AE, dyE))
            r2 = -rpE - mv(AE, dx)
            r3 = -rpC - (mv(AC, dx) + ds)
            r4 = -g - (W(sc, dyC) + Winv(sc, ds))
            c1, c2, c3, c4 = solve_dir_once(F, sc, -r1, -r2, -r3, -r4)
            d = (dx + c1, dyE + c2, dyC + c3, ds + c4)
        return d

    # --- init: one Newton solve at the identity scaling, then shift s and yC into the interior
    sc0 = jordan.nt_scaling(*cones, e, e, eps_sc)
    zx, zE, zC = c.new_zeros(B, n), c.new_zeros(B, p), c.new_zeros(B, mC)
    x, yE, _, _ = solve_dir(factor(sc0), sc0, *residuals(zx, zE, zC, zC), -e)
    s = jordan.shift_into_interior(*cones, bC - mv(AC, x), e)
    yC = e.clone()

    inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    mu_prev, err_prev, err_best = inf, inf, inf
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    xb, yEb, yCb, sb_ = x, yE, yC, s
    for _ in range(max_iters):
        solve_batched.host_syncs += 1
        if bool(done.all()):
            break
        active = ~done
        rd, rpE, rpC = residuals(x, yE, yC, s)
        mu = (s * yC).sum(-1) / nu_deg
        # convergence is tested BEFORE stepping
        pres, dres, gaprel = metrics(x, yE, yC, s, rd, rpE, rpC)
        done_now = (pres < tol) & (dres < tol) & (gaprel < tol)

        sc = jordan.nt_scaling(*cones, s, yC, eps_sc)
        F = factor(sc)
        lam = Winv(sc, s)  # = W yC
        lam_eigs = jordan.lam_psd_eigs(*cones, lam)
        lam_isq = jordan.lam_psd_isqrts(lam_eigs, eps_sc)
        mstep_pair = lambda da, db_: jordan.max_step_pair(*cones, lam, da, db_, lam_isq)

        # predictor (affine): g = lam
        dxa, dyEa, dyCa, dsa = solve_dir(F, sc, rd, rpE, rpC, lam)
        dsa_s, dya_s = Winv(sc, dsa), W(sc, dyCa)
        a_p, a_d = mstep_pair(dsa_s, dya_s)
        mu_aff = ((s + a_p[:, None] * dsa) * (yC + a_d[:, None] * dyCa)).sum(-1) / nu_deg
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0)

        # corrector with the Mehrotra second-order term in the scaled variables
        comp = jordan.jmul(*cones, lam, lam) + jordan.jmul(*cones, dsa_s, dya_s) - (sigma * mu)[:, None] * e
        g = jordan.jsolve(*cones, lam, comp, eps_sc, lam_eigs)
        dx, dyE, dyC, ds = solve_dir(F, sc, rd, rpE, rpC, g)

        a_cp, a_cd = mstep_pair(Winv(sc, ds), W(sc, dyC))
        alpha = torch.clamp(step_frac * torch.minimum(a_cp, a_cd), 0.0, 1.0)

        finite = torch.isfinite(alpha) & torch.isfinite(torch.cat([dx, dyE, dyC, ds], dim=-1)).all(-1)
        dead = mu <= 0.0  # complementarity collapsed: freeze (best-iterate carries the point out)
        # freeze via select, never alpha = 0: 0 * NaN would poison the state
        step = (finite & ~done_now & ~dead)[:, None]
        upd = lambda v, dv: torch.where(step, v + alpha[:, None] * dv, v)
        err = torch.maximum(pres, torch.maximum(dres, gaprel))
        stalled_now = (mu > 0.98 * mu_prev) & (err > 0.98 * err_prev)
        new_stall = torch.where(stalled_now, stall + 1, torch.zeros_like(stall))
        new_done = done_now | ~finite | (new_stall >= 5) | dead
        better = (err < err_best)[:, None]
        bupd = lambda cur, best: torch.where(better, cur, best)

        # an instance that was already done keeps every field (the vmapped while_loop's select)
        keep = lambda new, old: torch.where(active.view(-1, *([1] * (new.ndim - 1))), new, old)
        xb, yEb, yCb, sb_ = keep(bupd(x, xb), xb), keep(bupd(yE, yEb), yEb), keep(bupd(yC, yCb), yCb), keep(bupd(s, sb_), sb_)
        err_best = keep(torch.minimum(err, err_best), err_best)
        x, yE, yC, s = keep(upd(x, dx), x), keep(upd(yE, dyE), yE), keep(upd(yC, dyC), yC), keep(upd(s, ds), s)
        it = keep(it + 1, it)
        mu_prev, err_prev = keep(mu, mu_prev), keep(err, err_prev)
        stall, done = keep(new_stall, stall), keep(new_done, done)

    # the loop's best-iterate bookkeeping only sees states it stepped FROM; score the final iterate
    rd, rpE, rpC = residuals(x, yE, yC, s)
    pres_f, dres_f, gap_f = metrics(x, yE, yC, s, rd, rpE, rpC)
    err_f = torch.maximum(pres_f, torch.maximum(dres_f, gap_f))
    take = (err_f <= err_best)[:, None]
    x, yE, yC, s = (torch.where(take, a, bb) for a, bb in ((x, xb), (yE, yEb), (yC, yCb), (s, sb_)))
    rd, rpE, rpC = residuals(x, yE, yC, s)
    pres, dres, gaprel = metrics(x, yE, yC, s, rd, rpE, rpC)
    conv = (pres < 10 * tol) & (dres < 10 * tol) & (gaprel < 10 * tol)
    # back to the original row order: y = R' y_int, s = R' s_int
    sol = ConeSolution(x=x, y=torch.cat([yE, yC], dim=-1) @ R, s=torch.cat([zE, s], dim=-1) @ R)
    info = ConicSolveInfo(
        iterations=it, primal_residual=pres, dual_residual=dres, gap=(s * yC).sum(-1), converged=conv
    )
    return sol, info


solve_batched.host_syncs = 0


def solve(cp: ConeProgram, **kw) -> Tuple[ConeSolution, ConicSolveInfo]:
    """:func:`solve_batched` for one instance (fields without a batch
    dimension) or a batch."""
    if cp.c.ndim == 2:
        return solve_batched(cp, **kw)
    sol, info = solve_batched(cp.map(lambda t: t[None]), **kw)
    return sol.map(lambda t: t[0]), ConicSolveInfo(*(t[0] for t in info))


@full_precision
def solve_batched_fused(
    cp: ConeProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    reg: float | None = None,
) -> Tuple[ConeSolution, ConicSolveInfo]:
    """Solve a ``(B, ...)`` batch with the fused single-kernel IPM
    (``ops/cuda/conic_pdip.py``, one launch for all Newton iterations) when
    its layout is inside the kernel's envelope
    (:func:`~diffopt_tpu_torch.ops.cuda.conic_pdip.in_envelope`), else with
    the staged solver (:func:`solve_batched`) — chosen by shape, never by a
    failure. ``info.iterations`` is per instance; ``converged`` is
    ``max(pres, dres) < 10 tol`` as in the JAX package's fused route.

    Programs with exp/pow blocks go to the nonsymmetric IPM (its fused kernel
    K7 for a ``(B, ...)`` batch, its staged solver otherwise; its own
    ``max_iters`` default), equality-only programs to the DR splitting (the
    caller's ``tol``, DR's own iteration cap)."""
    if not supports(cp.cones):
        from . import conic_nsipm

        if conic_nsipm.supports(cp.cones) and any(k != "zero" for k, _, _ in cp.cones.blocks):
            solve_ns = conic_nsipm.solve_batched_fused if cp.c.ndim == 2 else conic_nsipm.solve_batched
            return solve_ns(cp, max_iters=max_iters, tol=tol, reg=reg)
        from . import conic as conicsolver

        return conicsolver.solve_batched(cp, tol=tol)
    if all(k == "zero" for k, _, _ in cp.cones.blocks):
        from . import conic as conicsolver

        return conicsolver.solve_batched(cp, tol=tol)
    cfg = get_config()
    dt, dev = cp.A.dtype, cp.A.device
    n = cp.num_vars
    if max_iters is None:
        max_iters = cfg.ipm_max_iters
    R_np, p, l, soc_dims, psd_sides = _row_transform(cp.cones)
    if cp.c.ndim != 2 or not conic_pdip.in_envelope(n, p, l, soc_dims, psd_sides, cp.A.element_size()):
        return solve_batched(cp, max_iters=max_iters, tol=tol, reg=reg)
    if tol is None:
        tol = cfg.ipm_tol(dt)
    elif dt != torch.float64:
        tol = max(tol, cfg.ipm_tol_f32)
    if reg is None:
        reg = cfg.ipm_reg(dt)
    R = torch.as_tensor(R_np, dtype=dt, device=dev)
    A_int = torch.einsum("ij,bjk->bik", R, cp.A)
    b_int = cp.b @ R.T
    x, yE, yC, s, it, pres, dres = conic_pdip.solve_tile_fused(
        cp.c, b_int[:, :p], b_int[:, p:], A_int[:, :p], A_int[:, p:], (p, l, soc_dims, psd_sides),
        max_iters=max_iters, tol=tol, reg=reg, eps=jordan.eps_for(dt),
    )
    y = torch.cat([yE, yC], dim=-1) @ R
    s_full = torch.cat([s.new_zeros(s.shape[0], p), s], dim=-1) @ R
    return (
        ConeSolution(x=x, y=y, s=s_full),
        ConicSolveInfo(
            iterations=it, primal_residual=pres, dual_residual=dres, gap=(s * yC).sum(-1),
            converged=torch.maximum(pres, dres) < 10 * tol,
        ),
    )
