"""Batched nonsymmetric-cone interior-point solver (dual-scaling Mehrotra
PDIPM). Counterpart of ``diffopt_tpu/solvers/conic_nsipm.py``.

Problem form (as :mod:`conic_ipm`)::

    min c'x   s.t.  Ax + s = b,  s in K,  y in K*

with K a product of zero / nonneg / nonpos / soc / rsoc / psd / exp / pow /
dual_exp / dual_pow blocks. The central path is parameterised by the primal
barrier F of the non-zero part of K (``c + A'y = 0``, ``Ax + s = b``,
``y = -mu grad F(s)``); each iteration linearises the last equation at s —
``dy + mu H(s) ds = -(y + sigma mu grad F(s))`` — which takes the place of the
NT scaling in the quasi-definite ``[cone | x | eq]`` Newton system. Steps are
chosen on static candidate grids under strict primal/dual interiority and the
Skajaa-Ye proximity neighbourhood ``||y + mu grad F(s)||_{H(s)^-1} <= beta
mu``, with a pure centering step where the predictor's search collapses. The
barrier algebra is ``ops/ns_barrier.py`` (closed forms, shared with the fused
kernel's plain version); the psd blocks, which only this solver takes, are
here.

Two solvers:

* :func:`solve_batched` — the staged solver, batch-first (the JAX module's
  ``vmap`` of a per-instance ``while_loop``, written out): one launch of a
  batched kernel per factorisation and substitution — the quasi-definite LDL'
  (K2/K3) while ``n + p + mC <= 128``, the condensed Cholesky (K4/K5) past
  it — with plain PyTorch between launches. An instance that is done keeps its
  state by select.
* :func:`solve_batched_fused` — the fused single-kernel IPM (K7,
  ``ops/cuda/ns_pdip.py``) by the reference's routing by shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..cones import svec_to_sym, sym_to_svec
from ..ir import ConeProgram, ConeSolution
from ..ops import jordan, ns_barrier
from ..ops.cuda import chol, ns_pdip
from ..ops.smalleig import eigh_small, eigvalsh_small
from ..utils.config import get_config
from ..utils.precision import full_precision
from .conic import ConicSolveInfo
from .conic_ipm import _row_transform

Tensor = torch.Tensor

_NS_KINDS = (
    "zero", "nonneg", "nonpos", "soc", "rsoc", "psd",
    "exp", "pow", "dual_exp", "dual_pow",
)
_NONSYM = ("exp", "pow", "dual_exp", "dual_pow")


def supports(cones) -> bool:
    """True when every block kind is solvable here (the full ConeSpec family)."""
    return all(k in _NS_KINDS for k, _, _ in cones.blocks)


def has_nonsymmetric(cones) -> bool:
    return any(k in _NONSYM for k, _, _ in cones.blocks)


def _psd_inv(v: Tensor, d: int):
    """``(S, S^-1)`` of a PD svec block by floored eigh (the relative floor keeps the inverse finite when
    boundary-riding eigenvalues round to <= 0)."""
    S = svec_to_sym(v)
    eps = 1e-15 if v.dtype == torch.float64 else 1e-7
    w, Q = eigh_small(S)
    w = torch.maximum(w, eps * torch.clamp(w.amax(-1, keepdim=True), min=1e-300))
    return S, (Q / w[..., None, :]) @ Q.transpose(-1, -2)


class _Psd:
    """The psd blocks' part of the barrier algebra (-logdet): the helper ``ops/ns_barrier.py`` calls."""

    @staticmethod
    def grad(v, d):
        return -sym_to_svec(_psd_inv(v, d)[1])

    @staticmethod
    def hess_pair(v, d):
        """symkron(S^-1) and symkron(S) as svec operators (column k: svec(X E_k X))."""
        S, Sinv = _psd_inv(v, d)
        tri = d * (d + 1) // 2
        E = svec_to_sym(torch.eye(tri, dtype=v.dtype, device=v.device))  # (tri, d, d)
        cols = lambda X: sym_to_svec(X[..., None, :, :] @ E @ X[..., None, :, :]).transpose(-1, -2)
        return cols(Sinv), cols(S)

    @staticmethod
    def interior(u, d):
        return eigvalsh_small(svec_to_sym(u)).amin(-1)

    @staticmethod
    def prox(s, y, d, mu):
        """zeta' symkron(S) zeta = tr(Z S Z S) with Z = Y - mu S^-1."""
        S, Sinv = _psd_inv(s, d)
        T = (svec_to_sym(y) - mu[..., None, None] * Sinv) @ S
        return (T * T.transpose(-1, -2)).sum((-1, -2))


def _check(cones) -> None:
    if not supports(cones):
        raise ValueError(f"conic_nsipm: unsupported cone kinds in {cones!r}")
    if all(k == "zero" for k, _, _ in cones.blocks):
        raise ValueError("conic_nsipm needs at least one non-zero cone block; use solvers.conic for equality-only programs")


def _tol(tol, dt):
    cfg = get_config()
    if tol is None:
        return cfg.nsipm_tol(dt)
    return tol if dt == torch.float64 else max(tol, cfg.nsipm_tol_f32)


@full_precision
def solve_batched(
    cp: ConeProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    reg: float | None = None,
    refine_iters: int | None = None,
    step_frac: float = 0.99,
    neighborhood: float = 0.9,
) -> Tuple[ConeSolution, ConicSolveInfo]:
    """Solve a ``(B, ...)`` batch with the staged nonsymmetric-cone IPM. ``neighborhood`` is the proximity
    bound beta (< 1). ``max_iters``/``tol``/``reg`` default from the active config (per dtype; an f32
    ``tol`` is raised to ``nsipm_tol_f32``). ``info.iterations`` is per instance: the bodies it ran.
    Each body costs one device-to-host copy (``done.all()``), counted in
    ``solve_batched.host_syncs``."""
    _check(cp.cones)
    cfg = get_config()
    dt, dev = cp.A.dtype, cp.A.device
    max_iters = cfg.nsipm_max_iters if max_iters is None else max_iters
    tol = _tol(tol, dt)
    reg = cfg.ipm_reg(dt) if reg is None else reg
    B, n = cp.c.shape
    R_np, p, l, soc_dims, psd_sides, ns_blocks = _row_transform(cp.cones, allow_ns=True)
    lay = ns_barrier.Layout(l, soc_dims, psd_sides, ns_blocks)
    R = torch.as_tensor(R_np, dtype=dt, device=dev)
    A = torch.einsum("ij,bjk->bik", R, cp.A)
    b = cp.b @ R.T
    c = cp.c
    AE, bE, AC, bC = A[:, :p], b[:, :p], A[:, p:], b[:, p:]
    mC = AC.shape[1]
    nu_deg = ns_barrier.nu_total(lay)
    eps_m, eps_soc, eps_w = ns_barrier.margin_eps(dt), ns_barrier.soc_eps(dt), ns_barrier.hess_floor(dt)
    psd = _Psd()
    eyen = torch.eye(n, dtype=dt, device=dev)
    eyep = torch.eye(p, dtype=dt, device=dev)
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    residuals = lambda x, yE, yC, s: jordan.residuals(c, AE, bE, AC, bC, x, yE, yC, s)
    metrics = lambda x, yE, yC, s, rd, rpE, rpC: jordan.metrics(c, bE, bC, x, yE, yC, s, rd, rpE, rpC)
    grad_barrier = lambda s: ns_barrier.grad_barrier(lay, s, eps_m, eps_soc, psd)
    feasible = lambda sn, yn: ns_barrier.feasible(lay, sn, yn, psd)
    prox_sq = lambda s, y, mu: ns_barrier.prox_sq(lay, s, y, mu, eps_m, eps_soc, 1e-300, psd)

    if refine_iters is None:
        refine_iters = 0 if dt == torch.float64 else 1
        if psd_sides or ns_blocks:
            # the psd W^2 / ns Hbar blocks condition like 1/mu^2: one pass against the block system
            refine_iters = max(refine_iters, 1)

    if n + p + mC <= 128:
        # the unsquared quasi-definite system in [cone | x | eq] order on the LDL' pair

        def factor(Hbar, Hinv):
            N = n + p + mC
            K = torch.zeros(B, N, N, dtype=dt, device=dev)
            K[:, :mC, :mC] = -Hinv
            K[:, :mC, mC:mC + n] = AC
            K[:, mC:mC + n, :mC] = AC.transpose(1, 2)
            K[:, mC:mC + n, mC:mC + n] = reg * eyen
            if p:
                K[:, mC:mC + n, mC + n:] = AE.transpose(1, 2)
                K[:, mC + n:, mC:mC + n] = AE
                K[:, mC + n:, mC + n:] = -reg * eyep
            return chol.ldl_batched(K), Hbar, Hinv

        def solve_once(F, rd, rpE, rpC, g):
            (L, dvec), _, Hinv = F
            sol = chol.ldl_solve_batched(L, dvec, torch.cat([-rpC + mv(Hinv, g), -rd, -rpE], dim=-1))
            dyC, dx, dyE = sol[:, :mC], sol[:, mC:mC + n], sol[:, mC + n:]
            return dx, dyE, dyC, -mv(Hinv, g + dyC)

    else:
        # the condensed normal equations on the Cholesky pair: Hx = AC' Hbar AC + reg I (no inverse)

        def factor(Hbar, Hinv):
            Lh = chol.cholesky_batched(AC.transpose(1, 2) @ (Hbar @ AC) + reg * eyen)
            Ls = chol.cholesky_batched(AE @ chol.cholesky_solve_batched(Lh, AE.transpose(1, 2)) + reg * eyep) if p else None
            return (Lh, Ls), Hbar, Hinv

        def solve_once(F, rd, rpE, rpC, g):
            (Lh, Ls), Hbar, _ = F
            x1 = chol.cholesky_solve_batched(Lh, -rd + rmv(AC, g - mv(Hbar, rpC)))
            if p:
                dyE = chol.cholesky_solve_batched(Ls, mv(AE, x1) + rpE)
                dx = x1 - chol.cholesky_solve_batched(Lh, rmv(AE, dyE))
            else:
                dyE, dx = rpE.new_zeros(B, 0), x1
            ds = -rpC - mv(AC, dx)
            return dx, dyE, -g - mv(Hbar, ds), ds

    def solve_dir(F, rd, rpE, rpC, g):
        """Direction with refinement against the unsquared block residuals (dyC + Hbar ds = -g)."""
        d = solve_once(F, rd, rpE, rpC, g)
        for _ in range(refine_iters):
            dx, dyE, dyC, ds = d
            r1 = -rd - (rmv(AC, dyC) + rmv(AE, dyE))
            r2 = -rpE - mv(AE, dx)
            r3 = -rpC - (mv(AC, dx) + ds)
            r4 = -g - (dyC + mv(F[1], ds))
            c1, c2, c3, c4 = solve_once(F, -r1, -r2, -r3, -r4)
            d = (dx + c1, dyE + c2, dyC + c3, ds + c4)
        return d

    grid_p = torch.tensor(ns_barrier.pred_grid(step_frac), dtype=dt, device=dev)
    grid_c = torch.tensor(ns_barrier.CENT_GRID, dtype=dt, device=dev)

    def candidates(s0, y0, ds, dy, grid):
        a = grid[None, :, None]
        sn, yn = s0[:, None, :] + a * ds[:, None, :], y0[:, None, :] + a * dy[:, None, :]
        return sn, yn, (sn * yn).sum(-1) / nu_deg

    def pred_search(s0, y0, ds, dy, with_prox, coarse=False):
        grid = grid_p[::2] if coarse else grid_p
        sn, yn, mu_n = candidates(s0, y0, ds, dy, grid)
        ok = feasible(sn, yn)
        if with_prox:
            ok = ok & (mu_n > 0) & (prox_sq(sn, yn, mu_n) <= (neighborhood * mu_n) ** 2)
        return torch.where(ok, grid, torch.zeros_like(grid)).amax(-1)

    def cent_search(s0, y0, ds, dy):
        """The feasible grid step of least prox^2 / mu^2 (the first minimum); 0 when it is not finite."""
        sn, yn, mu_n = candidates(s0, y0, ds, dy, grid_c)
        good = feasible(sn, yn) & (mu_n > 0)
        rel = prox_sq(sn, yn, mu_n) / torch.clamp(mu_n**2, min=1e-300)
        vals = torch.where(good, rel, torch.full_like(rel, float("inf")))
        best = torch.argmin(vals, dim=-1, keepdim=True)
        return torch.where(torch.isfinite(vals.gather(-1, best)[:, 0]), grid_c[best[:, 0]], torch.zeros_like(best[:, 0], dtype=dt))

    # --- init: central s0 per block, y0 = -grad F(s0) (mu0 = 1), x0 = 0
    s = ns_barrier.init_point(lay, dt, dev).expand(B, mC).clone()
    yC = -grad_barrier(s)
    x, yE = c.new_zeros(B, n), c.new_zeros(B, p)

    inf = torch.full((B,), float("inf"), dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    mu_prev, err_prev, err_best = inf, inf, inf
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    xb, yEb, yCb, sb_ = x, yE, yC, s
    zrd, zpe, zpc = c.new_zeros(B, n), c.new_zeros(B, p), c.new_zeros(B, mC)
    for _ in range(max_iters):
        solve_batched.host_syncs += 1
        if bool(done.all()):
            break
        active = ~done
        rd, rpE, rpC = residuals(x, yE, yC, s)
        mu = (s * yC).sum(-1) / nu_deg
        pres, dres, gaprel = metrics(x, yE, yC, s, rd, rpE, rpC)
        done_now = (pres < tol) & (dres < tol) & (gaprel < tol)

        gradF = grad_barrier(s)
        F = factor(*ns_barrier.hbar_pair(lay, s, mu, eps_m, eps_soc, eps_w, psd))
        # Mehrotra predictor: the affine probe (no refinement, coarse grid) only feeds sigma
        _, _, dyCa, dsa = solve_once(F, rd, rpE, rpC, yC)
        a_aff = pred_search(s, yC, dsa, dyCa, with_prox=False, coarse=True)[:, None]
        mu_aff = ((s + a_aff * dsa) * (yC + a_aff * dyCa)).sum(-1) / nu_deg
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0)
        dxp, dyEp, dyCp, dsp = solve_dir(F, rd, rpE, rpC, yC + (sigma * mu)[:, None] * gradF)
        alpha_p = pred_search(s, yC, dsp, dyCp, with_prox=True)
        # pure centering (zero residual right-hand side, no refinement) where the predictor collapses
        dxc, dyEc, dyCc, dsc = solve_once(F, zrd, zpe, zpc, yC + mu[:, None] * gradF)
        alpha_c = cent_search(s, yC, dsc, dyCc)
        use_cent = alpha_p < ns_barrier.ALPHA_STALL
        pick = lambda a, b_: torch.where(use_cent[:, None], a, b_)
        dx, dyE, dyC, ds = pick(dxc, dxp), pick(dyEc, dyEp), pick(dyCc, dyCp), pick(dsc, dsp)
        alpha = torch.where(use_cent, alpha_c, alpha_p)

        finite = torch.isfinite(alpha) & torch.isfinite(torch.cat([dx, dyE, dyC, ds], dim=-1)).all(-1)
        err = torch.maximum(pres, torch.maximum(dres, gaprel))
        stalled_now = (mu > 0.98 * mu_prev) & (err > 0.98 * err_prev)
        new_stall = torch.where(stalled_now, stall + 1, torch.zeros_like(stall))
        step = (finite & ~done_now)[:, None]
        upd = lambda v, dv: torch.where(step, v + alpha[:, None] * dv, v)
        new_done = done_now | ~finite | (new_stall >= 5)
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
    take = (torch.maximum(pres_f, torch.maximum(dres_f, gap_f)) <= err_best)[:, None]
    x, yE, yC, s = (torch.where(take, a, bb) for a, bb in ((x, xb), (yE, yEb), (yC, yCb), (s, sb_)))
    rd, rpE, rpC = residuals(x, yE, yC, s)
    pres, dres, gaprel = metrics(x, yE, yC, s, rd, rpE, rpC)
    conv = (pres < 10 * tol) & (dres < 10 * tol) & (gaprel < 10 * tol)
    sol = ConeSolution(x=x, y=torch.cat([yE, yC], dim=-1) @ R, s=torch.cat([c.new_zeros(B, p), s], dim=-1) @ R)
    info = ConicSolveInfo(iterations=it, primal_residual=pres, dual_residual=dres, gap=(s * yC).sum(-1), converged=conv)
    return sol, info


solve_batched.host_syncs = 0


def solve(cp: ConeProgram, **kw) -> Tuple[ConeSolution, ConicSolveInfo]:
    """:func:`solve_batched` for one instance (fields without a batch dimension) or a batch."""
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
    step_frac: float = 0.99,
    neighborhood: float = 0.9,
) -> Tuple[ConeSolution, ConicSolveInfo]:
    """Solve a ``(B, ...)`` batch with the fused single-kernel nonsymmetric IPM
    (``ops/cuda/ns_pdip.py``, one launch for all Newton iterations). By the reference's routing by shape,
    psd blocks, programs without an ns block or without equality rows (``p == 0``), Newton systems past
    the kernel's envelope (:func:`~diffopt_tpu_torch.ops.cuda.ns_pdip.in_envelope`, N <= 128) and batches
    that are not 2-D go to the staged solver (:func:`solve_batched`), with the caller's full tuning
    surface. ``converged`` is all three metrics below 10 tol."""
    if not supports(cp.cones):
        raise ValueError(f"conic_nsipm: unsupported cone kinds in {cp.cones!r}")
    cfg = get_config()
    dt, dev = cp.A.dtype, cp.A.device
    n = cp.num_vars
    R_np, p, l, soc_dims, psd_sides, ns_blocks = _row_transform(cp.cones, allow_ns=True)
    mC = l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides) + 3 * len(ns_blocks)
    if (
        psd_sides or not ns_blocks or mC == 0 or p == 0 or cp.c.ndim != 2
        or not ns_pdip.in_envelope(n, p, l, soc_dims, ns_blocks, cp.A.element_size())
    ):
        return solve_batched(cp, max_iters=max_iters, tol=tol, reg=reg, step_frac=step_frac, neighborhood=neighborhood)
    max_iters = cfg.nsipm_max_iters if max_iters is None else max_iters
    tol = _tol(tol, dt)
    reg = cfg.ipm_reg(dt) if reg is None else reg
    R = torch.as_tensor(R_np, dtype=dt, device=dev)
    A_int = torch.einsum("ij,bjk->bik", R, cp.A)
    b_int = cp.b @ R.T
    x, yE, yC, s, it, pres, dres, gaprel = ns_pdip.solve_tile_fused_ns(
        cp.c, b_int[:, :p], b_int[:, p:], A_int[:, :p], A_int[:, p:], (p, l, soc_dims, ns_blocks),
        max_iters=max_iters, tol=tol, reg=reg, eps=ns_barrier.margin_eps(dt), step_frac=step_frac,
        neighborhood=neighborhood,
    )
    y = torch.cat([yE, yC], dim=-1) @ R
    s_full = torch.cat([s.new_zeros(s.shape[0], p), s], dim=-1) @ R
    conv = (pres < 10 * tol) & (dres < 10 * tol) & (gaprel < 10 * tol)
    return (
        ConeSolution(x=x, y=y, s=s_full),
        ConicSolveInfo(iterations=it, primal_residual=pres, dual_residual=dres, gap=(s * yC).sum(-1), converged=conv),
    )
