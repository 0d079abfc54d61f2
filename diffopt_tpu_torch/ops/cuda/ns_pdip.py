"""Fully fused batched nonsymmetric-cone IPM: one CUDA kernel runs the whole
dual-scaling Mehrotra predictor-corrector loop of an instance, with the plain
PyTorch version beside it.

Replaces ``diffopt_tpu/ops/pallas/ns_pdip.py::solve_tile_fused_ns`` (kernel
body ``_kernel``). Source: ``csrc/ns_pdip.cu``. Internal layout
``[zero(p) | nonneg(l) | soc(d_1)... | ns...]`` with ns blocks of kind exp,
dual_exp, pow(alpha) or dual_pow(alpha); the caller
(``solvers/conic_nsipm.py::solve_batched_fused``) applies the static
orthogonal row transform R.

The method (Skajaa-Ye flavoured): the dual-scaling Hessian ``Hbar = mu
hess F(s)`` of the primal barrier takes the place of W^-2 in the
quasi-definite ``[cone | x | eq]`` Newton matrix, whose cone block is
``-Hbar^-1`` (diagonal per nonneg row, ``s s' - (det/2) J`` per soc block, a
floored-eigh 3x3 inverse per ns block); each body factors it once and solves
four times — the affine probe, the predictor and its refinement residual
against the unsquared block system, and the centering direction — and picks
its steps on static grids: the affine probe over 9 candidates (feasibility
only), the predictor over 18 (feasibility and the proximity neighbourhood
``prox^2 <= (0.9 mu)^2``), the centering over 7 (the least ``prox^2 / mu^2``),
the last taken where the predictor's step falls below 0.05.

Design on the H100: one instance per *team* of 1, 2 or 8 warps, one team per
thread block, many teams resident on each SM, as K6 (``csrc/conic_pdip.cu``):
the data, the iterate and the LDL' factor live in shared memory for all
iterations, held as ``SPtr`` indices (every access an LDS / STS); K is
assembled entry by entry into ``dense.cuh``'s register tiles on the team's
thread grid (its ``-Hbar^-1`` blocks computed from the stored per-block data,
never stored whole), the substitutions run on one warp with the right-hand
side in registers. Each 3x3 Hessian, its Jacobi eigendecomposition and
floored inverse run on one thread per ns block. The line-search candidates
are independent: one thread evaluates one candidate over the whole cone (its
point ``s + a ds``, ``y + a dy`` computed as it is read), the candidates of a
search side by side on the lanes of one warp, and the choice is made in grid
order, so it is the reference's whatever the order of evaluation. Which team
a layout gets is the launch rule, :func:`team_for`, written once in the
source and mirrored here: the smallest team whose register tiles hold N (one
warp to 40 rows, two to 64, eight to 128); every team does the same
operations in the same order, so they give the same bits. An instance leaves
its loop at its first freeze (converged, stalled, ``mu <= 0`` or a
non-finite direction); a frozen lane of the TPU kernel keeps its state, so
the result is the same.

What bounds it on the H100: operations. An instance reads ``(p + mC)(n + 1) +
n`` words once (the entropy family, n = 6, p = 1, mC = 9: 284 bytes in f32)
and then, per body, does the LDL' of N = n + p + mC, four direction solves,
three 3x3 Jacobi eigendecompositions per ns block and 34 candidate
evaluations (``chip_smoke.py::ns_pdip_flops`` counts it all). The critical
path is sequential, so everything stays on chip.

Envelope (:func:`in_envelope`): ``N = n + p + mC <= 128`` (the register tiles
of the LDL'), at most :data:`MAX_SOC_BLOCKS` soc and :data:`MAX_NS_BLOCKS` ns
blocks, and a working set that fits 227 KB of shared memory
(:func:`smem_bytes`) for the team that takes it. Equality-free programs (``p == 0``) are inside it; the
reference's rule that sends them to the staged solver is a routing rule of
``conic_nsipm.solve_batched_fused``, kept there.

Iteration counts: as K6's — for an instance that meets the criterion the
first body at which it did, for one that does not its own count of bodies
(the TPU kernel reports its 128-instance tile's).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import jordan, ns_barrier
from .chol import MAX_SMEM_BYTES, _SUFFIX, _odd, _require_cuda, ldl_batched_plain, ldl_solve_batched_plain, tile_max_n

Tensor = torch.Tensor

MAX_N = 128  # rows of K that the register tiles of the LDL' hold
MAX_SOC_BLOCKS = 128  # kMaxSoc in csrc/ns_pdip.cu
MAX_NS_BLOCKS = 42  # kMaxNs
TEAMS = (1, 2, 8)  # warps per instance the kernel is built for (kTeams)
_SLOTS = 64  # kNsSlots
_KIND_CODE = {"exp": 0, "dual_exp": 1, "pow": 2, "dual_pow": 3}
_STATIC_SMEM = 1024  # kNsStatic: room for the kernel's static shared memory (its table of indices)
MU_FLOOR = 1e-30  # the kernel's floor of mu in the sigma heuristic and the centering value


def smem_bytes(n: int, p: int, l: int, soc_dims, ns_blocks, itemsize: int, team: int = 8) -> int:
    """Dynamic shared memory of the kernel for a team of ``team`` warps — mirrors ``ns_smem_bytes`` in
    ``csrc/ns_pdip.cu`` (the wrapper checks the two against each other): the instance's working set and
    the team's pivot column (``2 tile_max_n(team)`` words)."""
    nns = len(ns_blocks)
    mC = l + sum(soc_dims) + 3 * nns
    N = n + p + mC
    nb = (1 if l else 0) + len(soc_dims) + nns
    # the ints (per cone block four, per cone row two, per ns block its kind), then the exponents
    int_bytes = ((4 * nb + 2 * mC + nns) * 4 + 15) // 16 * 16 + (nns * 8 + 15) // 16 * 16
    words = mC * n + p * n + n + p + mC + 7 * n + 7 * p + 17 * mC + 3 * N + N * _odd(N)
    words += len(soc_dims) + 18 * nns + 2 * tile_max_n(team) + _SLOTS
    return int_bytes + words * itemsize


def team_takes(n: int, p: int, l: int, soc_dims, ns_blocks, itemsize: int, team: int) -> bool:
    """Whether a team of ``team`` warps takes the layout (``ns_team_takes``): K's rows in its register
    tiles, its working set in one block's shared memory."""
    mC = l + sum(soc_dims) + 3 * len(ns_blocks)
    return (
        team in TEAMS and n + p + mC <= tile_max_n(team)
        and smem_bytes(n, p, l, soc_dims, ns_blocks, itemsize, team) <= MAX_SMEM_BYTES - _STATIC_SMEM
    )


def team_for(n: int, p: int, l: int, soc_dims, ns_blocks, itemsize: int) -> int:
    """The launch rule (``ns_team`` in ``csrc/ns_pdip.cu``): the smallest team that takes the layout; 0
    where none does."""
    return next((t for t in TEAMS if team_takes(n, p, l, soc_dims, ns_blocks, itemsize, t)), 0)


def in_envelope(n: int, p: int, l: int, soc_dims, ns_blocks, itemsize: int) -> bool:
    """Whether the fused kernel takes the layout (with the team the launch rule picks)."""
    mC = l + sum(soc_dims) + 3 * len(ns_blocks)
    return (
        mC >= 1 and n >= 1 and n + p + mC <= MAX_N
        and len(soc_dims) <= MAX_SOC_BLOCKS and len(ns_blocks) <= MAX_NS_BLOCKS
        and team_for(n, p, l, soc_dims, ns_blocks, itemsize) > 0
    )


# --- plain version ----------------------------------------------------------


def solve_tile_fused_ns_plain(
    c: Tensor, bE: Tensor, bC: Tensor, AE: Tensor, AC: Tensor,
    layout: Tuple[int, int, Tuple[int, ...], Tuple[Tuple[str, object], ...]],
    *,
    max_iters: int = 100,
    tol: float = 5e-6,
    reg: float = 1e-7,
    eps: float = 1e-7,
    step_frac: float = 0.99,
    neighborhood: float = 0.9,
):
    """Plain PyTorch version of the fused kernel: a batch-first transcription of the TPU kernel's body
    on top of ``ops/ns_barrier.py`` (its margin floor ``eps`` also floors the soc determinants, mu is
    floored at 1e-30, one refinement pass for the predictor and none for the probe and the centering
    direction, the Hessian inverses by floored eigh with ``eps_w`` 1e-14 in f64 and 1e-6 in f32),
    per-instance freeze by ``torch.where`` (never ``alpha = 0``), and a loop that stops once every
    instance is frozen. Same signature and outputs as :func:`solve_tile_fused_ns`."""
    p, l, soc_dims, ns_blocks = layout
    B, n = c.shape
    mC = bC.shape[-1]
    dt, dev = c.dtype, c.device
    lay = ns_barrier.Layout(l, tuple(soc_dims), (), tuple(ns_blocks))
    nu_deg = max(l + 2 * len(soc_dims) + 3 * len(ns_blocks), 1)
    eps_w = ns_barrier.hess_floor(dt)
    grid_p = torch.tensor(ns_barrier.pred_grid(step_frac), dtype=dt, device=dev)
    grid_c = torch.tensor(ns_barrier.CENT_GRID, dtype=dt, device=dev)
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    residuals = lambda x, yE, yC, s: jordan.residuals(c, AE, bE, AC, bC, x, yE, yC, s)
    metrics = lambda x, yE, yC, s, r: jordan.metrics(c, bE, bC, x, yE, yC, s, *r)
    grad_barrier = lambda s: ns_barrier.grad_barrier(lay, s, eps, eps)
    feasible = lambda sn, yn: ns_barrier.feasible(lay, sn, yn)
    prox_sq = lambda s, y, mu: ns_barrier.prox_sq(lay, s, y, mu, eps, eps, MU_FLOOR)

    eye_n = reg * torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
    eye_p = -reg * torch.eye(p, dtype=dt, device=dev).expand(B, p, p)
    zCp = torch.zeros(B, mC, p, dtype=dt, device=dev)

    def factor(Hbar, Hinv):
        K = torch.cat([
            torch.cat([-Hinv, AC, zCp], dim=2),
            torch.cat([AC.transpose(1, 2), eye_n, AE.transpose(1, 2)], dim=2),
            torch.cat([zCp.transpose(1, 2), AE, eye_p], dim=2),
        ], dim=1)
        L, dv = ldl_batched_plain(K)
        return L, dv, Hbar, Hinv

    def solve_once(F, rd, rpE, rpC, g):
        L, dv, _, Hinv = F
        sol = ldl_solve_batched_plain(L, dv, torch.cat([-rpC + mv(Hinv, g), -rd, -rpE], dim=-1))
        dyC, dx, dyE = sol[:, :mC], sol[:, mC:mC + n], sol[:, mC + n:]
        return dx, dyE, dyC, -mv(Hinv, g + dyC)

    def solve_dir(F, rd, rpE, rpC, g):
        """One refinement pass against the unsquared block system (dyC + Hbar ds = -g)."""
        dx, dyE, dyC, ds = solve_once(F, rd, rpE, rpC, g)
        r1 = -rd - (rmv(AC, dyC) + rmv(AE, dyE))
        r2 = -rpE - mv(AE, dx)
        r3 = -rpC - (mv(AC, dx) + ds)
        r4 = -g - (dyC + mv(F[2], ds))
        c1, c2, c3, c4 = solve_once(F, -r1, -r2, -r3, -r4)
        return dx + c1, dyE + c2, dyC + c3, ds + c4

    def candidates(s0, y0, ds, dy, grid):
        a = grid[None, :, None]
        sn, yn = s0[:, None, :] + a * ds[:, None, :], y0[:, None, :] + a * dy[:, None, :]
        return sn, yn, (sn * yn).sum(-1) / nu_deg

    def pred_search(s0, y0, ds, dy, grid, with_prox):
        """The largest grid step whose candidate is feasible (and, with_prox, inside the neighbourhood)."""
        sn, yn, mu_n = candidates(s0, y0, ds, dy, grid)
        good = feasible(sn, yn)
        if with_prox:
            good = good & (mu_n > 0) & (prox_sq(sn, yn, mu_n) <= (neighborhood * mu_n) ** 2)
        return torch.where(good, grid, torch.zeros_like(grid)).amax(-1)

    def cent_search(s0, y0, ds, dy):
        """The grid step of least prox^2 / mu^2 among the feasible candidates, ties to the earliest; 0
        when none is."""
        sn, yn, mu_n = candidates(s0, y0, ds, dy, grid_c)
        good = feasible(sn, yn) & (mu_n > 0)
        rel = prox_sq(sn, yn, mu_n) / torch.clamp(mu_n**2, min=MU_FLOOR)
        val = torch.where(good, rel, torch.full_like(rel, float("inf")))
        best_a, best_v = torch.zeros_like(val[:, 0]), torch.full_like(val[:, 0], float("inf"))
        for k in range(len(ns_barrier.CENT_GRID)):
            better = val[:, k] < best_v
            best_a = torch.where(better, grid_c[k], best_a)
            best_v = torch.where(better, val[:, k], best_v)
        return best_a

    # ---- init: central s0, yC = -grad F(s0) (mu0 = 1), x = 0
    s = ns_barrier.init_point(lay, dt, dev).expand(B, mC).clone()
    yC = -grad_barrier(s)
    x, yE = c.new_zeros(B, n), c.new_zeros(B, p)

    huge = torch.full((B,), 1e30, dtype=dt, device=dev)
    xb, yEb, yCb, sb_, errb = x, yE, yC, s, huge
    mu_prev, err_prev = huge, huge
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    itdone = torch.full((B,), -1, dtype=torch.int32, device=dev)
    own = torch.full((B,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    zrd, zpe, zpc = c.new_zeros(B, n), c.new_zeros(B, p), c.new_zeros(B, mC)
    for it in range(max_iters):
        r = residuals(x, yE, yC, s)
        mu = (s * yC).sum(-1) / nu_deg
        pres, dres, gaprel = metrics(x, yE, yC, s, r)
        done = (pres < tol) & (dres < tol) & (gaprel < tol)
        err = torch.maximum(torch.maximum(pres, dres), gaprel)
        better = (err < errb) & active
        sel = lambda new, old: torch.where(better[:, None], new, old)
        xb, yEb, yCb, sb_ = sel(x, xb), sel(yE, yEb), sel(yC, yCb), sel(s, sb_)
        errb = torch.where(better, err, errb)
        stalled_now = (mu > 0.98 * mu_prev) & (err > 0.98 * err_prev)
        stall = torch.where(stalled_now, stall + 1, torch.zeros_like(stall))
        stalled = stall >= 5

        gradF = grad_barrier(s)
        F = factor(*ns_barrier.hbar_pair(lay, s, mu, eps, eps, eps_w))

        # Mehrotra affine probe: no refinement, every second grid point, feasibility only
        _, _, dyCa, dsa = solve_once(F, *r, yC)
        a_aff = pred_search(s, yC, dsa, dyCa, grid_p[::2], with_prox=False)[:, None]
        mu_aff = ((s + a_aff * dsa) * (yC + a_aff * dyCa)).sum(-1) / nu_deg
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=MU_FLOOR)) ** 3, 0.0, 1.0)
        dxp, dyEp, dyCp, dsp = solve_dir(F, *r, yC + (sigma * mu)[:, None] * gradF)
        alpha_p = pred_search(s, yC, dsp, dyCp, grid_p, with_prox=True)

        # pure centering (zero residual right-hand side, no refinement) where the predictor stalls
        dxc, dyEc, dyCc, dsc = solve_once(F, zrd, zpe, zpc, yC + mu[:, None] * gradF)
        alpha_c = cent_search(s, yC, dsc, dyCc)
        use_cent = alpha_p < ns_barrier.ALPHA_STALL
        pick = lambda a, b_: torch.where(use_cent[:, None], a, b_)
        dx, dyE, dyC, ds = pick(dxc, dxp), pick(dyEc, dyEp), pick(dyCc, dyCp), pick(dsc, dsp)
        alpha = torch.where(use_cent, alpha_c, alpha_p)

        finite = (
            torch.isfinite(dx).all(-1) & torch.isfinite(dyC).all(-1) & torch.isfinite(ds).all(-1)
            & torch.isfinite(alpha) & torch.isfinite(dyE).all(-1)
        )
        dead = mu <= 0.0
        frozen = done | stalled | dead | ~finite
        itdone = torch.where(active & done, torch.full_like(itdone, it), itdone)
        own = torch.where(active & frozen, torch.full_like(own, it + 1), own)
        step = (active & ~frozen)[:, None]
        alpha = torch.clamp(torch.where(torch.isfinite(alpha), alpha, torch.zeros_like(alpha)), min=0.0)[:, None]
        upd = lambda v, dv: torch.where(step, v + alpha * dv, v)
        x, yE, yC, s = upd(x, dx), upd(yE, dyE), upd(yC, dyC), upd(s, ds)
        mu_prev, err_prev = mu, err
        active = active & ~frozen
        if not bool(active.any()):
            break

    # score the exit state once; return the best finite iterate and its metrics
    pres, dres, gaprel = metrics(x, yE, yC, s, residuals(x, yE, yC, s))
    err = torch.maximum(torch.maximum(pres, dres), gaprel)
    fin = torch.isfinite(x).all(-1) & torch.isfinite(yC).all(-1)
    last = ((err < errb) & fin)[:, None]
    x, yE, yC, s = (torch.where(last, a, b_) for a, b_ in ((x, xb), (yE, yEb), (yC, yCb), (s, sb_)))
    pres, dres, gaprel = metrics(x, yE, yC, s, residuals(x, yE, yC, s))
    its = torch.where(itdone >= 0, itdone, own)
    return x, yE, yC, s, its, pres, dres, gaprel


# --- wrapper ----------------------------------------------------------------


def _lib():
    from . import _build

    lib = _build.load("ns_pdip")
    if not getattr(lib, "_ns_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"ns_pdip_{sfx}")
            # c, bE, bC, AE, AC, x, yE, yC, s, it, pres, dres, gap; B, n, p, l, nsoc, soc_dims, nns,
            # ns_kinds, ns_alphas, ns_central, predictor grid; iters, tol, reg, eps, neighborhood; team; stream
            f.argtypes = [vp] * 13 + [ci] * 5 + [vp, ci, vp, vp, vp, vp, ci] + [cd] * 4 + [ci, vp]
            f.restype = ci
        lib.ns_pdip_smem_bytes.argtypes = [ci, ci, ci, ci, vp, ci, ci, ci]
        lib.ns_pdip_smem_bytes.restype = ctypes.c_longlong
        lib.ns_pdip_team.argtypes = [ci, ci, ci, ci, vp, ci, ci]
        lib.ns_pdip_team.restype = ci
        lib.ns_pdip_blocks_per_sm.argtypes = [ci, ci, ci, ci, vp, ci, ci, ci]
        lib.ns_pdip_blocks_per_sm.restype = ci
        lib._ns_bound = True
    return lib


def solve_tile_fused_ns(
    c: Tensor, bE: Tensor, bC: Tensor, AE: Tensor, AC: Tensor,
    layout: Tuple[int, int, Tuple[int, ...], Tuple[Tuple[str, object], ...]],
    *,
    max_iters: int = 100,
    tol: float = 5e-6,
    reg: float = 1e-7,
    eps: float = 1e-7,
    step_frac: float = 0.99,
    neighborhood: float = 0.9,
    team: int | None = None,
):
    """Run the fused nonsymmetric-cone IPM on internally-laid-out, batch-first data: ``c (B, n)``,
    ``bE (B, p)``, ``bC (B, mC)``, ``AE (B, p, n)``, ``AC (B, mC, n)``, ``layout = (p, l, soc_dims,
    ns_blocks)`` with ``ns_blocks`` a tuple of ``(kind, alpha)``. Returns ``(x, yE, yC, s, iterations
    (int32), pres, dres, gaprel)``, batch-first, the metrics of the returned state.

    CUDA tensors go to the kernel with ``team`` warps per instance (None: the launch rule's
    :func:`team_for`); a layout outside :func:`in_envelope`, a team that does not take it, a failed
    build or a failed launch raises — another team is never tried. CPU tensors go to the plain version,
    which has no teams."""
    p, l, soc_dims, ns_blocks = layout
    soc_dims = tuple(int(d) for d in soc_dims)
    ns_blocks = tuple((str(k), None if a is None else float(a)) for k, a in ns_blocks)
    B, n = c.shape
    mC = bC.shape[-1]
    if AC.shape != (B, mC, n) or AE.shape != (B, p, n) or bE.shape != (B, p):
        raise ValueError("solve_tile_fused_ns: inconsistent shapes")
    if mC != l + sum(soc_dims) + 3 * len(ns_blocks) or any(k not in _KIND_CODE for k, _ in ns_blocks):
        raise ValueError(f"solve_tile_fused_ns: layout {layout} does not span the {mC} cone rows")
    kw = dict(max_iters=max_iters, tol=tol, reg=reg, eps=eps, step_frac=step_frac, neighborhood=neighborhood)
    if c.device.type == "cpu":
        return solve_tile_fused_ns_plain(c, bE, bC, AE, AC, (p, l, soc_dims, ns_blocks), **kw)
    _require_cuda(c, "solve_tile_fused_ns")
    dt = c.dtype
    for t in (bE, bC, AE, AC):
        if t.device != c.device or t.dtype != dt:
            raise ValueError("solve_tile_fused_ns: all inputs must share device and dtype")
    itemsize = c.element_size()
    if not in_envelope(n, p, l, soc_dims, ns_blocks, itemsize):
        raise NotImplementedError(
            f"solve_tile_fused_ns: layout n={n}, p={p}, l={l}, soc {soc_dims}, ns {ns_blocks} is past the "
            "kernel's envelope (N <= 128, 227 KB of shared memory); "
            "solvers/conic_nsipm.py::solve_batched_fused routes such batches to the staged solver"
        )
    if team is None:
        team = team_for(n, p, l, soc_dims, ns_blocks, itemsize)
    elif not team_takes(n, p, l, soc_dims, ns_blocks, itemsize, team):
        raise ValueError(
            f"solve_tile_fused_ns: a team of {team} warps does not take layout n={n}, p={p}, l={l}, soc"
            f" {soc_dims}, ns {ns_blocks} (N <= {tile_max_n(team) if team in TEAMS else '-'} and 227 KB of"
            f" shared memory; teams {TEAMS})"
        )
    c, bE, bC, AE, AC = (t.detach().contiguous() for t in (c, bE, bC, AE, AC))
    x, yE, yC, s = c.new_empty(B, n), c.new_empty(B, p), c.new_empty(B, mC), c.new_empty(B, mC)
    its = torch.empty(B, dtype=torch.int32, device=c.device)
    pres, dres, gap = c.new_empty(B), c.new_empty(B), c.new_empty(B)
    if B > 0:
        lib = _lib()
        nns = len(ns_blocks)
        keep = (  # host arrays that must outlive the call
            (ctypes.c_int * max(len(soc_dims), 1))(*soc_dims),
            (ctypes.c_int * max(nns, 1))(*(_KIND_CODE[k] for k, _ in ns_blocks)),
            (ctypes.c_double * max(nns, 1))(*(0.0 if a is None else a for _, a in ns_blocks)),
            (ctypes.c_double * max(3 * nns, 1))(
                *np.concatenate([ns_barrier.central(k, a) for k, a in ns_blocks] or [np.zeros(0)]).tolist()),
            (ctypes.c_double * 18)(*ns_barrier.pred_grid(step_frac)),
        )
        socs, kinds, alphas, central, pred = (ctypes.cast(a, ctypes.c_void_p) for a in keep)
        want = smem_bytes(n, p, l, soc_dims, ns_blocks, itemsize, team)
        if lib.ns_pdip_smem_bytes(n, p, l, len(soc_dims), socs, nns, itemsize, team) != want:
            raise RuntimeError("solve_tile_fused_ns: shared-memory layout of wrapper and kernel differ")
        if lib.ns_pdip_team(n, p, l, len(soc_dims), socs, nns, itemsize) != team_for(n, p, l, soc_dims, ns_blocks,
                                                                                   itemsize):
            raise RuntimeError("solve_tile_fused_ns: launch rule of wrapper and kernel differ")
        fn = getattr(lib, f"ns_pdip_{_SUFFIX[dt]}")
        with torch.cuda.device(c.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(
                c.data_ptr(), bE.data_ptr(), bC.data_ptr(), AE.data_ptr(), AC.data_ptr(),
                x.data_ptr(), yE.data_ptr(), yC.data_ptr(), s.data_ptr(), its.data_ptr(),
                pres.data_ptr(), dres.data_ptr(), gap.data_ptr(), B, n, p, l, len(soc_dims), socs, nns,
                kinds, alphas, central, pred, int(max_iters), float(tol), float(reg), float(eps),
                float(neighborhood), int(team), stream,
            )
        from . import _build

        _build.check(lib, code, f"solve_tile_fused_ns (team of {team} warps)")
        solve_tile_fused_ns.launches += 1
    return x, yE, yC, s, its, pres, dres, gap


solve_tile_fused_ns.launches = 0


def blocks_per_sm(n: int, p: int, l: int, soc_dims, ns_blocks, dtype, team: int) -> int:
    """Instances (teams of ``team`` warps) resident on one SM of the current card for the layout, as the
    CUDA occupancy calculator counts them with the built kernel's registers and shared memory. Needs the
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("ns_pdip.blocks_per_sm: no CUDA device")
    soc_dims = tuple(int(d) for d in soc_dims)
    itemsize = torch.empty((), dtype=dtype).element_size()
    socs = ctypes.cast((ctypes.c_int * max(len(soc_dims), 1))(*soc_dims), ctypes.c_void_p)
    got = _lib().ns_pdip_blocks_per_sm(n, p, l, len(soc_dims), socs, len(ns_blocks), itemsize, team)
    if got < 0:
        raise RuntimeError(f"ns_pdip.blocks_per_sm: CUDA error {-got} for a team of {team} warps")
    return got
