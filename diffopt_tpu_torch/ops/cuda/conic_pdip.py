"""Fully fused batched symmetric-cone IPM: one CUDA kernel runs the whole
NT-scaled Mehrotra predictor-corrector loop of an instance, with the plain
PyTorch version beside it.

Replaces ``diffopt_tpu/ops/pallas/conic_pdip.py::solve_tile_fused`` (kernel
body ``_kernel``). Source: ``csrc/conic_pdip.cu``. Internal layout
``[zero(p) | nonneg(l) | soc(d_1)...soc(d_k) | psd(side_1)...]``; the caller
(``solvers/conic_ipm.py::solve_batched_fused``) applies the static orthogonal
row transform R (nonpos negation, rsoc rotation).

Design on the H100: one thread block per instance (the TPU kernel's 128
lanes become 128 blocks); ``AC``, ``AE``, ``c``, ``b``, the iterate, the
scaling and the LDL' factor of the Newton matrix live in shared memory for
all iterations. Per iteration the block assembles the quasi-definite matrix
K in ``[cone | x | eq]`` order straight into register tiles (its -W^2 block
computed entry by entry from the scaling, never stored), factors it with
``dense.cuh``'s register-tiled LDL' and keeps only L; the triangular
substitutions run on one warp with the right-hand side in registers, and the
refinement residual ``rhs - K sol`` is formed from the blocks of K. Each SOC
block's reductions are warp reductions; each psd block's Jacobi
eigendecompositions, square roots and small products run on one warp in
shared memory (the same sweep rule as :func:`~diffopt_tpu_torch.ops.smalleig.jacobi_eigh`).
An instance leaves its loop at its first freeze (converged, stalled,
``mu <= 0`` or a non-finite direction); a frozen lane of the TPU kernel keeps
its state, so the result is the same.

What bounds it on the H100: operations. An instance reads ``(p + mC)(n + 1)
+ n`` words once (the SOCP of BASELINE config 3, n = 16 and SOC(17): 1.2 KB
in f32) and then, per body, about ``N^3 / 3`` flops for the LDL', two
direction solves with their refinement residuals, and per psd block of side
d eight Jacobi eigendecompositions and some forty d x d products
(``chip_smoke.py::conic_pdip_flops`` counts it all). The critical path is
sequential — N elimination steps with a block barrier each, 2 N substitution
steps per solve on one warp, and the psd blocks' rotation chains — so the
design keeps every operand on chip and lets several blocks share an SM.

Envelope (:func:`in_envelope`): ``N = n + p + mC <= 128`` (the register
tiles of the LDL'), psd sides <= 12 (``smalleig.MAX_JACOBI_SIDE``), at most
:data:`MAX_SOC_BLOCKS` soc and :data:`MAX_PSD_BLOCKS` psd blocks, and a working
set that fits 227 KB of shared memory (:func:`smem_bytes`). It covers the
reference's envelope (N <= 128, psd side <= 6) in f32 and f64. Past it,
``solve_batched_fused`` sends the batch to the staged solver by shape.

Iteration counts: for an instance that meets the criterion both report the
first iteration at which it did; for one that does not, the TPU kernel
reports its 128-instance tile's loop count, this kernel the instance's own
(the count a tile holding only that instance would report).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import jordan
from ..smalleig import MAX_JACOBI_SIDE
from .chol import MAX_SMEM_BYTES, _SUFFIX, _odd, _require_cuda, ldl_batched_plain, ldl_solve_batched_plain

Tensor = torch.Tensor

MAX_N = 128  # rows of K that the register tiles of the LDL' hold
MAX_SOC_BLOCKS = 128  # kMaxSoc in csrc/conic_pdip.cu
MAX_PSD_BLOCKS = 64  # kMaxPsd
_SLOTS = 64  # kNumSlots
_COLBUF = 256  # kColbufWords of dense.cuh
_WARPS = 8
_STATIC_SMEM = 1024  # room for the kernel's static shared memory (its pointer table)


def smem_bytes(n: int, p: int, l: int, soc_dims, psd_sides, itemsize: int) -> int:
    """Dynamic shared memory of the kernel — mirrors ``conic_words`` in
    ``csrc/conic_pdip.cu`` (the wrapper checks the two against each other)."""
    mC = l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides)
    N = n + p + mC
    nb = (1 if l else 0) + len(soc_dims) + len(psd_sides)
    ints = 5 * nb + 2 * mC
    int_bytes = (ints * 4 + 15) // 16 * 16
    dmax = max(psd_sides, default=0)
    words = mC * n + p * n + n + p + mC
    words += 4 * n + 4 * p + 20 * mC + 4 * N + N * _odd(N) + _COLBUF + _SLOTS
    words += sum(5 * d * d + d for d in psd_sides) + _WARPS * (5 * dmax * dmax + dmax)
    return int_bytes + words * itemsize


def in_envelope(n: int, p: int, l: int, soc_dims, psd_sides, itemsize: int) -> bool:
    """Whether the fused kernel takes the layout."""
    mC = l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides)
    return (
        mC >= 1 and n >= 1 and n + p + mC <= MAX_N
        and max(psd_sides, default=0) <= MAX_JACOBI_SIDE
        and len(soc_dims) <= MAX_SOC_BLOCKS and len(psd_sides) <= MAX_PSD_BLOCKS
        and smem_bytes(n, p, l, soc_dims, psd_sides, itemsize) <= MAX_SMEM_BYTES - _STATIC_SMEM
    )


# --- plain version ----------------------------------------------------------


def solve_tile_fused_plain(
    c: Tensor, bE: Tensor, bC: Tensor, AE: Tensor, AC: Tensor,
    layout: Tuple[int, int, Tuple[int, ...], Tuple[int, ...]],
    *,
    max_iters: int = 50,
    tol: float = 5e-6,
    reg: float = 1e-7,
    eps: float = 1e-7,
):
    """Plain PyTorch version of the fused kernel: the same algorithm and
    constants on ``(B, ...)`` tensors (the cone algebra of ``ops/jordan.py``,
    the plain LDL' pair of ``ops/cuda/chol.py``), per-instance freeze by
    ``torch.where`` (never ``alpha = 0``), and a loop that stops once every
    instance is frozen. Same signature and outputs as
    :func:`solve_tile_fused`."""
    p, l, soc_dims, psd_sides = layout
    B, n = c.shape
    mC = bC.shape[-1]
    dt, dev = c.dtype, c.device
    cones = (l, soc_dims, psd_sides)
    nu_deg = max(l + len(soc_dims) + sum(psd_sides), 1)
    e = jordan.identity_elem(*cones, dt, dev).expand(B, mC)
    W = lambda sc, u: jordan.w_apply(*cones, sc, u, False)
    Winv = lambda sc, u: jordan.w_apply(*cones, sc, u, True)
    residuals = lambda x, yE, yC, s: jordan.residuals(c, AE, bE, AC, bC, x, yE, yC, s)
    metrics = lambda x, yE, yC, s, r: jordan.metrics(c, bE, bC, x, yE, yC, s, *r)

    eye_n = reg * torch.eye(n, dtype=dt, device=dev).expand(B, n, n)
    eye_p = -reg * torch.eye(p, dtype=dt, device=dev).expand(B, p, p)
    zCp = torch.zeros(B, mC, p, dtype=dt, device=dev)

    def factor(sc):
        # [cone | x | eq]: the unpivoted LDL' eliminates the O(1) -W^2 block first
        K = torch.cat([
            torch.cat([-jordan.w2_dense(*cones, sc), AC, zCp], dim=2),
            torch.cat([AC.transpose(1, 2), eye_n, AE.transpose(1, 2)], dim=2),
            torch.cat([zCp.transpose(1, 2), AE, eye_p], dim=2),
        ], dim=1)
        L, dv = ldl_batched_plain(K)
        return L, dv, K

    passes = 2 if psd_sides else 1

    def solve_dir(F, sc, rd, rpE, rpC, g):
        L, dv, K = F
        rhs = torch.cat([-rpC + W(sc, g), -rd, -rpE], dim=-1)
        sol = ldl_solve_batched_plain(L, dv, rhs)
        for _ in range(passes):  # refinement against the assembled K
            resid = rhs - torch.einsum("bij,bj->bi", K, sol)
            sol = sol + ldl_solve_batched_plain(L, dv, resid)
        dyC, dx, dyE = sol[:, :mC], sol[:, mC:mC + n], sol[:, mC + n:]
        return dx, dyE, dyC, -W(sc, g + W(sc, dyC))

    # ---- init: identity scaling, one solve from the zero iterate, then a per-block shift into the interior
    sc0 = jordan.nt_scaling(*cones, e, e, eps)
    zx, zE, zC = c.new_zeros(B, n), c.new_zeros(B, p), c.new_zeros(B, mC)
    x, yE, _, _ = solve_dir(factor(sc0), sc0, *residuals(zx, zE, zC, zC), -e)
    s = jordan.shift_into_interior(*cones, bC - torch.einsum("bij,bj->bi", AC, x), e)
    yC = e.clone()

    huge = torch.full((B,), 1e30, dtype=dt, device=dev)
    xb, yEb, yCb, sb_, errb = x, yE, yC, s, huge
    mu_prev, err_prev = huge, huge
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    itdone = torch.full((B,), -1, dtype=torch.int32, device=dev)
    own = torch.full((B,), max_iters, dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
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

        sc = jordan.nt_scaling(*cones, s, yC, eps)
        F = factor(sc)
        lam = Winv(sc, s)
        peigs = jordan.lam_psd_eigs(*cones, lam)
        isqs = jordan.lam_psd_isqrts(peigs, eps)

        # predictor: g = lam
        _, _, dyCa, dsa = solve_dir(F, sc, *r, lam)
        dsa_s, dya_s = Winv(sc, dsa), W(sc, dyCa)
        a_p, a_d = jordan.max_step_pair(*cones, lam, dsa_s, dya_s, isqs)
        mu_aff = ((s + a_p[:, None] * dsa) * (yC + a_d[:, None] * dyCa)).sum(-1) / nu_deg
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)
        # corrector with the Mehrotra second-order term in the scaled variables
        comp = jordan.jmul(*cones, lam, lam) + jordan.jmul(*cones, dsa_s, dya_s) - (sigma * mu)[:, None] * e
        g = jordan.jsolve(*cones, lam, comp, eps, peigs)
        dx, dyE, dyC, ds = solve_dir(F, sc, *r, g)
        alpha = torch.clamp(0.99 * torch.minimum(*jordan.max_step_pair(*cones, lam, Winv(sc, ds), W(sc, dyC), isqs)),
                            max=1.0)

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

    # score the exit state once (it never got a best-update inside the loop)
    pres, dres, gaprel = metrics(x, yE, yC, s, residuals(x, yE, yC, s))
    err = torch.maximum(torch.maximum(pres, dres), gaprel)
    fin = torch.isfinite(x).all(-1) & torch.isfinite(yC).all(-1)
    last = ((err < errb) & fin)[:, None]
    x, yE, yC, s = (torch.where(last, a, b_) for a, b_ in ((x, xb), (yE, yEb), (yC, yCb), (s, sb_)))
    # the metrics OF THE RETURNED STATE, split into primal / dual
    pres, dres, _ = metrics(x, yE, yC, s, residuals(x, yE, yC, s))
    its = torch.where(itdone >= 0, itdone, own)
    return x, yE, yC, s, its, pres, dres


# --- wrapper ----------------------------------------------------------------


def _lib():
    from . import _build

    lib = _build.load("conic_pdip")
    if not getattr(lib, "_conic_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"conic_pdip_{sfx}")
            # c, bE, bC, AE, AC, x, yE, yC, s, it, pres, dres; B, n, p, l, nsoc, soc_dims, npsd,
            # psd_sides; iters, tol, reg, eps; stream
            f.argtypes = [vp] * 12 + [ci] * 5 + [vp, ci, vp, ci, cd, cd, cd, vp]
            f.restype = ci
        lib.conic_pdip_smem_bytes.argtypes = [ci, ci, ci, ci, vp, ci, vp, ci]
        lib.conic_pdip_smem_bytes.restype = ctypes.c_longlong
        lib._conic_bound = True
    return lib


def solve_tile_fused(
    c: Tensor, bE: Tensor, bC: Tensor, AE: Tensor, AC: Tensor,
    layout: Tuple[int, int, Tuple[int, ...], Tuple[int, ...]],
    *,
    max_iters: int = 50,
    tol: float = 5e-6,
    reg: float = 1e-7,
    eps: float = 1e-7,
):
    """Run the fused IPM on internally-laid-out, batch-first data: ``c (B,
    n)``, ``bE (B, p)``, ``bC (B, mC)``, ``AE (B, p, n)``, ``AC (B, mC, n)``,
    ``layout = (p, l, soc_dims, psd_sides)``. Returns ``(x, yE, yC, s,
    iterations (int32), pres, dres)``, batch-first; ``pres`` / ``dres`` are the
    scale-relative residuals of the returned state.

    CUDA tensors go to the kernel (a layout outside :func:`in_envelope`, a
    failed build or a failed launch raises); CPU tensors to the plain
    version."""
    p, l, soc_dims, psd_sides = layout
    soc_dims, psd_sides = tuple(int(d) for d in soc_dims), tuple(int(d) for d in psd_sides)
    B, n = c.shape
    mC = bC.shape[-1]
    if AC.shape != (B, mC, n) or AE.shape != (B, p, n) or bE.shape != (B, p):
        raise ValueError("solve_tile_fused: inconsistent shapes")
    if mC != l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides):
        raise ValueError(f"solve_tile_fused: layout {layout} does not span the {mC} cone rows")
    if c.device.type == "cpu":
        return solve_tile_fused_plain(
            c, bE, bC, AE, AC, (p, l, soc_dims, psd_sides), max_iters=max_iters, tol=tol, reg=reg, eps=eps
        )
    _require_cuda(c, "solve_tile_fused")
    dt = c.dtype
    for t in (bE, bC, AE, AC):
        if t.device != c.device or t.dtype != dt:
            raise ValueError("solve_tile_fused: all inputs must share device and dtype")
    itemsize = c.element_size()
    if not in_envelope(n, p, l, soc_dims, psd_sides, itemsize):
        raise NotImplementedError(
            f"solve_tile_fused: layout n={n}, p={p}, l={l}, soc {soc_dims}, psd {psd_sides} is past the "
            "kernel's envelope (N <= 128, psd side <= 12, 227 KB of shared memory); "
            "solvers/conic_ipm.py::solve_batched_fused routes such batches to the staged solver"
        )
    c, bE, bC, AE, AC = (t.detach().contiguous() for t in (c, bE, bC, AE, AC))
    x = c.new_empty(B, n)
    yE = c.new_empty(B, p)
    yC = c.new_empty(B, mC)
    s = c.new_empty(B, mC)
    its = torch.empty(B, dtype=torch.int32, device=c.device)
    pres = c.new_empty(B)
    dres = c.new_empty(B)
    if B > 0:
        lib = _lib()
        socs = ctypes.cast((ctypes.c_int * max(len(soc_dims), 1))(*soc_dims), ctypes.c_void_p)
        psds = ctypes.cast((ctypes.c_int * max(len(psd_sides), 1))(*psd_sides), ctypes.c_void_p)
        want = smem_bytes(n, p, l, soc_dims, psd_sides, itemsize)
        if lib.conic_pdip_smem_bytes(n, p, l, len(soc_dims), socs, len(psd_sides), psds, itemsize) != want:
            raise RuntimeError("solve_tile_fused: shared-memory layout of wrapper and kernel differ")
        fn = getattr(lib, f"conic_pdip_{_SUFFIX[dt]}")
        with torch.cuda.device(c.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(
                c.data_ptr(), bE.data_ptr(), bC.data_ptr(), AE.data_ptr(), AC.data_ptr(),
                x.data_ptr(), yE.data_ptr(), yC.data_ptr(), s.data_ptr(), its.data_ptr(),
                pres.data_ptr(), dres.data_ptr(), B, n, p, l, len(soc_dims), socs, len(psd_sides), psds,
                int(max_iters), float(tol), float(reg), float(eps), stream,
            )
        from . import _build

        _build.check(lib, code, "solve_tile_fused")
        solve_tile_fused.launches += 1
    return x, yE, yC, s, its, pres, dres


solve_tile_fused.launches = 0
