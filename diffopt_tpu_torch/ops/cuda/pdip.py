"""Fully fused batched PDIP QP solver: one CUDA kernel runs the whole
Mehrotra predictor-corrector loop of an instance, with the plain PyTorch
version beside it.

Replaces ``diffopt_tpu/ops/pallas/pdip.py::solve_batched_fused`` (kernel body
``_pdip_kernel``). Source: ``csrc/pdip.cu`` (one thread block per instance; H,
its Cholesky factor L, W = L^-1 A', the Schur complement and the iterate live
in shared memory, Q, G, A too where they fit).

What bounds it on the H100: operations on the non-tensor f32 units. An
instance reads its data once (28 KB at n = 64, m = 32, p = 16 in f32) and does
about ``n^2 m + n^3/3 + n^2 p + p^2 n + 8 n^2`` flops per iteration
(0.4 MFLOP at that size) for five to ten iterations — a hundred flops per
byte, well past the card's ridge. The design therefore touches device memory
once, and shortens the sequential structure that the time really goes to: H
and S are assembled and factorised in registers (one block barrier per
column); every triangular substitution is run by one warp with its right-hand
side in registers (the p columns of W on the block's warps side by side, the
chain of a direction solve on one warp); the forward half of each H-solve is
shared, so a direction costs two n-substitutions where the reference does
six. Several blocks stay resident per SM, so one instance's serial stretches
overlap with another's arithmetic.

Envelope of the kernel: ``m >= 1``, ``1 <= p <= 128``, ``n <= 128`` (H and S
are factorised in register tiles, which hold 128 rows) and a working set that
fits 227 KB of shared memory (:func:`smem_bytes`; at n = 128 that allows
p = 128 in f32 and p = 32 in f64). A batch outside it goes, by its shape, to
the staged solver (``solvers/qp.py::solve_batched``), as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ...ir import QPSolution, QuadProgram
from . import chol
from .chol import MAX_SMEM_BYTES, _SUFFIX, _odd, _require_cuda

Tensor = torch.Tensor

MAX_ROWS = 128  # rows of H (n) and of S (p) that the kernel's register tiles hold
_SLOTS = 32  # scalar slots of the kernel (kNumSlots in csrc/pdip.cu)
_COLBUF = 256  # pivot-column buffer of the register-tiled factorisation (kColbufWords)


def smem_bytes(n: int, m: int, p: int, itemsize: int, stage: bool) -> int:
    """Dynamic shared memory of the kernel — mirrors ``pdip_words`` in
    ``csrc/pdip.cu`` (the wrapper checks the two against each other)."""
    words = (n * n + m * n + p * n) if stage else 0
    words += n * _odd(n) + n * _odd(p) + p * _odd(p)
    words += 9 * n + 12 * m + 7 * p + _SLOTS + _COLBUF
    return words * itemsize


def in_envelope(n: int, m: int, p: int, itemsize: int) -> bool:
    """Whether the fused kernel takes the shape."""
    return (
        m >= 1 and 1 <= p <= MAX_ROWS and n <= MAX_ROWS
        and smem_bytes(n, m, p, itemsize, stage=False) <= MAX_SMEM_BYTES
    )


def default_tol(dtype) -> float:
    return 1e-9 if dtype == torch.float64 else 5e-6


def default_reg(dtype) -> float:
    return 1e-11 if dtype == torch.float64 else 1e-7


def _lib():
    from . import _build

    lib = _build.load("pdip")
    if not getattr(lib, "_pdip_bound", False):
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"pdip_fused_{sfx}")
            f.argtypes = [vp] * 11 + [ci] * 5 + [cd, cd, ci, vp]
            f.restype = ci
        lib.pdip_smem_bytes.argtypes = [ci] * 5
        lib.pdip_smem_bytes.restype = ctypes.c_longlong
        lib._pdip_bound = True
    return lib


# --- plain version ----------------------------------------------------------


def solve_batched_fused_plain(
    qp: QuadProgram,
    *,
    max_iters: int = 25,
    tol: float | None = None,
    reg: float | None = None,
    return_iters: bool = False,
):
    """Plain PyTorch version of the fused kernel: the same algorithm and
    constants on ``(B, ...)`` tensors, per-instance freeze by ``torch.where``
    (never ``alpha = 0``: ``0 * NaN`` would poison an instance whose direction
    blew up). The loop stops once every instance is converged, stalled or
    non-finite."""
    Q, q, A, b, G, h = qp.Q, qp.q, qp.A, qp.b, qp.G, qp.h
    B, n, m, p = qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq
    dt, dev = Q.dtype, Q.device
    if m == 0 or p == 0:
        raise ValueError(f"the fused solver needs m >= 1 and p >= 1 (got m = {m}, p = {p})")
    tol = default_tol(dt) if tol is None else tol
    reg = default_reg(dt) if reg is None else reg

    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    amax = lambda x: x.abs().amax(dim=1)
    eye_n = torch.eye(n, dtype=dt, device=dev)
    eye_p = torch.eye(p, dtype=dt, device=dev)
    At = A.transpose(1, 2)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)

    def factor(lam, s):
        """L_h = chol(H), W = L_h^-1 A', L_s = chol(S) with S = A H^-1 A' + reg I = W'W + reg I."""
        ls = lam / s
        H = Q + reg * eye_n + (G * ls[:, :, None]).transpose(1, 2) @ G
        Lh = chol.cholesky_batched_plain(H)
        W = chol.forward_sub_plain(Lh, At)
        Ls = chol.cholesky_batched_plain(reg * eye_p + W.transpose(1, 2) @ W)
        return Lh, W, Ls

    def solve_dir(K, rd, rpe, rpi, rc, lam, s):
        """The reference's z1 = H^-1 rhs, dnu = S^-1 (A z1 + rpe), dz = z1 - H^-1 A' dnu, with
        the forward half of each H-solve shared: w = L^-1 rhs, dz = L'^-1 (w - W dnu)."""
        Lh, W, Ls = K
        rhs_z = -rd + rmv(G, (rc - lam * rpi) / s)
        w = chol.forward_sub_plain(Lh, rhs_z[..., None])
        rhs_s = rmv(W, w[..., 0]) + rpe
        dnu = chol.backward_sub_plain(Ls, chol.forward_sub_plain(Ls, rhs_s[..., None]))
        dz = chol.backward_sub_plain(Lh, w - W @ dnu)[..., 0]
        dnu = dnu[..., 0]
        ds = -rpi - mv(G, dz)
        dlam = -(rc + lam * ds) / s
        return dz, dnu, dlam, ds

    def residuals(z, nu, lam, s):
        Qz, Gl, An = mv(Q, z), rmv(G, lam), rmv(A, nu)
        rd = Qz + q + Gl + An
        dscale = torch.maximum(torch.maximum(amax(Qz), amax(q)), torch.maximum(amax(Gl), amax(An)))
        Az, Gz = mv(A, z), mv(G, z)
        rpe = Az - b
        rpi = Gz + s - h
        pscale = torch.maximum(torch.maximum(amax(Az), amax(b)), torch.maximum(amax(Gz), amax(h)))
        pobj = 0.5 * (z * Qz).sum(dim=1) + (q * z).sum(dim=1)
        return rd, rpe, rpi, 1.0 + dscale, 1.0 + pscale, 1.0 + pobj.abs()

    def step_len(v, dv, frac):
        ratio = torch.where(dv < 0, -v / dv, inf)
        return torch.clamp(frac * ratio.amin(dim=1), max=1.0)

    def err_of(z, nu, lam, s):
        rd, rpe, rpi, dscale, pscale, gscale = residuals(z, nu, lam, s)
        mu = (s * lam).sum(dim=1) / m
        pres = (amax(rpe) + amax(rpi)) / pscale
        dres = amax(rd) / dscale
        gaprel = mu * m / gscale
        return (rd, rpe, rpi), mu, pres, dres, gaprel

    # ---- init (same as the staged solver) ----------------------------------
    ones_m = torch.ones(B, m, dtype=dt, device=dev)
    dz0, dnu0, _, _ = solve_dir(factor(ones_m, ones_m), q, -b, -h, -ones_m, ones_m, ones_m)
    z, nu = dz0, dnu0
    s0 = h - mv(G, z)
    shift = torch.clamp(-s0.amin(dim=1) * 1.5, min=0.0) + 1.0
    s = s0 + shift[:, None]
    lam = ones_m

    big = torch.full((B,), 1e30, dtype=dt, device=dev)
    zb, nub, lamb, sb, errb = z, nu, lam, s, big
    mu_prev, err_prev = big, big
    stall = torch.zeros(B, dtype=torch.int32, device=dev)
    itdone = torch.full((B,), -1, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters:
        (rd, rpe, rpi), mu, pres, dres, gaprel = err_of(z, nu, lam, s)
        K = factor(lam, s)
        _, _, dlama, dsa = solve_dir(K, rd, rpe, rpi, s * lam, lam, s)
        ap = step_len(s, dsa, 1.0)
        ad = step_len(lam, dlama, 1.0)
        mu_aff = ((s + ap[:, None] * dsa) * (lam + ad[:, None] * dlama)).sum(dim=1) / m
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)
        rc = s * lam + dsa * dlama - (sigma * mu)[:, None]
        dz, dnu, dlam, ds = solve_dir(K, rd, rpe, rpi, rc, lam, s)
        alpha = torch.minimum(step_len(s, ds, 0.99), step_len(lam, dlam, 0.99))
        done = (pres < tol) & (dres < tol) & (gaprel < tol)
        err = torch.maximum(torch.maximum(pres, dres), gaprel)
        better = err < errb
        sel = lambda new, old: torch.where(better[:, None], new, old)
        zb, nub, lamb, sb = sel(z, zb), sel(nu, nub), sel(lam, lamb), sel(s, sb)
        errb = torch.where(better, err, errb)
        stalled_now = (mu > 0.98 * mu_prev) & (err > 0.98 * err_prev)
        stall = torch.where(stalled_now, stall + 1, torch.zeros_like(stall))
        stalled = stall >= 5
        finite = (
            torch.isfinite(dz).all(dim=1) & torch.isfinite(dnu).all(dim=1)
            & torch.isfinite(dlam).all(dim=1) & torch.isfinite(ds).all(dim=1)
        )
        frozen = done | stalled | ~finite
        itdone = torch.where(frozen & (itdone < 0), torch.full_like(itdone, it), itdone)
        step = (~frozen)[:, None]
        alpha = torch.where(torch.isfinite(alpha), alpha, torch.zeros_like(alpha))[:, None]
        upd = lambda x, dx: torch.where(step, x + alpha * dx, x)
        z, nu, lam, s = upd(z, dz), upd(nu, dnu), upd(lam, dlam), upd(s, ds)
        mu_prev, err_prev = mu, err
        it += 1
        if bool(frozen.all()):
            break

    # the exit state never got a best-update inside the loop: score it once
    _, mu, pres, dres, gaprel = err_of(z, nu, lam, s)
    err = torch.maximum(torch.maximum(pres, dres), gaprel)
    fin = torch.isfinite(z).all(dim=1) & torch.isfinite(lam).all(dim=1)
    better = ((err < errb) & fin)[:, None]
    sol = QPSolution(
        z=torch.where(better, z, zb), lam=torch.where(better, lam, lamb), nu=torch.where(better, nu, nub)
    )
    if return_iters:
        return sol, torch.where(itdone >= 0, itdone, torch.full_like(itdone, it))
    return sol


# --- wrapper ----------------------------------------------------------------

def solve_batched_fused(
    qp: QuadProgram,
    *,
    max_iters: int = 25,
    tol: float | None = None,
    reg: float | None = None,
    return_iters: bool = False,
):
    """Solve a ``(B, ...)`` batch of QPs with the fused kernel; returns
    AK17-convention primal-dual solutions.

    With ``return_iters=True`` returns ``(sol, iterations)`` where
    ``iterations`` is the int32 per-instance count of IPM bodies executed
    before the instance converged, stalled or froze.

    The route is chosen by shape alone, never by a failure: ``m == 0``,
    ``p == 0`` or a size past the kernel's envelope (:func:`in_envelope`:
    ``n, p <= 128`` and its shared memory) goes to the staged solver
    (``solvers/qp.py::solve_batched``) with the same ``max_iters``, ``tol``
    and ``reg``, and ``iterations`` is then that solver's count. Inside the
    envelope CUDA tensors go to the kernel (a failed build or launch raises)
    and CPU tensors to the plain version."""
    n, m, p = qp.num_vars, qp.num_ineq, qp.num_eq
    dt = qp.Q.dtype
    itemsize = qp.Q.element_size()
    if not in_envelope(n, m, p, itemsize):
        from ...solvers import qp as qpsolver

        sol, info = qpsolver.solve_batched(qp, max_iters=max_iters, tol=tol, reg=reg)
        return (sol, info.iterations) if return_iters else sol
    if qp.Q.device.type == "cpu":
        return solve_batched_fused_plain(
            qp, max_iters=max_iters, tol=tol, reg=reg, return_iters=return_iters
        )
    _require_cuda(qp.Q, "solve_batched_fused")
    for t in qp.tensors():
        if t.device != qp.Q.device or t.dtype != dt:
            raise ValueError("solve_batched_fused: all fields must share device and dtype")
    tol = default_tol(dt) if tol is None else tol
    reg = default_reg(dt) if reg is None else reg
    B = qp.batch_size
    qp = qp.map(lambda t: t.detach().contiguous())
    z = qp.q.new_empty(B, n)
    lam = qp.q.new_empty(B, m)
    nu = qp.q.new_empty(B, p)
    s = qp.q.new_empty(B, m)
    iters = torch.empty(B, dtype=torch.int32, device=qp.Q.device)
    if B > 0:
        # Q, G and A are staged in shared memory when that fits beside the
        # working set; otherwise the kernel reads them from device memory
        stage = smem_bytes(n, m, p, itemsize, stage=True) <= MAX_SMEM_BYTES
        lib = _lib()
        if lib.pdip_smem_bytes(n, m, p, itemsize, int(stage)) != smem_bytes(n, m, p, itemsize, stage):
            raise RuntimeError("solve_batched_fused: shared-memory layout of wrapper and kernel differ")
        fn = getattr(lib, f"pdip_fused_{_SUFFIX[dt]}")
        with torch.cuda.device(qp.Q.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(
                qp.Q.data_ptr(), qp.q.data_ptr(), qp.A.data_ptr(), qp.b.data_ptr(),
                qp.G.data_ptr(), qp.h.data_ptr(), z.data_ptr(), lam.data_ptr(), nu.data_ptr(),
                s.data_ptr(), iters.data_ptr(), B, n, m, p, int(max_iters), float(tol), float(reg),
                int(stage), stream,
            )
        from . import _build

        _build.check(lib, code, "solve_batched_fused")
        solve_batched_fused.launches += 1
    sol = QPSolution(z=z, lam=lam, nu=nu)
    return (sol, iters) if return_iters else sol


solve_batched_fused.launches = 0
