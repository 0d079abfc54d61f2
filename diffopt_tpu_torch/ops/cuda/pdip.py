"""Fully fused batched PDIP QP solver: one CUDA kernel runs the whole
Mehrotra predictor-corrector loop of an instance, with the plain PyTorch
version beside it.

Replaces ``diffopt_tpu/ops/pallas/pdip.py::solve_batched_fused`` (kernel body
``_pdip_kernel``). Source: ``csrc/pdip.cu``.

What bounds it on the H100: operations on the non-tensor f32 units. An
instance reads its data once (28 KB at n = 64, m = 32, p = 16 in f32) and does
about ``n^2 m + n^3/3 + n^2 p + p^2 n + 8 n^2`` flops per iteration
(0.4 MFLOP at that size) for five to ten iterations — a hundred flops per
byte, well past the card's ridge. What the time goes to is the sequential
structure (n elimination steps with a barrier each, chains of substitutions),
so the design keeps every operand on chip and puts as many instances on an SM
as it holds, each one's chain overlapping the others':

- one instance per *team* of 1, 2 or 8 warps, one team per thread block; the
  launch rule (:func:`team_for`, written once in the source and mirrored here)
  picks the smallest team whose register tiles hold ``max(n, p)`` rows: one
  warp to 32 (its tiles hold 40, where two warps were faster), two to 64,
  eight to 128;
- Q, G and A are staged in shared memory only where that costs no resident
  team (:func:`stage_for`); the factors, the iterate and the rest of the
  working set always live there;
- H is assembled and factorised in the team's register tiles with A's rows
  stacked under it, so that the same column steps leave W' = A L'^-1 (no
  substitution of its own); S = W'W + reg I is factorised on the same grid;
- a direction's substitution chain runs on one warp with its vector in
  registers from the forward substitution through the S solve to the backward
  substitution (W'w by shuffle reductions, w - W dnu by shuffle broadcasts);
- the working set is addressed by index into shared memory, so that every
  access is a shared-memory load or store, not a generic one.

Envelope of the kernel (:func:`in_envelope`): ``m >= 1``, ``1 <= n, p <=
128`` and a working set (unstaged) that fits 227 KB of shared memory for the
team that takes the shape (at n = 128 that allows p = 128 in f32 and p = 32 in
f64). A batch outside it goes, by its shape, to the staged solver
(``solvers/qp.py::solve_batched``), as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ...ir import QPSolution, QuadProgram
from . import chol
from .chol import MAX_SMEM_BYTES, _SUFFIX, _odd, _require_cuda

Tensor = torch.Tensor

MAX_ROWS = 128  # rows of H (n) and of S (p) that the register tiles of the largest team hold
TEAMS = (1, 2, 8)  # warps per instance the kernel is built for (kTeams in csrc/dense.cuh)
_SLOTS = 32  # scalar slots of the kernel (kNumSlots in csrc/pdip.cu)
_STATIC_SMEM = 512  # kPdipStatic: room for the kernel's static shared memory (its pointer table)
SM_SMEM_BYTES = 233472  # shared memory of one SM of an H100 (228 KB) ...
_BLOCK_RESERVED_SMEM = 1024  # ... of which each resident block takes 1 KB for the system
_SM_MAX_BLOCKS, _SM_MAX_WARPS = 32, 64


def tile_max_n(team: int) -> int:
    """Rows of H and S the register tiles of a team of ``team`` warps hold (``tile_max_n`` in ``csrc/dense.cuh``)."""
    return 40 if team == 1 else (128 if team == 8 else 64)


def _reg_blocks(itemsize: int, team: int) -> int:
    """Teams per SM the launch bounds promise the registers for (``pdip_reg_blocks``)."""
    return {1: 24, 2: 8, 8: 3}[team] if itemsize == 4 else {1: 12, 2: 4, 8: 1}[team]


def smem_bytes(n: int, m: int, p: int, itemsize: int, stage: bool, team: int = 8) -> int:
    """Dynamic shared memory of the kernel for a team of ``team`` warps — mirrors
    ``pdip_words`` in ``csrc/pdip.cu`` (the wrapper checks the two against each
    other): Q, G, A where staged, L_h with W' below it, L_s, the vectors, the
    scalar slots and the team's pivot column (``4 tile_max_n(team)`` words)."""
    words = (n * n + m * n + p * n) if stage else 0
    words += (n + p) * _odd(n) + p * _odd(p)
    words += 9 * n + 11 * m + 7 * p + _SLOTS + 4 * tile_max_n(team)
    return words * itemsize


def team_takes(n: int, m: int, p: int, itemsize: int, team: int) -> bool:
    """Whether a team of ``team`` warps takes the shape (``pdip_team_takes``):
    n and p rows in its register tiles, its working set (unstaged) in one
    block's shared memory."""
    return (
        team in TEAMS and n >= 1 and m >= 1 and p >= 1 and max(n, p) <= tile_max_n(team)
        and smem_bytes(n, m, p, itemsize, False, team) + _STATIC_SMEM <= MAX_SMEM_BYTES
    )


def rule_rows(team: int) -> int:
    """Rows up to which the launch rule gives a shape to a team (``pdip_rule_rows``):
    one warp's tiles hold 40, but at n = 40 two warps were faster on an H100."""
    return 32 if team == 1 else tile_max_n(team)


def team_for(n: int, m: int, p: int, itemsize: int) -> int:
    """The launch rule (``pdip_team`` in ``csrc/pdip.cu``): the smallest team
    that takes the shape within its :func:`rule_rows`, else the smallest that
    takes it at all; 0 where none does."""
    takes = [t for t in TEAMS if team_takes(n, m, p, itemsize, t)]
    return next((t for t in takes if max(n, p) <= rule_rows(t)), takes[0] if takes else 0)


def instances_per_sm(n: int, m: int, p: int, itemsize: int, team: int, stage: bool) -> int:
    """Instances (teams) one SM holds at least (``pdip_resident``): by shared
    memory, counting the whole room kept for the pointer table and the
    system's share of each block; by the registers the launch bounds promise;
    and by the SM's block and warp limits. The build may use fewer registers
    and allow more: :func:`blocks_per_sm` asks the card."""
    per_block = smem_bytes(n, m, p, itemsize, stage, team) + _STATIC_SMEM + _BLOCK_RESERVED_SMEM
    return min(_SM_MAX_BLOCKS, _SM_MAX_WARPS // team, _reg_blocks(itemsize, team), SM_SMEM_BYTES // per_block)


def stage_for(n: int, m: int, p: int, itemsize: int, team: int) -> bool:
    """Whether a team of ``team`` warps stages Q, G and A in shared memory
    (``pdip_stage``): where they fit and cost no resident instance."""
    return (
        smem_bytes(n, m, p, itemsize, True, team) + _STATIC_SMEM <= MAX_SMEM_BYTES
        and instances_per_sm(n, m, p, itemsize, team, True) >= instances_per_sm(n, m, p, itemsize, team, False)
    )


def in_envelope(n: int, m: int, p: int, itemsize: int) -> bool:
    """Whether the fused kernel takes the shape (with the team the launch rule picks)."""
    return team_for(n, m, p, itemsize) > 0


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
            # Q, q, A, b, G, h, z, lam, nu, s, it; B, n, m, p, iters; tol, reg; team; stream
            f.argtypes = [vp] * 11 + [ci] * 5 + [cd, cd, ci, vp]
            f.restype = ci
        lib.pdip_smem_bytes.argtypes = [ci] * 6
        lib.pdip_smem_bytes.restype = ctypes.c_longlong
        lib.pdip_team.argtypes = [ci] * 4
        lib.pdip_team.restype = ci
        lib.pdip_stage.argtypes = [ci] * 5
        lib.pdip_stage.restype = ci
        lib.pdip_blocks_per_sm.argtypes = [ci] * 5
        lib.pdip_blocks_per_sm.restype = ci
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
    team: int | None = None,
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
    envelope CUDA tensors go to the kernel with ``team`` warps per instance
    (None: the launch rule's :func:`team_for`); a team that does not take the
    shape raises ``ValueError`` (another team is never tried), and so does a
    forced team with a batch outside the envelope; a failed build or launch
    raises. CPU tensors go to the plain version, which has no teams."""
    n, m, p = qp.num_vars, qp.num_ineq, qp.num_eq
    dt = qp.Q.dtype
    itemsize = qp.Q.element_size()
    if team is not None and not team_takes(n, m, p, itemsize, team):
        raise ValueError(
            f"solve_batched_fused: a team of {team} warps does not take n={n}, m={m}, p={p}"
            f" (n, p <= {tile_max_n(team) if team in TEAMS else '-'}, m >= 1 and 227 KB of shared memory;"
            f" teams {TEAMS})"
        )
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
    team = team_for(n, m, p, itemsize) if team is None else team
    B = qp.batch_size
    qp = qp.map(lambda t: t.detach().contiguous())
    z = qp.q.new_empty(B, n)
    lam = qp.q.new_empty(B, m)
    nu = qp.q.new_empty(B, p)
    s = qp.q.new_empty(B, m)
    iters = torch.empty(B, dtype=torch.int32, device=qp.Q.device)
    if B > 0:
        lib = _lib()
        stage = stage_for(n, m, p, itemsize, team)
        if lib.pdip_smem_bytes(n, m, p, itemsize, team, int(stage)) != smem_bytes(n, m, p, itemsize, stage, team):
            raise RuntimeError("solve_batched_fused: shared-memory layout of wrapper and kernel differ")
        if lib.pdip_team(n, m, p, itemsize) != team_for(n, m, p, itemsize) or lib.pdip_stage(
            n, m, p, itemsize, team
        ) != int(stage):
            raise RuntimeError("solve_batched_fused: launch rule of wrapper and kernel differ")
        fn = getattr(lib, f"pdip_fused_{_SUFFIX[dt]}")
        with torch.cuda.device(qp.Q.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = fn(
                qp.Q.data_ptr(), qp.q.data_ptr(), qp.A.data_ptr(), qp.b.data_ptr(),
                qp.G.data_ptr(), qp.h.data_ptr(), z.data_ptr(), lam.data_ptr(), nu.data_ptr(),
                s.data_ptr(), iters.data_ptr(), B, n, m, p, int(max_iters), float(tol), float(reg),
                int(team), stream,
            )
        from . import _build

        _build.check(lib, code, f"solve_batched_fused (team of {team} warps)")
        solve_batched_fused.launches += 1
    sol = QPSolution(z=z, lam=lam, nu=nu)
    return (sol, iters) if return_iters else sol


solve_batched_fused.launches = 0


def blocks_per_sm(n: int, m: int, p: int, dtype, team: int) -> int:
    """Instances (teams of ``team`` warps) resident on one SM of the current
    card at the shape, with the staging the rule picks, as the CUDA occupancy
    calculator counts them with the built kernel's registers and shared
    memory. Needs the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("pdip.blocks_per_sm: no CUDA device")
    itemsize = torch.empty((), dtype=dtype).element_size()
    got = _lib().pdip_blocks_per_sm(n, m, p, itemsize, team)
    if got < 0:
        raise RuntimeError(f"pdip.blocks_per_sm: CUDA error {-got} for a team of {team} warps at n={n}, m={m}, p={p}")
    return got
