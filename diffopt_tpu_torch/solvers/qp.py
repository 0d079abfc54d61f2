"""Batched dense primal-dual interior-point QP/LP solver (the staged solver)
and QP solve diagnostics. Counterpart of ``diffopt_tpu/solvers/qp.py``.

A Mehrotra predictor-corrector interior-point method for

    min 1/2 z'Qz + q'z   s.t.  Az = b,  Gz + s = h,  s >= 0

written for ``(B, ...)`` tensors: every factorisation and substitution of an
iteration is ONE launch of a batched Cholesky kernel (``ops/cuda/chol.py``)
over the whole batch, with plain PyTorch glue between the launches. It takes
every shape (``m == 0``, ``p == 0``, any ``n``), which the fused single-kernel
solver (``ops/cuda/pdip.py``) does not, and is the second oracle for it.

Returns duals in the AK17 convention (:class:`~diffopt_tpu_torch.ir.QPSolution`):
``lam >= 0`` for ``Gz <= h`` and ``nu`` with Lagrangian ``+ nu.(Az - b)``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ir import QPSolution, QuadProgram
from ..ops.cuda.chol import cholesky_batched as chol, cholesky_solve_batched as chol_solve
from ..utils.config import get_config
from ..utils.precision import full_precision

Tensor = torch.Tensor


class QPSolveInfo(NamedTuple):
    iterations: Tensor  # int32, iterations actually used (-1: unknown)
    primal_residual: Tensor
    dual_residual: Tensor
    duality_gap: Tensor
    converged: Tensor  # bool


@full_precision
def solve_batched(
    qp: QuadProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    reg: float | None = None,
) -> Tuple[QPSolution, QPSolveInfo]:
    """Solve a ``(B, ...)`` batch of QPs with the staged interior-point method.

    ``max_iters``/``tol``/``reg`` default from the active
    :class:`~diffopt_tpu_torch.utils.config.DiffOptConfig` (per-dtype
    tolerances: complementarity products can't resolve below ~sqrt(eps) in
    f32). The loop runs until every instance is done or the cap is reached; an
    instance that is done keeps its state and its iteration count (by select,
    never by a zero step length), so ``info.iterations`` is per instance. Each
    body costs one device-to-host copy (``done.all()``), counted in
    ``solve_batched.host_syncs``.
    """
    cfg = get_config()
    B, n, m, p = qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq
    dt, dev = qp.Q.dtype, qp.Q.device
    if max_iters is None:
        max_iters = cfg.qp_max_iters
    if tol is None:
        tol = cfg.qp_tol(dt)
    if reg is None:
        reg = cfg.qp_reg(dt)
    Q, q, A, b, G, h = (t.detach() for t in qp.tensors())
    zeros = lambda *shape: torch.zeros(*shape, dtype=dt, device=dev)
    ones = lambda *shape: torch.ones(*shape, dtype=dt, device=dev)
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    norm = lambda v: torch.linalg.vector_norm(v, dim=-1)
    eyen = torch.eye(n, dtype=dt, device=dev)

    if m == 0 and p == 0:
        # Unconstrained: single Newton solve.
        lu, piv, _ = torch.linalg.lu_factor_ex(Q + reg * eyen)
        z = -torch.linalg.lu_solve(lu, piv, q[..., None])[..., 0]
        r = norm(mv(Q, z) + q)
        info = QPSolveInfo(
            iterations=torch.ones(B, dtype=torch.int32, device=dev),
            primal_residual=zeros(B),
            dual_residual=r,
            duality_gap=zeros(B),
            converged=r < tol,
        )
        return QPSolution(z=z, lam=zeros(B, 0), nu=zeros(B, 0)), info

    At, Gt = A.transpose(1, 2), G.transpose(1, 2)
    eyep = torch.eye(p, dtype=dt, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)

    def newton_mat(lam, s):
        """Cholesky factors of the condensed PD system: eliminate (ds, dlam)
        to get H = Q + G'(lam/s)G + reg I, then eliminate dnu via the Schur
        complement S = A H^-1 A' + reg I. Two batched Cholesky factorizations
        per IPM iteration."""
        H = Q + (Gt * (lam / s)[:, None, :]) @ G if m else Q
        Lh = chol(H + reg * eyen)
        Ls = chol(A @ chol_solve(Lh, At) + reg * eyep) if p else None
        return Lh, Ls

    def residuals(z, nu, lam, s):
        rd = mv(Q, z) + q + rmv(G, lam) + rmv(A, nu)  # dual/stationarity
        return rd, mv(A, z) - b, mv(G, z) + s - h

    def step_len(v, dv, frac):
        """Fraction-to-boundary: alpha = min(1, frac * min_{dv<0}(-v/dv)); only
        called with m > 0."""
        ratio = torch.where(dv < 0, -v / dv, inf)
        return torch.clamp(frac * ratio.amin(dim=1), max=1.0)

    def solve_dir(K, rd, rp_eq, rp_in, r_cent, lam, s):
        """Back-substitute the condensed system for (dz, dnu, dlam, ds).

        Full system: Q dz + G'dlam + A'dnu = -rd
                     A dz                  = -rp_eq
                     G dz + ds             = -rp_in
                     S dlam + Lam ds       = -r_cent
        Eliminate ds = -rp_in - G dz, dlam = -(r_cent + lam*ds)/s.
        """
        Lh, Ls = K
        rhs_z = -rd + rmv(G, (r_cent - lam * rp_in) / s) if m else -rd
        z1 = chol_solve(Lh, rhs_z)
        if p:
            dnu = chol_solve(Ls, mv(A, z1) + rp_eq)
            dz = z1 - chol_solve(Lh, rmv(A, dnu))
        else:
            dnu, dz = zeros(B, 0), z1
        ds = -rp_in - mv(G, dz)
        dlam = -(r_cent + lam * ds) / s
        return dz, dnu, dlam, ds

    def mean_dot(u, v):
        return (u * v).sum(dim=1) / m if m else zeros(B)

    # --- initialization (least-squares style, cf. Mehrotra / CVXGEN) --------
    rd0, rpe0, rpi0 = residuals(zeros(B, n), zeros(B, p), zeros(B, m), zeros(B, m))
    z, nu, _, _ = solve_dir(
        newton_mat(ones(B, m), ones(B, m)), rd0, rpe0, rpi0, -ones(B, m), ones(B, m), ones(B, m)
    )
    s = h - mv(G, z)
    if m:
        s = s + (torch.clamp(-torch.clamp(s.amin(dim=1), max=0.0) * 1.5, min=0.0) + 1.0)[:, None]
    lam = ones(B, m)

    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    # the residuals a body ends on are the ones the next body (and the final
    # report) starts from: computed once per iterate
    rd, rp_eq, rp_in = residuals(z, nu, lam, s)
    for _ in range(max_iters):
        K = newton_mat(lam, s)
        # affine (predictor) direction
        _, _, dlama, dsa = solve_dir(K, rd, rp_eq, rp_in, s * lam, lam, s)
        if m:
            mu = mean_dot(s, lam)
            a_p = step_len(s, dsa, 1.0)[:, None]
            a_d = step_len(lam, dlama, 1.0)[:, None]
            mu_aff = mean_dot(s + a_p * dsa, lam + a_d * dlama)
            # the floor is 1e-300 in the working dtype: 0 in f32, as in the
            # reference, so mu == 0 gives inf or NaN and the clip / the NaN
            # guard below decide
            sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0)
            # corrector: centering + Mehrotra second-order term
            r_cent = s * lam + dsa * dlama - (sigma * mu)[:, None]
        else:
            r_cent = s * lam
        dz, dnu, dlam, ds = solve_dir(K, rd, rp_eq, rp_in, r_cent, lam, s)
        if m:
            alpha = torch.minimum(step_len(s, ds, 0.99), step_len(lam, dlam, 0.99))[:, None]
        else:
            alpha = ones(B, 1)
        z_n, nu_n, lam_n, s_n = z + alpha * dz, nu + alpha * dnu, lam + alpha * dlam, s + alpha * ds

        # NaN guard: near-degenerate active sets can blow up the condensed
        # system once mu ~ eps; freeze at the last good iterate.
        finite = torch.isfinite(torch.cat([z_n, nu_n, lam_n, s_n], dim=1)).all(dim=1)
        # an instance that is done keeps its state; a non-finite step is dropped
        keep = (done | ~finite)[:, None]
        z_n, nu_n = torch.where(keep, z, z_n), torch.where(keep, nu, nu_n)
        lam_n, s_n = torch.where(keep, lam, lam_n), torch.where(keep, s, s_n)

        rd, rp_eq, rp_in = residuals(z_n, nu_n, lam_n, s_n)
        pres = torch.sqrt((rp_eq**2).sum(dim=1) + (rp_in**2).sum(dim=1))
        conv = (pres < tol) & (norm(rd) < tol) & (mean_dot(s_n, lam_n) < tol)
        it = torch.where(done, it, it + 1)
        done = done | conv | ~finite
        z, nu, lam, s = z_n, nu_n, lam_n, s_n
        solve_batched.host_syncs += 1
        if bool(done.all()):
            break

    pres = torch.sqrt((rp_eq**2).sum(dim=1) + (rp_in**2).sum(dim=1))
    dres = norm(rd)
    gap = (s * lam).sum(dim=1)
    mu_f = gap / m if m else gap
    # `done` may have been set by the NaN-freeze guard; report convergence
    # from the actual residuals (with a small slack on the gap, which can
    # stall one notch above tol on degenerate LP faces).
    info = QPSolveInfo(
        iterations=it,
        primal_residual=pres,
        dual_residual=dres,
        duality_gap=gap,
        converged=(pres < 10 * tol) & (dres < 10 * tol) & (mu_f < 100 * tol),
    )
    return QPSolution(z=z, lam=lam, nu=nu), info


solve_batched.host_syncs = 0


def solve(qp: QuadProgram, **kwargs) -> Tuple[QPSolution, QPSolveInfo]:
    """Solve one QP instance (fields without a batch dimension): adds the
    batch dimension, calls :func:`solve_batched`, strips it again."""
    sol, info = solve_batched(qp.map(lambda t: t[None]), **kwargs)
    return sol.map(lambda t: t[0]), QPSolveInfo(*(t[0] for t in info))


@full_precision
def kkt_metrics(
    qp: QuadProgram,
    sol: QPSolution,
    *,
    tol: float | None = None,
    iterations: Tensor | None = None,
) -> QPSolveInfo:
    """Post-hoc KKT residual metrics for an externally produced solution —
    the status source for solve paths that don't carry per-instance solver
    state (the fused PDIP kernel).

    ``converged`` uses the same scale-RELATIVE criterion as the fused kernel's
    termination (with a 10x/100x exit-report slack): absolute residuals are
    unreachable in f32 once data/solution scales are large, and an absolute
    flag would mark entire well-solved large-scale batches unconverged —
    which ``nan_on_unconverged`` would then NaN-poison wholesale. The slack
    variable is reconstructed as ``max(h - Gz, 0)`` so primal infeasibility
    shows up as ``max(Gz - h, 0)`` mass in ``primal_residual``.
    ``primal_residual``/``dual_residual`` are reported relative (max-abs over
    rows, divided by the scale factors); ``duality_gap`` stays the raw
    complementarity sum.

    ``iterations`` is the solver's own per-instance count where the caller
    has one (the fused kernel exports it); without it the field is -1
    (unknown), since residuals alone cannot tell.
    """
    dt = qp.Q.dtype
    if tol is None:
        tol = get_config().qp_tol(dt)
    m = qp.num_ineq
    z, lam, nu = sol.z, sol.lam, sol.nu
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    amax = lambda x: x.abs().amax(dim=-1) if x.shape[-1] else x.new_zeros(x.shape[:-1])
    Qz, Gl, An = mv(qp.Q, z), rmv(qp.G, lam), rmv(qp.A, nu)
    rd = Qz + qp.q + Gl + An
    dscale = 1.0 + torch.maximum(
        torch.maximum(amax(Qz), amax(qp.q)), torch.maximum(amax(Gl), amax(An))
    )
    Az, Gz = mv(qp.A, z), mv(qp.G, z)
    rp_eq = Az - qp.b
    viol = torch.clamp(Gz - qp.h, min=0.0)
    s = torch.clamp(qp.h - Gz, min=0.0)
    pscale = 1.0 + torch.maximum(
        torch.maximum(amax(Az), amax(qp.b)), torch.maximum(amax(Gz), amax(qp.h))
    )
    pobj = 0.5 * (z * Qz).sum(dim=-1) + (qp.q * z).sum(dim=-1)
    gscale = 1.0 + pobj.abs()
    pres = (amax(rp_eq) + amax(viol)) / pscale
    dres = amax(rd) / dscale
    gap = (s * lam).sum(dim=-1)
    mu_f = (gap / m if m else gap) / gscale
    conv = (
        (pres < 10 * tol) & (dres < 10 * tol) & (mu_f < 100 * tol)
        & torch.isfinite(z).all(dim=-1)
        & torch.isfinite(lam).all(dim=-1)
        & torch.isfinite(nu).all(dim=-1)
    )
    if iterations is None:
        iterations = torch.full(conv.shape, -1, dtype=torch.int32, device=conv.device)
    else:
        iterations = iterations.to(torch.int32).expand(conv.shape)
    return QPSolveInfo(
        iterations=iterations,
        primal_residual=pres,
        dual_residual=dres,
        duality_gap=gap,
        converged=conv,
    )
