"""QP KKT implicit-differentiation core (OptNet / Amos-Kolter 2017).

Counterpart of ``diffopt_tpu/ops/kkt.py``, batch-first: every function takes
``(B, ...)`` tensors and calls the batched LDL' kernels directly.

* ``kkt_jacobian``  — the matrix ``J`` of AK17 eq. (6)
* ``qp_forward``    — JVP: solves ``J d = -rhs(dData)``
* ``qp_reverse``    — VJP: solves ``J' g = -seed`` and contracts to data
  cotangents
* ``qp_polish``     — active-set polish of a solved batch

Methods: ``"ldl"`` (the kernels of ``ops/cuda/chol.py``); ``"lu"``,
``"lstsq"``, ``"qr"`` or a callable ``(M, rhs) -> x`` (``ops/linalg.py``:
``torch.linalg``, as the JAX package leaves them to the library); and
``"auto"``, which decides per instance: an LP (``Q == 0``, singular KKT
matrix) gets the least-squares solve, every other instance LU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ir import QPSolution, QPTangent, QuadProgram
from ..utils.config import get_config
from ..utils.precision import full_precision
from . import linalg
from .cuda import chol

Tensor = torch.Tensor


class KKTSplit(NamedTuple):
    dz: Tensor
    dlam: Tensor
    dnu: Tensor


def _mv(M: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product (handles 0-sized dims)."""
    return torch.einsum("bij,bj->bi", M, v)


def _rmv(M: Tensor, v: Tensor) -> Tensor:
    """Batched M' v."""
    return torch.einsum("bij,bi->bj", M, v)


def _t(M: Tensor) -> Tensor:
    return M.transpose(-1, -2)


def _eye_like(M: Tensor, n: int) -> Tensor:
    return torch.eye(n, dtype=M.dtype, device=M.device)


def _split(x: Tensor, n: int, m: int) -> KKTSplit:
    return KKTSplit(x[:, :n], x[:, n:n + m], x[:, n + m:])


def _ldl_fits(qp: QuadProgram) -> bool:
    """Whether the KKT system is inside the LDL' kernel's envelope; larger
    systems take the LU route."""
    return qp.num_vars + qp.num_ineq + qp.num_eq <= chol.ldl_max_n(qp.Q.dtype)


def _auto_solve(qp: QuadProgram, J: Tensor, rhs: Tensor, refine_iters: int) -> Tensor:
    """Per-instance LP-vs-QP dispatch: an all-zero ``Q`` (singular KKT matrix)
    takes the least-squares solve, everything else LU. Instances are chosen
    by select, so the NaN that LU leaves on a singular instance never reaches
    a lane that took ``lstsq``; a branch that no instance needs is skipped
    (one device-to-host copy of the LP count decides that)."""
    is_lp = qp.Q.flatten(1).abs().amax(dim=1) == 0.0
    n_lp = int(is_lp.sum())
    _auto_solve.host_syncs += 1
    if n_lp == 0:
        return linalg.solve(J, rhs, "lu", refine_iters=refine_iters)
    x_lp = linalg.solve(J, rhs, "lstsq", refine_iters=refine_iters)
    if n_lp == qp.batch_size:
        return x_lp
    return torch.where(is_lp[:, None], x_lp, linalg.solve(J, rhs, "lu", refine_iters=refine_iters))


_auto_solve.host_syncs = 0


def _kkt_solve(qp: QuadProgram, sol: QPSolution, rhs: Tensor, method, refine_iters: int, transpose: bool) -> Tensor:
    """``J^-1 rhs`` (or ``J'^-1 rhs``) by ``method``."""
    if method == "ldl" and _ldl_fits(qp):
        return qp_kkt_solve_ldl(qp, sol, rhs, transpose=transpose, refine_iters=max(refine_iters, 2))
    J = kkt_jacobian(qp, sol)
    if transpose:
        J = _t(J)
    if method == "auto":
        return _auto_solve(qp, J, rhs, refine_iters)
    # "ldl" past the kernels' envelope takes the LU route, by size
    return linalg.solve(J, rhs, "lu" if method == "ldl" else method, refine_iters=refine_iters)


@full_precision
def kkt_jacobian(qp: QuadProgram, sol: QPSolution) -> Tensor:
    """Jacobian of the KKT residual wrt (z, lam, nu) at the solution::

        J = [ Q          G'         A' ]
            [ diag(lam)G diag(Gz-h) 0  ]
            [ A          0          0  ]
    """
    B, m, p = qp.batch_size, qp.num_ineq, qp.num_eq
    slack = _mv(qp.G, sol.z) - qp.h
    row0 = torch.cat([qp.Q, _t(qp.G), _t(qp.A)], dim=-1)
    row1 = torch.cat([sol.lam[..., None] * qp.G, torch.diag_embed(slack), qp.Q.new_zeros(B, m, p)], dim=-1)
    row2 = torch.cat([qp.A, qp.Q.new_zeros(B, p, m), qp.Q.new_zeros(B, p, p)], dim=-1)
    return torch.cat([row0, row1, row2], dim=-2)


def qp_forward_rhs(sol: QPSolution, dqp: QPTangent) -> Tensor:
    """Right-hand side ``[rhs1; rhs2; rhs3]`` of the forward system (see
    :func:`qp_forward`)."""
    z, lam, nu = sol.z, sol.lam, sol.nu
    rhs1 = _mv(dqp.dQ, z) + dqp.dq + _rmv(dqp.dG, lam) + _rmv(dqp.dA, nu)
    rhs2 = lam * (_mv(dqp.dG, z) - dqp.dh)
    rhs3 = _mv(dqp.dA, z) - dqp.db
    return torch.cat([rhs1, rhs2, rhs3], dim=-1)


@full_precision
def qp_forward(
    qp: QuadProgram, sol: QPSolution, dqp: QPTangent, *, method="lu", refine_iters: int = 0
) -> KKTSplit:
    """Forward (JVP) sensitivity: directional derivative of (z, lam, nu) along
    the data perturbation ``dqp``. Solves ``J [dz; dlam; dnu] = -rhs`` with::

        rhs1 = dQ z + dq + dG' lam + dA' nu
        rhs2 = lam .* (dG z - dh)
        rhs3 = dA z - db
    """
    d = -_kkt_solve(qp, sol, qp_forward_rhs(sol, dqp), method, refine_iters, transpose=False)
    return _split(d, qp.num_vars, qp.num_ineq)


@full_precision
def qp_reverse_system(
    qp: QuadProgram, sol: QPSolution, seed: KKTSplit, *, method="lu", refine_iters: int = 0
) -> KKTSplit:
    """Solve the adjoint system ``J' g = -[dl/dz; dl/dlam; dl/dnu]``."""
    rhs = torch.cat([seed.dz, seed.dlam, seed.dnu], dim=-1)
    g = -_kkt_solve(qp, sol, rhs, method, refine_iters, transpose=True)
    return _split(g, qp.num_vars, qp.num_ineq)


@full_precision
def qp_reverse_accumulate(qp: QuadProgram, sol: QPSolution, g: KKTSplit) -> QPTangent:
    """Contract the adjoint solution into data cotangents::

        dQ = (gz z' + z gz') / 2
        dq = gz
        dG = (lam.*glam) z' + lam gz'
        dh = -lam .* glam
        dA = gnu z' + nu gz'
        db = -gnu
    """
    z, lam, nu = sol.z, sol.lam, sol.nu
    gz, glam, gnu = g.dz, g.dlam, g.dnu
    outer = lambda a, b: a[..., :, None] * b[..., None, :]
    return QPTangent(
        dQ=0.5 * (outer(gz, z) + outer(z, gz)),
        dq=gz,
        dA=outer(gnu, z) + outer(nu, gz),
        db=-gnu,
        dG=outer(lam * glam, z) + outer(lam, gz),
        dh=-lam * glam,
    )


@full_precision
def qp_reverse(
    qp: QuadProgram,
    sol: QPSolution,
    dz_seed: Tensor,
    dlam_seed: Tensor | None = None,
    dnu_seed: Tensor | None = None,
    *,
    method="lu",
    refine_iters: int = 0,
) -> Tuple[QPTangent, KKTSplit]:
    """Reverse (VJP) sensitivity: cotangents of the data given cotangents of
    the solution. Returns ``(data_cotangents, adjoint_solution)``."""
    seed = KKTSplit(
        dz_seed,
        torch.zeros_like(sol.lam) if dlam_seed is None else dlam_seed,
        torch.zeros_like(sol.nu) if dnu_seed is None else dnu_seed,
    )
    g = qp_reverse_system(qp, sol, seed, method=method, refine_iters=refine_iters)
    return qp_reverse_accumulate(qp, sol, g), g


@full_precision
def kkt_residual(qp: QuadProgram, sol: QPSolution) -> Tensor:
    """Stationarity + complementarity + primal-feasibility residual, the
    implicit function whose Jacobian is :func:`kkt_jacobian`."""
    z, lam, nu = sol.z, sol.lam, sol.nu
    r1 = _mv(qp.Q, z) + qp.q + _rmv(qp.G, lam) + _rmv(qp.A, nu)
    r2 = lam * (_mv(qp.G, z) - qp.h)
    r3 = _mv(qp.A, z) - qp.b
    return torch.cat([r1, r2, r3], dim=-1)


# ---------------------------------------------------------------------------
# Symmetrized (quasi-definite) KKT path — the kernel-accelerated solve.
#
# J = R K with R = diag(I, diag(lam_e), I) and
#     K = [ Q + rp I    G'                  A'   ]
#         [ G           diag(s/lam_e)-rn I  0    ]
#         [ A           0                  -rn I ]
# where s = Gz - h <= 0 and lam_e = max(lam, floor). K is symmetric
# quasi-definite, so an unpivoted batched LDL' factorization is stable
# (Vanderbei 1995), and ONE factorization serves both the forward
# (J d = rhs) and adjoint (J' g = seed) solves:
#     forward:  d = K^-1 (R^-1 rhs)     (rhs given with row2 pre-divided)
#     adjoint:  w = K^-1 seed,  g = R^-1 w.
# Regularization and the lam floor are removed by iterative refinement
# against the true (unsymmetrized) J.
# ---------------------------------------------------------------------------


def _kkt_symmetric(qp: QuadProgram, sol: QPSolution, lam_floor, reg):
    B, n, m, p = qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq
    slack = _mv(qp.G, sol.z) - qp.h
    lam_e = torch.clamp(sol.lam, min=lam_floor)
    zeros = qp.Q.new_zeros
    row0 = torch.cat([qp.Q + reg * _eye_like(qp.Q, n), _t(qp.G), _t(qp.A)], dim=-1)
    row1 = torch.cat([qp.G, torch.diag_embed(slack / lam_e - reg), zeros(B, m, p)], dim=-1)
    row2 = torch.cat([qp.A, zeros(B, p, m), (-reg * _eye_like(qp.Q, p)).expand(B, p, p)], dim=-1)
    return torch.cat([row0, row1, row2], dim=-2), lam_e


def _jmatvec(qp: QuadProgram, sol: QPSolution, x: Tensor, transpose: bool) -> Tensor:
    """Apply the true J (or J') without materializing it."""
    n, m = qp.num_vars, qp.num_ineq
    slack = _mv(qp.G, sol.z) - qp.h
    xz, xl, xn = x[:, :n], x[:, n:n + m], x[:, n + m:]
    if not transpose:
        r0 = _mv(qp.Q, xz) + _rmv(qp.G, xl) + _rmv(qp.A, xn)
        r1 = sol.lam * _mv(qp.G, xz) + slack * xl
    else:
        r0 = _mv(qp.Q, xz) + _rmv(qp.G, sol.lam * xl) + _rmv(qp.A, xn)
        r1 = _mv(qp.G, xz) + slack * xl
    r2 = _mv(qp.A, xz)
    return torch.cat([r0, r1, r2], dim=-1)


@full_precision
def qp_kkt_solve_ldl(
    qp: QuadProgram,
    sol: QPSolution,
    rhs: Tensor,
    *,
    transpose: bool,
    refine_iters: int = 2,
    lam_floor: float | None = None,
    reg: float | None = None,
) -> Tensor:
    """Solve J x = rhs (or J' x = rhs) via the LDL' kernels.

    ``rhs`` is the true right-hand side (NOT pre-scaled). Refinement steps
    use true-J matvecs to remove the regularization and lam-floor bias.
    """
    cfg = get_config()
    if lam_floor is None:
        lam_floor = cfg.ldl_lam_floor(qp.Q.dtype)
    if reg is None:
        reg = cfg.ldl_reg(qp.Q.dtype)
    n, m = qp.num_vars, qp.num_ineq

    K, lam_e = _kkt_symmetric(qp, sol, lam_floor, reg)
    L, d = chol.ldl_batched(K)

    def scale_rows(r):  # R^-1 r
        return torch.cat([r[:, :n], r[:, n:n + m] / lam_e, r[:, n + m:]], dim=-1)

    def approx_solve(r):
        if not transpose:
            return chol.ldl_solve_batched(L, d, scale_rows(r))
        return scale_rows(chol.ldl_solve_batched(L, d, r))

    x = approx_solve(rhs)
    for _ in range(refine_iters):
        x = x + approx_solve(rhs - _jmatvec(qp, sol, x, transpose))
    return x


# ---------------------------------------------------------------------------
# Active-set polish.
#
# An f32 interior-point solve terminates with complementarity products
# s_i lam_i ~ sqrt(eps_f32) — that floor propagates into the KKT point and
# dominates gradient error on near-degenerate instances. Fixing the active
# set and re-solving the purely LINEAR KKT equations
#     Q z + G_a' lam_a + A' nu = -q,   G_a z = h_a,   A z = b,   lam_i = 0
# (a in the active set, i inactive) has no complementarity products, so one
# quasi-definite LDL' solve + refinement recovers ~f32-linear accuracy.
# The polish is guarded: it is accepted per instance only when it reduces
# the true KKT residual and keeps lam >= 0 and s >= -tol (a misclassified
# weakly-active set fails the guard and the original point is kept).
# ---------------------------------------------------------------------------


@full_precision
def qp_polish(qp: QuadProgram, sol: QPSolution, *, reg: float | None = None) -> QPSolution:
    """One active-set polish step on a solved batch."""
    B, n, m, p = qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq
    dt = qp.Q.dtype
    if reg is None:
        reg = 1e-11 if dt == torch.float64 else 1e-7
    if m == 0:
        return sol
    s = qp.h - _mv(qp.G, sol.z)
    active = sol.lam > s
    af = active.to(dt)
    Ga = qp.G * af[..., None]
    ha = qp.h * af
    einact = 1.0 - af  # diag: 1 on inactive rows (forces lam_i = 0)

    zeros = qp.Q.new_zeros
    row0 = torch.cat([qp.Q + reg * _eye_like(qp.Q, n), _t(Ga), _t(qp.A)], dim=-1)
    row1 = torch.cat([Ga, -torch.diag_embed(einact + reg), zeros(B, m, p)], dim=-1)
    row2 = torch.cat([qp.A, zeros(B, p, m), (-reg * _eye_like(qp.Q, p)).expand(B, p, p)], dim=-1)
    K = torch.cat([row0, row1, row2], dim=-2)
    rhs = torch.cat([-qp.q, ha, qp.b], dim=-1)

    def k0_matvec(w):
        wz, wl, wn = w[:, :n], w[:, n:n + m], w[:, n + m:]
        r0 = _mv(qp.Q, wz) + _rmv(Ga, wl) + _rmv(qp.A, wn)
        r1 = _mv(Ga, wz) - einact * wl
        r2 = _mv(qp.A, wz)
        return torch.cat([r0, r1, r2], dim=-1)

    if _ldl_fits(qp):
        L, dvec = chol.ldl_batched(K)
        solve = lambda r: chol.ldl_solve_batched(L, dvec, r)
    else:
        lu, piv, _ = torch.linalg.lu_factor_ex(K)
        solve = lambda r: torch.linalg.lu_solve(lu, piv, r[..., None])[..., 0]

    w = solve(rhs)
    for _ in range(2):
        w = w + solve(rhs - k0_matvec(w))

    z_p = w[:, :n]
    lam_p = torch.where(active, w[:, n:n + m], torch.zeros_like(s))
    nu_p = w[:, n + m:]
    pol = QPSolution(z=z_p, lam=lam_p, nu=nu_p)

    s_p = qp.h - _mv(qp.G, z_p)
    hscale = 1.0 + qp.h.abs().amax(dim=-1)
    res_old = kkt_residual(qp, sol).abs().amax(dim=-1)
    res_new = kkt_residual(qp, pol).abs().amax(dim=-1)
    ok = (
        (res_new < res_old)
        & torch.isfinite(w).all(dim=-1)
        & (lam_p.amin(dim=-1) >= -1e-5 * hscale)
        & (s_p.amin(dim=-1) >= -1e-5 * hscale)
    )[:, None]
    return QPSolution(
        z=torch.where(ok, z_p, sol.z),
        lam=torch.where(ok, torch.clamp(lam_p, min=0.0), sol.lam),
        nu=torch.where(ok, nu_p, sol.nu),
    )
