"""Schur-complement reduction for block-arrow (scenario-coupled) systems.

Counterpart of ``diffopt_tpu/parallel/schur.py`` (BASELINE config 5: batches
of scenario QPs coupled through a few first-stage variables). The KKT system of

    min  sum_s [ 1/2 x_s'Q_s x_s + q_s'x_s ] + 1/2 z'Q0 z + q0'z
    s.t. A_s x_s + B_s z = b_s   (dual nu_s)
         G_s x_s <= h_s          (dual lam_s)

is block-arrow: independent per-scenario KKT blocks K_s, a small coupling
block over z, and cross blocks C_s carrying B_s. The port factors the S
blocks of a process in ONE launch of the batched LDL' kernel
(``ops/cuda/chol.py::ldl_batched``, K2) and solves with them in batched
launches of K3 (``ldl_solve_batched``: the c columns of C at once, then each
right-hand side); the local Schur contributions ``C' K^-1 C`` are summed over
the scenario shards of a process group with ``all_reduce``, the c x c
coupling system is solved replicated, and the back-substitution is local.

Batch-first and explicit about placement: every scenario field has the
scenario dimension S first, the coupling fields ``Q0 (c, c)`` and
``q0 (c,)`` have none. ``group`` takes the place of the JAX package's
``axis_name``: with ``group=None`` there is no collective (one process holds
every scenario), with a process group each process holds its shard of the
scenarios and the reductions run over the group.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from ..ir import QuadProgram, _TensorStruct
from ..ops.cuda import chol
from ..utils.precision import full_precision

Tensor = torch.Tensor


def _psum(x: Tensor, group) -> Tensor:
    """Sum of ``x`` over the processes of ``group`` (``x`` itself with no group)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _pmin(x: Tensor, group) -> Tensor:
    """Least ``x`` over the processes of ``group`` (``x`` itself with no group)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


@full_precision
def schur_arrow_solve(
    Kloc: Tensor,
    C: Tensor,
    K0: Tensor,
    rloc: Tensor,
    r0: Tensor,
    group=None,
) -> Tuple[Tensor, Tensor]:
    """Solve the symmetric block-arrow system

        [ blkdiag(Kloc)   C   ] [xloc]   [rloc]
        [ C'              K0  ] [x0  ] = [r0  ]

    with ``Kloc (S, nb, nb)`` quasi-definite local blocks, ``C (S, nb, c)``,
    ``K0 (c, c)``, ``rloc (S, nb)``, ``r0 (c,)``. With ``group``, S is this
    process's shard and the coupling sums are ``all_reduce``d over the group.

    One K2 launch at N = nb and three K3 launches: at (nb, c) for K^-1 C, at
    (nb, 1) for K^-1 rloc and for the back-substitution."""
    L, d = chol.ldl_batched(Kloc)
    KinvC = chol.ldl_solve_batched(L, d, C)  # (S, nb, c)
    Kinvr = chol.ldl_solve_batched(L, d, rloc)  # (S, nb)
    S_sum = _psum(torch.einsum("sic,sid->cd", C, KinvC), group)
    r_sum = _psum(torch.einsum("sic,si->c", C, Kinvr), group)
    x0 = torch.linalg.solve(K0 - S_sum, (r0 - r_sum)[:, None])[:, 0]
    xloc = chol.ldl_solve_batched(L, d, rloc - torch.einsum("sic,c->si", C, x0))
    return xloc, x0


@dataclasses.dataclass(frozen=True)
class TwoStageQP(_TensorStruct):
    """Scenario-coupled QP (see module docstring). Shapes: ``Qs (S, n, n)``,
    ``qs (S, n)``, ``As (S, p, n)``, ``bs (S, p)``, ``Gs (S, m, n)``,
    ``hs (S, m)``, ``Bs (S, p, c)``, ``Q0 (c, c)``, ``q0 (c,)``."""

    Qs: Tensor
    qs: Tensor
    As: Tensor
    bs: Tensor
    Gs: Tensor
    hs: Tensor
    Bs: Tensor
    Q0: Tensor
    q0: Tensor

    @property
    def dims(self):
        S, n = self.qs.shape
        p = self.bs.shape[-1]
        m = self.hs.shape[-1]
        c = self.q0.shape[-1]
        return S, n, m, p, c


class TwoStageSolution(NamedTuple):
    xs: Tensor  # (S, n)
    lams: Tensor  # (S, m)
    nus: Tensor  # (S, p)
    z: Tensor  # (c,)


def to_monolithic(ts: TwoStageQP) -> QuadProgram:
    """Flatten into one big QuadProgram over [x_1..x_S, z] (test oracle): one
    instance, its fields without a batch dimension."""
    S, n, m, p, c = ts.dims
    N = S * n + c
    Q = torch.block_diag(*ts.Qs, ts.Q0)
    q = torch.cat([ts.qs.reshape(-1), ts.q0])
    A = ts.Qs.new_zeros(S * p, N)
    A[:, : S * n] = torch.block_diag(*ts.As)
    A[:, S * n :] = ts.Bs.reshape(S * p, c)
    G = ts.Qs.new_zeros(S * m, N)
    G[:, : S * n] = torch.block_diag(*ts.Gs)
    return QuadProgram(Q=Q, q=q, A=A, b=ts.bs.reshape(-1), G=G, h=ts.hs.reshape(-1))


def _eye(k: int, like: Tensor) -> Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _scenario_kkt_blocks(ts: TwoStageQP, sol: TwoStageSolution, lam_floor, reg):
    """Per-scenario symmetrized KKT blocks K_s over (x_s, lam_s, nu_s), the
    cross blocks C_s (B_s in the nu rows), and the coupling block K0."""
    S, n, m, p, c = ts.dims
    slack = torch.einsum("smn,sn->sm", ts.Gs, sol.xs) - ts.hs
    lam_e = torch.clamp(sol.lams, min=lam_floor)

    nb = n + m + p
    K = ts.Qs.new_zeros(S, nb, nb)
    K[:, :n, :n] = ts.Qs + reg * _eye(n, ts.Qs)
    K[:, :n, n : n + m] = ts.Gs.transpose(-1, -2)
    K[:, n : n + m, :n] = ts.Gs
    K[:, n : n + m, n : n + m] = torch.diag_embed(slack / lam_e - reg)
    K[:, :n, n + m :] = ts.As.transpose(-1, -2)
    K[:, n + m :, :n] = ts.As
    K[:, n + m :, n + m :] = -reg * _eye(p, ts.Qs)

    C = ts.Qs.new_zeros(S, nb, c)
    C[:, n + m :, :] = ts.Bs

    K0 = ts.Q0 + reg * _eye(c, ts.Q0)
    return K, C, K0, lam_e


def _sensitivity_defaults(dt, lam_floor, reg):
    if lam_floor is None:
        lam_floor = 1e-12 if dt == torch.float64 else 1e-6
    if reg is None:
        reg = 1e-11 if dt == torch.float64 else 1e-6
    return lam_floor, reg


@full_precision
def two_stage_forward_sensitivity(
    ts: TwoStageQP,
    sol: TwoStageSolution,
    dts: TwoStageQP,
    *,
    group=None,
    lam_floor: float | None = None,
    reg: float | None = None,
) -> TwoStageSolution:
    """JVP of the coupled solution map along a data perturbation ``dts``,
    computed via the Schur-arrow solve — never materializing the monolithic
    KKT system. With ``group`` the scenarios are sharded over its processes
    and the coupling reduction is an ``all_reduce`` over it."""
    S, n, m, p, c = ts.dims
    lam_floor, reg = _sensitivity_defaults(ts.Qs.dtype, lam_floor, reg)

    K, C, K0, _ = _scenario_kkt_blocks(ts, sol, lam_floor, reg)

    # AK17-style RHS, block-arrow layout. Scenario rows:
    #   r_x  = dQ_s x_s + dq_s + dG_s' lam_s + dA_s' nu_s
    #   r_l  = (dG_s x_s - dh_s)           (pre-divided complementarity row)
    #   r_nu = dA_s x_s + dB_s z - db_s
    # Coupling row: r_z = dQ0 z + dq0 + sum_s dB_s' nu_s   (all_reduce over the group)
    r_x = (
        torch.einsum("sij,sj->si", dts.Qs, sol.xs)
        + dts.qs
        + torch.einsum("smj,sm->sj", dts.Gs, sol.lams)
        + torch.einsum("spj,sp->sj", dts.As, sol.nus)
    )
    r_l = torch.einsum("smj,sj->sm", dts.Gs, sol.xs) - dts.hs
    r_nu = torch.einsum("spj,sj->sp", dts.As, sol.xs) + torch.einsum("spc,c->sp", dts.Bs, sol.z) - dts.bs
    rloc = -torch.cat([r_x, r_l, r_nu], dim=-1)
    r_z_local = _psum(torch.einsum("spc,sp->c", dts.Bs, sol.nus), group)
    r0 = -(dts.Q0 @ sol.z + dts.q0 + r_z_local)

    dloc, dz = schur_arrow_solve(K, C, K0, rloc, r0, group=group)
    return TwoStageSolution(xs=dloc[:, :n], lams=dloc[:, n : n + m], nus=dloc[:, n + m :], z=dz)


@full_precision
def two_stage_reverse_sensitivity(
    ts: TwoStageQP,
    sol: TwoStageSolution,
    dxs: Tensor,
    dz: Tensor,
    *,
    group=None,
    lam_floor: float | None = None,
    reg: float | None = None,
) -> TwoStageQP:
    """VJP of the coupled solution map: data cotangents for primal seeds
    (``dxs`` per scenario, ``dz`` on the coupling variables).

    The symmetrized arrow system K is symmetric, so the adjoint reuses the
    same Schur solve: with J = R K (R rescaling the lam rows), J' g = -seed
    becomes K w = -seed, g_lam = w_lam / lam_e. Cotangents then follow the
    AK17 accumulation per block, plus the coupling blocks:
    dB_s = g_nu_s z' + nu_s g_z', dQ0 = (g_z z' + z g_z')/2, dq0 = g_z. With
    ``group``, dQ0 and dq0 are each process's copy of the replicated
    cotangent (the coupling solve is replicated, not a sum over shards)."""
    S, n, m, p, c = ts.dims
    lam_floor, reg = _sensitivity_defaults(ts.Qs.dtype, lam_floor, reg)

    K, C, K0, lam_e = _scenario_kkt_blocks(ts, sol, lam_floor, reg)
    rloc = -torch.cat([dxs, dxs.new_zeros(S, m + p)], dim=-1)
    wloc, gz = schur_arrow_solve(K, C, K0, rloc, -dz, group=group)
    gx = wloc[:, :n]
    glam = wloc[:, n : n + m] / lam_e
    gnu = wloc[:, n + m :]

    outer = lambda a, b: a[..., :, None] * b[..., None, :]
    xs, lams, nus, z = sol
    return TwoStageQP(
        Qs=0.5 * (outer(gx, xs) + outer(xs, gx)),
        qs=gx,
        As=outer(gnu, xs) + outer(nus, gx),
        bs=-gnu,
        Gs=outer(lams * glam, xs) + outer(lams, gx),
        hs=-lams * glam,
        Bs=outer(gnu, z.expand(S, c)) + outer(nus, gz.expand(S, c)),
        Q0=0.5 * (torch.outer(gz, z) + torch.outer(z, gz)),
        q0=gz,
    )


class TwoStageSolveInfo(NamedTuple):
    iterations: Tensor
    primal_residual: Tensor
    dual_residual: Tensor
    duality_gap: Tensor
    converged: Tensor


@full_precision
def solve_two_stage(
    ts: TwoStageQP,
    *,
    max_iters: int = 50,
    tol: float | None = None,
    reg: float | None = None,
    group=None,
) -> Tuple[TwoStageSolution, TwoStageSolveInfo]:
    """Interior-point solve of the coupled two-stage QP where every Newton
    step is a :func:`schur_arrow_solve` — per-scenario LDL' factorizations
    (K2 / K3 on the card), the coupling sums reduced over ``group``, no
    monolithic system. With ``group`` the scenarios are sharded over its
    processes: BASELINE config 5's "10^5 QPs" solver.

    Condensed per-scenario blocks over (x_s, nu_s) (inequalities eliminated
    through their complementarity rows as in ``solvers/qp.py``), coupling
    variable z replicated. Each body factors its blocks twice, once for the
    predictor and once for the corrector, as the JAX package does. The loop
    ends when the global residuals and gap are under ``tol`` or an update
    goes non-finite (the iterate is then kept, by select); each body costs
    one device-to-host copy of that flag, counted in
    ``solve_two_stage.host_syncs``. The stopping test is global: every
    process of ``group`` stops on the same body.

    The result is the best iterate of the run: the one with the least of the
    largest of its primal residual, dual residual and mean complementarity,
    the three quantities of the stopping test. Where the loop converges that
    is its last iterate, as in the JAX package, which returns the last one
    in every case. They differ past a breakdown. Once the largest lam/s
    passes about 1/eps (some 20 bodies in f64 at the benchmark's shape and
    S = 100,000, 11-14 in f32), the unpivoted LDL' of a block loses its
    inertia (a pivot of the wrong sign, or zero), and the later bodies leave
    the central path. The update goes non-finite, and the loop stops, only
    where rounding leaves a pivot exactly zero; elsewhere it runs on to
    ``max_iters``."""
    S, n, m, p, c = ts.dims
    dt, dev = ts.Qs.dtype, ts.Qs.device
    if tol is None:
        tol = 1e-9 if dt == torch.float64 else 5e-6
    if reg is None:
        reg = 1e-11 if dt == torch.float64 else 1e-7
    psum = lambda x: _psum(x, group)
    ones = lambda *shape: torch.ones(*shape, dtype=dt, device=dev)
    zeros = lambda *shape: torch.zeros(*shape, dtype=dt, device=dev)
    Qs, qs, As, bs, Gs, hs, Bs, Q0, q0 = ts.tensors()

    nb = n + p
    # the blocks' constant parts: the (x, nu) off-diagonal blocks, the -reg diagonal, C and K0
    K_base = zeros(S, nb, nb)
    K_base[:, :n, n:] = As.transpose(-1, -2)
    K_base[:, n:, :n] = As
    K_base[:, n:, n:] = -reg * _eye(p, Qs)
    C = zeros(S, nb, c)
    C[:, n:, :] = Bs
    K0 = Q0 + reg * _eye(c, Q0)
    Qreg = Qs + reg * _eye(n, Qs)

    def residuals(xs, z, nus, lams, s):
        rd = (
            torch.einsum("sij,sj->si", Qs, xs)
            + qs
            + torch.einsum("smi,sm->si", Gs, lams)
            + torch.einsum("spi,sp->si", As, nus)
        )
        rz = Q0 @ z + q0 + psum(torch.einsum("spc,sp->c", Bs, nus))
        rpe = torch.einsum("spi,si->sp", As, xs) + torch.einsum("spc,c->sp", Bs, z) - bs
        rpi = torch.einsum("smi,si->sm", Gs, xs) + s - hs
        return rd, rz, rpe, rpi

    def build_blocks(lams, s):
        K = K_base.clone()
        K[:, :n, :n] = Qreg + torch.einsum("smi,sm,smj->sij", Gs, lams / s, Gs)
        return K

    def solve_newton(K, rhs_x, rhs_z, rhs_nu, lams, s, rpi, rc):
        # eliminate (ds, dlam): rhs_x += G'((rc - lam*rpi)/s)
        rx = rhs_x + torch.einsum("smi,sm->si", Gs, (rc - lams * rpi) / s)
        dloc, dz = schur_arrow_solve(K, C, K0, torch.cat([rx, rhs_nu], dim=-1), rhs_z, group=group)
        dxs, dnus = dloc[:, :n], dloc[:, n:]
        ds = -rpi - torch.einsum("smi,si->sm", Gs, dxs)
        dlams = -(rc + lams * ds) / s
        return dxs, dz, dnus, dlams, ds

    def step_len(v, dv, frac):
        ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
        amax = _pmin(ratio.amin(), group)
        return torch.clamp(frac * amax, max=1.0)

    count_m = psum(torch.tensor(float(S * m), dtype=dt, device=dev))

    # init
    rd0, rz0, rpe0, rpi0 = residuals(zeros(S, n), zeros(c), zeros(S, p), zeros(S, m), zeros(S, m))
    xs, z, nus, _, _ = solve_newton(
        build_blocks(ones(S, m), ones(S, m)), -rd0, -rz0, -rpe0, ones(S, m), ones(S, m), rpi0, -ones(S, m)
    )
    s0 = hs - torch.einsum("smi,si->sm", Gs, xs)
    smin = _pmin(s0.amin(), group)
    s = s0 + torch.clamp(-smin * 1.5, min=0.0) + 1.0
    lams = ones(S, m)

    it = 0
    best, best_merit = (xs, z, nus, lams, s), torch.tensor(float("inf"), dtype=dt, device=dev)
    for it in range(1, max_iters + 1):
        rd, rz, rpe, rpi = residuals(xs, z, nus, lams, s)
        mu = psum((s * lams).sum()) / count_m
        K = build_blocks(lams, s)
        # predictor
        dxa, dza, dna, dla, dsa = solve_newton(K, -rd, -rz, -rpe, lams, s, rpi, s * lams)
        ap = step_len(s, dsa, 1.0)
        ad = step_len(lams, dla, 1.0)
        mu_aff = psum(((s + ap * dsa) * (lams + ad * dla)).sum()) / count_m
        sig = torch.clamp((mu_aff / torch.clamp(mu, min=1e-300)) ** 3, 0.0, 1.0)
        rc = s * lams + dsa * dla - sig * mu
        # corrector: the same blocks, factored again inside the Schur solve
        dxs, dz, dnus, dlams, ds = solve_newton(K, -rd, -rz, -rpe, lams, s, rpi, rc)
        alpha = torch.minimum(step_len(s, ds, 0.99), step_len(lams, dlams, 0.99))
        xs_n = xs + alpha * dxs
        z_n = z + alpha * dz
        nus_n = nus + alpha * dnus
        lams_n = lams + alpha * dlams
        s_n = s + alpha * ds
        finite = (torch.isfinite(xs_n).all() & torch.isfinite(s_n).all()).to(dt)
        # every process freezes together (alpha is already the least over the group; this syncs the NaN guard)
        finite = _pmin(finite, group) > 0
        xs = torch.where(finite, xs_n, xs)
        z = torch.where(finite, z_n, z)
        nus = torch.where(finite, nus_n, nus)
        lams = torch.where(finite, lams_n, lams)
        s = torch.where(finite, s_n, s)
        rd, rz, rpe, rpi = residuals(xs, z, nus, lams, s)
        pres = torch.sqrt(psum((rpe**2).sum() + (rpi**2).sum()))
        dres = torch.sqrt(psum((rd**2).sum()) + (rz**2).sum())
        mu_n = psum((s * lams).sum()) / count_m
        # every process holds the same global residuals, so they keep the same best iterate
        merit = torch.maximum(torch.maximum(pres, dres), mu_n)
        better = merit < best_merit
        best = tuple(torch.where(better, new, old) for new, old in zip((xs, z, nus, lams, s), best))
        best_merit = torch.where(better, merit, best_merit)
        done = ((pres < tol) & (dres < tol) & (mu_n < tol)) | ~finite
        solve_two_stage.host_syncs += 1
        if bool(done):
            break

    xs, z, nus, lams, s = best
    rd, rz, rpe, rpi = residuals(xs, z, nus, lams, s)
    pres = torch.sqrt(psum((rpe**2).sum() + (rpi**2).sum()))
    dres = torch.sqrt(psum((rd**2).sum()) + (rz**2).sum())
    gap = psum((s * lams).sum())
    info = TwoStageSolveInfo(
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        primal_residual=pres,
        dual_residual=dres,
        duality_gap=gap,
        converged=(pres < 10 * tol) & (dres < 10 * tol) & (gap / count_m < 100 * tol),
    )
    return TwoStageSolution(xs=xs, lams=lams, nus=nus, z=z), info


solve_two_stage.host_syncs = 0
