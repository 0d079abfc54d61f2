"""Batched conic solver: Douglas-Rachford splitting on the homogeneous
self-dual embedding (SCS), and the diagnostics of the conic solvers.
Counterpart of ``diffopt_tpu/solvers/conic.py``.

With the skew-symmetric ``(n + m + 1)^2`` matrix::

    Q = [ 0   A'  c ]
        [-A   0   b ]
        [-c' -b'  0 ]

each iteration is ``ut = (I + Q)^-1 (u + v)``, over-relaxed by alpha,
``u = Pi_C(ut_r - v)`` with C = R^n x K* x R+, ``v = v - ut_r + u``, and the
solution is recovered as ``x = u_x / tau, y = u_y / tau, s = v_y / tau``.
``(I + Q)`` is constant, so its inverse is formed once (``torch.linalg.inv``
of a small matrix, as the JAX module's ``jnp.linalg.inv``) and every
iteration is one batched matrix-vector product and a cone projection. Written
batch-first: the JAX module's ``vmap`` of a per-instance ``while_loop``, with
an instance that is done keeping its state by select.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import cones as _cones
from ..ir import ConeProgram, ConeSolution
from ..utils.config import get_config
from ..utils.precision import full_precision

Tensor = torch.Tensor


class ConicSolveInfo(NamedTuple):
    iterations: Tensor  # int32, per instance
    primal_residual: Tensor
    dual_residual: Tensor
    gap: Tensor
    converged: Tensor  # bool


def _build_Q(cp: ConeProgram) -> Tensor:
    """The embedding's skew-symmetric matrix, ``(B, n + m + 1, n + m + 1)``."""
    A, b, c = cp.A, cp.b, cp.c
    B, m, n = A.shape
    z = lambda r, k: A.new_zeros(B, r, k)
    row0 = torch.cat([z(n, n), A.transpose(1, 2), c[:, :, None]], dim=2)
    row1 = torch.cat([-A, z(m, m), b[:, :, None]], dim=2)
    row2 = torch.cat([-c[:, None, :], -b[:, None, :], z(1, 1)], dim=2)
    return torch.cat([row0, row1, row2], dim=1)


def _proj_C(cp: ConeProgram, u: Tensor) -> Tensor:
    """Project onto C = R^n x K* x R+ (the u-space cone of the embedding)."""
    n, m = cp.num_vars, cp.num_rows
    return torch.cat([u[:, :n], _cones.pi(cp.cones, u[:, n:n + m]), torch.clamp(u[:, n + m:], min=0.0)], dim=-1)


def _ruiz_scales(cp: ConeProgram, iters: int = 10):
    """Ruiz equilibration scales (D rows, E cols) of each instance's A, block-uniform on non-polyhedral
    cone rows so that s in K is preserved (SCS-style scaling)."""
    A = cp.A.abs()
    B, m, n = A.shape
    gid = np.zeros(m, np.int64)
    g = 0
    for kind, off, dim in cp.cones.offsets():
        if kind in ("zero", "nonneg", "nonpos"):
            gid[off:off + dim] = np.arange(g, g + dim)
            g += dim
        else:
            gid[off:off + dim] = g
            g += 1
    gid = torch.as_tensor(gid, device=A.device).expand(B, m)
    D = A.new_ones(B, m)
    E = A.new_ones(B, n)
    for _ in range(iters):
        rnorm = (D[:, :, None] * A * E[:, None, :]).amax(2)
        gmax = A.new_zeros(B, g).scatter_reduce(1, gid, rnorm, reduce="amax", include_self=True)
        D = D / torch.sqrt(torch.clamp(gmax.gather(1, gid), min=1e-8))
        cnorm = (D[:, :, None] * A * E[:, None, :]).amax(1)
        E = E / torch.sqrt(torch.clamp(cnorm, min=1e-8))
    return D, E


def _aa_extrapolate(X: Tensor, F: Tensor, x: Tensor, f: Tensor, reg: float = 1e-10) -> Tensor:
    """Type-II Anderson extrapolation from rolling histories ``(B, 2N, mem)`` (columns oldest to newest) of
    iterates X and fixed-point residuals F at the current ``(x, f)``: ``x + f - (dX + dF) theta`` with
    theta from the small regularised least-squares problem."""
    dF = F[:, :, 1:] - F[:, :, :-1]
    dX = X[:, :, 1:] - X[:, :, :-1]
    G = dF.transpose(1, 2) @ dF + reg * torch.eye(dF.shape[2], dtype=X.dtype, device=X.device)
    theta = torch.linalg.solve(G, (dF.transpose(1, 2) @ f[:, :, None]))[:, :, 0]
    return x + f - ((dX + dF) @ theta[:, :, None])[:, :, 0]


def _metrics(cp: ConeProgram, x, y, s):
    nrm = lambda t: torch.linalg.vector_norm(t, dim=-1)
    pres = nrm(torch.einsum("bij,bj->bi", cp.A, x) + s - cp.b) / (1.0 + nrm(cp.b))
    dres = nrm(torch.einsum("bij,bi->bj", cp.A, y) + cp.c) / (1.0 + nrm(cp.c))
    pobj = (cp.c * x).sum(-1)
    dobj = -(cp.b * y).sum(-1)
    gap = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
    return pres, dres, gap


@full_precision
def solve_batched(
    cp: ConeProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    alpha: float | None = None,
    check_every: int = 25,
    equilibrate: bool = False,
    accel: bool = False,
) -> Tuple[ConeSolution, ConicSolveInfo]:
    """Solve a ``(B, ...)`` batch by DR splitting. ``max_iters`` / ``tol`` / ``alpha`` (the
    over-relaxation) default from the active config; ``tol`` is dtype-aware (an f32 ``tol`` is raised to
    ``dr_tol_f32``). Convergence is tested every ``check_every`` iterations, and ``info.iterations`` is
    per instance. ``equilibrate`` applies SCS-style Ruiz scaling and re-checks the residuals on the
    original data (converged at 100 tol); ``accel`` takes a safeguarded type-II Anderson step when its
    fixed-point residual beats the plain step's. Each check costs one device-to-host copy, counted in
    ``solve_batched.host_syncs``."""
    cfg = get_config()
    dt = cp.A.dtype
    max_iters = cfg.dr_max_iters if max_iters is None else max_iters
    if tol is None:
        tol = cfg.dr_tol(dt)
    elif dt != torch.float64:
        tol = max(tol, cfg.dr_tol_f32)
    alpha = cfg.dr_relaxation if alpha is None else alpha
    kw = dict(max_iters=max_iters, tol=tol, alpha=alpha, check_every=check_every, accel=accel)
    if equilibrate:
        D, E = _ruiz_scales(cp)
        cp_s = ConeProgram(A=D[:, :, None] * cp.A * E[:, None, :], b=D * cp.b, c=E * cp.c, cones=cp.cones)
        sol_s, info = solve_batched(cp_s, equilibrate=False, **kw)
        sol = ConeSolution(x=E * sol_s.x, y=D * sol_s.y, s=sol_s.s / D)
        pres, dres, gap = _metrics(cp, sol.x, sol.y, sol.s)
        conv = (pres < 100 * tol) & (dres < 100 * tol) & (gap < 100 * tol)
        return sol, ConicSolveInfo(info.iterations, pres, dres, gap, conv)

    B, m, n = cp.A.shape
    N = n + m + 1
    dev = cp.A.device
    IQinv = torch.linalg.inv(torch.eye(N, dtype=dt, device=dev) + _build_Q(cp))
    u = cp.A.new_zeros(B, N)
    u[:, -1] = 1.0
    v = u.clone()

    def recover(u, v):
        tau = torch.clamp(u[:, -1:], min=1e-12)
        return u[:, :n] / tau, u[:, n:n + m] / tau, v[:, n:n + m] / tau

    def dr_map(z):
        u, v = z[:, :N], z[:, N:]
        ut = torch.einsum("bij,bj->bi", IQinv, u + v)
        ut_r = alpha * ut + (1 - alpha) * u
        u_new = _proj_C(cp, ut_r - v)
        return torch.cat([u_new, v - ut_r + u_new], dim=-1)

    mem = 5
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    z = torch.cat([u, v], dim=-1)
    while True:
        active = ~done & (it < max_iters)
        solve_batched.host_syncs += 1
        if not bool(active.any()):
            break
        z0 = z
        if not accel:
            for _ in range(check_every):
                z = dr_map(z)
        else:
            X = z[:, :, None].repeat(1, 1, mem)
            F = torch.zeros_like(X)
            for _ in range(check_every):
                gz = dr_map(z)
                f = gz - z
                X = torch.cat([X[:, :, 1:], z[:, :, None]], dim=2)
                F = torch.cat([F[:, :, 1:], f[:, :, None]], dim=2)
                z_aa = _aa_extrapolate(X, F, z, f)
                g_aa = dr_map(z_aa)
                take = torch.linalg.vector_norm(g_aa - z_aa, dim=-1) < torch.linalg.vector_norm(f, dim=-1)
                z = torch.where(take[:, None], g_aa, gz)
        z = torch.where(active[:, None], z, z0)  # an instance that is done keeps its state
        pres, dres, gap = _metrics(cp, *recover(z[:, :N], z[:, N:]))
        done = done | (active & (pres < tol) & (dres < tol) & (gap < tol))
        it = torch.where(active, it + check_every, it)

    x, y, s = recover(z[:, :N], z[:, N:])
    pres, dres, gap = _metrics(cp, x, y, s)
    conv = (pres < 10 * tol) & (dres < 10 * tol) & (gap < 10 * tol)
    return ConeSolution(x=x, y=y, s=s), ConicSolveInfo(it, pres, dres, gap, conv)


solve_batched.host_syncs = 0


def solve(cp: ConeProgram, **kw) -> Tuple[ConeSolution, ConicSolveInfo]:
    """:func:`solve_batched` for one instance (fields without a batch dimension) or a batch."""
    if cp.c.ndim == 2:
        return solve_batched(cp, **kw)
    sol, info = solve_batched(cp.map(lambda t: t[None]), **kw)
    return sol.map(lambda t: t[0]), ConicSolveInfo(*(t[0] for t in info))
