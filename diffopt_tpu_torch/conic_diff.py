"""Conic program implicit differentiation (Agrawal et al. 2019).

Counterpart of ``diffopt_tpu/conic_diff.py``: differentiate the solution map
of ``min c'x s.t. Ax + s = b, s in K`` through the normalized residual map of
the homogeneous self-dual embedding. Batch-first: every function takes
``(B, ...)`` problems and solutions.

With the optimal ``(x, y, s)`` set ``u = x``, ``v = y - s``, ``w = 1``;
``Dpi = DPi_{K*}(v)``; and::

    M = [  0        A' Dpi   c ]
        [ -A      -Dpi + I   b ]
        [ -c'     -b' Dpi    0 ]

* forward: rhs = [dA'pi(v) + dc; -dA u + db; -<dc,u> - <db,pi(v)>];
  dz = M^+ rhs; dx = -(du - x dw), dy = -(Dpi dv - y dw),
  ds = -(Dpi dv - dv - s dw).
* reverse: dz = [dx; Dpi'(dy+ds) - ds; -x'dx - y'dy - s'ds]; g = M'^+ dz;
  with pz = [u; pi(v); 1]: dA = g_m x' - pi(v) g_n', db = g_w pi(v) - g_m,
  dc = g_w x - g_n.

``M`` is square but singular in general. The routes (``method``): a dense
least-squares solve (``lstsq``), ``lu`` and ``qr`` through ``ops/linalg.py``;
the normal equations on the batched Cholesky kernels K4/K5 (``gram``, with a
ridge and refinement in ``residual_dtype``); the matrix-free LSQR
(``lsqr``, ``ops/lsqr.py``); and ``auto``, which takes LSQR once ``dim(M)``
passes ``config.conic_lsqr_threshold`` and ``lstsq`` below it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import cones as _cones
from .ir import ConeProgram, ConeSolution, ConeTangent
from .ops import linalg
from .utils.config import get_config
from .utils.precision import full_precision, residual_dtype

Tensor = torch.Tensor


class ConeForward(NamedTuple):
    dx: Tensor
    dy: Tensor
    ds: Tensor


def _mv(M, v):
    return torch.einsum("bij,bj->bi", M, v)


def _rmv(M, v):
    return torch.einsum("bij,bi->bj", M, v)


@full_precision
def residual_matrix(cp: ConeProgram, sol: ConeSolution) -> Tensor:
    """Materialize M ``(B, n + m + 1, n + m + 1)``."""
    A, b, c = cp.A, cp.b, cp.c
    B, n, m = c.shape[0], cp.num_vars, cp.num_rows
    Dpi = _cones.dpi_dense(cp.cones, sol.y - sol.s)
    eye_m = torch.eye(m, dtype=A.dtype, device=A.device)
    row0 = torch.cat([A.new_zeros(B, n, n), A.transpose(1, 2) @ Dpi, c[:, :, None]], dim=2)
    row1 = torch.cat([-A, -Dpi + eye_m, b[:, :, None]], dim=2)
    row2 = torch.cat([-c[:, None, :], -_rmv(Dpi, b)[:, None, :], A.new_zeros(B, 1, 1)], dim=2)
    return torch.cat([row0, row1, row2], dim=1)


def residual_operator(cp: ConeProgram, sol: ConeSolution):
    """Matrix-free (matvec, rmatvec) for M on ``(B, n + m + 1)`` tensors —
    applies A, A' and a *prepared* DPi (:func:`cones.dpi_operator`: the
    per-block factorizations are computed once) without materializing M."""
    A, b, c = cp.A, cp.b, cp.c
    n, m = cp.num_vars, cp.num_rows
    dpi_a, dpi_r = _cones.dpi_operator(cp.cones, sol.y - sol.s)

    def matvec(z):
        zu, zv, zw = z[:, :n], z[:, n:n + m], z[:, n + m]
        dpi_zv = dpi_a(zv)
        top = _rmv(A, dpi_zv) + c * zw[:, None]
        mid = -_mv(A, zu) - dpi_zv + zv + b * zw[:, None]
        bot = -(c * zu).sum(-1) - (b * dpi_zv).sum(-1)
        return torch.cat([top, mid, bot[:, None]], dim=-1)

    def rmatvec(z):
        zu, zv, zw = z[:, :n], z[:, n:n + m], z[:, n + m]
        # M' = [0, -A', -c; DPi'A, -DPi'+I, -DPi'b; c', b', 0]
        dpi_t = dpi_r(_mv(A, zu) - zv - b * zw[:, None])
        top = -_rmv(A, zv) - c * zw[:, None]
        mid = dpi_t + zv
        bot = (c * zu).sum(-1) + (b * zv).sum(-1)
        return torch.cat([top, mid, bot[:, None]], dim=-1)

    return matvec, rmatvec


def resolve_method(cp: ConeProgram, method: str | None = None) -> str:
    """Size-aware dispatch: ``'auto'`` routes to the matrix-free LSQR once
    ``dim(M) = n + m + 1`` exceeds ``config.conic_lsqr_threshold``, else to
    the dense least-squares solve."""
    if method is None:
        method = get_config().conic_method
    if method == "auto":
        N = cp.num_vars + cp.num_rows + 1
        return "lsqr" if N > get_config().conic_lsqr_threshold else "lstsq"
    return method


def _gram_solve(M: Tensor, rhs: Tensor, refine_iters: int) -> Tensor:
    """Least-squares solve of M x = rhs through the normal equations on the
    Cholesky kernels: (M'M + delta0 (1 + tr(M'M)/N) I) x = M' rhs, with at
    least two refinement passes whose residuals accumulate in
    ``residual_dtype`` (the normal equations square cond(M))."""
    from .ops.cuda import chol

    dt, N = M.dtype, M.shape[-1]
    # the ridge sits above the rounding noise of forming M'M, scale-relative
    delta0 = 1e-12 if dt == torch.float64 else 1e-6
    G = M.transpose(1, 2) @ M
    scale = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[:, None, None] / N
    G = G + delta0 * (1.0 + scale) * torch.eye(N, dtype=dt, device=M.device)
    L = chol.cholesky_batched(G)
    gsolve = lambda r: chol.cholesky_solve_batched(L, _rmv(M, r))
    rdt = residual_dtype(dt)
    Mr, rhsr = M.to(rdt), rhs.to(rdt)
    x = gsolve(rhs).to(rdt)
    for _ in range(max(refine_iters, 2)):
        r = rhsr - _mv(Mr, x)
        x = x + gsolve(r.to(dt)).to(rdt)
    return x.to(dt)


def _solve_system(cp, sol, rhs, method, refine_iters, transpose: bool) -> Tensor:
    """Solve M z = rhs (or M' z = rhs) by ``method`` (see the module note)."""
    method = resolve_method(cp, method)
    if method == "lsqr":
        from .ops.lsqr import lsqr

        mv, rmv = residual_operator(cp, sol)
        if transpose:
            mv, rmv = rmv, mv
        return lsqr(mv, rmv, rhs, rhs.shape[-1], max_iters=get_config().conic_lsqr_iters).x
    M = residual_matrix(cp, sol)
    if transpose:
        M = M.transpose(1, 2)
    if method == "gram":
        return _gram_solve(M, rhs, refine_iters)
    return linalg.solve(M, rhs, method, refine_iters=refine_iters)


def residual_map(cp: ConeProgram, sol: ConeSolution) -> Tensor:
    """The HSDE normalized-residual map N(z) = Q Pi(z) - (Pi(z) - z) at
    z = (x, y - s, 1); N(z*) = 0 at a solution and DN(z) is
    :func:`residual_matrix`."""
    A, b, c = cp.A, cp.b, cp.c
    v = sol.y - sol.s
    piv = _cones.pi(cp.cones, v)
    top = _rmv(A, piv) + c
    mid = -_mv(A, sol.x) + b - (piv - v)
    bot = (-(c * sol.x).sum(-1) - (b * piv).sum(-1))[:, None]
    return torch.cat([top, mid, bot], dim=-1)


@full_precision
def refine_solution(cp: ConeProgram, sol: ConeSolution, *, steps: int = 2, method: str = "auto") -> ConeSolution:
    """Newton refinement of a batch of conic solutions against the HSDE
    residual map — the conic analogue of the QP active-set polish. The
    residual and the iterate live in ``residual_dtype`` (f64) while each
    Newton step is solved in the working dtype; a step is accepted per
    instance only when ||N|| strictly decreases, the homogenizing w stays
    positive and the new point is finite."""
    n, m = cp.num_vars, cp.num_rows
    dt = cp.A.dtype
    rdt = residual_dtype(dt)
    cpr = cp.map(lambda t: t.to(rdt))

    def to_sol(z):
        v = z[:, n:n + m]
        piv = _cones.pi(cp.cones, v)
        return ConeSolution(x=z[:, :n], y=piv, s=piv - v)

    z = torch.cat([sol.x.to(rdt), (sol.y - sol.s).to(rdt), sol.x.new_ones(sol.x.shape[0], 1, dtype=rdt)], dim=-1)
    best_res = torch.linalg.vector_norm(residual_map(cpr, to_sol(z)), dim=-1)
    for _ in range(steps):
        Nz = residual_map(cpr, to_sol(z))
        dz = _solve_system(cp, to_sol(z.to(dt)), Nz.to(dt), method, 0, transpose=False)
        z_new = z - dz.to(rdt)
        w = z_new[:, -1]
        w_ok = w > 0
        z_new = z_new / torch.where(w_ok, w, torch.ones_like(w))[:, None]
        res_new = torch.linalg.vector_norm(residual_map(cpr, to_sol(z_new)), dim=-1)
        ok = (res_new < best_res) & w_ok & torch.isfinite(z_new).all(-1)
        z = torch.where(ok[:, None], z_new, z)
        best_res = torch.where(ok, res_new, best_res)
    return to_sol(z.to(dt))


def _forward_rhs(cp, sol, dcp, vp):
    dA, db, dc = dcp.dA, dcp.db, dcp.dc
    return torch.cat(
        [_rmv(dA, vp) + dc, -_mv(dA, sol.x) + db, (-(dc * sol.x).sum(-1) - (db * vp).sum(-1))[:, None]], dim=-1
    )


def _forward_from(cp, sol, v, dz) -> ConeForward:
    n, m = cp.num_vars, cp.num_rows
    du, dv, dw = dz[:, :n], dz[:, n:n + m], dz[:, n + m]
    dpidv = _cones.dpi_apply(cp.cones, v, dv)
    return ConeForward(
        dx=-(du - sol.x * dw[:, None]),
        dy=-(dpidv - sol.y * dw[:, None]),
        ds=-(dpidv - dv - sol.s * dw[:, None]),
    )


def _reverse_seed(cp, sol, v, dx, dy, ds):
    dy = torch.zeros_like(sol.y) if dy is None else dy
    ds = torch.zeros_like(sol.s) if ds is None else ds
    return torch.cat(
        [
            dx,
            _cones.dpi_rmatvec(cp.cones, v, dy + ds) - ds,
            (-(sol.x * dx).sum(-1) - (sol.y * dy).sum(-1) - (sol.s * ds).sum(-1))[:, None],
        ],
        dim=-1,
    )


def _reverse_from(cp, sol, vp, g) -> ConeTangent:
    """VJP of rhs(dA, db, dc) = dQ.pz with pz = [u; pi(v); 1], including the
    global minus of dsol = -Dphi(M^-1 rhs)."""
    n, m = cp.num_vars, cp.num_rows
    gn, gm, gw = g[:, :n], g[:, n:n + m], g[:, n + m]
    outer = lambda a, b: a[:, :, None] * b[:, None, :]
    return ConeTangent(dA=outer(gm, sol.x) - outer(vp, gn), db=gw[:, None] * vp - gm, dc=gw[:, None] * sol.x - gn)


@full_precision
def forward_differentiate(
    cp: ConeProgram, sol: ConeSolution, dcp: ConeTangent, *, method: str = "auto", refine_iters: int = 0
) -> ConeForward:
    """JVP of the conic solution map along (dA, db, dc)."""
    v = sol.y - sol.s
    rhs = _forward_rhs(cp, sol, dcp, _cones.pi(cp.cones, v))
    dz = _solve_system(cp, sol, rhs, method, refine_iters, transpose=False)
    return _forward_from(cp, sol, v, dz)


@full_precision
def reverse_differentiate(
    cp: ConeProgram,
    sol: ConeSolution,
    dx: Tensor,
    dy: Optional[Tensor] = None,
    ds: Optional[Tensor] = None,
    *,
    method: str = "auto",
    refine_iters: int = 0,
) -> ConeTangent:
    """VJP of the conic solution map for cotangents (dx, dy, ds). Solves with
    the true adjoint M', so that <JVP(d), seed> == <d, VJP(seed)>."""
    v = sol.y - sol.s
    seed = _reverse_seed(cp, sol, v, dx, dy, ds)
    g = _solve_system(cp, sol, seed, method, refine_iters, transpose=True)
    return _reverse_from(cp, sol, _cones.pi(cp.cones, v), g)
