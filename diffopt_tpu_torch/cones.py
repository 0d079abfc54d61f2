"""Cone specifications and projection calculus.

Counterpart of ``diffopt_tpu/cones.py``. A :class:`ConeSpec` is the static
row layout of the cone K; the projections Pi and their derivatives DPi act on
the **dual cone** of each constraint set, as the conic residual map uses
``v = y - s`` projected onto K*. Every function is batch-first: ``v`` is
``(..., m)`` with the blocks along the last dimension.

Supported (MOI set -> kind):

* ``zero``    — Zeros;        dual = Reals:  Pi(v) = v,       DPi = I
* ``nonneg``  — Nonnegatives; dual = Nonneg: Pi = max(v, 0),  DPi = diag(v >= 0)
* ``nonpos``  — Nonpositives; dual = Nonpos: Pi = min(v, 0),  DPi = diag(v <= 0)
* ``soc``     — SecondOrderCone (self-dual): closed-form 2x2 block formula
* ``rsoc``    — RotatedSecondOrderCone (self-dual): orthogonal rotation of soc
* ``psd``     — PSD cone in **svec** coordinates (self-dual): eigh-based
* ``exp`` / ``dual_exp`` — ExponentialCone and its dual (dim 3): Newton on
  the projection's optimality conditions (Friberg 2021), 60 bisection-guarded
  steps on the static bracket [-30, 30]; the dual side by Moreau's identity
* ``pow`` / ``dual_pow`` — PowerCone(alpha) and its dual (dim 3): Newton in
  the radius (Hien 2015), the dual side by Moreau's identity

DPi of the four 3-dim kinds is the closed-form implicit derivative of the
projection's KKT system at its solution (Hien 2015, Thm 4.2), built as a
dense ``(..., 3, 3)`` block: never a derivative through the Newton loop. The
exp blocks' DPi is not symmetric, so :func:`dpi_rmatvec` applies its
transpose. Autograd reaches a projection through a
``torch.autograd.Function`` whose ``backward`` and ``jvp`` use that block.

PSD convention: rows are the *scaled* triangle (svec) — upper triangle,
column-by-column, off-diagonal entries multiplied by sqrt(2) — so the
Euclidean inner product equals the Frobenius product and the cone is
self-dual with a symmetric DPi. :func:`moi_tri_to_svec` /
:func:`svec_to_moi_tri` convert data expressed in MOI triangle coordinates.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_KINDS = (
    "zero", "nonneg", "nonpos", "soc", "rsoc", "psd", "exp", "dual_exp",
    "pow", "dual_pow",
)
_NONSYMMETRIC = ("exp", "dual_exp", "pow", "dual_pow")


class ConeSpec:
    """Static, hashable ordered list of cone blocks.

    Blocks are ``(kind, dim)`` or, for parameterized cones (``pow`` /
    ``dual_pow``), ``(kind, dim, alpha)``. ``dim`` is the number of *rows*
    the block spans (for ``psd`` the triangle length ``d(d+1)/2``, not the
    matrix side). Blocks are normalized to ``(kind, dim, param)`` with
    ``param=None`` for unparameterized kinds.
    """

    __slots__ = ("blocks",)

    def __init__(self, blocks: Sequence[Tuple]):
        norm = []
        for blk in blocks:
            if len(blk) == 2:
                k, d = blk
                prm = None
            else:
                k, d, prm = blk
                prm = None if prm is None else float(prm)
            norm.append((str(k), int(d), prm))
        blocks = tuple(norm)
        for k, d, prm in blocks:
            if k not in _KINDS:
                raise ValueError(f"unknown cone kind {k!r}; expected one of {_KINDS}")
            if k == "psd":
                side = _tri_side(d)
                if side * (side + 1) // 2 != d:
                    raise ValueError(f"psd block dim {d} is not a triangle number")
            if k in _NONSYMMETRIC and d != 3:
                raise ValueError(f"{k} cone blocks must have dim 3, got {d}")
            if k == "rsoc" and d < 2:
                raise ValueError(f"rsoc block dim must be >= 2, got {d}")
            if k in ("pow", "dual_pow"):
                if prm is None or not (0.0 < prm < 1.0):
                    raise ValueError(f"{k} blocks need an exponent in (0,1): ('{k}', 3, alpha)")
            elif prm is not None:
                raise ValueError(f"{k} blocks take no parameter")
        self.blocks = blocks

    @property
    def total_dim(self) -> int:
        return sum(d for _, d, _ in self.blocks)

    def offsets(self):
        """Yield (kind, start, dim) for each block."""
        off = 0
        for k, d, _ in self.blocks:
            yield k, off, d
            off += d

    def offsets_params(self):
        """Yield (kind, start, dim, param) for each block."""
        off = 0
        for k, d, prm in self.blocks:
            yield k, off, d, prm
            off += d

    def __hash__(self):
        return hash(self.blocks)

    def __eq__(self, other):
        return isinstance(other, ConeSpec) and self.blocks == other.blocks

    def __repr__(self):
        return f"ConeSpec({list(self.blocks)})"


def _tri_side(tri_len: int) -> int:
    """Matrix side d such that d(d+1)/2 == tri_len (rounded)."""
    return int(round(((8 * tri_len + 1) ** 0.5 - 1) / 2))


def _tri_order(d: int) -> np.ndarray:
    """Static (row, col) index list of the upper triangle, column-by-column:
    (0,0),(0,1),(1,1),(0,2),... — the MOI/SCS ordering."""
    return np.array([(r, c) for c in range(d) for r in range(c + 1)]).reshape(-1, 2)


def _svec_scale_np(d: int) -> np.ndarray:
    order = _tri_order(d)
    return np.where(order[:, 0] == order[:, 1], 1.0, math.sqrt(2.0))


def _svec_scale(d: int, like: Tensor) -> Tensor:
    """Per-entry svec scaling: 1 on the diagonal, sqrt(2) off-diagonal."""
    return torch.as_tensor(_svec_scale_np(d), dtype=like.dtype, device=like.device)


def svec_to_sym(v: Tensor) -> Tensor:
    """svec ``(..., tri)`` (off-diagonal scaled by sqrt2) -> symmetric ``(..., d, d)``."""
    d = _tri_side(v.shape[-1])
    order = _tri_order(d)
    index = np.zeros((d, d), dtype=np.int64)
    index[order[:, 0], order[:, 1]] = np.arange(len(order))
    index[order[:, 1], order[:, 0]] = np.arange(len(order))
    vals = v / _svec_scale(d, v)
    idx = torch.as_tensor(index.reshape(-1), device=v.device)
    return vals[..., idx].reshape(v.shape[:-1] + (d, d))


def sym_to_svec(X: Tensor) -> Tensor:
    """Symmetric ``(..., d, d)`` -> svec ``(..., tri)`` (off-diagonal scaled by sqrt2)."""
    d = X.shape[-1]
    order = _tri_order(d)
    r = torch.as_tensor(order[:, 0], device=X.device)
    c = torch.as_tensor(order[:, 1], device=X.device)
    return X[..., r, c] * _svec_scale(d, X)


def moi_tri_to_svec(v: Tensor) -> Tensor:
    """MOI unscaled triangle coordinates -> svec (multiply off-diag by sqrt2)."""
    return v * _svec_scale(_tri_side(v.shape[-1]), v)


def svec_to_moi_tri(v: Tensor) -> Tensor:
    """svec -> MOI unscaled triangle coordinates."""
    return v / _svec_scale(_tri_side(v.shape[-1]), v)


def moi_tri_seed_to_svec(v: Tensor) -> Tensor:
    """A *perturbation seed* on MOI unscaled-triangle rows -> svec under MOI's
    symmetric-half convention (an off-diagonal triangle value denotes HALF
    that value in each mirrored entry): net off-diagonal factor 1/sqrt(2)."""
    scale = _svec_scale(_tri_side(v.shape[-1]), v)
    return v * torch.where(scale > 1.0, 0.5 * scale, scale)


# ---------------------------------------------------------------------------
# Per-kind projection Pi onto the dual cone and its derivative, batched over
# the leading dimensions of the block ``(..., d)``.
# ---------------------------------------------------------------------------


def _pi_soc(v: Tensor) -> Tensor:
    t, x = v[..., 0], v[..., 1:]
    nx = torch.linalg.vector_norm(x, dim=-1)
    # three regimes: inside (nx <= t) -> v; polar (nx <= -t) -> 0; else boundary
    alpha = torch.clamp((t + nx) / 2.0, min=0.0)
    safe_nx = torch.where(nx > 0, nx, torch.ones_like(nx))
    proj_x = (alpha / safe_nx)[..., None] * x
    inside = nx <= t
    out_t = torch.where(inside, t, alpha)
    out_x = torch.where(inside[..., None], x, proj_x)
    return torch.cat([out_t[..., None], out_x], dim=-1)


def _dpi_soc_dense(v: Tensor) -> Tensor:
    """Dense DPi ``(..., d, d)`` for the second-order cone at v = (t, x)."""
    d = v.shape[-1]
    t, x = v[..., 0], v[..., 1:]
    nx = torch.linalg.vector_norm(x, dim=-1)
    safe_nx = torch.where(nx > 0, nx, torch.ones_like(nx))
    xb = x / safe_nx[..., None]
    eye = torch.eye(d, dtype=v.dtype, device=v.device)
    # boundary case: 0.5 [[1, xb'], [xb, ((nx + t)/nx) I - (t/nx) xb xb']]
    blk = torch.zeros(v.shape[:-1] + (d, d), dtype=v.dtype, device=v.device)
    blk[..., 0, 0] = 0.5
    blk[..., 0, 1:] = 0.5 * xb
    blk[..., 1:, 0] = 0.5 * xb
    lower = ((nx + t) / (2 * safe_nx))[..., None, None] * torch.eye(d - 1, dtype=v.dtype, device=v.device) - (
        t / (2 * safe_nx)
    )[..., None, None] * (xb[..., :, None] * xb[..., None, :])
    blk[..., 1:, 1:] = lower
    inside = (nx <= t)[..., None, None]
    polar = (nx <= -t)[..., None, None]
    return torch.where(inside, eye.expand_as(blk), torch.where(polar, torch.zeros_like(blk), blk))


def _rsoc_rotation(d: int, like: Tensor) -> Tensor:
    """The symmetric orthogonal T carrying K_rsoc onto K_soc."""
    T = np.eye(d)
    isq = 1.0 / np.sqrt(2.0)
    T[0, 0] = T[0, 1] = T[1, 0] = isq
    T[1, 1] = -isq
    return torch.as_tensor(T, dtype=like.dtype, device=like.device)


def _pi_rsoc(v: Tensor) -> Tensor:
    T = _rsoc_rotation(v.shape[-1], v)
    return _pi_soc(v @ T) @ T  # T symmetric: v @ T == T @ v for vectors


def _dpi_rsoc_dense(v: Tensor) -> Tensor:
    T = _rsoc_rotation(v.shape[-1], v)
    return T @ _dpi_soc_dense(v @ T) @ T


def _pi_psd_tri(v: Tensor) -> Tensor:
    from .ops.smalleig import eigh_small

    w, U = eigh_small(svec_to_sym(v))
    wp = torch.clamp(w, min=0.0)
    return sym_to_svec((U * wp[..., None, :]) @ U.transpose(-1, -2))


def _psd_kmat(w: Tensor) -> Tensor:
    """Entrywise derivative weights K_ij = (wi+ + wj+) / (|wi| + |wj|)."""
    wp = torch.clamp(w, min=0.0)
    num = wp[..., :, None] + wp[..., None, :]
    den = w.abs()[..., :, None] + w.abs()[..., None, :]
    safe = torch.where(den > 0, den, torch.ones_like(den))
    return torch.where(den > 0, num / safe, torch.full_like(den, 0.5))


def _psd_eigs(v: Tensor):
    """(U, U', K) of the PSD projection's derivative at svec block v."""
    from .ops.smalleig import eigh_small

    w, U = eigh_small(svec_to_sym(v))
    return U, U.transpose(-1, -2), _psd_kmat(w)


def _dpi_psd_apply_eigs(U, Ut, K, dv: Tensor) -> Tensor:
    """DPi_psd @ dv from a prepared decomposition; dv ``(..., [k,] tri)``
    where the optional k axis sits between the batch and the block."""
    extra = dv.ndim - (U.ndim - 1)
    if extra:
        U, Ut, K = (t.unsqueeze(-3) for t in (U, Ut, K))
    inner = Ut @ svec_to_sym(dv) @ U
    return sym_to_svec(U @ (K * inner) @ Ut)


def _dpi_psd_tri_apply(v: Tensor, dv: Tensor) -> Tensor:
    return _dpi_psd_apply_eigs(*_psd_eigs(v), dv)


def _dpi_psd_tri_dense(v: Tensor) -> Tensor:
    """Dense DPi ``(..., tri, tri)``: one eigendecomposition for the block,
    then the congruence U'(.)U per basis column."""
    tri = v.shape[-1]
    U, Ut, K = _psd_eigs(v)
    basis = torch.eye(tri, dtype=v.dtype, device=v.device).expand(v.shape[:-1] + (tri, tri))
    cols = _dpi_psd_apply_eigs(U, Ut, K, basis)  # (..., k, tri): column k in row k
    return cols.transpose(-1, -2)


# --- exponential cone -----------------------------------------------------------
# K_exp = cl{(x,y,z): y>0, y exp(x/y) <= z}; its dual K_exp* = cl{(u,v,w): u<0, -u exp(v/u) <= e w}.
# Pi_{K*}(v) = v + Pi_K(-v) (Moreau).


def _exp_regions(v0: Tensor):
    """(in_cone, in_polar, special) of the exp-cone projection at ``v0 (..., 3)``."""
    r, s, t = v0.unbind(-1)
    one = torch.ones_like(s)
    in_cone = ((s > 0) & (s * torch.exp(r / torch.where(s > 0, s, one)) <= t)) | (
        (r <= 0) & (s.abs() <= 1e-300) & (t >= 0)
    )
    u, w = -r, -t
    in_polar = ((u > 0) & (u * torch.exp(-s / torch.where(u > 0, u, one)) <= math.e * w)) | (
        (u <= 0) & (-s <= 0) & (w >= 0)
    )
    special = (r <= 0) & (s <= 0)
    return in_cone, in_polar, special


def _proj_exp_value(v0: Tensor) -> Tensor:
    """Projection of ``v0 (..., 3)`` onto the primal exponential cone: the point itself inside it, 0 in
    the polar cone, (r, 0, max(t, 0)) where r, s <= 0, else the boundary point from 60 bisection-guarded
    Newton steps in rho on the static bracket [-30, 30]."""
    r, s, t = v0.unbind(-1)
    in_cone, in_polar, special = _exp_regions(v0)
    lo = torch.full_like(r, -30.0)
    hi = torch.full_like(r, 30.0)
    rho = 0.5 * (lo + hi)
    one = torch.ones_like(r)
    for _ in range(60):
        erho, emrho = torch.exp(rho), torch.exp(-rho)
        f = ((rho - 1) * r + s) * erho - (r - rho * s) * emrho - (rho * (rho - 1) + 1) * t
        df = (rho * r + s) * erho + (r - (rho - 1) * s) * emrho - (2 * rho - 1) * t
        neg = f < 0
        lo = torch.where(neg, rho, lo)
        hi = torch.where(neg, hi, rho)
        newton = rho - f / torch.where(df.abs() > 1e-30, df, one)
        ok = (newton > lo) & (newton < hi)
        rho = torch.where(ok, newton, 0.5 * (lo + hi))
    vp = torch.clamp((rho - 1) * r + s, min=1e-300) / (rho * (rho - 1) + 1)
    gen = torch.stack([rho * vp, vp, vp * torch.exp(rho)], dim=-1)
    heur = torch.stack([r, torch.zeros_like(r), torch.clamp(t, min=0.0)], dim=-1)
    out = torch.where(special[..., None], heur, gen)
    out = torch.where(in_polar[..., None], torch.zeros_like(out), out)
    return torch.where(in_cone[..., None], v0, out)


def _exp_jvp(v0: Tensor, p: Tensor, dv: Tensor) -> Tensor:
    """The implicit derivative of the exp-cone projection applied to ``dv``: on the boundary, the KKT
    system of the projection, [[I + mu H, grad g], [grad g', 0]] [dp; dmu] = [dv; 0] with the rank-1 H of
    g(p) = y e^(x/y) - z inverted by Sherman-Morrison, in the scale-invariant form of the JAX package
    (unit khat ~ (y, -x), sigma = q / (1 + q) through 1/q, unit gradient ~ (y, y - x, -y^2/z)); I inside
    the cone, 0 in the polar cone and at the corner p ~ 0, diag(1, 0, [t > 0]) where r, s <= 0."""
    dt = v0.dtype
    r, s, t = v0.unbind(-1)
    in_cone, in_polar, special = _exp_regions(v0)
    x = p[..., 0]
    y = torch.clamp(p[..., 1], min=1e-30)
    z = torch.clamp(p[..., 2], min=1e-30)
    mu = torch.clamp(p[..., 2] - t, min=0.0)
    hyp = torch.clamp(torch.sqrt(x * x + y * y), min=1e-30)
    k0, k1 = y / hyp, -x / hyp
    invq = (y / hyp) ** 2 * (y * y) / torch.clamp(mu * z, min=torch.finfo(dt).tiny)
    sigma = 1.0 / (1.0 + invq)
    fz = lambda a: torch.where(torch.isfinite(a), a, torch.zeros_like(a))

    def ainv(b):
        kb = k0 * b[..., 0] + k1 * b[..., 1]
        return torch.stack([b[..., 0] - sigma * kb * k0, b[..., 1] - sigma * kb * k1, b[..., 2]], dim=-1)

    gbar = torch.stack([y, y - x, -(y * y) / z], dim=-1)
    ghat = fz(gbar / torch.linalg.vector_norm(gbar, dim=-1, keepdim=True))
    w_s = fz(ainv(ghat))
    denom = (ghat * w_s).sum(-1)
    coefv = fz(ghat / torch.clamp(denom, min=1e-30)[..., None])
    u_s = ainv(dv)
    dp_gen = u_s - (coefv * u_s).sum(-1, keepdim=True) * w_s
    zero = torch.zeros_like(dv[..., 0])
    dp_special = torch.stack([dv[..., 0], zero, torch.where(t > 0, dv[..., 2], zero)], dim=-1)
    at_zero = p.abs().sum(-1) <= 1e-12 * (1.0 + v0.abs().sum(-1))
    dp = torch.where(special[..., None], dp_special, dp_gen)
    dp = torch.where((in_polar | at_zero)[..., None], torch.zeros_like(dp), dp)
    return torch.where(in_cone[..., None], dv, dp)


# --- power cone --------------------------------------------------------------------
# K_pow(a) = cl{(x,y,z): x^a y^(1-a) >= |z|, x,y >= 0}; its dual
# K_pow(a)* = cl{(u,v,w): (u/a)^a (v/(1-a))^(1-a) >= |w|, u,v >= 0}. Pi_{K*}(v) = v + Pi_K(-v).


def _pow_val(x: Tensor, y: Tensor, a: float) -> Tensor:
    return torch.clamp(x, min=0.0) ** a * torch.clamp(y, min=0.0) ** (1 - a)


def _pow_regions(v0: Tensor, a: float):
    x0, y0, z0 = v0.unbind(-1)
    zh = z0.abs()
    in_cone = (x0 >= 0) & (y0 >= 0) & (_pow_val(x0, y0, a) >= zh)
    in_polar = (x0 <= 0) & (y0 <= 0) & (_pow_val(-x0 / a, -y0 / (1 - a), a) >= zh)
    return in_cone, in_polar


def _proj_pow_value(v0: Tensor, a: float) -> Tensor:
    """Projection onto the primal power cone (Hien 2015, Thm 3.1): (x(r), y(r), sign(z0) r) with r the
    root in (0, |z0|) of x(r)^a y(r)^(1-a) - r, found by 60 bisection-guarded Newton steps."""
    x0, y0, z0 = v0.unbind(-1)
    in_cone, in_polar = _pow_regions(v0, a)
    zs = torch.clamp(z0.abs(), min=1e-12)
    qx = lambda r: x0 * x0 + 4 * a * r * (zs - r)
    qy = lambda r: y0 * y0 + 4 * (1 - a) * r * (zs - r)
    xr = lambda r: 0.5 * (x0 + torch.sqrt(qx(r)))
    yr = lambda r: 0.5 * (y0 + torch.sqrt(qy(r)))
    one = torch.ones_like(zs)
    lo, hi, r = torch.zeros_like(zs), zs, 0.5 * zs
    for _ in range(60):
        X, Y = xr(r), yr(r)
        Xs, Ys = torch.clamp(X, min=1e-300), torch.clamp(Y, min=1e-300)
        phi = torch.exp(a * torch.log(Xs) + (1 - a) * torch.log(Ys))
        f = phi - r
        pos = f >= 0
        lo = torch.where(pos, r, lo)
        hi = torch.where(pos, hi, r)
        # d/dr of phi - r: phi (a X'/X + (1 - a) Y'/Y) - 1, the clamps' derivative 0 below their floor
        dX = torch.where(X > 1e-300, (a * (zs - r) - a * r) / torch.sqrt(qx(r)) / Xs, torch.zeros_like(X))
        dY = torch.where(Y > 1e-300, ((1 - a) * (zs - r) - (1 - a) * r) / torch.sqrt(qy(r)) / Ys, torch.zeros_like(Y))
        df = phi * (a * dX + (1 - a) * dY) - 1.0
        newton = r - f / torch.where(df.abs() > 1e-30, df, one)
        ok = (newton > lo) & (newton < hi)
        r = torch.where(ok, newton, 0.5 * (lo + hi))
    gen = torch.stack([xr(r), yr(r), torch.sign(z0) * r], dim=-1)
    out = torch.where(in_polar[..., None], torch.zeros_like(gen), gen)
    return torch.where(in_cone[..., None], v0, out)


def _pow_jvp(v0: Tensor, p: Tensor, dv: Tensor, a: float) -> Tensor:
    """The implicit derivative of the power-cone projection applied to ``dv`` (the KKT system of the
    projection with g(p) = |z| - x^a y^(1-a), whose Hessian has zero z row and column: a 2x2 Cramer solve
    and the Schur complement for dmu); I inside the cone, 0 in the polar cone."""
    dt = v0.dtype
    z0 = v0[..., 2]
    in_cone, in_polar = _pow_regions(v0, a)
    x, y = torch.clamp(p[..., 0], min=1e-30), torch.clamp(p[..., 1], min=1e-30)
    mu = torch.clamp(z0.abs() - p[..., 2].abs(), min=0.0)
    sig = torch.where(z0 >= 0, torch.ones_like(z0), -torch.ones_like(z0))
    phi = torch.exp(a * torch.log(x) + (1 - a) * torch.log(y))
    g = torch.stack([-a * phi / x, -(1 - a) * phi / y, sig], dim=-1)
    hxx = -a * (a - 1) * phi / (x * x)
    hxy = -a * (1 - a) * phi / (x * y)
    hyy = -(1 - a) * (-a) * phi / (y * y)
    a00, a01, a11 = 1.0 + mu * hxx, mu * hxy, 1.0 + mu * hyy
    tiny = torch.finfo(dt).tiny
    fz = lambda t: torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    det2 = a00 * a11 - a01 * a01
    safe2 = torch.where(det2.abs() > tiny, det2, torch.ones_like(det2))
    m00, m01, m11 = fz(a11 / safe2), fz(-a01 / safe2), fz(a00 / safe2)

    def asolve(b):
        return torch.stack([m00 * b[..., 0] + m01 * b[..., 1], m01 * b[..., 0] + m11 * b[..., 1], b[..., 2]], dim=-1)

    gf = fz(g)
    w = fz(asolve(gf))
    denom = (gf * w).sum(-1)
    coef = fz(gf / torch.where(denom.abs() > tiny, denom, torch.ones_like(denom))[..., None])
    u = asolve(dv)
    dp_gen = u - (coef * u).sum(-1, keepdim=True) * w
    dp = torch.where(in_polar[..., None], torch.zeros_like(dp_gen), dp_gen)
    return torch.where(in_cone[..., None], dv, dp)


def _ns_primal(kind: str) -> str:
    """The primal cone whose projection gives Pi of a ``kind`` block: exp and pow blocks project onto
    their dual cone (Moreau), dual_exp and dual_pow onto the primal one."""
    return "exp" if kind in ("exp", "dual_exp") else "pow"


def _ns_value(kind: str, alpha, v: Tensor) -> Tensor:
    """Pi of one 3-dim block (no derivative)."""
    proj = _proj_exp_value if _ns_primal(kind) == "exp" else (lambda u: _proj_pow_value(u, float(alpha)))
    return v + proj(-v) if kind in ("exp", "pow") else proj(v)


def _ns_jac(kind: str, alpha, v: Tensor) -> Tensor:
    """Dense DPi ``(..., 3, 3)`` of one 3-dim block: the implicit derivative applied to the three
    basis vectors (columns); I - D(-v) on the Moreau side."""
    dual = kind in ("exp", "pow")
    u = -v if dual else v
    if _ns_primal(kind) == "exp":
        p = _proj_exp_value(u)
        jvp = _exp_jvp
    else:
        p = _proj_pow_value(u, float(alpha))
        jvp = lambda v0, pp, dv: _pow_jvp(v0, pp, dv, float(alpha))
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(v.shape[:-1] + (3, 3))
    cols = jvp(u[..., None, :], p[..., None, :], eye)  # (..., j, i): the image of e_j in row j
    D = cols.transpose(-1, -2)
    return eye - D if dual else D


class _NsProjection(torch.autograd.Function):
    """Pi of one 3-dim block with the implicit derivative as its AD rules (``backward``: DPi' g,
    ``jvp``: DPi dv), computed from the saved point only when a derivative is asked for."""

    @staticmethod
    def forward(ctx, v, kind, alpha):
        ctx.kind, ctx.alpha = kind, alpha
        ctx.save_for_backward(v)
        ctx.save_for_forward(v)
        return _ns_value(kind, alpha, v.detach())

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        D = _ns_jac(ctx.kind, ctx.alpha, v.detach())
        return (D.transpose(-1, -2) @ g[..., None])[..., 0], None, None

    @staticmethod
    def jvp(ctx, dv, *_):
        (v,) = ctx.saved_tensors
        return (_ns_jac(ctx.kind, ctx.alpha, v.detach()) @ dv[..., None])[..., 0]


def _ns_grouped(cones: "ConeSpec", v: Tensor, fn) -> dict:
    """``fn(kind, alpha, blocks)`` once per (kind, alpha), on all the spec's blocks of it stacked along a new
    axis ``(..., g, 3)`` (one Newton loop for them all); returns {offset: fn's value for that block}."""
    groups = {}
    for kind, off, _, prm in cones.offsets_params():
        if kind in _NONSYMMETRIC:
            groups.setdefault((kind, prm), []).append(off)
    out = {}
    for (kind, prm), offs in groups.items():
        blocks = torch.stack([v[..., o:o + 3] for o in offs], dim=-2)
        res = fn(kind, prm, blocks)
        for i, o in enumerate(offs):
            out[o] = res.select(blocks.dim() - 2, i)
    return out


# ---------------------------------------------------------------------------
# Public API over a full ConeSpec
# ---------------------------------------------------------------------------


def pi(cones: ConeSpec, v: Tensor) -> Tensor:
    """Project ``v (..., m)`` onto the product of dual cones."""
    outs = []
    ns = _ns_grouped(cones, v, lambda kind, alpha, blocks: _NsProjection.apply(blocks, kind, alpha))
    for kind, off, d, prm in cones.offsets_params():
        blk = v[..., off : off + d]
        if kind == "zero":
            outs.append(blk)
        elif kind == "nonneg":
            outs.append(torch.clamp(blk, min=0.0))
        elif kind == "nonpos":
            outs.append(torch.clamp(blk, max=0.0))
        elif kind == "soc":
            outs.append(_pi_soc(blk))
        elif kind == "rsoc":
            outs.append(_pi_rsoc(blk))
        elif kind == "psd":
            outs.append(_pi_psd_tri(blk))
        else:
            outs.append(ns[off])
    return torch.cat(outs, dim=-1) if outs else v[..., :0]


def _masked(mask: Tensor, db: Tensor) -> Tensor:
    return torch.where(mask, db, torch.zeros_like(db))


def _matvec(D: Tensor, u: Tensor) -> Tensor:
    return (D @ u[..., None])[..., 0]


def dpi_apply(cones: ConeSpec, v: Tensor, dv: Tensor, transpose: bool = False) -> Tensor:
    """Apply the block-diagonal derivative ``DPi(v) @ dv`` (``transpose``: ``DPi(v)' @ dv``) without
    materializing the whole matrix."""
    outs = []
    jac = _ns_grouped(cones, v, _ns_jac)
    for kind, off, d, prm in cones.offsets_params():
        blk = v[..., off : off + d]
        dblk = dv[..., off : off + d]
        if kind == "zero":
            outs.append(dblk)
        elif kind == "nonneg":
            outs.append(_masked(blk >= 0, dblk))
        elif kind == "nonpos":
            outs.append(_masked(blk <= 0, dblk))
        elif kind == "soc":
            outs.append((_dpi_soc_dense(blk) @ dblk[..., None])[..., 0])
        elif kind == "rsoc":
            outs.append((_dpi_rsoc_dense(blk) @ dblk[..., None])[..., 0])
        elif kind == "psd":
            outs.append(_dpi_psd_tri_apply(blk, dblk))
        else:
            D = jac[off]
            outs.append(_matvec(D.transpose(-1, -2) if transpose else D, dblk))
    return torch.cat(outs, dim=-1) if outs else dv[..., :0]


def dpi_rmatvec(cones: ConeSpec, v: Tensor, dv: Tensor) -> Tensor:
    """Apply ``DPi(v)' @ dv``: the transpose of the exp / pow blocks, the others are symmetric."""
    return dpi_apply(cones, v, dv, transpose=True)


def dpi_operator(cones: ConeSpec, v: Tensor):
    """Prepared ``(apply, rapply)`` closures for ``DPi(v)`` / ``DPi(v)'``.

    The per-block factorizations (the PSD eigendecomposition, the SOC/RSOC
    dense blocks, the exp/pow 3x3 blocks) are computed ONCE here and closed over — the shape the
    matrix-free LSQR path needs, which applies DPi hundreds of times at a
    fixed ``v``. ``v`` is ``(B, m)``; the closures take ``(B, m)``."""
    makers = []  # (offset, dim, apply_fn, transposed apply_fn)
    jac = _ns_grouped(cones, v, _ns_jac)
    for kind, off, d, prm in cones.offsets_params():
        blk = v[..., off : off + d]
        if kind == "zero":
            f = lambda db: db
        elif kind in ("nonneg", "nonpos"):
            f = (lambda mask: lambda db: _masked(mask, db))(blk >= 0 if kind == "nonneg" else blk <= 0)
        elif kind in ("soc", "rsoc"):
            D = _dpi_soc_dense(blk) if kind == "soc" else _dpi_rsoc_dense(blk)
            f = (lambda D: lambda db: (D @ db[..., None])[..., 0])(D)
        elif kind == "psd":
            f = (lambda eigs: lambda db: _dpi_psd_apply_eigs(*eigs, db))(_psd_eigs(blk))
        else:
            D = jac[off]
            Dt = D.transpose(-1, -2)
            f = (lambda D: lambda db: _matvec(D, db))(D)
            makers.append((off, d, f, (lambda Dt: lambda db: _matvec(Dt, db))(Dt)))
            continue
        makers.append((off, d, f, f))  # a symmetric block

    def apply(dv):
        outs = [f(dv[..., off : off + d]) for off, d, f, _ in makers]
        return torch.cat(outs, dim=-1) if outs else dv[..., :0]

    def rapply(dv):
        outs = [r(dv[..., off : off + d]) for off, d, _, r in makers]
        return torch.cat(outs, dim=-1) if outs else dv[..., :0]

    return apply, rapply


def dpi_dense(cones: ConeSpec, v: Tensor) -> Tensor:
    """Materialized block-diagonal ``DPi(v)`` ``(..., m, m)``."""
    m = cones.total_dim
    out = torch.zeros(v.shape[:-1] + (m, m), dtype=v.dtype, device=v.device)
    jac = _ns_grouped(cones, v, _ns_jac)
    for kind, off, d, prm in cones.offsets_params():
        blk = v[..., off : off + d]
        if kind == "zero":
            B = torch.eye(d, dtype=v.dtype, device=v.device).expand(v.shape[:-1] + (d, d))
        elif kind == "nonneg":
            B = torch.diag_embed((blk >= 0).to(v.dtype))
        elif kind == "nonpos":
            B = torch.diag_embed((blk <= 0).to(v.dtype))
        elif kind == "soc":
            B = _dpi_soc_dense(blk)
        elif kind == "rsoc":
            B = _dpi_rsoc_dense(blk)
        elif kind == "psd":
            B = _dpi_psd_tri_dense(blk)
        else:
            B = jac[off]
        out[..., off : off + d, off : off + d] = B
    return out


def contains_dual(cones: ConeSpec, v: Tensor, tol: float = 1e-8) -> Tensor:
    """Boolean check that v lies (approximately) in the product of dual cones."""
    return torch.linalg.vector_norm(pi(cones, v) - v, dim=-1) <= tol
