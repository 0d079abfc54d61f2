"""Barrier algebra of the nonsymmetric-cone interior-point method, shared by
the staged solver (``solvers/conic_nsipm.py``) and the plain version of the
fused kernel (``ops/cuda/ns_pdip.py``).

Counterpart of the barrier half of ``diffopt_tpu/ops/pallas/ns_pdip.py``
(``_safe_margin_ll``, ``_ns_parts``, ``_ns_grad``, ``_ns_hess``,
``_ns_interior_ll``, ``_ns_central_np``, ``_solve3_sym_ll``) and of
``diffopt_tpu/solvers/conic_nsipm.py`` (``_soc_det``, ``_grad_barrier``,
``_hbar_pair``, ``_interior_measure``, ``_prox_sq``). The staged JAX solver
differentiates its barriers with ``jax.grad`` / ``jax.hessian``; here both
users take the closed forms of the fused kernel, with its arithmetic
associated as the kernel (``csrc/ns_pdip.cu``) associates it.

Barriers of the 3-dim cones (logarithmically homogeneous, nu = 3):

* ``exp``      K = cl{(x, y, z): y e^(x/y) <= z, y > 0},
               F = -log(y log(z/y) - x) - log y - log z
* ``dual_exp`` K* with t = -u0: F = -log(v + t + t log(w/t)) - log t - log w
* ``pow``      K_a = {x^a y^(1-a) >= |z|}: F = -log(x^2a y^2(1-a) - z^2) - (1-a) log x - a log y
* ``dual_pow`` K_a* = {(x/a)^a (y/(1-a))^(1-a) >= |z|}, the same form in x/a, y/(1-a).

Vectors are batch-first with the cone rows along the last dimension; ``mu``
has the leading shape. The internal layout of the cone rows is
``[nonneg(l) | soc(d_1)... | psd(side_1)... | ns...]`` (:class:`Layout`); the
psd blocks are the staged solver's alone and reach these functions through
its ``psd`` helper object (methods ``grad``, ``hess_pair``, ``interior``,
``prox``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import jordan
from .smalleig import jacobi_eigh

Tensor = torch.Tensor

NS_KINDS = ("exp", "dual_exp", "pow", "dual_pow")
DUAL_KIND = {"exp": "dual_exp", "dual_exp": "exp", "pow": "dual_pow", "dual_pow": "pow"}
# the centering search's candidate steps; the predictor's come from pred_grid
CENT_GRID = (1.0, 0.6, 0.35, 0.2, 0.1, 0.05, 0.02)
ALPHA_STALL = 0.05  # a predictor step below this takes the pure centering step instead


def pred_grid(step_frac: float) -> Tuple[float, ...]:
    """The predictor's 18 candidate steps: 1, step_frac 0.8^k (k < 14), 0.02, 0.008, 0.003. The affine
    probe searches every second one."""
    return tuple(float(a) for a in np.concatenate([[1.0], step_frac * 0.8 ** np.arange(14), [0.02, 0.008, 0.003]]))


class Layout(NamedTuple):
    """Static internal layout of the non-zero cone rows."""

    l: int
    soc_dims: Tuple[int, ...]
    psd_sides: Tuple[int, ...]
    ns_blocks: Tuple[Tuple[str, object], ...]  # (kind, alpha); alpha None for the exp kinds


def ns_offset(lay: Layout) -> int:
    return lay.l + sum(lay.soc_dims) + sum(d * (d + 1) // 2 for d in lay.psd_sides)


def ns_slices(lay: Layout):
    off = ns_offset(lay)
    return [slice(off + 3 * k, off + 3 * k + 3) for k in range(len(lay.ns_blocks))]


def nu_total(lay: Layout) -> int:
    """Barrier parameter: 1 per nonneg row, 2 per soc block, the side per psd block, 3 per ns block."""
    return max(lay.l + 2 * len(lay.soc_dims) + sum(lay.psd_sides) + 3 * len(lay.ns_blocks), 1)


# --- one 3-dim block ------------------------------------------------------------


def safe_margin(g: Tensor, u: Tensor, eps: float) -> Tensor:
    """Relative floor on a cone margin: a boundary-riding iterate rounds its margin to <= 0; the floor
    keeps the barrier's gradient and Hessian finite (the termination test has fired by then)."""
    scale = (u[..., 0].abs() + u[..., 1].abs()) + u[..., 2].abs()
    return torch.maximum(g, eps * scale)


def parts(kind: str, alpha, u: Tensor, eps: float):
    """Margin g, its gradient dg (3 tensors), the nonzero entries of its Hessian d2g ({(i, j): tensor},
    i <= j), and the linear log terms' gradient dlin and Hessian diagonal hlin (3 tensors each, None
    for a zero entry) of one block value ``u (..., 3)``: grad F = -dg / g + dlin, hess F = dg dg' / g^2
    - d2g / g + diag(hlin)."""
    if kind == "exp":
        x, y, z = u.unbind(-1)
        Lg = torch.log(z / y)
        g = safe_margin(y * Lg - x, u, eps)
        dg = [-torch.ones_like(x), Lg - 1.0, y / z]
        d2g = {(1, 1): -1.0 / y, (1, 2): 1.0 / z, (2, 2): -y / z**2}
        dlin = [None, -1.0 / y, -1.0 / z]
        hlin = [None, 1.0 / y**2, 1.0 / z**2]
    elif kind == "dual_exp":
        t = -u[..., 0]
        v, w = u[..., 1], u[..., 2]
        M = torch.log(w / t)
        g = safe_margin(v + t + t * M, u, eps)
        dg = [-M, torch.ones_like(t), t / w]
        d2g = {(0, 0): -1.0 / t, (0, 2): -1.0 / w, (2, 2): -t / w**2}
        dlin = [1.0 / t, None, -1.0 / w]
        hlin = [1.0 / t**2, None, 1.0 / w**2]
    elif kind in ("pow", "dual_pow"):
        a = float(alpha)
        x, y, z = u.unbind(-1)
        if kind == "pow":
            P = torch.exp(2 * a * torch.log(x) + 2 * (1 - a) * torch.log(y))
        else:
            P = torch.exp(2 * a * torch.log(x / a) + 2 * (1 - a) * torch.log(y / (1 - a)))
        g = safe_margin(P - z**2, u, eps)
        dg = [2 * a * P / x, 2 * (1 - a) * P / y, -2 * z]
        d2g = {
            (0, 0): 2 * a * (2 * a - 1) * P / x**2,
            (0, 1): 4 * a * (1 - a) * P / (x * y),
            (1, 1): 2 * (1 - a) * (1 - 2 * a) * P / y**2,
            (2, 2): torch.full_like(z, -2.0),
        }
        dlin = [-(1 - a) / x, -a / y, None]
        hlin = [(1 - a) / x**2, a / y**2, None]
    else:
        raise ValueError(f"no nonsymmetric barrier for cone kind {kind!r}")
    return g, dg, d2g, dlin, hlin


def grad(kind: str, alpha, u: Tensor, eps: float) -> Tensor:
    """grad F of one block, ``(..., 3)``."""
    g, dg, _, dlin, _ = parts(kind, alpha, u, eps)
    return torch.stack([-d / g if dl is None else -d / g + dl for d, dl in zip(dg, dlin)], dim=-1)


def hess(kind: str, alpha, u: Tensor, eps: float) -> Tensor:
    """hess F of one block, dense ``(..., 3, 3)``."""
    g, dg, d2g, _, hlin = parts(kind, alpha, u, eps)
    gg = g * g
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            e = dg[i] * dg[j] / gg
            v = d2g.get((i, j) if i <= j else (j, i))
            if v is not None:
                e = e - v / g
            if i == j and hlin[i] is not None:
                e = e + hlin[i]
            row.append(e)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def interior(kind: str, alpha, u: Tensor) -> Tensor:
    """Interiority measure of one block: positive iff strictly interior to the cone ``kind``; its logs
    are guarded, so an out-of-domain value reads -1 ("not interior"), never NaN."""
    neg1 = torch.full_like(u[..., 0], -1.0)
    if kind == "exp":
        x, y, z = u.unbind(-1)
        pos = (y > 0) & (z > 0)
        ys = torch.where(pos, y, 1.0)
        zs = torch.where(pos, z, 1.0)
        m3 = ys * torch.log(zs / ys) - x
        return torch.where(pos, torch.minimum(torch.minimum(y, z), m3), neg1)
    if kind == "dual_exp":
        t, v, w = -u[..., 0], u[..., 1], u[..., 2]
        pos = (t > 0) & (w > 0)
        ts = torch.where(pos, t, 1.0)
        ws = torch.where(pos, w, 1.0)
        m3 = v + ts + ts * torch.log(ws / ts)
        return torch.where(pos, torch.minimum(torch.minimum(t, w), m3), neg1)
    a = float(alpha)
    x, y, z = u.unbind(-1)
    sx, sy = (1.0, 1.0) if kind == "pow" else (a, 1.0 - a)
    pos = (x > 0) & (y > 0)
    xs = torch.where(pos, x, 1.0)
    ys = torch.where(pos, y, 1.0)
    phi = torch.exp(a * torch.log(xs / sx) + (1 - a) * torch.log(ys / sy))
    m3 = phi - z.abs()
    return torch.where(pos, torch.minimum(torch.minimum(x, y), m3), neg1)


_EXP0 = np.array([-1.0513839453227140, 0.5564096194693700, 1.2589678847689470])


def central(kind: str, alpha) -> np.ndarray:
    """The block's central starting point (float64): Hypatia's for exp; -grad F_exp at it for dual_exp;
    (sqrt(1 + a), sqrt(2 - a), 0) for pow, which is also -grad F_pow there, so dual_pow takes it too."""
    if kind == "exp":
        return _EXP0.copy()
    if kind == "dual_exp":
        x, y, z = _EXP0
        L = np.log(z / y)
        g = y * L - x
        return -np.array([1.0 / g, -(L - 1.0) / g - 1.0 / y, -(y / z) / g - 1.0 / z])
    a = float(alpha)
    return np.array([np.sqrt(1.0 + a), np.sqrt(2.0 - a), 0.0])


def solve3_sym(A: Tensor, b: Tensor, tiny: float) -> Tensor:
    """Cramer solve of a symmetric ``(..., 3, 3)`` system for ``(..., 3)``; a determinant of magnitude
    at most ``tiny`` divides by 1."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    safe = torch.where(det.abs() > tiny, det, torch.ones_like(det))
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([
        (c00 * b0 + c01 * b1 + c02 * b2) / safe,
        (c01 * b0 + c11 * b1 + c12 * b2) / safe,
        (c02 * b0 + c12 * b1 + c22 * b2) / safe,
    ], dim=-1)


def hess_inv_floored(Hb: Tensor, eps_w: float) -> Tensor:
    """Inverse of a 3x3 barrier Hessian through its Jacobi eigendecomposition with the eigenvalues
    floored at ``eps_w max(w)``: near convergence a margin g -> 0 conditions the block like 1/mu^2, and a
    raw inverse overflows in its cofactors."""
    w, Q = jacobi_eigh(Hb)
    w = torch.maximum(w, eps_w * w.amax(-1, keepdim=True))
    return (Q / w[..., None, :]) @ Q.transpose(-1, -2)


def soc_det(sb: Tensor, eps: float) -> Tensor:
    """SOC Jordan determinant in the factored form (s0 - ||s1||)(s0 + ||s1||) with a relative floor."""
    nu1 = torch.sqrt((sb[..., 1:] ** 2).sum(-1))
    det = (sb[..., 0] - nu1) * (sb[..., 0] + nu1)
    return torch.maximum(det, eps * sb[..., 0] ** 2)


def soc_eps(dt) -> float:
    """The staged solver's floor of the soc determinant (the fused kernel uses its margin floor)."""
    return 1e-14 if dt == torch.float64 else 1e-7


def margin_eps(dt) -> float:
    return 1e-15 if dt == torch.float64 else 1e-7


def hess_floor(dt) -> float:
    """eps_w, the relative floor of the 3x3 Hessians' eigenvalues."""
    return 1e-14 if dt == torch.float64 else 1e-6


# --- the whole cone -----------------------------------------------------------------


def init_point(lay: Layout, dt, device) -> Tensor:
    """Central s0: the identity of the symmetric blocks, then each ns block's central point."""
    base = jordan.identity_elem(lay.l, lay.soc_dims, lay.psd_sides, dt, device)
    ns = [torch.as_tensor(central(k, a), dtype=dt, device=device) for k, a in lay.ns_blocks]
    return torch.cat([base, *ns])


def _check_psd(lay, psd):
    if lay.psd_sides and psd is None:
        raise ValueError("psd blocks need the staged solver's psd helper")


def grad_barrier(lay: Layout, s: Tensor, eps: float, soc_eps_: float, psd=None) -> Tensor:
    """grad F(s) blockwise (``eps`` floors the ns margins, ``soc_eps_`` the soc determinants)."""
    out = [-1.0 / s[..., :lay.l]]
    for sl in jordan.soc_slices(lay.l, lay.soc_dims):
        sb = s[..., sl]
        out.append(-2.0 * jordan.J(sb) / soc_det(sb, soc_eps_)[..., None])
    if lay.psd_sides:
        _check_psd(lay, psd)
        for d, sl in zip(lay.psd_sides, jordan.psd_slices(lay.l, lay.soc_dims, lay.psd_sides)):
            out.append(psd.grad(s[..., sl], d))
    for (kind, alpha), sl in zip(lay.ns_blocks, ns_slices(lay)):
        out.append(grad(kind, alpha, s[..., sl], eps))
    return torch.cat(out, dim=-1)


def hbar_pair(lay: Layout, s: Tensor, mu: Tensor, eps: float, soc_eps_: float, eps_w: float, psd=None):
    """Dense block-diagonal ``Hbar = mu hess F(s)`` and ``Hbar^-1``, ``(B, mC, mC)`` each: diag(1/s^2)
    and diag(s^2) on the nonneg rows, (4/det^2) Js Js' - (2/det) J and s s' - (det/2) J per soc block,
    the closed-form Hessian and its floored-eigh inverse per ns block; every entry computed unscaled,
    then times mu (Hbar) or over mu (Hbar^-1)."""
    mC = s.shape[-1]
    H = s.new_zeros(s.shape + (mC,))
    Hi = s.new_zeros(s.shape + (mC,))
    if lay.l:
        i = torch.arange(lay.l, device=s.device)
        H[..., i, i] = 1.0 / s[..., :lay.l] ** 2
        Hi[..., i, i] = s[..., :lay.l] ** 2
    for d, sl in zip(lay.soc_dims, jordan.soc_slices(lay.l, lay.soc_dims)):
        sb = s[..., sl]
        det = soc_det(sb, soc_eps_)[..., None, None]
        Js = jordan.J(sb)
        Jd = torch.diag(torch.tensor([1.0] + [-1.0] * (d - 1), dtype=s.dtype, device=s.device))
        H[..., sl, sl] = (4.0 / det**2) * Js[..., :, None] * Js[..., None, :] - (2.0 / det) * Jd
        Hi[..., sl, sl] = sb[..., :, None] * sb[..., None, :] - 0.5 * det * Jd
    if lay.psd_sides:
        _check_psd(lay, psd)
        for d, sl in zip(lay.psd_sides, jordan.psd_slices(lay.l, lay.soc_dims, lay.psd_sides)):
            H[..., sl, sl], Hi[..., sl, sl] = psd.hess_pair(s[..., sl], d)
    for (kind, alpha), sl in zip(lay.ns_blocks, ns_slices(lay)):
        Hb = hess(kind, alpha, s[..., sl], eps)
        H[..., sl, sl] = Hb
        Hi[..., sl, sl] = hess_inv_floored(Hb, eps_w)
    return mu[..., None, None] * H, Hi / mu[..., None, None]


def interior_measure(lay: Layout, u: Tensor, dual: bool, psd=None) -> Tensor:
    """Least blockwise interiority measure of ``u`` for K (``dual=False``) or K* (``dual=True``):
    positive iff strictly interior to every block; a NaN propagates."""
    vals = []
    if lay.l:
        vals.append(u[..., :lay.l].amin(-1))
    for sl in jordan.soc_slices(lay.l, lay.soc_dims):
        ub = u[..., sl]
        vals.append(ub[..., 0] - torch.sqrt((ub[..., 1:] ** 2).sum(-1)))
    if lay.psd_sides:
        _check_psd(lay, psd)
        for d, sl in zip(lay.psd_sides, jordan.psd_slices(lay.l, lay.soc_dims, lay.psd_sides)):
            vals.append(psd.interior(u[..., sl], d))
    for (kind, alpha), sl in zip(lay.ns_blocks, ns_slices(lay)):
        vals.append(interior(DUAL_KIND[kind] if dual else kind, alpha, u[..., sl]))
    out = vals[0]
    for v in vals[1:]:
        out = torch.minimum(out, v)
    return out


def feasible(lay: Layout, sn: Tensor, yn: Tensor, psd=None) -> Tensor:
    """Strictly interior primal and dual, and finite."""
    fin = torch.isfinite(sn).all(-1) & torch.isfinite(yn).all(-1)
    return (interior_measure(lay, sn, False, psd) > 0) & (interior_measure(lay, yn, True, psd) > 0) & fin


def prox_sq(lay: Layout, s: Tensor, y: Tensor, mu: Tensor, eps: float, soc_eps_: float, tiny: float,
            psd=None) -> Tensor:
    """Squared central-path proximity ``||y + mu grad F(s)||^2`` in the norm of ``hess F(s)^-1``
    (Skajaa-Ye). Each ns block's 3x3 solve is Jacobi-scaled and by Cramer (``tiny`` guards its
    determinant)."""
    q = torch.zeros_like(mu)
    if lay.l:
        q = q + ((s[..., :lay.l] * y[..., :lay.l] - mu[..., None]) ** 2).sum(-1)
    for sl in jordan.soc_slices(lay.l, lay.soc_dims):
        sb, yb = s[..., sl], y[..., sl]
        det = soc_det(sb, soc_eps_)
        z = yb - (2.0 * mu / det)[..., None] * jordan.J(sb)
        Hiz = (sb * z).sum(-1)[..., None] * sb - (0.5 * det)[..., None] * jordan.J(z)
        q = q + (z * Hiz).sum(-1)
    if lay.psd_sides:
        _check_psd(lay, psd)
        for d, sl in zip(lay.psd_sides, jordan.psd_slices(lay.l, lay.soc_dims, lay.psd_sides)):
            q = q + psd.prox(s[..., sl], y[..., sl], d, mu)
    for (kind, alpha), sl in zip(lay.ns_blocks, ns_slices(lay)):
        sb = s[..., sl]
        z = y[..., sl] + mu[..., None] * grad(kind, alpha, sb, eps)
        Hb = hess(kind, alpha, sb, eps)
        dj = torch.sqrt(torch.diagonal(Hb, dim1=-2, dim2=-1))
        Hs = Hb / dj[..., :, None] / dj[..., None, :]
        x = solve3_sym(Hs, z / dj, tiny) / dj
        q = q + (z * x).sum(-1)
    return q
