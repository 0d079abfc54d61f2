"""Jordan-algebra and Nesterov-Todd scaling helpers of the symmetric-cone
interior-point method, shared by the staged solver (``solvers/conic_ipm.py``)
and the plain version of the fused kernel (``ops/cuda/conic_pdip.py``).

Their arithmetic is the fused kernel's (``csrc/conic_pdip.cu``): products
associated as the kernel associates them, symmetrised where it symmetrises,
the soc block of W^2 as ``eta^2 (2 wb wb' - J)`` and the psd block as the
symmetric Kronecker square of W_nt, eigendecompositions by the Jacobi of
``ops/smalleig.py`` (the library eigensolver past its side limit, which only
the staged solver reaches).

Vectors hold the cone rows ``[nonneg(l) | soc(d_1)... | psd(side_1)...]``
(psd blocks as svec, off-diagonal entries scaled by sqrt2) along the last
dimension, ``(B, mC)`` or ``(B, k, mC)``; a scaling carries the batch
dimension B. ``eps`` is the relative floor of the scaling (:func:`eps_for`).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..cones import _tri_order
from .smalleig import eigh_small, eigvalsh_small

Tensor = torch.Tensor


def eps_for(dt) -> float:
    """The scaling floor of the reference for a dtype."""
    return 1e-14 if dt == torch.float64 else 1e-7


def soc_slices(l, soc_dims):
    out, off = [], l
    for d in soc_dims:
        out.append(slice(off, off + d))
        off += d
    return out


def psd_slices(l, soc_dims, psd_sides):
    out, off = [], l + sum(soc_dims)
    for d in psd_sides:
        tri = d * (d + 1) // 2
        out.append(slice(off, off + tri))
        off += tri
    return out


def J(u):
    return torch.cat([u[..., :1], -u[..., 1:]], dim=-1)


def sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


@functools.lru_cache(maxsize=None)
def _svec_tables(d):
    index = np.zeros((d, d), dtype=np.int64)
    scale = np.zeros((d, d))
    for k, (r, c) in enumerate(_tri_order(d)):
        index[r, c] = index[c, r] = k
        scale[r, c] = scale[c, r] = 1.0 if r == c else 1.0 / math.sqrt(2.0)
    return index.reshape(-1), scale


def mat(u, d):
    """svec block ``(..., tri)`` -> symmetric ``(..., d, d)``: off-diagonal entries times 1/sqrt2."""
    index, scale = _svec_tables(d)
    idx = torch.as_tensor(index, device=u.device)
    return u[..., idx].reshape(u.shape[:-1] + (d, d)) * torch.as_tensor(scale, dtype=u.dtype, device=u.device)


def svec(M, d):
    """``(..., d, d)`` -> svec ``(..., tri)``, symmetrising: ``(M_rc + M_cr) / sqrt2`` off the
    diagonal, ``M_rr`` on it (as ``(M_rr + M_rr) / 2``, which is exact)."""
    order = _tri_order(d)
    r, c = order[:, 0], order[:, 1]
    flat = M.reshape(M.shape[:-2] + (d * d,))
    up = torch.as_tensor(r * d + c, device=M.device)
    lo = torch.as_tensor(c * d + r, device=M.device)
    w = torch.as_tensor(np.where(r == c, 0.5, 0.5 * math.sqrt(2.0)), dtype=M.dtype, device=M.device)
    return (flat[..., up] + flat[..., lo]) * w


def identity_elem(l, soc_dims, psd_sides, dt, device):
    """The identity e of the cone: ones on nonneg rows, the head of each soc block, svec(I) per psd block."""
    parts = [torch.ones(l, dtype=dt, device=device)]
    for d in soc_dims:
        parts.append(torch.zeros(d, dtype=dt, device=device))
        parts[-1][0] = 1.0
    for d in psd_sides:
        parts.append(svec(torch.eye(d, dtype=dt, device=device), d))
    return torch.cat(parts)


def jdet_sqrt(u, eps):
    """sqrt(u0^2 - ||u1||^2) in the factored form with a relative floor."""
    nu1 = torch.sqrt((u[..., 1:] ** 2).sum(-1))
    det = (u[..., 0] - nu1) * (u[..., 0] + nu1)
    return torch.sqrt(torch.maximum(det, eps * u[..., 0] ** 2))


def floored_eigs(w, eps):
    """The reference's relative eigenvalue floor: max(w, eps max(max w, 0), 1e-30)."""
    wf = torch.maximum(w, eps * torch.clamp(w.amax(-1, keepdim=True), min=0.0))
    return torch.clamp(wf, min=1e-30)


def psd_sqrt_pair(X, eps):
    """(X^1/2, X^-1/2) of a (nearly) PD symmetric X with the relative eigenvalue floor."""
    w, V = eigh_small(X)
    sq = torch.sqrt(floored_eigs(w, eps))
    Vt = V.transpose(-1, -2)
    return (V * sq[..., None, :]) @ Vt, (V / sq[..., None, :]) @ Vt


class Scaling(NamedTuple):
    w: Tensor  # (B, l) nonneg scales sqrt(s/y)
    etas: Tuple[Tensor, ...]  # per soc block: (B,)
    vs: Tuple[Tensor, ...]  # per soc block: (B, d) with v'Jv = 1
    wbs: Tuple[Tensor, ...]  # per soc block: (B, d), the scaling point with W = eta (2 v v' - J)
    wnts: Tuple[Tensor, ...]  # per psd block: W_nt (B, d, d)
    rs: Tuple[Tensor, ...]  # per psd block: W_nt^1/2
    ris: Tuple[Tensor, ...]  # per psd block: W_nt^-1/2


def nt_scaling(l, soc_dims, psd_sides, s, y, eps) -> Scaling:
    """The NT scaling W of the pair (s, y), with W y = W^-1 s."""
    w = torch.sqrt(s[..., :l] / y[..., :l])
    etas, vs, wbs = [], [], []
    for sl in soc_slices(l, soc_dims):
        rs, ry = jdet_sqrt(s[..., sl], eps), jdet_sqrt(y[..., sl], eps)
        sb, yb = s[..., sl] / rs[..., None], y[..., sl] / ry[..., None]
        gamma = torch.sqrt(torch.clamp((1.0 + (sb * yb).sum(-1)) / 2.0, min=eps))
        wb = (sb + J(yb)) / (2.0 * gamma)[..., None]
        v = torch.cat([wb[..., :1] + 1.0, wb[..., 1:]], dim=-1) / torch.sqrt(
            2.0 * torch.clamp(wb[..., 0] + 1.0, min=eps)
        )[..., None]
        etas.append(torch.sqrt(rs / ry))
        vs.append(v)
        wbs.append(wb)
    wnts, rs_psd, ris_psd = [], [], []
    for d, sl in zip(psd_sides, psd_slices(l, soc_dims, psd_sides)):
        # W_nt solves W Y W = S: W_nt = S^1/2 (S^1/2 Y S^1/2)^-1/2 S^1/2, kept with its square-root pair
        S, Y = mat(s[..., sl], d), mat(y[..., sl], d)
        Sh, _ = psd_sqrt_pair(S, eps)
        _, Zih = psd_sqrt_pair(sym(Sh @ (Y @ Sh)), eps)
        Wnt = sym(Sh @ (Zih @ Sh))
        Rb, Rbi = psd_sqrt_pair(Wnt, eps)
        wnts.append(Wnt)
        rs_psd.append(Rb)
        ris_psd.append(Rbi)
    return Scaling(w, tuple(etas), tuple(vs), tuple(wbs), tuple(wnts), tuple(rs_psd), tuple(ris_psd))


def w_apply(l, soc_dims, psd_sides, sc: Scaling, u, inv: bool):
    """W u (or W^-1 u) blockwise: diag(w) on nonneg; eta (2 v v' - J) on soc (inverse
    (2 Jv (v'Ju) - Ju) / eta); X -> R X R (or R^-1 X R^-1) per psd block."""
    ex = (lambda t: t.unsqueeze(1)) if u.ndim == 3 else (lambda t: t)
    w = ex(sc.w)
    parts = [u[..., :l] / w if inv else u[..., :l] * w]
    for sl, eta, v in zip(soc_slices(l, soc_dims), sc.etas, sc.vs):
        ub, v, eta = u[..., sl], ex(v), ex(eta)[..., None]
        if inv:
            ju = J(ub)
            parts.append((2.0 * J(v) * (v * ju).sum(-1, keepdim=True) - ju) / eta)
        else:
            parts.append((2.0 * v * (v * ub).sum(-1, keepdim=True) - J(ub)) * eta)
    for d, sl, Rb, Rbi in zip(psd_sides, psd_slices(l, soc_dims, psd_sides), sc.rs, sc.ris):
        Rm = ex(Rbi if inv else Rb)
        parts.append(svec(Rm @ (mat(u[..., sl], d) @ Rm), d))
    return torch.cat(parts, dim=-1)


def w2_dense(l, soc_dims, psd_sides, sc: Scaling):
    """W^2 as a dense block-diagonal ``(B, mC, mC)``: diag(w^2); eta^2 (2 wb wb' - J) per soc
    block; the symmetric Kronecker square of W_nt per psd block."""
    B, dt, dev = sc.w.shape[0], sc.w.dtype, sc.w.device
    mC = l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides)
    W2 = torch.zeros(B, mC, mC, dtype=dt, device=dev)
    W2[:, :l, :l] = torch.diag_embed(sc.w * sc.w)
    for d, sl, eta, wb in zip(soc_dims, soc_slices(l, soc_dims), sc.etas, sc.wbs):
        Jd = torch.diag(torch.tensor([1.0] + [-1.0] * (d - 1), dtype=dt, device=dev))
        W2[:, sl, sl] = (2.0 * wb[:, :, None] * wb[:, None, :] - Jd) * (eta * eta)[:, None, None]
    for d, sl, P in zip(psd_sides, psd_slices(l, soc_dims, psd_sides), sc.wnts):
        order = _tri_order(d)
        wts = np.where(order[:, 0] == order[:, 1], 1.0, math.sqrt(2.0))
        coef = torch.as_tensor(0.5 * wts[:, None] * wts[None, :], dtype=dt, device=dev)
        i, j = order[:, 0][:, None], order[:, 1][:, None]
        k, m = order[:, 0][None, :], order[:, 1][None, :]
        W2[:, sl, sl] = coef * (P[:, i, k] * P[:, j, m] + P[:, i, m] * P[:, j, k])
    return W2


def jmul(l, soc_dims, psd_sides, u, v):
    """Jordan product u o v: elementwise on nonneg, the arrow product per soc block, the
    symmetrised matrix product per psd block."""
    parts = [u[..., :l] * v[..., :l]]
    for sl in soc_slices(l, soc_dims):
        ub, vb = u[..., sl], v[..., sl]
        head = (ub * vb).sum(-1, keepdim=True)
        parts.append(torch.cat([head, ub[..., :1] * vb[..., 1:] + vb[..., :1] * ub[..., 1:]], dim=-1))
    for d, sl in zip(psd_sides, psd_slices(l, soc_dims, psd_sides)):
        parts.append(svec(mat(u[..., sl], d) @ mat(v[..., sl], d), d))
    return torch.cat(parts, dim=-1)


def lam_psd_eigs(l, soc_dims, psd_sides, lam):
    """One eigendecomposition per psd block of the scaled point lam, shared by the Lyapunov
    solve and all four step lengths."""
    return [eigh_small(mat(lam[..., sl], d)) for d, sl in zip(psd_sides, psd_slices(l, soc_dims, psd_sides))]


def lam_psd_isqrts(psd_eigs, eps):
    """lam_blk^-1/2 per psd block from the shared eigendecomposition."""
    return [(Q / torch.sqrt(floored_eigs(w, eps))[..., None, :]) @ Q.transpose(-1, -2) for w, Q in psd_eigs]


def jsolve(l, soc_dims, psd_sides, lam, dd, eps, psd_eigs):
    """g with lam o g = dd: the inverse arrow operator per soc block, the Lyapunov solve
    L G + G L = 2 D in the eigenbasis of lam per psd block."""
    parts = [dd[..., :l] / lam[..., :l]]
    for sl in soc_slices(l, soc_dims):
        lb, db = lam[..., sl], dd[..., sl]
        nl1 = torch.sqrt((lb[..., 1:] ** 2).sum(-1))
        det = (lb[..., 0] - nl1) * (lb[..., 0] + nl1)
        floor = eps * lb[..., 0] ** 2
        det = torch.where(det.abs() > floor, det, floor)
        g0 = (lb[..., 0] * db[..., 0] - (lb[..., 1:] * db[..., 1:]).sum(-1)) / det
        g1 = (db[..., 1:] - lb[..., 1:] * g0[..., None]) / lb[..., :1]
        parts.append(torch.cat([g0[..., None], g1], dim=-1))
    for d, sl, (w, Q) in zip(psd_sides, psd_slices(l, soc_dims, psd_sides), psd_eigs):
        denom = w[..., :, None] + w[..., None, :]
        floor = (eps * w.abs().amax(-1))[..., None, None]
        denom = torch.where(denom.abs() > floor, denom, floor)
        Qt = Q.transpose(-1, -2)
        inner = (Qt @ ((2.0 * mat(dd[..., sl], d)) @ Q)) / denom
        parts.append(svec(Q @ (inner @ Qt), d))
    return torch.cat(parts, dim=-1)


def soc_boundary_step(ub, db, big):
    """Step to the boundary of one soc block: the smallest positive root of
    (u0 + a d0)^2 - ||u1 + a d1||^2 = a^2 qa + a qb + qc = 0 (qc > 0 inside), capped where the
    head reaches 0."""
    qa = db[..., 0] ** 2 - (db[..., 1:] ** 2).sum(-1)
    qb = 2.0 * (ub[..., 0] * db[..., 0] - (ub[..., 1:] * db[..., 1:]).sum(-1))
    nu1 = torch.sqrt((ub[..., 1:] ** 2).sum(-1))
    qc = torch.clamp((ub[..., 0] - nu1) * (ub[..., 0] + nu1), min=0.0)
    disc = qb**2 - 4.0 * qa * qc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    one = torch.ones_like(qa)
    safe_a = torch.where(qa.abs() > 1e-30, qa, one)
    r1 = (-qb - sq) / (2.0 * safe_a)
    r2 = (-qb + sq) / (2.0 * safe_a)
    rlin = torch.where(qb < 0, -qc / torch.where(qb < 0, qb, one), big)
    quad_root = torch.minimum(torch.where(r1 > 0, r1, big), torch.where(r2 > 0, r2, big))
    root = torch.where(qa.abs() > 1e-30, torch.where(disc >= 0, quad_root, big), rlin)
    cap = torch.where(db[..., 0] < 0, -ub[..., 0] / torch.where(db[..., 0] < 0, db[..., 0], one), big)
    return torch.minimum(root, cap)


def max_step_pair(l, soc_dims, psd_sides, lam, dlam_a, dlam_b, psd_isqrts):
    """The largest steps in (0, 1] keeping lam + alpha dlam in the cone, for two directions from
    the same scaled point; per psd block -1 / lambda_min(lam^-1/2 dlam lam^-1/2) where that
    minimum is negative, both directions in one stacked eigenvalue call."""
    big = torch.tensor(float("inf"), dtype=lam.dtype, device=lam.device)
    amaxes = []
    for dlam in (dlam_a, dlam_b):
        ratio = torch.where(dlam[..., :l] < 0, -lam[..., :l] / dlam[..., :l], big)
        amaxes.append(torch.cat([ratio, big.expand(ratio.shape[:-1] + (1,))], dim=-1).amin(-1))
    for d, sl, isq in zip(psd_sides, psd_slices(l, soc_dims, psd_sides), psd_isqrts):
        pair = torch.stack([sym(isq @ (mat(dl[..., sl], d) @ isq)) for dl in (dlam_a, dlam_b)])
        lmins = eigvalsh_small(pair).amin(-1)
        for i in range(2):
            neg = torch.where(lmins[i] < 0, lmins[i], -torch.ones_like(lmins[i]))
            amaxes[i] = torch.minimum(amaxes[i], torch.where(lmins[i] < 0, -1.0 / neg, big))
    for sl in soc_slices(l, soc_dims):
        for i, dlam in enumerate((dlam_a, dlam_b)):
            amaxes[i] = torch.minimum(amaxes[i], soc_boundary_step(lam[..., sl], dlam[..., sl], big))
    return torch.clamp(amaxes[0], max=1.0), torch.clamp(amaxes[1], max=1.0)


def residuals(c, AE, bE, AC, bC, x, yE, yC, s):
    """rd = c + AC'yC + AE'yE, rpE = AE x - bE, rpC = AC x + s - bC."""
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    return c + rmv(AC, yC) + rmv(AE, yE), mv(AE, x) - bE, mv(AC, x) + s - bC


def metrics(c, bE, bC, x, yE, yC, s, rd, rpE, rpC):
    """The scale-relative (SCS-style) termination metrics ``(pres, dres, gaprel)``."""
    nrm = lambda u: torch.sqrt((u * u).sum(-1))
    AxC, AxE = rpC - s + bC, rpE + bE
    psc = 1.0 + torch.maximum(
        torch.sqrt((AxC * AxC).sum(-1) + (AxE * AxE).sum(-1)),
        torch.maximum(nrm(s), torch.sqrt((bC * bC).sum(-1) + (bE * bE).sum(-1))),
    )
    pres = torch.sqrt((rpC * rpC).sum(-1) + (rpE * rpE).sum(-1)) / psc
    dres = nrm(rd) / (1.0 + torch.maximum(nrm(rd - c), nrm(c)))
    pobj = (c * x).sum(-1)
    dobj = -(bC * yC).sum(-1) - (bE * yE).sum(-1)
    gaprel = (pobj - dobj).abs() / (1.0 + pobj.abs() + dobj.abs())
    return pres, dres, gaprel


def shift_into_interior(l, soc_dims, psd_sides, s0, e):
    """The init's per-block shift of s0 into the interior: by 1 + max(0, -1.5 min) on the nonneg
    rows and per psd block (its least eigenvalue), the head by 1 + max(0, 1.5 (||tail|| - head))
    per soc block."""
    parts = []
    if l:
        sh = torch.clamp(-1.5 * s0[:, :l].amin(-1), min=0.0) + 1.0
        parts.append(s0[:, :l] + sh[:, None])
    for sl in soc_slices(l, soc_dims):
        sb = s0[:, sl]
        shb = torch.clamp(1.5 * (torch.sqrt((sb[:, 1:] ** 2).sum(-1)) - sb[:, 0]), min=0.0) + 1.0
        parts.append(torch.cat([sb[:, :1] + shb[:, None], sb[:, 1:]], dim=-1))
    for d, sl in zip(psd_sides, psd_slices(l, soc_dims, psd_sides)):
        shb = torch.clamp(-1.5 * eigvalsh_small(mat(s0[:, sl], d)).amin(-1), min=0.0) + 1.0
        parts.append(s0[:, sl] + shb[:, None] * e[:, sl])
    return torch.cat(parts, dim=-1)
