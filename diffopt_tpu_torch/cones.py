"""Cone specifications and projection calculus (the symmetric cones).

Counterpart of ``diffopt_tpu/cones.py``. A :class:`ConeSpec` is the static
row layout of the cone K; the projections Pi and their derivatives DPi act on
the **dual cone** of each constraint set, as the conic residual map uses
``v = y - s`` projected onto K*. Every function is batch-first: ``v`` is
``(..., m)`` with the blocks along the last dimension.

Supported here (MOI set -> kind):

* ``zero``    — Zeros;        dual = Reals:  Pi(v) = v,       DPi = I
* ``nonneg``  — Nonnegatives; dual = Nonneg: Pi = max(v, 0),  DPi = diag(v >= 0)
* ``nonpos``  — Nonpositives; dual = Nonpos: Pi = min(v, 0),  DPi = diag(v <= 0)
* ``soc``     — SecondOrderCone (self-dual): closed-form 2x2 block formula
* ``rsoc``    — RotatedSecondOrderCone (self-dual): orthogonal rotation of soc
* ``psd``     — PSD cone in **svec** coordinates (self-dual): eigh-based

``ConeSpec`` accepts ``exp``, ``dual_exp``, ``pow`` and ``dual_pow`` blocks as
metadata, as the JAX class does; their projections come with the slice of
the port that brings the nonsymmetric cones (kernel K7), and until then every
function below raises ``NotImplementedError`` for them.

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


def _nonsymmetric(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"cone kind {kind!r}: the exp/pow cones come with the slice of the port that brings "
        "the nonsymmetric interior-point method and its fused kernel (K7, ops/pallas/ns_pdip.py)"
    )


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


# ---------------------------------------------------------------------------
# Public API over a full ConeSpec
# ---------------------------------------------------------------------------


def pi(cones: ConeSpec, v: Tensor) -> Tensor:
    """Project ``v (..., m)`` onto the product of dual cones."""
    outs = []
    for kind, off, d, _ in cones.offsets_params():
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
            raise _nonsymmetric(kind)
    return torch.cat(outs, dim=-1) if outs else v[..., :0]


def _masked(mask: Tensor, db: Tensor) -> Tensor:
    return torch.where(mask, db, torch.zeros_like(db))


def dpi_apply(cones: ConeSpec, v: Tensor, dv: Tensor) -> Tensor:
    """Apply the block-diagonal derivative ``DPi(v) @ dv`` without
    materializing the matrix."""
    outs = []
    for kind, off, d, _ in cones.offsets_params():
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
            raise _nonsymmetric(kind)
    return torch.cat(outs, dim=-1) if outs else dv[..., :0]


def dpi_rmatvec(cones: ConeSpec, v: Tensor, dv: Tensor) -> Tensor:
    """Apply ``DPi(v)' @ dv``: every symmetric-cone DPi block is symmetric."""
    return dpi_apply(cones, v, dv)


def dpi_operator(cones: ConeSpec, v: Tensor):
    """Prepared ``(apply, rapply)`` closures for ``DPi(v)`` / ``DPi(v)'``.

    The per-block factorizations (the PSD eigendecomposition, the SOC/RSOC
    dense blocks) are computed ONCE here and closed over — the shape the
    matrix-free LSQR path needs, which applies DPi hundreds of times at a
    fixed ``v``. ``v`` is ``(B, m)``; the closures take ``(B, m)``."""
    makers = []  # (offset, dim, apply_fn)
    for kind, off, d, _ in cones.offsets_params():
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
            raise _nonsymmetric(kind)
        makers.append((off, d, f))

    def apply(dv):
        outs = [f(dv[..., off : off + d]) for off, d, f in makers]
        return torch.cat(outs, dim=-1) if outs else dv[..., :0]

    return apply, apply  # every block is symmetric


def dpi_dense(cones: ConeSpec, v: Tensor) -> Tensor:
    """Materialized block-diagonal ``DPi(v)`` ``(..., m, m)``."""
    m = cones.total_dim
    out = torch.zeros(v.shape[:-1] + (m, m), dtype=v.dtype, device=v.device)
    for kind, off, d, _ in cones.offsets_params():
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
            raise _nonsymmetric(kind)
        out[..., off : off + d, off : off + d] = B
    return out


def contains_dual(cones: ConeSpec, v: Tensor, tol: float = 1e-8) -> Tensor:
    """Boolean check that v lies (approximately) in the product of dual cones."""
    return torch.linalg.vector_norm(pi(cones, v) - v, dim=-1) <= tol
