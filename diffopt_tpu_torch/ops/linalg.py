"""Dense linear-algebra substrate for the differentiation rules.

Counterpart of ``diffopt_tpu/ops/linalg.py``. These are library calls in the
JAX package too (outside any hand-written kernel) and stay ``torch.linalg``
calls here; every function is batch-aware over leading dims.

``solve`` routes between:
  * ``lu``    — batched LU (``torch.linalg.lu_factor`` / ``lu_solve``)
  * ``lstsq`` — minimum-norm least-squares via the normal equations and an
                eigh pseudo-inverse, robust for the singular LP-KKT case
  * ``qr``    — batched QR solve
  * a callable ``(M, rhs) -> x`` — the pluggable linear solver
plus optional fixed-point iterative refinement to recover near-f64 accuracy
from f32 factorizations.
"""

from __future__ import annotations

from functools import partial

import torch

from ..utils.precision import full_precision, residual_dtype

Tensor = torch.Tensor


def _as_columns(M: Tensor, rhs: Tensor):
    vec = rhs.ndim == M.ndim - 1
    return (rhs[..., None] if vec else rhs), vec


def lu_solve_dense(M: Tensor, rhs: Tensor) -> Tensor:
    """Batched dense LU solve; rhs may be (..., n) or (..., n, k). A singular
    ``M`` gives inf / NaN entries (no exception), as in the JAX package."""
    rhs, vec = _as_columns(M, rhs)
    lu, piv, _ = torch.linalg.lu_factor_ex(M)  # the _ex form neither raises nor waits for the device
    return _lu_solve_factored(lu, piv, rhs[..., 0] if vec else rhs)


def _lu_solve_factored(lu: Tensor, piv: Tensor, rhs: Tensor) -> Tensor:
    vec = rhs.ndim == lu.ndim - 1
    out = torch.linalg.lu_solve(lu, piv, rhs[..., None] if vec else rhs)
    return out[..., 0] if vec else out


def qr_solve_dense(M: Tensor, rhs: Tensor) -> Tensor:
    rhs, vec = _as_columns(M, rhs)
    Q, R = torch.linalg.qr(M)
    out = torch.linalg.solve_triangular(R, Q.transpose(-1, -2) @ rhs, upper=True)
    return out[..., 0] if vec else out


def lstsq_solve_dense(M: Tensor, rhs: Tensor, ridge: float = 0.0) -> Tensor:
    """Minimum-norm least-squares solve of a (possibly singular) square system.

    Solves ``(M'M + ridge*I) x = M' rhs`` through the eigendecomposition of
    the normal matrix; with ridge=0 and a singular M this returns the
    minimum-norm least-squares solution. For hard-singular normal matrices
    pass a tiny ridge.
    """
    rhs, vec = _as_columns(M, rhs)
    Mt = M.transpose(-1, -2)
    gram = Mt @ M
    if ridge:
        gram = gram + ridge * torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    out = _solve_psd_with_pinv_fallback(gram, Mt @ rhs)
    return out[..., 0] if vec else out


def _solve_psd_with_pinv_fallback(G: Tensor, rhs: Tensor) -> Tensor:
    """Solve G x = rhs for PSD G through its eigh pseudo-inverse (eigenvalues
    below ``eps * n * max|w|`` are dropped)."""
    w, U = torch.linalg.eigh(G)
    tol = torch.finfo(G.dtype).eps * G.shape[-1]
    wmax = w.abs().amax(dim=-1, keepdim=True)
    safe = torch.where(w != 0, w, torch.ones_like(w))
    inv_w = torch.where(w > tol * wmax, 1.0 / safe, torch.zeros_like(w))
    return U @ (inv_w[..., None] * (U.transpose(-1, -2) @ rhs))


def refine(M: Tensor, rhs: Tensor, x: Tensor, solve_fn, iters: int = 2) -> Tensor:
    """Iterative refinement: improves ``x ~= M^-1 rhs`` using ``solve_fn`` as
    the (approximate) inner solver. Residuals and the solution estimate are
    accumulated in :func:`~diffopt_tpu_torch.utils.precision.residual_dtype`
    (f64), so the refined f32 forward error floors near the f32 storage
    epsilon rather than ``cond(M) * eps_f32``."""
    vec = rhs.ndim == M.ndim - 1
    wdt = M.dtype
    rdt = residual_dtype(wdt)
    Mr, rhsr, xr = M.to(rdt), rhs.to(rdt), x.to(rdt)
    for _ in range(iters):
        r = rhsr - ((Mr @ xr[..., None])[..., 0] if vec else Mr @ xr)
        xr = xr + solve_fn(M, r.to(wdt)).to(rdt)
    return xr.to(wdt)


@full_precision
def solve(M: Tensor, rhs: Tensor, method="lu", *, refine_iters: int = 0, ridge: float = 0.0) -> Tensor:
    """Front door used by the diff rules. ``method`` may also be a callable
    ``(M, rhs) -> x`` — the pluggable linear solver."""
    if callable(method):
        fn = method
    elif method == "lu":
        # one factorisation serves the solve and every refinement pass
        lu, piv, _ = torch.linalg.lu_factor_ex(M)
        fn = lambda _M, r: _lu_solve_factored(lu, piv, r)
    elif method == "qr":
        fn = qr_solve_dense
    elif method == "lstsq":
        fn = partial(lstsq_solve_dense, ridge=ridge)
    else:
        raise ValueError(f"unknown solve method {method!r}")
    x = fn(M, rhs)
    if refine_iters:
        x = refine(M, rhs, x, fn, iters=refine_iters)
    return x


def tri_solve(L: Tensor, rhs: Tensor, lower: bool = True, trans: bool = False) -> Tensor:
    """Triangular solve; ``trans`` solves with the transpose of ``L``."""
    if trans:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), rhs, upper=lower)
    return torch.linalg.solve_triangular(L, rhs, upper=not lower)
