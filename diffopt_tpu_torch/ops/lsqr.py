"""Matrix-free LSQR (Paige & Saunders) on batched linear operators.

Counterpart of ``diffopt_tpu/ops/lsqr.py``. Works on a pair of closures
``(matvec, rmatvec)`` acting on ``(B, k)`` tensors, so the conic residual
operator M can be applied blockwise (A, A', DPi) without materializing it.
Batch-first: the JAX module's ``vmap`` of a ``while_loop`` written out — every
instance runs the recurrence until its own tolerance is met, and a converged
instance keeps its state by select while the others go on. Returns the
minimum-norm least-squares solution for singular/inconsistent systems.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.precision import full_precision

Tensor = torch.Tensor


class LSQRResult(NamedTuple):
    x: Tensor
    iterations: Tensor  # int32, per instance
    residual_norm: Tensor  # ||A'r|| — the least-squares optimality measure
    converged: Tensor  # bool, per instance (internal: no public entry point surfaces it)


def _normalize(v: Tensor):
    n = torch.linalg.vector_norm(v, dim=-1)
    safe = torch.where(n > 0, n, torch.ones_like(n))
    return v / safe[:, None], n


@full_precision
def lsqr(
    matvec: Callable[[Tensor], Tensor],
    rmatvec: Callable[[Tensor], Tensor],
    b: Tensor,
    x_size: int,
    *,
    max_iters: int = 200,
    atol: float | None = None,
) -> LSQRResult:
    """Solve ``min ||A x - b||_2`` per instance, ``A`` given as (matvec,
    rmatvec) on ``(B, k)`` tensors and ``b (B, m)``. The loop stops once every
    instance has converged (one device-to-host copy per iteration)."""
    dt = b.dtype
    if atol is None:
        atol = 1e-10 if dt == torch.float64 else 1e-5
    B = b.shape[0]
    u, beta = _normalize(b)
    v, alpha = _normalize(rmatvec(u))
    x = b.new_zeros(B, x_size)
    w = v
    rhobar, phibar = alpha, beta
    it = torch.zeros(B, dtype=torch.int32, device=b.device)
    done = alpha * beta == 0
    arnorm = alpha * beta
    best_x, best_arnorm = x, arnorm
    arnorm0 = arnorm
    for _ in range(max_iters):
        if bool(done.all()):
            break
        active = ~done
        # bidiagonalization
        u_n, beta_n = _normalize(matvec(v) - alpha[:, None] * u)
        v_n, alpha_n = _normalize(rmatvec(u_n) - beta_n[:, None] * v)
        # orthogonal transformation
        rho = torch.sqrt(rhobar**2 + beta_n**2)
        c = rhobar / rho
        s = beta_n / rho
        theta = s * alpha_n
        rhobar_n = -c * alpha_n
        phi = c * phibar
        phibar_n = s * phibar
        x_n = x + (phi / rho)[:, None] * w
        w_n = v_n - (theta / rho)[:, None] * w
        arnorm_n = alpha_n * (s * phibar).abs()
        # keep the best iterate: after a rank breakdown the recurrences amplify noise
        better = arnorm_n < best_arnorm
        best_x_n = torch.where(better[:, None], x_n, best_x)
        best_arnorm_n = torch.where(better, arnorm_n, best_arnorm)
        done_n = arnorm_n <= atol * torch.clamp(arnorm0, min=1.0)
        # a converged instance keeps every field
        keep = lambda new, old: torch.where(active.view(-1, *([1] * (new.ndim - 1))), new, old)
        x, u, v, w = keep(x_n, x), keep(u_n, u), keep(v_n, v), keep(w_n, w)
        alpha, beta = keep(alpha_n, alpha), keep(beta_n, beta)
        rhobar, phibar = keep(rhobar_n, rhobar), keep(phibar_n, phibar)
        arnorm = keep(arnorm_n, arnorm)
        best_x, best_arnorm = keep(best_x_n, best_x), keep(best_arnorm_n, best_arnorm)
        it = keep(it + 1, it)
        done = keep(done_n, done)
    return LSQRResult(x=best_x, iterations=it, residual_norm=best_arnorm, converged=done)


@full_precision
def lsqr_dense(M: Tensor, b: Tensor, **kw) -> LSQRResult:
    """LSQR on a materialized ``(B, m, k)`` matrix."""
    return lsqr(
        lambda x: (M @ x[..., None])[..., 0], lambda y: (M.transpose(-1, -2) @ y[..., None])[..., 0], b, M.shape[-1], **kw
    )
