"""Batched eigendecomposition of SMALL symmetric matrices via cyclic Jacobi.

Counterpart of ``diffopt_tpu/ops/smalleig.py``. Every PSD cone block
produces a batch of tiny symmetric matrices (side d <= ~8, batch 10^3..10^5);
cyclic Jacobi with a static number of sweeps handles the whole batch with a
handful of elementwise ops per rotation, and its arithmetic is exactly what
the fused conic kernel (``csrc/conic_pdip.cu``) does on one warp per matrix,
so the kernel's plain version (``ops/cuda/conic_pdip.py``) reuses it.

Past :data:`MAX_JACOBI_SIDE` the library eigensolver (``torch.linalg.eigh``)
takes over, as the JAX module hands those sides to ``jnp.linalg.eigh``. The
JAX call returns NaN for a matrix it cannot decompose; the PyTorch call raises
for the whole batch (CUDA's batched Jacobi reports a failure to converge on a
matrix whose entries span the f32 range, which an interior point with a
floored eigenvalue produces). So the library route decomposes in f64, and a
matrix with a non-finite entry gets NaN eigenvalues and vectors without
reaching the library, as in the reference.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Past this side length the unrolled pair loop stops paying for itself and the
# library eigensolver wins; PSD blocks in this framework are tiny in practice.
MAX_JACOBI_SIDE = 12


def _sweeps_for(d: int, dtype) -> int:
    # quadratic convergence: d <= 4 needs ~6 sweeps to roundoff, d <= 12 ~10;
    # f64 takes two more
    base = 6 if d <= 4 else (8 if d <= 8 else 10)
    return base if dtype != torch.float64 else base + 2


def jacobi_eigh(A: Tensor, sweeps: int | None = None, vectors: bool = True):
    """Eigendecomposition ``A = V diag(w) V'`` of a symmetric ``(..., d, d)``
    batch. Eigenvalues are NOT sorted (every consumer is order-free).

    Rotations use the Rutishauser tangent ``t = sign(tau) / (|tau| + hypot(1,
    tau))``; a rotation is skipped (``t = 0``) once ``|a_pq| <= eps (|a_pp| +
    |a_qq|)``, i.e. once it is a no-op in working precision. ``vectors=False``
    skips the accumulation of V and returns ``(w, None)``."""
    d = A.shape[-1]
    dt = A.dtype
    if sweeps is None:
        sweeps = _sweeps_for(d, dt)
    if d == 1:
        w = A[..., 0, 0][..., None]
        return (w, torch.ones_like(A)) if vectors else (w, None)
    eps = torch.finfo(dt).eps
    A = A.clone()
    V = torch.eye(d, dtype=dt, device=A.device).expand(A.shape).clone() if vectors else None
    one = torch.ones((), dtype=dt, device=A.device)
    for _ in range(sweeps):
        for p in range(d - 1):
            for q in range(p + 1, d):
                app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
                small = apq.abs() <= eps * (app.abs() + aqq.abs())
                apq_s = torch.where(small, one, apq)
                tau = 0.5 * (aqq - app) / apq_s
                t = torch.where(
                    small,
                    torch.zeros_like(tau),
                    torch.where(tau >= 0, one, -one) / (tau.abs() + torch.hypot(one, tau)),
                )
                ct = torch.hypot(one, t)
                c = (1.0 / ct)[..., None]
                s = (t / ct)[..., None]
                # A <- J' A J with J the (p, q) Givens rotation: rows, then columns
                rowp, rowq = A[..., p, :].clone(), A[..., q, :].clone()
                A[..., p, :] = c * rowp - s * rowq
                A[..., q, :] = s * rowp + c * rowq
                colp, colq = A[..., :, p].clone(), A[..., :, q].clone()
                A[..., :, p] = c * colp - s * colq
                A[..., :, q] = s * colp + c * colq
                if vectors:
                    vp, vq = V[..., :, p].clone(), V[..., :, q].clone()
                    V[..., :, p] = c * vp - s * vq
                    V[..., :, q] = s * vp + c * vq
    return torch.diagonal(A, dim1=-2, dim2=-1).clone(), V


def _library_eigh(A: Tensor, vectors: bool):
    finite = torch.isfinite(A).flatten(-2).all(-1)
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    work = torch.where(finite[..., None, None], A.to(torch.float64), eye)
    nan = torch.tensor(float("nan"), dtype=A.dtype, device=A.device)
    if not vectors:
        return torch.where(finite[..., None], torch.linalg.eigvalsh(work).to(A.dtype), nan), None
    w, V = torch.linalg.eigh(work)
    return torch.where(finite[..., None], w.to(A.dtype), nan), torch.where(finite[..., None, None], V.to(A.dtype), nan)


def eigh_small(A: Tensor):
    """``(w, V) = eigh(A)``: Jacobi up to :data:`MAX_JACOBI_SIDE` (eigenvalues
    unsorted), the library eigensolver past it."""
    if A.shape[-1] <= MAX_JACOBI_SIDE:
        return jacobi_eigh(A)
    return _library_eigh(A, True)


def eigvalsh_small(A: Tensor) -> Tensor:
    if A.shape[-1] <= MAX_JACOBI_SIDE:
        return jacobi_eigh(A, vectors=False)[0]
    return _library_eigh(A, False)[0]
