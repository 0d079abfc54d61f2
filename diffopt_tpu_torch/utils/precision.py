"""Full-precision matmul scope for KKT solves and implicit differentiation.

Counterpart of ``diffopt_tpu/utils/precision.py``. On an NVIDIA card an f32
``matmul`` may run on the tensor cores in TF32 (about three decimal digits)
when ``allow_tf32`` / a lower ``float32_matmul_precision`` is set by the
surrounding program. That is the wrong trade for Newton systems: a TF32
residual matvec floors iterative refinement far above the 1e-6 gradient
agreement this framework targets. Every public solve/differentiate entry
point runs under :func:`full_precision`, which forces both switches for the
duration of the call and restores the caller's settings afterwards.
"""

from __future__ import annotations

from functools import wraps

import torch


def residual_dtype(dtype):
    """Accumulation dtype for iterative-refinement residuals.

    Classic mixed-precision refinement: factor and solve in the working dtype,
    accumulate residuals (and the solution estimate) in a wider one, so the
    refined forward error floors at the storage epsilon of the working dtype
    instead of ``cond * eps``. PyTorch always has float64, so this is float64
    for every working dtype — what the JAX package does with x64 enabled."""
    return torch.float64


def full_precision(fn):
    """Decorator: run ``fn`` with TF32 matmuls off and f32 matmul precision
    ``"highest"``."""

    @wraps(fn)
    def wrapped(*args, **kwargs):
        prev_tf32 = torch.backends.cuda.matmul.allow_tf32
        prev_prec = torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(prev_prec)
            torch.backends.cuda.matmul.allow_tf32 = prev_tf32

    return wrapped
