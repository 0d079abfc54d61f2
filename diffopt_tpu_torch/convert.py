"""Problem data and solutions in and out of the port, through numpy.

This system's "weights and state" are problem data and solutions. The JAX
package holds them as pytrees of ``jax.Array``; the port never imports jax,
so the hand-over is numpy: anything whose fields ``numpy.asarray`` accepts (a
``diffopt_tpu.QuadProgram`` of jax arrays included, through the array
protocol) becomes the port's dataclass of tensors, dtype and device explicit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ir import QPSolution, QPTangent, QuadProgram


def _from_fields(cls, src, dtype, device):
    names = [f.name for f in dataclasses.fields(cls)]
    get = (lambda k: src[k]) if isinstance(src, dict) else (lambda k: getattr(src, k))
    return cls(*(torch.tensor(np.asarray(get(k)), dtype=dtype, device=device) for k in names))


def quadprogram_from_numpy(src, *, dtype, device) -> QuadProgram:
    """``src``: an object or dict with array-like ``Q, q, A, b, G, h``."""
    return _from_fields(QuadProgram, src, dtype, device)


def qpsolution_from_numpy(src, *, dtype, device) -> QPSolution:
    """``src``: an object or dict with array-like ``z, lam, nu``."""
    return _from_fields(QPSolution, src, dtype, device)


def qptangent_from_numpy(src, *, dtype, device) -> QPTangent:
    """``src``: an object or dict with array-like ``dQ, dq, dA, db, dG, dh``."""
    return _from_fields(QPTangent, src, dtype, device)


def to_numpy(struct) -> dict:
    """Field name -> numpy array (on the host) of any of the port's structs."""
    return {
        f.name: getattr(struct, f.name).detach().cpu().numpy() for f in dataclasses.fields(struct)
    }
