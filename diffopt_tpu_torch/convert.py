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

from .cones import ConeSpec
from .ir import ConeProgram, ConeSolution, ConeTangent, QPSolution, QPTangent, QuadProgram
from .ops.kkt import KKTSplit
from .solvers.conic import ConicSolveInfo
from .solvers.qp import QPSolveInfo


def _field_names(cls):
    return cls._fields if hasattr(cls, "_fields") else [f.name for f in dataclasses.fields(cls)]


def _from_fields(cls, src, dtype, device):
    get = (lambda k: src[k]) if isinstance(src, dict) else (lambda k: getattr(src, k))
    return cls(*(torch.tensor(np.asarray(get(k)), dtype=dtype, device=device) for k in _field_names(cls)))


def quadprogram_from_numpy(src, *, dtype, device) -> QuadProgram:
    """``src``: an object or dict with array-like ``Q, q, A, b, G, h``."""
    return _from_fields(QuadProgram, src, dtype, device)


def qpsolution_from_numpy(src, *, dtype, device) -> QPSolution:
    """``src``: an object or dict with array-like ``z, lam, nu``."""
    return _from_fields(QPSolution, src, dtype, device)


def qptangent_from_numpy(src, *, dtype, device) -> QPTangent:
    """``src``: an object or dict with array-like ``dQ, dq, dA, db, dG, dh``."""
    return _from_fields(QPTangent, src, dtype, device)


def kktsplit_from_numpy(src, *, dtype, device) -> KKTSplit:
    """``src``: an object or dict with array-like ``dz, dlam, dnu``."""
    return _from_fields(KKTSplit, src, dtype, device)


def qpsolveinfo_from_numpy(src, *, device) -> QPSolveInfo:
    """``src``: an object or dict with array-like ``iterations``,
    ``primal_residual``, ``dual_residual``, ``duality_gap``, ``converged``;
    every field keeps its own dtype (int32, floats, bool)."""
    get = (lambda k: src[k]) if isinstance(src, dict) else (lambda k: getattr(src, k))
    return QPSolveInfo(*(torch.tensor(np.asarray(get(k)), device=device) for k in QPSolveInfo._fields))


def conespec_from(src) -> ConeSpec:
    """``src``: anything with a ``blocks`` sequence of ``(kind, dim[, param])``
    (a ``diffopt_tpu.ConeSpec`` included) or such a sequence itself."""
    return ConeSpec(getattr(src, "blocks", src))


def coneprogram_from_numpy(src, *, dtype, device, cones=None) -> ConeProgram:
    """``src``: an object or dict with array-like ``A, b, c`` (and ``cones``
    unless given here)."""
    get = (lambda k: src[k]) if isinstance(src, dict) else (lambda k: getattr(src, k))
    t = lambda k: torch.tensor(np.asarray(get(k)), dtype=dtype, device=device)
    return ConeProgram(t("A"), t("b"), t("c"), conespec_from(get("cones") if cones is None else cones))


def conesolution_from_numpy(src, *, dtype, device) -> ConeSolution:
    """``src``: an object or dict with array-like ``x, y, s``."""
    return _from_fields(ConeSolution, src, dtype, device)


def conetangent_from_numpy(src, *, dtype, device) -> ConeTangent:
    """``src``: an object or dict with array-like ``dA, db, dc``."""
    return _from_fields(ConeTangent, src, dtype, device)


def conicsolveinfo_from_numpy(src, *, device) -> ConicSolveInfo:
    """``src``: an object or dict with array-like ``iterations``,
    ``primal_residual``, ``dual_residual``, ``gap``, ``converged``; every
    field keeps its own dtype."""
    get = (lambda k: src[k]) if isinstance(src, dict) else (lambda k: getattr(src, k))
    return ConicSolveInfo(*(torch.tensor(np.asarray(get(k)), device=device) for k in ConicSolveInfo._fields))


def to_numpy(struct) -> dict:
    """Field name -> numpy array (on the host) of any of the port's structs
    (the dataclasses of ``ir.py`` and the named tuples ``KKTSplit``,
    ``QPSolveInfo``, ``ConicSolveInfo``); a ``ConeProgram``'s ``cones`` comes
    along as its list of blocks."""
    out = {}
    for k in _field_names(type(struct)):
        v = getattr(struct, k)
        out[k] = list(v.blocks) if isinstance(v, ConeSpec) else v.detach().cpu().numpy()
    return out
