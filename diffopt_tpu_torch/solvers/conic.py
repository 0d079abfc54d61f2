"""Diagnostics of the conic solvers. Counterpart of the ``ConicSolveInfo`` of
``diffopt_tpu/solvers/conic.py``; the DR splitting of that module comes with
the slice of the port that brings the nonsymmetric cones (kernel K7)."""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class ConicSolveInfo(NamedTuple):
    iterations: Tensor  # int32, per instance
    primal_residual: Tensor
    dual_residual: Tensor
    gap: Tensor
    converged: Tensor  # bool
