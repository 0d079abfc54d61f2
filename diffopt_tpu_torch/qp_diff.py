"""Differentiation verbs for quadratic programs.

Counterpart of ``diffopt_tpu/qp_diff.py``: pure functions over the dataclass
IR that differentiate a *given* primal-dual solution;
:mod:`diffopt_tpu_torch.solvers.qp` provides the embedded solver, and
:func:`diffopt_tpu_torch.solve_qp` fuses both behind ``torch.autograd``.

Both verbs take one instance (fields without a batch dimension) or a
``(B, ...)`` batch; the batch is the port's form of ``vmap``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ir import QPSolution, QPTangent, QuadProgram
from .ops import kkt
from .ops.kkt import KKTSplit
from .utils.precision import full_precision

Tensor = torch.Tensor


def _resolve_method(qp: QuadProgram, method):
    """'auto' picks 'lstsq' for an LP (``Q`` all zero: its KKT matrix is
    singular) and 'lu' otherwise. For one instance that is decided here, on
    the host; a batch keeps 'auto' and :mod:`diffopt_tpu_torch.ops.kkt`
    decides per instance, so an LP inside a mixed batch gets the
    least-squares path, never a silent LU of a singular KKT matrix."""
    if method is None:
        from .utils.config import get_config

        method = get_config().kkt_method
    if method != "auto" or qp.q.ndim > 1:
        return method
    return "lstsq" if float(qp.Q.detach().abs().max()) == 0.0 else "lu"


def _batched(x, batched: bool):
    """Add the batch dimension to every tensor of ``x`` unless it has one."""
    if batched or x is None:
        return x
    if isinstance(x, Tensor):
        return x[None]
    return x.map(lambda t: t[None])


@full_precision
def forward_differentiate(
    qp: QuadProgram,
    sol: QPSolution,
    dqp: QPTangent,
    *,
    method=None,
    refine_iters: int = 0,
) -> KKTSplit:
    """JVP of the QP solution map: tangents (dz, dlam, dnu) for a data
    perturbation ``dqp``. AK17 eq. (6)."""
    batched = qp.q.ndim > 1
    d = kkt.qp_forward(
        _batched(qp, batched), _batched(sol, batched), _batched(dqp, batched),
        method=_resolve_method(qp, method), refine_iters=refine_iters,
    )
    return d if batched else KKTSplit(*(t[0] for t in d))


@full_precision
def reverse_differentiate(
    qp: QuadProgram,
    sol: QPSolution,
    dz: Tensor,
    dlam: Optional[Tensor] = None,
    dnu: Optional[Tensor] = None,
    *,
    method=None,
    refine_iters: int = 0,
) -> QPTangent:
    """VJP of the QP solution map: data cotangents for a primal (and optional
    dual) seed. AK17 eqns (7)-(8)."""
    batched = qp.q.ndim > 1
    grads, _ = kkt.qp_reverse(
        _batched(qp, batched), _batched(sol, batched),
        _batched(dz, batched), _batched(dlam, batched), _batched(dnu, batched),
        method=_resolve_method(qp, method), refine_iters=refine_iters,
    )
    return grads if batched else grads.map(lambda t: t[0])
