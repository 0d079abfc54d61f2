"""Differentiable solve entry points: the autograd-integration layer.

Counterpart of ``diffopt_tpu/solve.py``. ``solve_qp_batched`` is a
``torch.autograd.Function``: it differentiates *through the KKT system at the
solution* (implicit function theorem), never through solver iterations.

Ported so far: ``solve_qp_batched``.
"""

from __future__ import annotations

import torch

from .ir import QPSolution, QuadProgram
from .ops import kkt
from .ops.cuda import pdip
from .solvers import qp as qpsolver
from .solvers.qp import QPSolveInfo
from .utils.config import get_config
from .utils.precision import full_precision


def _poison_unconverged(sol: QPSolution, converged: torch.Tensor) -> QPSolution:
    """NaN out non-converged instances: with ``config.nan_on_unconverged`` a
    silently-wrong gradient from an unconverged solve becomes an
    impossible-to-miss NaN in both the value and anything differentiated
    through it."""
    nan = float("nan")
    return sol.map(lambda a: torch.where(converged[:, None], a, torch.full_like(a, nan)))


class _SolveQPBatched(torch.autograd.Function):
    """forward: fused PDIP -> active-set polish -> metrics / poison;
    backward: LDL' adjoint solve -> accumulate."""

    @staticmethod
    def forward(ctx, Q, q, A, b, G, h, max_iters, method, refine_iters, polish, with_info, poison):
        qp = QuadProgram(*(t.detach() for t in (Q, q, A, b, G, h)))
        sol, iters = pdip.solve_batched_fused(qp, max_iters=max_iters, return_iters=True)
        if polish:
            # active-set polish (ops/kkt.py): removes the f32 sqrt(eps)
            # complementarity floor from the KKT point, which otherwise
            # dominates gradient error on near-degenerate instances
            sol = kkt.qp_polish(qp, sol)
        info = None
        if with_info or poison:
            # residual diagnostics are post-hoc KKT metrics; the iteration
            # count is the kernel's own
            info = qpsolver.kkt_metrics(qp, sol, iterations=iters)
            if poison:
                sol = _poison_unconverged(sol, info.converged)
        ctx.save_for_backward(*qp.tensors(), *sol.tensors())
        ctx.method, ctx.refine_iters = method, refine_iters
        if with_info:
            ctx.mark_non_differentiable(*info)
            return (*sol.tensors(), *info)
        return sol.tensors()

    @staticmethod
    def backward(ctx, gz, glam, gnu, *_info_grads):
        saved = ctx.saved_tensors
        qp, sol = QuadProgram(*saved[:6]), QPSolution(*saved[6:])
        grads, _ = kkt.qp_reverse(
            qp, sol, gz, glam, gnu, method=ctx.method, refine_iters=ctx.refine_iters
        )
        return (grads.dQ, grads.dq, grads.dA, grads.db, grads.dG, grads.dh) + (None,) * 6


@full_precision
def solve_qp_batched(
    qp: QuadProgram,
    *,
    max_iters: int = 25,
    method: str = "ldl",
    refine_iters: int = 2,
    polish: bool = True,
    with_info: bool = False,
):
    """Solve a ``(B, ...)`` batch of QPs with the fused single-kernel PDIP
    (``ops/cuda/pdip.py``), active-set polish the KKT points, and
    differentiate through the LDL' KKT path (``ops/cuda/chol.py``). Gradients
    flow to all six data tensors. ``with_info=True`` returns ``(sol, info)``
    with post-hoc KKT residual diagnostics
    (:func:`~diffopt_tpu_torch.solvers.qp.kkt_metrics`) and the kernel's
    iteration counts as a non-differentiable output.

    Runs where the tensors live: CUDA tensors go through the kernels, CPU
    tensors through their plain versions."""
    out = _SolveQPBatched.apply(
        *qp.tensors(), max_iters, method, refine_iters, polish, with_info,
        get_config().nan_on_unconverged,
    )
    sol = QPSolution(*out[:3])
    return (sol, QPSolveInfo(*out[3:])) if with_info else sol
