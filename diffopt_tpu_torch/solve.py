"""Differentiable solve entry points: the autograd-integration layer.

Counterpart of ``diffopt_tpu/solve.py``. ``solve_qp_batched`` is a
``torch.autograd.Function``: it differentiates *through the KKT system at the
solution* (implicit function theorem), never through solver iterations.

``solve_qp`` runs the staged interior-point solver and registers both a
reverse and a forward rule; ``solve_qp_batched`` runs the fused single-kernel
solver with the polish and the LDL' adjoint.
"""

from __future__ import annotations

import torch

from .ir import QPSolution, QPTangent, QuadProgram
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


def _data_cotangents(ctx, gz, glam, gnu):
    """The reverse rule both entry points share: cotangents of the six data
    tensors from the saved problem and solution, by ``ctx.method``."""
    saved = ctx.saved_tensors
    qp, sol = QuadProgram(*saved[:6]), QPSolution(*saved[6:])
    grads, _ = kkt.qp_reverse(qp, sol, gz, glam, gnu, method=ctx.method, refine_iters=ctx.refine_iters)
    return grads.tensors()


class _SolveQP(torch.autograd.Function):
    """forward: staged interior-point solve -> poison; backward: KKT adjoint
    solve -> accumulate; jvp: KKT tangent solve. The dataclasses are flattened
    to tensors at this boundary."""

    @staticmethod
    def forward(ctx, Q, q, A, b, G, h, max_iters, tol, reg, method, refine_iters, with_info, poison):
        qp = QuadProgram(*(t.detach() for t in (Q, q, A, b, G, h)))
        sol, info = qpsolver.solve_batched(qp, max_iters=max_iters, tol=tol, reg=reg)
        if poison:
            sol = _poison_unconverged(sol, info.converged)
        ctx.save_for_backward(*qp.tensors(), *sol.tensors())
        ctx.save_for_forward(*qp.tensors(), *sol.tensors())
        ctx.method, ctx.refine_iters, ctx.with_info = method, refine_iters, with_info
        if with_info:
            ctx.mark_non_differentiable(*info)
            return (*sol.tensors(), *info)
        return sol.tensors()

    @staticmethod
    def backward(ctx, gz, glam, gnu, *_info_grads):
        return _data_cotangents(ctx, gz, glam, gnu) + (None,) * 7

    @staticmethod
    def jvp(ctx, dQ, dq, dA, db, dG, dh, *_options):
        saved = ctx.saved_tensors
        qp, sol = QuadProgram(*saved[:6]), QPSolution(*saved[6:])
        # an input without a tangent arrives as None: a zero perturbation
        dqp = QPTangent(*(
            torch.zeros_like(x) if t is None else t for x, t in zip(qp.tensors(), (dQ, dq, dA, db, dG, dh))
        ))
        d = kkt.qp_forward(qp, sol, dqp, method=ctx.method, refine_iters=ctx.refine_iters)
        return (d.dz, d.dlam, d.dnu) + ((None,) * 5 if ctx.with_info else ())


@full_precision
def solve_qp(
    qp: QuadProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    reg: float | None = None,
    method=None,
    refine_iters: int | None = None,
    mode: str = "vjp",
    with_info: bool = False,
):
    """Solve a QP with the staged interior-point solver
    (``solvers/qp.py::solve_batched``) and make the solution differentiable
    w.r.t. the problem data. ``qp`` is one instance (fields without a batch
    dimension) or a ``(B, ...)`` batch — the batch is the port's form of
    ``vmap(solve_qp)``.

    Both AD rules sit on one ``torch.autograd.Function``: the reverse rule
    serves ``backward`` / ``torch.autograd.grad``, the forward rule
    ``torch.autograd.forward_ad``. ``mode`` ('vjp' or 'jvp') is kept for
    parity with the JAX package, where it picks which of the two is
    registered; values are identical.

    ``with_info=True`` returns ``(sol, info)`` — the solver's
    :class:`~diffopt_tpu_torch.solvers.qp.QPSolveInfo` diagnostics (residuals,
    ``converged``) ride along as a non-differentiable output. With
    ``config.nan_on_unconverged``, unconverged instances are NaN-poisoned
    rather than silently wrong.

    ``method=None`` resolves to the config's ``kkt_method`` (default 'auto':
    LPs route to the least-squares solve of the singular KKT system, decided
    per instance) and ``refine_iters=None`` to its ``kkt_refine_iters``.

    Runs where the tensors live: CUDA tensors go through the kernels, CPU
    tensors through their plain versions."""
    if mode not in ("vjp", "jvp"):
        raise ValueError(f"mode must be 'vjp' or 'jvp', got {mode!r}")
    cfg = get_config()
    if method is None:
        method = cfg.kkt_method
    if refine_iters is None:
        refine_iters = cfg.kkt_refine_iters
    batched = qp.q.ndim > 1
    tensors = qp.tensors() if batched else tuple(t[None] for t in qp.tensors())
    out = _SolveQP.apply(
        *tensors, max_iters, tol, reg, method, refine_iters, with_info, cfg.nan_on_unconverged
    )
    if not batched:
        out = tuple(t[0] for t in out)
    sol = QPSolution(*out[:3])
    return (sol, QPSolveInfo(*out[3:])) if with_info else sol


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
        return _data_cotangents(ctx, gz, glam, gnu) + (None,) * 6


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
