"""Differentiable solve entry points: the autograd-integration layer.

Counterpart of ``diffopt_tpu/solve.py``. ``solve_qp_batched`` is a
``torch.autograd.Function``: it differentiates *through the KKT system at the
solution* (implicit function theorem), never through solver iterations.

``solve_qp`` runs the staged interior-point solver and registers both a
reverse and a forward rule; ``solve_qp_batched`` runs the fused single-kernel
solver with the polish and the LDL' adjoint. ``solve_conic`` and
``solve_conic_batched`` are their conic counterparts: the staged NT-scaled
IPM with both rules, and the fused conic kernel with the ``gram`` polish and
adjoint.
"""

from __future__ import annotations

import torch

from . import conic_diff
from .ir import ConeProgram, ConeSolution, ConeTangent, QPSolution, QPTangent, QuadProgram
from .ops import kkt
from .ops.cuda import pdip
from .solvers import conic_ipm
from .solvers import qp as qpsolver
from .solvers.conic import ConicSolveInfo
from .solvers.qp import QPSolveInfo
from .utils.config import get_config
from .utils.precision import full_precision


def _poison_unconverged(sol, converged: torch.Tensor):
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


# ---------------------------------------------------------------------------
# Conic programs
# ---------------------------------------------------------------------------

_CONIC_WAITING = (
    "solver={!r}: the nonsymmetric IPM and the DR splitting come with the slice of the port that brings "
    "kernel K7 (solvers/conic_nsipm.py, solvers/conic.py, ops/pallas/ns_pdip.py)"
)


class _SolveConic(torch.autograd.Function):
    """forward: staged IPM (``fused=False``) or the fused kernel (``fused=True``)
    -> HSDE Newton polish -> poison; backward: adjoint solve of the residual
    map; jvp: tangent solve. The dataclasses are flattened to tensors here."""

    @staticmethod
    def forward(ctx, A, b, c, cones, fused, max_iters, tol, method, refine_iters, polish, with_info, poison):
        cp = ConeProgram(A.detach(), b.detach(), c.detach(), cones)
        if fused:
            sol, info = conic_ipm.solve_batched_fused(cp, max_iters=max_iters, tol=tol)
        else:
            sol, info = conic_ipm.solve_batched(cp, max_iters=max_iters, tol=tol)
        if polish:
            sol = conic_diff.refine_solution(cp, sol, steps=polish, method="gram" if fused else method)
        if poison:
            sol = _poison_unconverged(sol, info.converged)
        ctx.save_for_backward(*cp.tensors(), *sol.tensors())
        ctx.save_for_forward(*cp.tensors(), *sol.tensors())
        ctx.cones, ctx.method, ctx.refine_iters, ctx.with_info = cones, method, refine_iters, with_info
        if with_info:
            ctx.mark_non_differentiable(*info)
            return (*sol.tensors(), *info)
        return sol.tensors()

    @staticmethod
    def _saved(ctx):
        t = ctx.saved_tensors
        return ConeProgram(*t[:3], ctx.cones), ConeSolution(*t[3:])

    @staticmethod
    def backward(ctx, gx, gy, gs, *_info_grads):
        cp, sol = _SolveConic._saved(ctx)
        g = conic_diff.reverse_differentiate(
            cp, sol, gx, gy, gs, method=ctx.method, refine_iters=ctx.refine_iters
        )
        return (g.dA, g.db, g.dc) + (None,) * 9

    @staticmethod
    def jvp(ctx, dA, db, dc, *_options):
        cp, sol = _SolveConic._saved(ctx)
        # an input without a tangent arrives as None: a zero perturbation
        dcp = ConeTangent(*(torch.zeros_like(x) if t is None else t for x, t in zip(cp.tensors(), (dA, db, dc))))
        d = conic_diff.forward_differentiate(cp, sol, dcp, method=ctx.method, refine_iters=ctx.refine_iters)
        return (d.dx, d.dy, d.ds) + ((None,) * 5 if ctx.with_info else ())


def _run_conic(cp, fused, max_iters, tol, method, refine_iters, polish, with_info, poison):
    batched = cp.c.ndim > 1
    tensors = cp.tensors() if batched else tuple(t[None] for t in cp.tensors())
    out = _SolveConic.apply(
        *tensors, cp.cones, fused, max_iters, tol, method, refine_iters, polish, with_info, poison
    )
    if not batched:
        out = tuple(t[0] for t in out)
    sol = ConeSolution(*out[:3])
    return (sol, ConicSolveInfo(*out[3:])) if with_info else sol


@full_precision
def solve_conic(
    cp: ConeProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    method: str | None = None,
    refine_iters: int | None = None,
    mode: str = "vjp",
    solver: str = "auto",
    polish: int | None = None,
    with_info: bool = False,
):
    """Solve a cone program differentiably (implicit differentiation of the
    homogeneous self-dual embedding at the solution). ``cp`` is one instance
    or a ``(B, ...)`` batch.

    ``solver='auto'`` / ``'ipm'`` runs the staged NT-scaled interior-point
    method (``solvers/conic_ipm.py::solve_batched``) on symmetric-cone
    programs (zero/nonneg/nonpos/soc/rsoc/psd); ``'nsipm'`` and ``'dr'``, exp/
    pow blocks and equality-only programs raise ``NotImplementedError`` until
    the slice of the port that brings them. ``polish`` Newton-refines the
    solved point against the HSDE residual map before differentiating
    (:func:`conic_diff.refine_solution`). ``max_iters``/``tol``/``method``/
    ``refine_iters``/``polish`` default from the active config (per dtype).

    Both AD rules sit on one ``torch.autograd.Function`` (``backward`` and
    ``jvp``); ``mode`` ('vjp' or 'jvp') is kept for parity with the JAX
    package, where it picks which rule is registered. ``with_info=True``
    returns ``(sol, info)`` with the solver's
    :class:`~diffopt_tpu_torch.solvers.conic.ConicSolveInfo` as a
    non-differentiable output; with ``config.nan_on_unconverged`` the
    unconverged instances are NaN-poisoned."""
    if mode not in ("vjp", "jvp"):
        raise ValueError(f"mode must be 'vjp' or 'jvp', got {mode!r}")
    if solver in ("nsipm", "dr"):
        raise NotImplementedError(_CONIC_WAITING.format(solver))
    if solver not in ("auto", "ipm"):
        raise ValueError(f"solver must be 'auto', 'ipm', 'nsipm' or 'dr', got {solver!r}")
    conic_ipm._check_supported(cp.cones)
    cfg = get_config()
    dt = cp.A.dtype
    method = cfg.conic_method if method is None else method
    refine_iters = cfg.conic_refine(dt) if refine_iters is None else refine_iters
    polish = cfg.conic_polish_steps(dt) if polish is None else polish
    return _run_conic(cp, False, max_iters, tol, method, refine_iters, polish, with_info, cfg.nan_on_unconverged)


@full_precision
def solve_conic_batched(
    cp: ConeProgram,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    method: str = "gram",
    refine_iters: int = 2,
    polish: int | None = None,
    with_info: bool = False,
):
    """Solve a ``(B, ...)`` batch of symmetric-cone programs with the fused
    single-kernel IPM (``ops/cuda/conic_pdip.py``; the staged solver for
    layouts past its envelope), Newton-polish the solved points against the
    HSDE residual on the ``gram`` route (dtype-aware default number of
    steps), and differentiate through the homogeneous-embedding residual at
    the solutions (``method='gram'``: the normal equations on the Cholesky
    kernels). The highest-throughput conic entry point (BASELINE config 3).
    ``with_info=True`` returns ``(sol, info)`` with per-instance diagnostics
    as a non-differentiable output."""
    conic_ipm._check_supported(cp.cones)
    if cp.c.ndim != 2:
        raise ValueError(f"solve_conic_batched takes a (B, ...) batch, got c of shape {tuple(cp.c.shape)}")
    cfg = get_config()
    polish = cfg.conic_polish_steps(cp.A.dtype) if polish is None else polish
    return _run_conic(cp, True, max_iters, tol, method, refine_iters, polish, with_info, cfg.nan_on_unconverged)
