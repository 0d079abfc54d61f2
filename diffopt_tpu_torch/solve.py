"""Differentiable solve entry points: the autograd-integration layer.

Counterpart of ``diffopt_tpu/solve.py``. ``solve_qp_batched`` is a
``torch.autograd.Function``: it differentiates *through the KKT system at the
solution* (implicit function theorem), never through solver iterations.

``solve_qp`` runs the staged interior-point solver and registers both a
reverse and a forward rule; ``solve_qp_batched`` runs the fused single-kernel
solver with the polish and the LDL' adjoint. ``solve_conic`` and
``solve_conic_batched`` are their conic counterparts: the staged NT-scaled
IPM with both rules, and the fused conic kernel with the ``gram`` polish and
adjoint. ``solve_nlp`` runs the embedded NLP interior-point solver with the
sIpopt reverse and forward rules.
"""

from __future__ import annotations

import torch

from . import conic_diff
from .ir import ConeProgram, ConeSolution, ConeTangent, QPSolution, QPTangent, QuadProgram
from .ops import kkt
from .ops.cuda import pdip
from .solvers import conic as conicsolver
from .solvers import conic_ipm, conic_nsipm
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

def resolve_conic_solver(solver: str, cones) -> str:
    """``solver='auto'`` -> 'ipm' for symmetric-cone programs with a non-zero block, 'nsipm' for programs
    with exp/pow blocks, 'dr' for equality-only ones; 'ipm' / 'nsipm' / 'dr' force one."""
    if solver not in ("auto", "ipm", "nsipm", "dr"):
        raise ValueError(f"solver must be 'auto', 'ipm', 'nsipm' or 'dr', got {solver!r}")
    if solver != "auto":
        return solver
    nonzero = any(k != "zero" for k, _, _ in cones.blocks)
    if conic_ipm.supports(cones) and nonzero:
        return "ipm"
    if conic_nsipm.supports(cones) and nonzero:
        return "nsipm"
    return "dr"


def conic_solver_fn(solver: str, **kw):
    """The batch solver a resolved ``solver`` name stands for (``kw``: its keyword arguments; ``alpha``
    reaches only the DR splitting); 'fused' is the fused-kernel route of ``solve_conic_batched``."""
    alpha = kw.pop("alpha", None)
    if solver == "fused":
        return lambda cp: conic_ipm.solve_batched_fused(cp, **kw)
    if solver == "ipm":
        return lambda cp: conic_ipm.solve_batched(cp, **kw)
    if solver == "nsipm":
        return lambda cp: conic_nsipm.solve_batched(cp, **kw)
    return lambda cp: conicsolver.solve_batched(cp, alpha=alpha, **kw)


class _SolveConic(torch.autograd.Function):
    """forward: the solver (``'ipm'`` / ``'nsipm'`` / ``'dr'`` staged, or ``'fused'``: the fused kernels
    by shape) -> HSDE Newton polish -> poison; backward: adjoint solve of the residual map; jvp: tangent
    solve. The dataclasses are flattened to tensors here."""

    @staticmethod
    def forward(ctx, A, b, c, cones, solver, max_iters, tol, alpha, method, refine_iters, polish, with_info, poison):
        cp = ConeProgram(A.detach(), b.detach(), c.detach(), cones)
        sol, info = conic_solver_fn(solver, max_iters=max_iters, tol=tol, alpha=alpha)(cp)
        if polish:
            sol = conic_diff.refine_solution(cp, sol, steps=polish, method="gram" if solver == "fused" else method)
        if poison:
            sol = _poison_unconverged(sol, info.converged)
        # forward-mode AD refuses outputs that are views (the polish slices x, y, s out of one vector)
        sol = sol.map(lambda t: t.clone() if t._base is not None else t)
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
        return (g.dA, g.db, g.dc) + (None,) * 10

    @staticmethod
    def jvp(ctx, dA, db, dc, *_options):
        cp, sol = _SolveConic._saved(ctx)
        # an input without a tangent arrives as None: a zero perturbation
        dcp = ConeTangent(*(torch.zeros_like(x) if t is None else t for x, t in zip(cp.tensors(), (dA, db, dc))))
        d = conic_diff.forward_differentiate(cp, sol, dcp, method=ctx.method, refine_iters=ctx.refine_iters)
        return (d.dx, d.dy, d.ds) + ((None,) * 5 if ctx.with_info else ())


def _run_conic(cp, solver, max_iters, tol, alpha, method, refine_iters, polish, with_info, poison):
    batched = cp.c.ndim > 1
    tensors = cp.tensors() if batched else tuple(t[None] for t in cp.tensors())
    out = _SolveConic.apply(
        *tensors, cp.cones, solver, max_iters, tol, alpha, method, refine_iters, polish, with_info, poison
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
    alpha: float | None = None,
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

    ``solver='auto'`` runs the staged NT-scaled interior-point method
    (``solvers/conic_ipm.py``) on symmetric-cone programs (zero/nonneg/nonpos/
    soc/rsoc/psd), the staged nonsymmetric-cone IPM (``solvers/conic_nsipm.py``)
    on programs with exp/pow/dual_exp/dual_pow blocks, and the DR splitting
    (``solvers/conic.py``) on equality-only programs; ``'ipm'`` / ``'nsipm'`` /
    ``'dr'`` force one (``alpha``, the over-relaxation, reaches only DR).
    ``polish`` Newton-refines the solved point against the HSDE residual map
    before differentiating (:func:`conic_diff.refine_solution`).
    ``max_iters``/``tol``/``method``/``refine_iters``/``polish`` default from
    the active config (per solver and dtype).

    Both AD rules sit on one ``torch.autograd.Function`` (``backward`` and
    ``jvp``); ``mode`` ('vjp' or 'jvp') is kept for parity with the JAX
    package, where it picks which rule is registered. ``with_info=True``
    returns ``(sol, info)`` with the solver's
    :class:`~diffopt_tpu_torch.solvers.conic.ConicSolveInfo` as a
    non-differentiable output; with ``config.nan_on_unconverged`` the
    unconverged instances are NaN-poisoned."""
    if mode not in ("vjp", "jvp"):
        raise ValueError(f"mode must be 'vjp' or 'jvp', got {mode!r}")
    solver = resolve_conic_solver(solver, cp.cones)
    cfg = get_config()
    dt = cp.A.dtype
    method = cfg.conic_method if method is None else method
    refine_iters = cfg.conic_refine(dt) if refine_iters is None else refine_iters
    polish = cfg.conic_polish_steps(dt) if polish is None else polish
    return _run_conic(cp, solver, max_iters, tol, alpha, method, refine_iters, polish, with_info, cfg.nan_on_unconverged)


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
    """Solve a ``(B, ...)`` batch of conic programs with a fused single-kernel
    IPM — K6 (``ops/cuda/conic_pdip.py``) for the symmetric cones, K7
    (``ops/cuda/ns_pdip.py``) for programs with exp/pow blocks, each with its
    staged solver for layouts past its envelope, the DR splitting for
    equality-only programs — Newton-polish the solved points against the
    HSDE residual on the ``gram`` route (dtype-aware default number of
    steps), and differentiate through the homogeneous-embedding residual at
    the solutions (``method='gram'``: the normal equations on the Cholesky
    kernels). The highest-throughput conic entry point (BASELINE config 3).
    ``with_info=True`` returns ``(sol, info)`` with per-instance diagnostics
    as a non-differentiable output."""
    if cp.c.ndim != 2:
        raise ValueError(f"solve_conic_batched takes a (B, ...) batch, got c of shape {tuple(cp.c.shape)}")
    cfg = get_config()
    polish = cfg.conic_polish_steps(cp.A.dtype) if polish is None else polish
    return _run_conic(cp, "fused", max_iters, tol, None, method, refine_iters, polish, with_info, cfg.nan_on_unconverged)


# ---------------------------------------------------------------------------
# NLP
# ---------------------------------------------------------------------------

from . import nlp_diff  # noqa: E402
from .nlp_diff import NLPProblem, NLPSolution  # noqa: E402
from .solvers import nlp as nlpsolver  # noqa: E402
from .solvers.nlp import NLPSolveInfo  # noqa: E402


class _SolveNLP(torch.autograd.Function):
    """forward: the embedded interior-point solver -> poison; backward: the sIpopt reverse rule
    (``nlp_diff.reverse_differentiate``); jvp: its forward rule. ``x0`` (a warm start) gets no
    gradient: the solution map of a local optimum does not depend on the start point."""

    @staticmethod
    def forward(ctx, p, x0, nlp, max_iters, tol, with_info, poison):
        p = p.detach()
        sol, info = nlpsolver.solve(nlp, p, x0, max_iters=max_iters, tol=tol)
        if poison:
            sol = _poison_unconverged(sol, info.converged)
        ctx.save_for_backward(p, *sol)
        ctx.save_for_forward(p, *sol)
        ctx.nlp, ctx.with_info = nlp, with_info
        if with_info:
            ctx.mark_non_differentiable(*info)
            return (*sol, *info)
        return tuple(sol)

    @staticmethod
    def backward(ctx, gx, gy, gzL, gzU, *_info_grads):
        p, *sol = ctx.saved_tensors
        dp = nlp_diff.reverse_differentiate(ctx.nlp, NLPSolution(*sol), p, dx=gx, dy=gy, dzL=gzL, dzU=gzU)
        return (dp,) + (None,) * 6

    @staticmethod
    def jvp(ctx, dp, *_options):
        p, *sol = ctx.saved_tensors
        # a parameter without a tangent arrives as None: a zero perturbation
        dp = torch.zeros_like(p) if dp is None else dp
        fwd = nlp_diff.forward_differentiate(ctx.nlp, NLPSolution(*sol), p, dp)
        return (fwd.dx, fwd.dy, fwd.dzL, fwd.dzU) + ((None,) * 5 if ctx.with_info else ())


@full_precision
def solve_nlp(
    nlp: NLPProblem,
    p,
    x0=None,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    mode: str = "vjp",
    with_info: bool = False,
):
    """Solve a parameterized NLP and make the full primal-dual solution
    differentiable w.r.t. ``p`` (implicit sIpopt sensitivity at the local
    optimum, :mod:`diffopt_tpu_torch.nlp_diff`). ``p`` is one instance
    ``(np,)`` or a ``(B, np)`` batch, on the problem's device.

    ``x0`` (optional warm start) is treated as non-differentiable. Both AD
    rules sit on one ``torch.autograd.Function`` (``backward`` and ``jvp``);
    ``mode`` ('vjp' or 'jvp') is kept for parity with the JAX package, where it
    picks which rule is registered; values are identical.

    ``with_info=True`` returns ``(sol, info)`` with the solver's
    :class:`~diffopt_tpu_torch.solvers.nlp.NLPSolveInfo` as a
    non-differentiable output; with ``config.nan_on_unconverged`` unconverged
    instances are NaN-poisoned instead of silently wrong."""
    if mode not in ("vjp", "jvp"):
        raise ValueError(f"mode must be 'vjp' or 'jvp', got {mode!r}")
    p = nlp.param(p)
    single = p.ndim == 1
    if single:
        p = p[None]
    out = _SolveNLP.apply(p, x0, nlp, max_iters, tol, with_info, get_config().nan_on_unconverged)
    if single:
        out = tuple(t[0] for t in out)
    sol = NLPSolution(*out[:4])
    return (sol, NLPSolveInfo(*out[4:])) if with_info else sol
