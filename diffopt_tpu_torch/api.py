"""Session API: solve once, differentiate many times with cached factors.

Counterpart of ``diffopt_tpu/api.py``. What is worth caching when a user
differentiates the same solved program repeatedly with different seeds is the
*numeric factorization* of the KKT Jacobian; :class:`QPDiffContext` does
exactly that; :class:`ConicDiffContext` caches the residual map's gram
factorizations (or, past the LSQR threshold, the prepared matrix-free
operator).

Also carries the error/status semantics: statuses surface as flags from the
solvers, and this host-side wrapper raises. ``differentiate_time_sec`` is the
wall time of the last ``forward`` / ``reverse`` call (taken after
``torch.cuda.synchronize()`` when the tensors live on a card).

The contexts take one instance (fields without a batch dimension) or a
``(B, ...)`` batch; an instance gets a batch dimension on the way in and
loses it on the way out. :class:`NLPDiffContext` caches the LU (with inertia
correction) of an NLP's KKT Jacobian.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from . import conic_diff
from . import cones as _cones
from .ir import ConeProgram, ConeSolution, ConeTangent, QPSolution, QPTangent, QuadProgram
from .ops import kkt
from .ops.kkt import KKTSplit
from .solvers import qp as qpsolver
from .utils.config import get_config
from .utils.precision import full_precision, residual_dtype

Tensor = torch.Tensor


class NotSolvedError(RuntimeError):
    """Raised when differentiating an unsolved/unconverged program."""


def _lead(t: Tensor) -> Tensor:
    return t[None]


def _drop(struct):
    """Remove the batch dimension the context added (a tensor, any NamedTuple or struct of tensors)."""
    if isinstance(struct, Tensor):
        return struct[0]
    if hasattr(struct, "map"):
        return struct.map(lambda t: t[0])
    return type(struct)(*(t[0] for t in struct))


class QPDiffContext:
    """Solve + differentiate session for one QuadProgram or a ``(B, ...)`` batch.

    ``ctx = QPDiffContext(qp)`` solves (staged solver) and LU-factorizes the
    KKT Jacobian once; every subsequent ``forward(...)`` / ``reverse(...)`` is
    a pair of triangular solves. Create a new context after changing problem
    data (functional invalidation). The LU of a singular KKT matrix (an LP)
    gives inf / NaN without an error: differentiate LPs through
    :func:`~diffopt_tpu_torch.solve_qp` instead.
    """

    @full_precision
    def __init__(
        self,
        qp: QuadProgram,
        sol: Optional[QPSolution] = None,
        *,
        check: bool = True,
        solver_kwargs: Optional[dict] = None,
    ):
        self.qp = qp
        self._single = qp.q.ndim == 1
        if self._single:
            qp = qp.map(_lead)
            sol = None if sol is None else sol.map(_lead)
        self._qp = qp
        t0 = time.perf_counter()
        if sol is None:
            sol, info = qpsolver.solve_batched(qp, **(solver_kwargs or {}))
            if self._single:
                info = _drop(info)
            self.solve_info = info
            if check and not bool(info.converged.all()):
                raise NotSolvedError(
                    "cannot differentiate: solver did not converge "
                    f"(primal {float(info.primal_residual.max()):.2e}, "
                    f"dual {float(info.dual_residual.max()):.2e})"
                )
        else:
            self.solve_info = None
        self._sol = sol
        self.sol = _drop(sol) if self._single else sol
        self._lu, self._piv, _ = torch.linalg.lu_factor_ex(kkt.kkt_jacobian(qp, sol))
        self.differentiate_time_sec = float("nan")
        self._factor_time_sec = time.perf_counter() - t0

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        device = self.sol.tensors()[0].device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.differentiate_time_sec = time.perf_counter() - t0
        return _drop(out) if self._single else out

    def _lu_solve(self, rhs: Tensor, adjoint: bool) -> Tensor:
        return torch.linalg.lu_solve(self._lu, self._piv, rhs[..., None], adjoint=adjoint)[..., 0]

    @full_precision
    def forward(self, dqp: QPTangent) -> KKTSplit:
        """JVP with the cached factorization."""

        if self._single:
            dqp = dqp.map(_lead)

        def run():
            d = -self._lu_solve(kkt.qp_forward_rhs(self._sol, dqp), adjoint=False)
            return kkt._split(d, self.qp.num_vars, self.qp.num_ineq)

        return self._timed(run)

    @full_precision
    def reverse(
        self,
        dz: Tensor,
        dlam: Optional[Tensor] = None,
        dnu: Optional[Tensor] = None,
    ) -> QPTangent:
        """VJP with the cached factorization (the transposed solve reuses the
        same LU)."""

        if self._single:
            dz, dlam, dnu = (None if t is None else t[None] for t in (dz, dlam, dnu))

        def run():
            seed = torch.cat(
                [
                    dz,
                    torch.zeros_like(self._sol.lam) if dlam is None else dlam,
                    torch.zeros_like(self._sol.nu) if dnu is None else dnu,
                ],
                dim=-1,
            )
            g = -self._lu_solve(seed, adjoint=True)
            split = kkt._split(g, self.qp.num_vars, self.qp.num_ineq)
            return kkt.qp_reverse_accumulate(self._qp, self._sol, split)

        return self._timed(run)


class ConicDiffContext:
    """Conic analogue of :class:`QPDiffContext`: solve once, cache the
    residual-map factorization, differentiate repeatedly.

    ``ctx = ConicDiffContext(cp)`` solves with the staged solver that
    ``solver`` names ('auto' as :func:`solve_conic` resolves it, or 'ipm',
    'nsipm', 'dr'; ``solver_kwargs`` go to it), Newton-polishes the point
    (``polish`` steps, dtype-aware default), then caches BOTH directions'
    normal-equation factors — LU of the gram pair ``M'M`` and ``MM'`` with a
    scale-relative ridge (``torch.linalg.lu_factor_ex``, a library LU as in
    the JAX class) — so every ``forward`` / ``reverse`` is triangular solves
    plus two refinement passes in ``residual_dtype``. Past
    ``config.conic_lsqr_threshold`` it caches the prepared matrix-free
    operator instead and runs LSQR per call."""

    @full_precision
    def __init__(
        self,
        cp: ConeProgram,
        sol: Optional[ConeSolution] = None,
        *,
        check: bool = True,
        solver: str = "auto",
        solver_kwargs: Optional[dict] = None,
        polish: Optional[int] = None,
    ):
        self.cp = cp
        self._single = cp.c.ndim == 1
        if self._single:
            cp = cp.map(_lead)
            sol = None if sol is None else sol.map(_lead)
        self._cp = cp
        t0 = time.perf_counter()
        if sol is None:
            # the dispatch of solve_conic(solver='auto'); solver_kwargs go to whichever solver runs
            from .solve import conic_solver_fn, resolve_conic_solver

            sol, info = conic_solver_fn(resolve_conic_solver(solver, cp.cones), **(solver_kwargs or {}))(cp)
            self.solve_info = _drop(info) if self._single else info
            if check and not bool(info.converged.all()):
                raise NotSolvedError(
                    "cannot differentiate: conic solver did not converge "
                    f"(primal {float(info.primal_residual.max()):.2e})"
                )
        else:
            self.solve_info = None
        if polish is None:
            polish = get_config().conic_polish_steps(cp.A.dtype)
        if polish:
            sol = conic_diff.refine_solution(cp, sol, steps=polish)
        self._sol = sol
        self.sol = _drop(sol) if self._single else sol
        self._matfree = conic_diff.resolve_method(cp) == "lsqr"
        if self._matfree:
            self._mv, self._rmv = conic_diff.residual_operator(cp, sol)
            self._M = self._lu = self._lu_t = None
        else:
            M = conic_diff.residual_matrix(cp, sol)
            dt, N = M.dtype, M.shape[-1]
            delta = 1e-12 if dt == torch.float64 else 1e-6
            eye = torch.eye(N, dtype=dt, device=M.device)
            self._M = M

            def ridged(G):
                scale = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[:, None, None] / N
                return G + delta * (1.0 + scale) * eye

            self._lu = torch.linalg.lu_factor_ex(ridged(M.transpose(1, 2) @ M))[:2]
            self._lu_t = torch.linalg.lu_factor_ex(ridged(M @ M.transpose(1, 2)))[:2]
        self.differentiate_time_sec = float("nan")
        self._factor_time_sec = time.perf_counter() - t0

    def _gram_solve(self, rhs: Tensor, transpose: bool) -> Tensor:
        """Least-squares solve of M x = rhs (or M' x = rhs) from the cached
        normal-equation factors with refinement, or LSQR on the cached
        operator past the size threshold."""
        if self._matfree:
            from .ops.lsqr import lsqr

            mv, rmv = (self._rmv, self._mv) if transpose else (self._mv, self._rmv)
            return lsqr(mv, rmv, rhs, rhs.shape[-1], max_iters=get_config().conic_lsqr_iters).x
        M = self._M.transpose(1, 2) if transpose else self._M
        lu, piv = self._lu_t if transpose else self._lu
        gsolve = lambda r: torch.linalg.lu_solve(lu, piv, torch.einsum("bij,bi->bj", M, r)[..., None])[..., 0]
        wdt = M.dtype
        rdt = residual_dtype(wdt)
        Mr, rhsr = M.to(rdt), rhs.to(rdt)
        x = gsolve(rhs).to(rdt)
        for _ in range(2):
            r = rhsr - torch.einsum("bij,bj->bi", Mr, x)
            x = x + gsolve(r.to(wdt)).to(rdt)
        return x.to(wdt)

    _timed = QPDiffContext._timed

    @full_precision
    def forward(self, dcp: ConeTangent) -> "conic_diff.ConeForward":
        """JVP with the cached factorization."""
        if self._single:
            dcp = dcp.map(_lead)

        def run():
            cp, sol = self._cp, self._sol
            v = sol.y - sol.s
            rhs = conic_diff._forward_rhs(cp, sol, dcp, _cones.pi(cp.cones, v))
            return conic_diff._forward_from(cp, sol, v, self._gram_solve(rhs, transpose=False))

        return self._timed(run)

    @full_precision
    def reverse(self, dx: Tensor, dy: Optional[Tensor] = None, ds: Optional[Tensor] = None) -> ConeTangent:
        """VJP with the cached adjoint (MM') factorization."""
        if self._single:
            dx, dy, ds = (None if t is None else t[None] for t in (dx, dy, ds))

        def run():
            cp, sol = self._cp, self._sol
            v = sol.y - sol.s
            seed = conic_diff._reverse_seed(cp, sol, v, dx, dy, ds)
            g = self._gram_solve(seed, transpose=True)
            return conic_diff._reverse_from(cp, sol, _cones.pi(cp.cones, v), g)

        return self._timed(run)


class NLPDiffContext:
    """NLP analogue of :class:`QPDiffContext`: solve (optionally), assemble
    and LU-factorize the KKT Jacobian ``M`` once (with the inertia correction
    of :func:`~diffopt_tpu_torch.nlp_diff.factorize_with_inertia`, or
    ``factorization``), then differentiate many — both directions reuse the
    factorization. ``p`` is one instance ``(np,)`` or a ``(B, np)`` batch on
    the problem's device; ``sol`` (optional) in the same form."""

    @full_precision
    def __init__(
        self,
        nlp,
        p,
        sol=None,
        *,
        check: bool = True,
        factorization=None,
        solver_kwargs: Optional[dict] = None,
    ):
        from . import nlp_diff
        from .solvers import nlp as nlpsolver

        self.nlp = nlp
        self.p = nlp.param(p)
        self._single = self.p.ndim == 1
        p = self.p[None] if self._single else self.p
        if self._single and sol is not None:
            sol = sol.map(_lead)
        t0 = time.perf_counter()
        if sol is None:
            sol, info = nlpsolver.solve(nlp, p, **(solver_kwargs or {}))
            self.solve_info = _drop(info) if self._single else info
            if check and not bool(info.converged.all()):
                raise NotSolvedError(
                    "cannot differentiate: NLP solver did not converge "
                    f"(KKT residual {float(info.kkt_residual.max()):.2e})"
                )
        else:
            self.solve_info = None
        self.sol = _drop(sol) if self._single else sol
        # (layout, lu, piv, singular, N): what the three verbs below solve with
        self._factor = nlp_diff._factored(nlp, sol, p, factorization)
        self.differentiate_time_sec = float("nan")
        self._factor_time_sec = time.perf_counter() - t0

    _timed = QPDiffContext._timed

    @full_precision
    def forward(self, dp):
        """Directional sensitivity with the cached factorization."""
        from . import nlp_diff

        N = self._factor[-1]
        dp = torch.as_tensor(dp, dtype=N.dtype, device=N.device)
        dp = dp[None] if self._single else dp
        return self._timed(lambda: nlp_diff.tangent_from_factor(self.nlp, *self._factor, dp))

    @full_precision
    def jacobian(self):
        """Full ``ds/dp`` with the cached factorization."""
        from . import nlp_diff

        return self._timed(lambda: nlp_diff.jacobian_from_factor(self.nlp, *self._factor))

    @full_precision
    def reverse(self, dx=None, dy=None, dzL=None, dzU=None):
        """Parameter cotangent via one transposed solve on the cached LU."""
        from . import nlp_diff

        seeds = [None if t is None else (t[None] if self._single else t) for t in (dx, dy, dzL, dzU)]
        return self._timed(lambda: nlp_diff.cotangent_from_factor(self.nlp, *self._factor, *seeds))
