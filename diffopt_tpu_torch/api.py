"""Session API: solve once, differentiate many times with cached factors.

Counterpart of ``diffopt_tpu/api.py``. What is worth caching when a user
differentiates the same solved program repeatedly with different seeds is the
*numeric factorization* of the KKT Jacobian; :class:`QPDiffContext` does
exactly that.

Also carries the error/status semantics: statuses surface as flags from the
solvers, and this host-side wrapper raises. ``differentiate_time_sec`` is the
wall time of the last ``forward`` / ``reverse`` call (taken after
``torch.cuda.synchronize()`` when the tensors live on a card).

The conic and NLP contexts come with their slices of the port.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .ir import QPSolution, QPTangent, QuadProgram
from .ops import kkt
from .ops.kkt import KKTSplit
from .solvers import qp as qpsolver
from .utils.precision import full_precision

Tensor = torch.Tensor


class NotSolvedError(RuntimeError):
    """Raised when differentiating an unsolved/unconverged program."""


class QPDiffContext:
    """Solve + differentiate session for one ``(B, ...)`` batched QuadProgram.

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
        t0 = time.perf_counter()
        if sol is None:
            sol, info = qpsolver.solve_batched(qp, **(solver_kwargs or {}))
            self.solve_info = info
            if check and not bool(info.converged.all()):
                raise NotSolvedError(
                    "cannot differentiate: solver did not converge "
                    f"(primal {float(info.primal_residual.max()):.2e}, "
                    f"dual {float(info.dual_residual.max()):.2e})"
                )
        else:
            self.solve_info = None
        self.sol = sol
        self._lu, self._piv, _ = torch.linalg.lu_factor_ex(kkt.kkt_jacobian(qp, sol))
        self.differentiate_time_sec = float("nan")
        self._factor_time_sec = time.perf_counter() - t0

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.qp.Q.is_cuda:
            torch.cuda.synchronize(self.qp.Q.device)
        self.differentiate_time_sec = time.perf_counter() - t0
        return out

    def _lu_solve(self, rhs: Tensor, adjoint: bool) -> Tensor:
        return torch.linalg.lu_solve(self._lu, self._piv, rhs[..., None], adjoint=adjoint)[..., 0]

    @full_precision
    def forward(self, dqp: QPTangent) -> KKTSplit:
        """JVP with the cached factorization."""

        def run():
            d = -self._lu_solve(kkt.qp_forward_rhs(self.sol, dqp), adjoint=False)
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

        def run():
            seed = torch.cat(
                [
                    dz,
                    torch.zeros_like(self.sol.lam) if dlam is None else dlam,
                    torch.zeros_like(self.sol.nu) if dnu is None else dnu,
                ],
                dim=-1,
            )
            g = -self._lu_solve(seed, adjoint=True)
            split = kkt._split(g, self.qp.num_vars, self.qp.num_ineq)
            return kkt.qp_reverse_accumulate(self.qp, self.sol, split)

        return self._timed(run)
