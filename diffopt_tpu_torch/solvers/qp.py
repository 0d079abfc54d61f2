"""QP solve diagnostics. Counterpart of ``diffopt_tpu/solvers/qp.py``.

Ported so far: :class:`QPSolveInfo` and :func:`kkt_metrics`. The staged
interior-point ``solve`` / ``solve_batched`` (the route for empty constraint
blocks and sizes past the fused kernel's envelope) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ir import QPSolution, QuadProgram
from ..utils.precision import full_precision

Tensor = torch.Tensor


class QPSolveInfo(NamedTuple):
    iterations: Tensor  # int32, iterations actually used (-1: unknown)
    primal_residual: Tensor
    dual_residual: Tensor
    duality_gap: Tensor
    converged: Tensor  # bool


@full_precision
def kkt_metrics(
    qp: QuadProgram,
    sol: QPSolution,
    *,
    tol: float | None = None,
    iterations: Tensor | None = None,
) -> QPSolveInfo:
    """Post-hoc KKT residual metrics for an externally produced solution —
    the status source for solve paths that don't carry per-instance solver
    state (the fused PDIP kernel).

    ``converged`` uses the same scale-RELATIVE criterion as the fused kernel's
    termination (with a 10x/100x exit-report slack): absolute residuals are
    unreachable in f32 once data/solution scales are large, and an absolute
    flag would mark entire well-solved large-scale batches unconverged —
    which ``nan_on_unconverged`` would then NaN-poison wholesale. The slack
    variable is reconstructed as ``max(h - Gz, 0)`` so primal infeasibility
    shows up as ``max(Gz - h, 0)`` mass in ``primal_residual``.
    ``primal_residual``/``dual_residual`` are reported relative (max-abs over
    rows, divided by the scale factors); ``duality_gap`` stays the raw
    complementarity sum.

    ``iterations`` is the solver's own per-instance count where the caller
    has one (the fused kernel exports it); without it the field is -1
    (unknown), since residuals alone cannot tell.
    """
    from ..utils.config import get_config

    dt = qp.Q.dtype
    if tol is None:
        tol = get_config().qp_tol(dt)
    m = qp.num_ineq
    z, lam, nu = sol.z, sol.lam, sol.nu
    mv = lambda M, v: torch.einsum("bij,bj->bi", M, v)
    rmv = lambda M, v: torch.einsum("bij,bi->bj", M, v)
    amax = lambda x: x.abs().amax(dim=-1) if x.shape[-1] else x.new_zeros(x.shape[:-1])
    Qz, Gl, An = mv(qp.Q, z), rmv(qp.G, lam), rmv(qp.A, nu)
    rd = Qz + qp.q + Gl + An
    dscale = 1.0 + torch.maximum(
        torch.maximum(amax(Qz), amax(qp.q)), torch.maximum(amax(Gl), amax(An))
    )
    Az, Gz = mv(qp.A, z), mv(qp.G, z)
    rp_eq = Az - qp.b
    viol = torch.clamp(Gz - qp.h, min=0.0)
    s = torch.clamp(qp.h - Gz, min=0.0)
    pscale = 1.0 + torch.maximum(
        torch.maximum(amax(Az), amax(qp.b)), torch.maximum(amax(Gz), amax(qp.h))
    )
    pobj = 0.5 * (z * Qz).sum(dim=-1) + (qp.q * z).sum(dim=-1)
    gscale = 1.0 + pobj.abs()
    pres = (amax(rp_eq) + amax(viol)) / pscale
    dres = amax(rd) / dscale
    gap = (s * lam).sum(dim=-1)
    mu_f = (gap / m if m else gap) / gscale
    conv = (
        (pres < 10 * tol) & (dres < 10 * tol) & (mu_f < 100 * tol)
        & torch.isfinite(z).all(dim=-1)
        & torch.isfinite(lam).all(dim=-1)
        & torch.isfinite(nu).all(dim=-1)
    )
    if iterations is None:
        iterations = torch.full(conv.shape, -1, dtype=torch.int32, device=conv.device)
    else:
        iterations = iterations.to(torch.int32).expand(conv.shape)
    return QPSolveInfo(
        iterations=iterations,
        primal_residual=pres,
        dual_residual=dres,
        duality_gap=gap,
        converged=conv,
    )
