"""Heterogeneous-instance batching: padding and size-bucketing (QP part).

Counterpart of ``diffopt_tpu/utils/batching.py``. Batches must share shapes;
these utilities pad a list of differently-sized (unbatched) QuadPrograms into
one ``(B, ...)`` batch — inactive rows are padded so the padded instance is
mathematically identical to the original:

* objective: padded Q gets identity diagonal, padded q zeros, padded primal
  variables solve to 0 and are masked out of results;
* equality rows: pad with ``x_pad_i = 0`` rows (identity on padding vars);
* inequality rows: pad with ``0'x <= 1`` (never active, zero dual).

``bucket_by_shape`` groups instances into few shape buckets to bound padding
waste. Outputs live on the inputs' device; padding is differentiable, so
gradients of a padded batch flow back to the original instances' tensors.
The conic padding comes with the cone slice of the port.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ir import QPSolution, QPTangent, QuadProgram


def _embed(block: torch.Tensor, shape, fill: float = 0.0) -> torch.Tensor:
    """``block`` in the leading corner of a ``shape`` tensor of ``fill``."""
    out = block.new_full(shape, fill)
    out[tuple(slice(0, k) for k in block.shape)] = block
    return out


def pad_qp(qp: QuadProgram, n: int, m: int, p: int) -> QuadProgram:
    """Pad one (unbatched) instance to (n, m, p) preserving its solution on
    the original coordinates."""
    n0, m0, p0 = qp.num_vars, qp.num_ineq, qp.num_eq
    if (n0, m0, p0) == (n, m, p):
        return qp
    # Every padded equality row MUST bind its own fresh padding variable
    # (x_pad_i = 0, whose dual is uniquely 0 by stationarity Q x_pad + nu =
    # 0). A trivial 0 = 0 row keeps the padded *solution* correct but its
    # dual is indeterminate — the KKT Jacobian goes singular and implicit
    # differentiation returns NaN. pad_and_stack sizes n so this never
    # under-runs.
    extra = p - p0
    if extra > n - n0:
        raise ValueError(
            f"pad_qp: {extra} padded equality rows need {extra} padding "
            f"variables but only {n - n0} are available — pad n to at "
            f"least {n0 + extra}"
        )
    pad_diag = torch.zeros(n, dtype=qp.Q.dtype, device=qp.Q.device)
    pad_diag[n0:] = 1.0  # padded vars: min 1/2 x^2 -> 0
    Q = _embed(qp.Q, (n, n)) + torch.diag(pad_diag)
    A = _embed(qp.A, (p, n))
    if extra > 0:
        bind = torch.zeros_like(A)
        bind[torch.arange(p0, p), torch.arange(n0, n0 + extra)] = 1.0
        A = A + bind
    return QuadProgram(
        Q=Q,
        q=_embed(qp.q, (n,)),
        A=A,
        b=_embed(qp.b, (p,)),
        G=_embed(qp.G, (m, n)),
        h=_embed(qp.h, (m,), fill=1.0),  # padded rows: 0'x <= 1
    )


def pad_and_stack(qps: Sequence[QuadProgram]) -> Tuple[QuadProgram, list]:
    """Pad a list of instances to their max dims and stack into one batch.
    Returns (batched_qp, original_dims) for unpadding results."""
    dims = [(qp.num_vars, qp.num_ineq, qp.num_eq) for qp in qps]
    m = max(d[1] for d in dims)
    p = max(d[2] for d in dims)
    # n must leave room for one fresh padding variable per padded equality
    # row of EVERY instance (see pad_qp)
    n = max(max(d[0] for d in dims), max(d[0] + (p - d[2]) for d in dims))
    padded = [pad_qp(qp, n, m, p) for qp in qps]
    batched = QuadProgram(*(torch.stack(ts) for ts in zip(*(q.tensors() for q in padded))))
    return batched, dims


def unpad_solution(sol: QPSolution, dims: list) -> List[QPSolution]:
    """Slice a batched solution back to the original per-instance dims."""
    return [
        QPSolution(z=sol.z[i, :n0], lam=sol.lam[i, :m0], nu=sol.nu[i, :p0])
        for i, (n0, m0, p0) in enumerate(dims)
    ]


def unpad_tangent(tan, dims: list):
    """Slice padded-batch *data gradients* back to the original per-instance
    shapes — the gradient counterpart of :func:`unpad_solution`.

    ``tan`` is a batched :class:`~diffopt_tpu_torch.ir.QPTangent` or a
    ``QuadProgram``-shaped struct of gradients. Cotangent entries on padding
    rows/columns perturb rows that do not exist in the original instance; on
    the original coordinates the padded program's solution map is identical
    to the unpadded one (padded duals are uniquely zero by construction), so
    the slices ARE the per-instance gradients.
    """
    cls = QPTangent if isinstance(tan, QPTangent) else QuadProgram
    Q, q, A, b, G, h = tan.tensors()
    return [
        cls(Q[i, :n0, :n0], q[i, :n0], A[i, :p0, :n0], b[i, :p0], G[i, :m0, :n0], h[i, :m0])
        for i, (n0, m0, p0) in enumerate(dims)
    ]


def bucket_by_shape(
    qps: Sequence[QuadProgram], max_buckets: int = 4
) -> Dict[Tuple[int, int, int], List[int]]:
    """Group instance indices into at most ``max_buckets`` shape buckets
    (greedy by padded-volume cost). Returns {bucket_dims: [indices]}."""
    dims = [(qp.num_vars, qp.num_ineq, qp.num_eq) for qp in qps]
    uniq = sorted(set(dims))
    if len(uniq) <= max_buckets:
        buckets = {u: [] for u in uniq}
        for i, d in enumerate(dims):
            buckets[d].append(i)
        return buckets
    # greedy merge: split sorted unique dims into contiguous groups, bucket
    # dim = elementwise max of the group
    groups = np.array_split(np.arange(len(uniq)), max_buckets)
    buckets: Dict[Tuple[int, int, int], List[int]] = {}
    assign = {}
    for g in groups:
        members = [uniq[i] for i in g]
        bd = tuple(int(max(u[k] for u in members)) for k in range(3))
        buckets[bd] = []
        for u in members:
            assign[u] = bd
    for i, d in enumerate(dims):
        buckets[assign[d]].append(i)
    return buckets
