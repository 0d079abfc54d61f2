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

Conic programs (same n, a shared ordered kind sequence) are padded row-wise
to the elementwise-max cone spec with strictly inactive rows whose dual is 0:

* nonneg / nonpos blocks: rows ``0'x + s = +1`` / ``-1`` (s strictly inside);
* soc / rsoc blocks grown in place: tail rows ``s_i = 0``; whole appended
  blocks: ``s = (1, 0, ..., 0)`` (``(1, 1, 0, ...)`` for rsoc);
* whole appended psd blocks: ``s = svec(I)``.

Zero-cone rows are not padded (a 0 = 0 row has an indeterminate dual).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..cones import ConeSpec, _tri_side, sym_to_svec
from ..ir import ConeProgram, ConeSolution, ConeTangent, QPSolution, QPTangent, QuadProgram


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


# ---------------------------------------------------------------------------
# Conic programs
# ---------------------------------------------------------------------------


def cone_pad_spec(specs: Sequence[ConeSpec]) -> ConeSpec:
    """Elementwise-max target spec for specs sharing the same ordered kind
    sequence (extra trailing blocks in some instances are allowed; missing
    blocks are padded in as interior blocks)."""
    max_len = max(len(sp.blocks) for sp in specs)
    blocks = []
    for i in range(max_len):
        present = [sp.blocks[i] for sp in specs if len(sp.blocks) > i]
        kinds = {b[0] for b in present}
        if len(kinds) != 1:
            raise ValueError(
                f"cone block {i}: mismatched kinds {sorted(kinds)}; heterogeneous batching needs a shared kind sequence"
            )
        (kind,) = kinds
        prms = {b[2] for b in present}
        if len(prms) != 1:
            raise ValueError(f"cone block {i}: mismatched {kind} parameters {sorted(prms)}")
        prm = prms.pop()
        if kind == "zero":
            dims = {b[1] for b in present}
            if len(dims) != 1 or len(present) != len(specs):
                raise ValueError("zero-cone blocks cannot be padded (indeterminate duals)")
            blocks.append((kind, dims.pop()))
        else:
            d = max(b[1] for b in present)
            blocks.append((kind, d) if prm is None else (kind, d, prm))
    return ConeSpec(blocks)


def pad_cone_program(cp: ConeProgram, target: ConeSpec) -> ConeProgram:
    """Pad one (unbatched) instance's rows to ``target`` (same n) preserving
    its solution: x identical, original (y, s) on the original rows, padded
    rows strictly inactive with zero dual."""
    if cp.cones == target:
        return cp
    n = cp.num_vars
    src = list(cp.cones.offsets())
    A_rows, b_rows = [], []
    for i, (kind, _, t_dim) in enumerate(target.offsets()):
        if i < len(src):
            s_kind, s_off, s_dim = src[i]
            if s_kind != kind or s_dim > t_dim:
                raise ValueError(f"block {i}: cannot pad {s_kind}({s_dim}) to {kind}({t_dim})")
            A_rows.append(cp.A[s_off:s_off + s_dim])
            b_rows.append(cp.b[s_off:s_off + s_dim])
        else:
            s_dim = 0
        extra = t_dim - s_dim
        if extra == 0:
            continue
        A_rows.append(cp.A.new_zeros(extra, n))
        pad = cp.b.new_zeros(extra)
        if kind == "nonneg":
            pad += 1.0  # s = 1 > 0
        elif kind == "nonpos":
            pad -= 1.0  # s = -1 < 0
        elif kind in ("soc", "rsoc"):
            if s_dim == 0:  # a whole appended block: strictly interior head
                pad[0] = 1.0
                if kind == "rsoc" and extra > 1:
                    pad[1] = 1.0  # (1, 1, 0..): 2tu = 2 > 0
        elif kind == "psd":
            if s_dim > 0:
                raise ValueError("psd blocks cannot be grown in place (svec interleaving); only whole appended psd blocks are supported")
            pad = sym_to_svec(torch.eye(_tri_side(extra), dtype=cp.b.dtype, device=cp.b.device))
        else:
            raise NotImplementedError(
                f"cannot pad cone kind {kind!r}: the exp/pow cones come with the slice of the port that brings kernel K7"
            )
        b_rows.append(pad)
    return ConeProgram(A=torch.cat(A_rows, dim=0), b=torch.cat(b_rows, dim=0), c=cp.c, cones=target)


def pad_and_stack_cones(cps: Sequence[ConeProgram]) -> Tuple[ConeProgram, list]:
    """Pad a list of same-n conic instances to a shared cone spec and stack.
    Returns (batched_cp, original_specs) for unpadding."""
    if len({cp.num_vars for cp in cps}) != 1:
        raise ValueError("pad_and_stack_cones requires a shared variable count")
    target = cone_pad_spec([cp.cones for cp in cps])
    padded = [pad_cone_program(cp, target) for cp in cps]
    batched = ConeProgram(
        A=torch.stack([q.A for q in padded]), b=torch.stack([q.b for q in padded]),
        c=torch.stack([q.c for q in padded]), cones=target,
    )
    return batched, [cp.cones for cp in cps]


def _cone_row_index(spec: ConeSpec, target: ConeSpec, device) -> torch.Tensor:
    rows = [np.arange(t_off, t_off + s_dim) for (_, _, s_dim), (_, t_off, _) in zip(spec.offsets(), target.offsets())]
    return torch.as_tensor(np.concatenate(rows) if rows else np.zeros((0,), np.int64), device=device)


def unpad_cone_solution(sol: ConeSolution, specs: list, target: ConeSpec) -> List[ConeSolution]:
    """Slice a batched solution back to each instance's original rows."""
    out = []
    for i, spec in enumerate(specs):
        idx = _cone_row_index(spec, target, sol.y.device)
        out.append(ConeSolution(x=sol.x[i], y=sol.y[i, idx], s=sol.s[i, idx]))
    return out


def unpad_cone_tangent(tan, specs: list, target: ConeSpec):
    """Slice padded-batch data gradients (a batched
    :class:`~diffopt_tpu_torch.ir.ConeTangent`, or a ``ConeProgram``-shaped
    struct of gradients) back to each instance's original rows. Padding rows
    are strictly inactive with zero dual, so on the original rows the padded
    solution map — and its gradient — is the unpadded one."""
    is_tan = isinstance(tan, ConeTangent)
    A, b, c = tan.tensors()
    out = []
    for i, spec in enumerate(specs):
        idx = _cone_row_index(spec, target, A.device)
        vals = (A[i, idx, :], b[i, idx], c[i])
        out.append(ConeTangent(*vals) if is_tan else ConeProgram(*vals, cones=spec))
    return out
