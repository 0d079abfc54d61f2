"""Tensor-parallel blocked Cholesky over a process group.

Counterpart of ``diffopt_tpu/parallel/tp_chol.py``: when a SINGLE instance's
matrix outgrows one device, the factorization itself is sharded. 1-D
block-column distribution: with P processes in the group, process k owns the
``(n, nb)`` column block k (``nb = n / P``, columns ``k nb .. (k+1) nb``).
The right-looking factorization loops over the P block columns:

  1. the owner of block column k factors its diagonal block
     (``torch.linalg.cholesky``) and forms the panel ``A[:, k] Lkk^-T`` from
     its local block (rows above the diagonal block zeroed),
  2. the owner's panel goes to every process with ``dist.broadcast``
     (PyTorch's idiom for the JAX package's masked ``psum``),
  3. the processes to the right apply the rank-nb trailing update to their
     local columns, an ``(n, nb) @ (nb, nb)`` product.

The triangular solves run blockwise: a ``dist.reduce`` of the off-diagonal
contributions to the owner of each row block in the forward sweep, a
``dist.broadcast`` of each finished block of the solution in the backward
sweep. The result equals a local Cholesky up to summation order. Each
process passes and receives only its own column block and its own slice of
the vectors (PyTorch has no global array). With ``group=None`` there is one
part and no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def _parts(group):
    """(this process's block index, number of blocks) in ``group``."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _src(group, k: int) -> int:
    """The global rank of the process that owns block ``k`` of ``group``."""
    return dist.get_global_rank(group, k)


def tp_cholesky(H_local: Tensor, group=None) -> Tensor:
    """Cholesky-factor a symmetric positive definite ``(n, n)`` matrix whose
    column blocks are spread over ``group``: ``H_local`` is this process's
    ``(n, nb)`` column block, and the result its column block of the
    lower-triangular factor L (rows above the diagonal block zero). ``n``
    must divide evenly by the group's size."""
    d, nparts = _parts(group)
    n, nb = H_local.shape
    if n != nb * nparts:
        raise ValueError(f"column block {tuple(H_local.shape)} is not an n / {nparts} share of n = {n}")
    L_local = H_local.clone()
    for k in range(nparts):
        r0 = k * nb
        if d == k:
            Lkk = torch.linalg.cholesky(L_local[r0 : r0 + nb])
            # panel = A[:, k-block] Lkk^-T on the rows from the diagonal block down
            panel = torch.zeros_like(L_local)
            panel[r0:] = torch.linalg.solve_triangular(Lkk.mT, L_local[r0:], upper=True, left=False)
        else:
            panel = torch.empty_like(L_local)
        if group is not None:
            dist.broadcast(panel, src=_src(group, k), group=group)
        if d > k:
            # trailing update of this process's columns: A[:, d] -= L[:, k] L[d-rows, k]'
            L_local -= panel @ panel[d * nb : (d + 1) * nb].mT
        elif d == k:
            L_local = panel
    return L_local


def tp_cholesky_solve(L_local: Tensor, r_local: Tensor, group=None) -> Tensor:
    """Solve ``L L' z = r`` with the factor's column blocks spread over
    ``group`` (from :func:`tp_cholesky`): ``r_local`` is this process's
    ``(nb,)`` slice of the right-hand side, the result its slice of z."""
    d, nparts = _parts(group)
    n, nb = L_local.shape
    # forward: y_k = Lkk^-1 (r_k - sum_{j<k} L[k-rows, j-cols] y_j); the sum is reduced onto process k
    y = torch.zeros_like(r_local)
    for k in range(nparts):
        rows = slice(k * nb, (k + 1) * nb)
        acc = L_local[rows] @ y if d < k else torch.zeros_like(r_local)
        if group is not None:
            dist.reduce(acc, dst=_src(group, k), op=dist.ReduceOp.SUM, group=group)
        if d == k:
            y = torch.linalg.solve_triangular(L_local[rows], (r_local - acc)[:, None], upper=False)[:, 0]
    # backward: z_k = Lkk^-T (y_k - sum_{j>k} L[j-rows, k-cols]' z_j); process k owns every L[j-rows, k-cols],
    # and each finished z_j is broadcast to all
    z = torch.zeros_like(r_local)
    acc = torch.zeros_like(r_local)
    for k in reversed(range(nparts)):
        rows = slice(k * nb, (k + 1) * nb)
        if d == k:
            z = torch.linalg.solve_triangular(L_local[rows].mT, (y - acc)[:, None], upper=True)[:, 0]
            zk = z
        else:
            zk = torch.empty_like(r_local)
        if group is not None:
            dist.broadcast(zk, src=_src(group, k), group=group)
        if d < k:
            acc = acc + L_local[rows].mT @ zk
    return z


def tp_solve_psd(H_local: Tensor, r_local: Tensor, group=None) -> Tensor:
    """One-call sharded positive definite solve ``H z = r`` (factor + two
    triangular solves), for single systems past one device's memory:
    ``H_local`` is this process's column block, ``r_local`` its slice of r."""
    return tp_cholesky_solve(tp_cholesky(H_local, group), r_local, group)
