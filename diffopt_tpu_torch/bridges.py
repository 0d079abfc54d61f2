"""Differentiable problem rewrites (the reference's MOI bridges, as functions).

Counterpart of ``diffopt_tpu/bridges.py``. Each rewrite is a plain function
from IR to IR written in differentiable torch, so derivative transport is the
chain rule under autograd — with the one nontrivial case, the
quadratic-constraint -> SOC rewrite, getting the explicit Cholesky-factor
calculus (``dU_from_dQ`` / ``dQ_from_dU``) as first-class ops.

Rewrites provided:

* ``geq_to_leq``        — sign-flip of >= rows into <= rows
* ``bounds_to_rows``    — variable bounds as inequality rows
* ``max_to_min``        — objective sense flip
* ``qp_to_cone``        — QuadProgram -> ConeProgram (zero + nonneg rows, and
                          the epigraph rsoc block for a quadratic objective)
* ``qp_via_conic``      — a QuadProgram solved through the conic backend
* ``quad_constraint_to_soc`` — 1/2 x'Qx + a'x + b <= 0 into SOC rows via the
                          Cholesky factor (MOI QuadtoSOC bridge)
* ``dU_from_dQ`` / ``dQ_from_dU`` — the triangular derivative transport pair

Torch tensors are always concrete, so ``qp_to_cone`` can always look at Q to
decide whether the objective is quadratic and whether Q is singular: the JAX
package's case of a traced Q, where the ``quadratic`` flag must be passed, has
no counterpart here. Where Q is not positive definite and ``psd=False`` is
forced, ``torch.linalg.cholesky`` raises (the JAX package gets NaN).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .cones import ConeSpec
from .ir import ConeProgram, QPSolution, QuadProgram, default_device

Tensor = torch.Tensor


def geq_to_leq(G_geq: Tensor, h_geq: Tensor) -> Tuple[Tensor, Tensor]:
    """``Gx >= h``  ->  ``(-G)x <= (-h)``."""
    return -G_geq, -h_geq


def bounds_to_rows(lb, ub, *, dtype=torch.float64, device=None) -> Tuple[Tensor, Tensor]:
    """Finite variable bounds as inequality rows ``Gx <= h`` (upper bounds first, then lower), from
    concrete ``lb`` / ``ub`` (a static pattern), on ``device`` (None: the card; raises without one)."""
    device = default_device(device, "bounds_to_rows")
    lb = np.asarray(lb, float)
    ub = np.asarray(ub, float)
    n = lb.shape[0]
    rows, rhs = [], []
    for j in np.nonzero(np.isfinite(ub))[0]:
        e = np.zeros(n)
        e[j] = 1.0
        rows.append(e)
        rhs.append(ub[j])
    for j in np.nonzero(np.isfinite(lb))[0]:
        e = np.zeros(n)
        e[j] = -1.0
        rows.append(e)
        rhs.append(-lb[j])
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    if not rows:
        return as_t(np.zeros((0, n))), as_t(np.zeros((0,)))
    return as_t(np.stack(rows)), as_t(np.array(rhs))


def max_to_min(Q: Tensor, q: Tensor) -> Tuple[Tensor, Tensor]:
    """max 1/2 x'Qx + q'x == min of the negation."""
    return -Q, -q


def _psd_singular(Q: Tensor) -> bool:
    """Whether a (batch of) positive semidefinite Q is singular; raises on an indefinite Q."""
    w = torch.linalg.eigvalsh(Q.detach())
    wmax = float(w.max()) if w.numel() else 0.0
    wmin = float(w.min()) if w.numel() else 0.0
    tol_psd = 1e2 * torch.finfo(Q.dtype).eps * max(wmax, 1.0)
    if wmin < -tol_psd:
        raise ValueError(
            f"qp_to_cone: Q is indefinite (min eigenvalue {wmin:.3e}); the epigraph-RSOC lowering "
            "requires Q >= 0"
        )
    return wmin < tol_psd


def qp_to_cone(qp: QuadProgram, quadratic: bool | None = None, psd: bool | None = None) -> ConeProgram:
    """Lower a QuadProgram (one instance or a batch) into conic geometric form.

    Affine objectives (LPs) lower directly: rows = [Az + s = b, s in {0}] +
    [Gz + s = h, s in R+]. Quadratic objectives lower via the epigraph
    rotated-SOC: with ``Q = U'U``,

        min 1/2 x'Qx + q'x  ==  min q'x + t  s.t.  (t, 1, Ux) in RSOC

    (``2 t * 1 >= ||Ux||^2 = x'Qx``). The lowering is differentiable torch
    (factorization included), so derivative transport through the bridge is
    the chain rule under autograd.

    ``quadratic=None`` decides from Q (``norm(Q) != 0``). ``psd`` picks the
    factorization: ``False`` = Cholesky (Q strictly positive definite),
    ``True`` = ``eigh`` with eigenvalues clamped at zero, which handles
    singular positive semidefinite Q; ``None`` decides from Q's eigenvalues
    and raises on an indefinite Q.
    """
    n, p, m = qp.num_vars, qp.num_eq, qp.num_ineq
    if quadratic is None:
        quadratic = float(torch.linalg.norm(qp.Q.detach())) != 0.0
    if not quadratic:
        A = torch.cat([qp.A, qp.G], dim=-2)
        b = torch.cat([qp.b, qp.h], dim=-1)
        return ConeProgram(A=A, b=b, c=qp.q, cones=ConeSpec([("zero", p), ("nonneg", m)]))

    dt, dev = qp.Q.dtype, qp.Q.device
    if psd is None:
        psd = _psd_singular(qp.Q)
    if psd:
        # U = sqrt(clamp(w, 0)) V': U'U = Q for any positive semidefinite Q, singular ones included
        w, V = torch.linalg.eigh(qp.Q)
        U = torch.sqrt(torch.clamp(w, min=0.0))[..., :, None] * V.transpose(-1, -2)
    else:
        U = torch.linalg.cholesky(qp.Q).transpose(-1, -2)
    lead = qp.Q.shape[:-2]
    zeros = lambda *s: torch.zeros(*s, dtype=dt, device=dev)
    A_eq = torch.cat([qp.A, zeros(*qp.A.shape[:-2], p, 1)], dim=-1)
    A_in = torch.cat([qp.G, zeros(*qp.G.shape[:-2], m, 1)], dim=-1)
    # rsoc rows: s1 = t, s2 = 1, s3.. = U x  (s = b - A xtilde)
    r1 = zeros(*lead, 1, n + 1)
    r1[..., 0, n] = -1.0
    r2 = zeros(*lead, 1, n + 1)
    r3 = torch.cat([-U, zeros(*lead, n, 1)], dim=-1)
    lead_b = qp.b.shape[:-1]
    A = torch.cat([A_eq, A_in, r1, r2, r3], dim=-2)
    b = torch.cat([qp.b, qp.h, zeros(*lead_b, 1), torch.ones(*lead_b, 1, dtype=dt, device=dev),
                   zeros(*lead_b, n)], dim=-1)
    c = torch.cat([qp.q, torch.ones(*qp.q.shape[:-1], 1, dtype=dt, device=dev)], dim=-1)
    return ConeProgram(A=A, b=b, c=c, cones=ConeSpec([("zero", p), ("nonneg", m), ("rsoc", n + 2)]))


def qp_via_conic(qp: QuadProgram, quadratic: bool | None = None, psd: bool | None = None, **solve_options):
    """Solve a QuadProgram through the conic backend (:func:`~diffopt_tpu_torch.solve_conic`,
    ``solve_options`` go to it) and map the solution back to AK17 QP coordinates. Differentiable:
    gradients flow through the epigraph lowering (the factorization included) and the conic rule.

    Dual mapping: ``nu = y_zero``, ``lam = y_nonneg``; the rsoc dual block is dropped.
    """
    from .solve import solve_conic

    sol = solve_conic(qp_to_cone(qp, quadratic=quadratic, psd=psd), **solve_options)
    n, p, m = qp.num_vars, qp.num_eq, qp.num_ineq
    return QPSolution(z=sol.x[..., :n], lam=sol.y[..., p:p + m], nu=sol.y[..., :p])


def quad_constraint_to_soc(Q: Tensor, a: Tensor, beta: Tensor) -> Tuple[Tensor, Tensor, ConeSpec]:
    """Rewrite ``1/2 x'Qx + a'x + beta <= 0`` (Q positive definite) into SOC rows.

    MOI's QuadtoSOC bridge produces ``(1, -a'x - beta, Ux) in RSOC`` with
    ``Q = U'U``; composing with the standard RSOC->SOC map gives the SOC block
    ``(t+u, t-u, sqrt2 Ux)``. Returns ``(A_rows, b_rows, spec)`` in
    ``Ax + s = b`` orientation (s = row value).
    """
    n = a.shape[-1]
    U = torch.linalg.cholesky(Q).transpose(-1, -2)  # Q = U'U with U upper
    sq2 = torch.sqrt(torch.tensor(2.0, dtype=Q.dtype, device=Q.device))
    # s rows as functions of x:  s1 = 1 + (-a'x - beta) = t+u, s2 = 1 - u, s3.. = sqrt2 * U x
    A1 = a[..., None, :]  # s1 = (1 - beta) - a'x  -> A row = +a
    b1 = (1.0 - beta)[..., None]
    A2 = -a[..., None, :]  # s2 = (1 + beta) + a'x -> A row = -a
    b2 = (1.0 + beta)[..., None]
    A3 = -sq2 * U
    b3 = torch.zeros(*Q.shape[:-2], n, dtype=Q.dtype, device=Q.device)
    return torch.cat([A1, A2, A3], dim=-2), torch.cat([b1, b2, b3], dim=-1), ConeSpec([("soc", n + 2)])


def dU_from_dQ(dQ: Tensor, U: Tensor) -> Tensor:
    """Solve ``dQ = dU'U + U'dU`` for upper-triangular ``dU`` — forward
    transport of a quadratic-form perturbation through its Cholesky factor.

    Closed form: with ``S = U^-T dQ U^-1`` (symmetric),
    ``dU = (strict_triu(S) + diag(S)/2) U``.
    """
    Ut = U.transpose(-1, -2)
    T1 = torch.linalg.solve_triangular(Ut, dQ, upper=False)
    S = torch.linalg.solve_triangular(Ut, T1.transpose(-1, -2), upper=False).transpose(-1, -2)
    F = torch.triu(S, 1) + 0.5 * torch.diag_embed(torch.diagonal(S, dim1=-2, dim2=-1))
    return F @ U


def dQ_from_dU(dU: Tensor, U: Tensor) -> Tensor:
    """Return the symmetric ``dQ`` solving ``triu(dU) = 2 triu(U dQ)`` —
    reverse transport from SOC coordinates back to the quadratic form.

    Closed form (two triangular solves + two matmuls): write ``M = U dQ =
    T + P`` with ``T = triu(dU)/2`` known and ``P`` strictly lower unknown.
    Symmetry of ``dQ = U^{-1} M`` is equivalent to ``P U' - U P' = U T' - T U'
    =: K`` (antisymmetric); since ``R = P U'`` is strictly lower and
    ``R - R' = K``, ``R = tril(K, -1)``, then ``P`` and ``dQ`` are triangular
    solves."""
    T = torch.triu(dU) / 2.0
    Ut = U.transpose(-1, -2)
    Tt = T.transpose(-1, -2)
    K = U @ Tt - T @ Ut
    R = torch.tril(K, -1)
    # P U' = R  <=>  U P' = R'
    Pt = torch.linalg.solve_triangular(U, R.transpose(-1, -2), upper=True)
    dQ = torch.linalg.solve_triangular(U, T + Pt.transpose(-1, -2), upper=True)
    # symmetric by construction; enforce exactly for downstream seeds
    return 0.5 * (dQ + dQ.transpose(-1, -2))
