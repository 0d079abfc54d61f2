"""Inputs and plain reference of the dense QP layer ``min 1/2 z'Qz + q'z s.t. Az = b, Gz <= h``.

Plain PyTorch only: nothing here imports the measured package or JAX. The reference runs in the dtype
of the tensors it is given (float64 for the comparison that decides ``correct``; float32 with TF32
matmuls for the control that has to fail it) and on their device.

``solve_and_grad`` is the reference of a training step: the solution z of each instance and the
gradient of ``sum(z**2)`` with respect to each of the six data tensors. It finds the active set with a
Mehrotra interior-point method, then solves the equality-constrained QP on that set by the range-space
method (a Cholesky factor of Q and matrix products), through which autograd takes the gradients: on a
strictly complementary instance that is the derivative of the solution map.
"""

from __future__ import annotations

import torch

NAMES = ("Q", "q", "A", "b", "G", "h")


def generate(cfg: dict, batch: int, gen: torch.Generator, device, dtype) -> dict:
    """``batch`` i.i.d. instances of the source's distribution, made on ``device`` from ``gen``."""
    n, m, p = cfg["n"], cfg["m"], cfg["p"]
    rnd = lambda *shape: torch.randn(*shape, dtype=dtype, device=device, generator=gen)
    L = rnd(batch, n, n)
    Q = L @ L.transpose(-1, -2) + n * torch.eye(n, dtype=dtype, device=device)
    del L
    return dict(Q=Q, q=rnd(batch, n), A=rnd(batch, p, n), b=rnd(batch, p), G=rnd(batch, m, n), h=rnd(batch, m) + 2.0)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def ipm(d: dict, tol: float = 1e-12, max_iters: int = 60):
    """Mehrotra predictor-corrector on the full Newton system, every lane frozen once its
    scale-relative criterion is at most ``tol``. Returns ``(z, lam, s, history)``: ``history`` is
    (iterations + 1, B), the criterion of each lane before each iteration."""
    Q, q, A, b, G, h = (d[k] for k in NAMES)
    B, n = q.shape
    m, p = h.shape[1], b.shape[1]
    Qs = 0.5 * (Q + Q.transpose(-1, -2))
    z, nu = q.new_zeros(B, n), q.new_zeros(B, p)
    lam, s = q.new_ones(B, m), q.new_ones(B, m)
    scale = lambda v: 1.0 + v.abs().amax(-1)
    sq, sb, sh = scale(q), scale(b) if p else q.new_ones(B), scale(h)
    zeros_pp, zeros_pm = q.new_zeros(B, p, p), q.new_zeros(B, p, m)
    history = []
    for _ in range(max_iters + 1):
        rd = _mv(Qs, z) + q + _mv(A.transpose(-1, -2), nu) + _mv(G.transpose(-1, -2), lam)
        rp = _mv(A, z) - b
        ri = _mv(G, z) + s - h
        mu = (s * lam).sum(-1) / m
        obj = 0.5 * (z * _mv(Qs, z)).sum(-1) + (q * z).sum(-1)
        crit = torch.stack([rd.abs().amax(-1) / sq, (rp.abs().amax(-1) if p else 0 * mu) / sb,
                            ri.abs().amax(-1) / sh, mu / (1.0 + obj.abs())]).amax(0)
        history.append(crit)
        live = crit > tol
        if not bool(live.any()) or len(history) > max_iters:
            break
        K = torch.cat([
            torch.cat([Qs, A.transpose(-1, -2), G.transpose(-1, -2)], -1),
            torch.cat([A, zeros_pp, zeros_pm], -1),
            torch.cat([G, zeros_pm.transpose(-1, -2), torch.diag_embed(-s / lam)], -1),
        ], -2)
        LU, piv = torch.linalg.lu_factor(K)

        def direction(rc):
            rhs = torch.cat([-rd, -rp, -ri - rc / lam], -1)
            sol = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
            dz, dnu, dlam = sol.split([n, p, m], -1)
            return dz, dnu, dlam, (rc - s * dlam) / lam

        def max_step(v, dv):
            ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
            return ratio.amin(-1).clamp(max=1.0)

        dz, dnu, dlam, ds = direction(-s * lam)
        a = torch.minimum(max_step(s, ds), max_step(lam, dlam))[:, None]
        sigma = (((s + a * ds) * (lam + a * dlam)).sum(-1) / m / mu).clamp(min=0.0) ** 3
        dz, dnu, dlam, ds = direction(sigma[:, None] * mu[:, None] - s * lam - ds * dlam)
        a = (0.99 * torch.minimum(max_step(s, ds), max_step(lam, dlam))).clamp(max=1.0)[:, None]
        a = torch.where(live[:, None], a, torch.zeros_like(a))
        z, nu, lam, s = z + a * dz, nu + a * dnu, lam + a * dlam, s + a * ds
    return z, lam, s, torch.stack(history)


def equality_solve(d: dict, active: torch.Tensor):
    """z of the QP with the ``active`` inequality rows held as equalities and the others dropped, by the
    range-space method: z = -Q^-1 (q + C'w), (C Q^-1 C') w = -(C Q^-1 q + r), C = [A; G_active],
    r = [b; h_active]. Differentiable in every data tensor."""
    Q, q, A, b, G, h = (d[k] for k in NAMES)
    act = active.to(q.dtype)
    Qs = 0.5 * (Q + Q.transpose(-1, -2))
    L = torch.linalg.cholesky(Qs)
    Qinv = torch.cholesky_inverse(L)
    C = torch.cat([A, G * act[..., None]], -2)
    r = torch.cat([b, h * act], -1)
    QiCt = Qinv @ C.transpose(-1, -2)
    S = C @ QiCt + torch.diag_embed(torch.cat([torch.zeros_like(b), 1.0 - act], -1))
    w = torch.linalg.solve(S, -(_mv(QiCt.transpose(-1, -2), q) + r))
    return -_mv(Qinv, q + _mv(C.transpose(-1, -2), w)), w


def solve_and_grad(d: dict):
    """The reference step on the batch ``d``: ``(z, grads, audit, margin)``; the interior-point method's
    tolerance is 1e-12 in float64 and 1e-6 below it. ``grads`` maps each data tensor's name to the
    gradient of ``sum(z**2)``; ``audit`` counts the lanes whose active set does not hold up (a negative
    multiplier or a violated dropped row at the equality solution); ``margin`` is each instance's distance
    from degeneracy: the smallest over the inequality rows of max(lam_i, s_i) at the interior-point
    solution, over 1 + max |h| (a row with both near nought is weakly active, and there the solution map
    is not differentiable)."""
    tol = 1e-12 if d["q"].dtype == torch.float64 else 1e-6
    with torch.no_grad():
        _, lam, s, _ = ipm(d, tol)
    active = lam > s
    margin = torch.maximum(lam, s).amin(-1) / (1.0 + d["h"].abs().amax(-1))
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in d.items()}
    with torch.enable_grad():
        z, w = equality_solve(leaves, active)
        grads = torch.autograd.grad((z * z).sum(), [leaves[k] for k in NAMES])
    with torch.no_grad():
        p = d["b"].shape[1]
        slack = d["h"] - _mv(d["G"], z)
        scale = 1.0 + d["h"].abs().amax(-1, keepdim=True)
        bad_dual = ((w[:, p:] < -1e-9 * (1.0 + w[:, p:].abs().amax(-1, keepdim=True))) & active).any(-1)
        bad_primal = ((slack < -1e-9 * scale) & ~active).any(-1)
    audit = int((bad_dual | bad_primal).sum())
    return z.detach(), dict(zip(NAMES, grads)), audit, margin
