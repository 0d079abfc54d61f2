"""Inputs and plain reference of the SOCP layer ``min c'x s.t. ||F x - g|| <= e'x + f``, in the conic form
``min c'x s.t. A x + s = b, s in SOC(n + 1)`` with ``A = [-e'; -F]``, ``b = [f; -g]``.

Plain PyTorch only: nothing here imports the measured package or JAX. The reference runs in the dtype
of the tensors it is given (float64 for the comparison that decides ``correct``; float32 with TF32
matmuls for the control that has to fail it) and on their device.

``solve_and_grad`` solves each instance in closed form. F is square with its singular values in
[1, 2], so with u = F x - g the program is ``min a'u s.t. ||u|| <= d'u + beta`` (a = F^-T c,
d = F^-T e, beta = f + d'g, ||d|| <= 1/2): the constraint is active, u / ||u|| = d - t a with t > 0 the
positive root of ||d - t a|| = 1, and ||u|| = beta / (1 - d'(u / ||u||)). Autograd through that formula
gives the derivative of the solution map. ``ipm`` is a plain interior-point method on the conic form; it
only counts the iterations these inputs need (the roofline's work), and the tests hold it against the
closed form.
"""

from __future__ import annotations

import torch

NAMES = ("A", "b", "c")


def generate(cfg: dict, batch: int, gen: torch.Generator, device, dtype) -> dict:
    """``batch`` i.i.d. instances of the source's distribution, made on ``device`` from ``gen``: F
    standard normal with its spectrum clamped to [1, 2], e of norm 1/2, f = ||g|| + 1 (strictly feasible
    at x = 0, bounded)."""
    n = cfg["n"]
    k = cfg["cones"][0][1] - 1
    rnd = lambda *shape: torch.randn(*shape, dtype=dtype, device=device, generator=gen)
    F = rnd(batch, k, n)
    U, S, Vh = torch.linalg.svd(F, full_matrices=False)
    F = (U * S.clamp(1.0, 2.0)[:, None, :]) @ Vh
    del U, Vh
    g, e, c = rnd(batch, k), rnd(batch, n), rnd(batch, n)
    e = e * (0.5 / e.norm(dim=-1, keepdim=True).clamp(min=1e-30))
    f = g.norm(dim=-1, keepdim=True) + 1.0
    return dict(A=torch.cat([-e[:, None, :], -F], 1), b=torch.cat([f, -g], 1), c=c)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def closed_form(A, b, c):
    e, F, f, g = -A[:, 0, :], -A[:, 1:, :], b[:, 0], -b[:, 1:]
    Finv = torch.linalg.inv(F)
    FinvT = Finv.transpose(-1, -2)
    a, dvec = _mv(FinvT, c), _mv(FinvT, e)
    beta = f + (dvec * g).sum(-1)
    aa, ad, dd = (a * a).sum(-1), (a * dvec).sum(-1), (dvec * dvec).sum(-1)
    t = (ad + torch.sqrt(ad * ad - aa * (dd - 1.0))) / aa
    w = dvec - t[:, None] * a
    u = (beta / (1.0 - (dvec * w).sum(-1)))[:, None] * w
    return _mv(Finv, u + g)


def solve_and_grad(d: dict):
    """The reference step on the batch ``d``: ``(x, grads, 0, None)``; ``grads`` maps each data tensor's
    name to the gradient of ``sum(x**2)`` (nothing to audit: the solve is exact; no margin: the cone
    constraint is active with a positive multiplier on every instance, so none is near degeneracy)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in d.items()}
    with torch.enable_grad():
        x = closed_form(*(leaves[k] for k in NAMES))
        grads = torch.autograd.grad((x * x).sum(), [leaves[k] for k in NAMES])
    return x.detach(), dict(zip(NAMES, grads)), 0, None


def _arrow(u):
    """L(u) = [[u0, u1'], [u1, u0 I]]: u o v = L(u) v (the Jordan product of the second-order cone)."""
    L = torch.diag_embed(u[:, :1].expand_as(u)).clone()
    L[:, 0, :] = u
    L[:, :, 0] = u
    return L


def _jmul(u, v):
    return torch.cat([(u * v).sum(-1, keepdim=True), u[:, :1] * v[:, 1:] + v[:, :1] * u[:, 1:]], -1)


def _soc_step(u, du):
    """Largest step a <= 1 with u + a du in the cone (u interior)."""
    qa = du[:, 0] ** 2 - (du[:, 1:] ** 2).sum(-1)
    qb = u[:, 0] * du[:, 0] - (u[:, 1:] * du[:, 1:]).sum(-1)
    qc = u[:, 0] ** 2 - (u[:, 1:] ** 2).sum(-1)
    disc2 = qb * qb - qa * qc
    disc = disc2.clamp(min=0.0).sqrt()
    inf = torch.full_like(qa, float("inf"))
    roots = torch.stack([(-qb - disc) / qa, (-qb + disc) / qa, -qc / (2 * qb)])
    linear = qa.abs() < 1e-300
    quad = ~linear & (disc2 >= 0)
    ok = torch.stack([quad, quad, linear]) & (roots > 0) & torch.isfinite(roots)
    return torch.where(ok, roots, inf).amin(0).clamp(max=1.0)


def ipm(d: dict, tol: float = 1e-10, max_iters: int = 60):
    """Mehrotra predictor-corrector with Nesterov-Todd scaling on ``min c'x s.t. Ax + s = b, s in SOC``,
    every lane frozen once its scale-relative criterion is at most ``tol``. Returns ``(x, history)``:
    ``history`` is (iterations + 1, B), the criterion of each lane before each iteration."""
    A, b, c = (d[k] for k in NAMES)
    B, mC, n = A.shape
    x = c.new_zeros(B, n)
    s = b.clone()
    y = torch.zeros_like(b)
    y[:, 0] = 1.0
    e = torch.zeros_like(b)
    e[:, 0] = 1.0
    sb, sc = 1.0 + b.abs().amax(-1), 1.0 + c.abs().amax(-1)
    eye = torch.eye(mC, dtype=b.dtype, device=b.device).expand(B, mC, mC)
    zero_nn = c.new_zeros(B, n, n)
    history = []
    for _ in range(max_iters + 1):
        rd = _mv(A.transpose(-1, -2), y) + c
        rp = _mv(A, x) + s - b
        mu = (s * y).sum(-1)
        crit = torch.stack([rp.abs().amax(-1) / sb, rd.abs().amax(-1) / sc,
                            mu / (1.0 + (c * x).sum(-1).abs())]).amax(0)
        history.append(crit)
        live = crit > tol
        if not bool(live.any()) or len(history) > max_iters:
            break
        # Nesterov-Todd scaling W (symmetric): W y = W^-1 s = lam
        ns = (s[:, 0] ** 2 - (s[:, 1:] ** 2).sum(-1)).sqrt()
        ny = (y[:, 0] ** 2 - (y[:, 1:] ** 2).sum(-1)).sqrt()
        sbar, ybar = s / ns[:, None], y / ny[:, None]
        gamma = ((1.0 + (sbar * ybar).sum(-1)) / 2).sqrt()
        wbar = torch.cat([sbar[:, :1] + ybar[:, :1], sbar[:, 1:] - ybar[:, 1:]], -1) / (2 * gamma[:, None])
        eta = (ns / ny).sqrt()
        w1 = wbar[:, 1:]
        Wb = eye.clone()
        Wb[:, 0, 0] = wbar[:, 0]
        Wb[:, 0, 1:] = w1
        Wb[:, 1:, 0] = w1
        Wb[:, 1:, 1:] += w1[:, :, None] * w1[:, None, :] / (1.0 + wbar[:, :1, None])
        Wbi = Wb.clone()
        Wbi[:, 0, 1:] = -w1
        Wbi[:, 1:, 0] = -w1
        W, Winv = eta[:, None, None] * Wb, Wbi / eta[:, None, None]
        lam = _mv(W, y)
        K = torch.cat([torch.cat([zero_nn, A.transpose(-1, -2)], -1), torch.cat([A, -(W @ W)], -1)], -2)
        LU, piv = torch.linalg.lu_factor(K)
        Llam = _arrow(lam)

        def direction(rc):
            t = torch.linalg.solve(Llam, rc)  # lam \ rc
            rhs = torch.cat([-rd, -rp - _mv(W, t)], -1)
            sol = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
            dx, dy = sol.split([n, mC], -1)
            return dx, dy, _mv(W, t - _mv(W, dy))

        dx, dy, ds = direction(-_jmul(lam, lam))
        a = torch.minimum(_soc_step(s, ds), _soc_step(y, dy))[:, None]
        sigma = (((s + a * ds) * (y + a * dy)).sum(-1) / mu).clamp(min=0.0, max=1.0) ** 3
        rc = -_jmul(lam, lam) - _jmul(_mv(Winv, ds), _mv(W, dy)) + (sigma * mu)[:, None] * e
        dx, dy, ds = direction(rc)
        a = (0.99 * torch.minimum(_soc_step(s, ds), _soc_step(y, dy))).clamp(max=1.0)[:, None]
        a = torch.where(live[:, None], a, torch.zeros_like(a))
        x, y, s = x + a * dx, y + a * dy, s + a * ds
    return x, torch.stack(history)
