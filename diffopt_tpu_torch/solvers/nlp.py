"""Embedded NLP solver: primal-dual interior point (Ipopt-style), batch-first.

Counterpart of ``diffopt_tpu/solvers/nlp.py``: a damped primal-dual
interior-point method for the :class:`~diffopt_tpu_torch.nlp_diff.NLPProblem`
form::

    min/max f(x, p)   s.t.  c_i(x,p) {=,<=,>=} 0,   lb <= x <= ub

internally rewritten (like the sensitivity system) as

    min sigma*f(w)  s.t.  C(w) = 0,  l <= w <= u,   w = [x; s_geq; s_leq]

with adaptive barrier mu = 0.1 * avg complementarity, fraction-to-boundary
steps, a condensed symmetric Newton system, Levenberg regularization for
nonconvexity, and a NaN-freeze guard.

The JAX solver is written for one instance and batched by ``vmap``; here the
leading dimension of every tensor is the batch. The loop runs a body for the
whole batch until every instance is done or the cap is reached, and an
instance that is done keeps every field of its state (the select of the
vmapped ``while_loop``) — never a zero step. The check of that costs one host
sync a body (``solve.host_syncs``).

The Newton system ``[[Wt, J'], [J, -reg I]]`` goes to the batched LDL' pair
(``ops/cuda/chol.py``: the factor and solve kernels on CUDA tensors, their
plain versions on CPU tensors) with one refinement pass where
``len_w + nc <= 128``, as in the JAX package, and to ``torch.linalg.solve_ex``
past that (the library route the JAX package takes there; no error check, so
a singular system gives non-finite values as ``jnp.linalg.solve`` does).

Returns duals converted to the JuMP/MOI conventions used by
:mod:`diffopt_tpu_torch.nlp_diff` (y = -yhat, zL = zl, zU = -zu — sense-independent).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from ..nlp_diff import NLPProblem, NLPSolution
from ..ops.cuda import chol
from ..utils.precision import full_precision

Tensor = torch.Tensor

_BIG = 1e20
# the Newton systems up to this order go to the LDL' pair with one refinement pass, larger ones to the
# library's LU solve: the JAX package's boundary (see ROADMAP.md §3 for why it is not chol.ldl_max_n)
LDL_MAX_N = 128


class NLPSolveInfo(NamedTuple):
    iterations: Tensor
    kkt_residual: Tensor
    constraint_violation: Tensor
    complementarity: Tensor
    converged: Tensor


@full_precision
def solve(
    nlp: NLPProblem,
    p,
    x0: Optional[Tensor] = None,
    *,
    max_iters: int | None = None,
    tol: float | None = None,
    reg: float = 1e-8,
) -> Tuple[NLPSolution, NLPSolveInfo]:
    """Solve a ``(B, np)`` batch of parameters (or one instance, ``(np,)``) from ``x0`` (``(B, n)``,
    ``(n,)`` for every instance, or None: zero pushed inside the bounds). ``max_iters`` / ``tol`` default
    from the config (``nlp_max_iters`` / ``nlp_tol``); ``converged`` is a KKT error below ``10 * tol``."""
    from ..utils.config import get_config

    cfg = get_config()
    if max_iters is None:
        max_iters = cfg.nlp_max_iters
    if tol is None:
        tol = cfg.nlp_tol
    p = nlp.param(p).detach()
    single = p.ndim == 1
    if single:
        p = p[None]
    n, nc = nlp.n, nlp.nc
    sigma = nlp.sense_mult
    n_geq, n_leq = len(nlp.geq_locs), len(nlp.leq_locs)
    len_w = n + n_geq + n_leq
    B, dt, dev = p.shape[0], p.dtype, p.device
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)

    # bounds on w (slacks: geq in [0, inf), leq in (-inf, 0])
    lw = np.concatenate([nlp.lb, np.zeros(n_geq), np.full(n_leq, -np.inf)])
    uw = np.concatenate([nlp.ub, np.full(n_geq, np.inf), np.zeros(n_leq)])
    has_l, has_u = np.isfinite(lw), np.isfinite(uw)
    lw_c, uw_c = as_t(np.where(has_l, lw, -_BIG)), as_t(np.where(has_u, uw, _BIG))
    mask_l, mask_u = as_t(has_l), as_t(has_u)

    # each constraint's slack as an index into [w; 0] (len_w: the zero, for an equality)
    sel = np.full(nc, len_w)
    sel[nlp.geq_locs] = n + np.arange(n_geq)
    sel[nlp.leq_locs] = n + n_geq + np.arange(n_leq)
    sel = torch.as_tensor(sel, device=dev)

    def f_one(w, p_):
        return sigma * nlp.objective(w[:n], p_)

    def C_one(w, p_):
        cv = nlp.constraints(w[:n], p_)
        return cv - torch.cat([w, w.new_zeros(1)])[sel] if n_geq + n_leq else cv

    def lag_one(w, yhat, p_):
        return f_one(w, p_) + torch.dot(yhat, C_one(w, p_)) if nc else f_one(w, p_)

    grad_f = vmap(grad(f_one))
    hess_L = vmap(jacrev(jacrev(lag_one)))
    if nc:
        C_b, jac_C = vmap(C_one), vmap(jacrev(C_one))
    else:
        C_b = lambda w, p_: w.new_zeros(B, 0)
        jac_C = lambda w, p_: w.new_zeros(B, 0, len_w)

    def slacks(w):
        return (w - lw_c) * mask_l + (1 - mask_l), (uw_c - w) * mask_u + (1 - mask_u)

    def residuals(w, yhat, zl, zu, mu):
        g = grad_f(w, p)
        J = jac_C(w, p)
        r_stat = g + (J.transpose(1, 2) @ yhat[..., None])[..., 0] - zl * mask_l + zu * mask_u
        r_feas = C_b(w, p)
        sl, su = slacks(w)
        r_cl = (sl * zl - mu[:, None]) * mask_l
        r_cu = (su * zu - mu[:, None]) * mask_u
        return r_stat, r_feas, r_cl, r_cu, J, sl, su

    def kkt_error(w, yhat, zl, zu, mu):
        r_stat, r_feas, r_cl, r_cu = residuals(w, yhat, zl, zu, mu)[:4]
        return torch.cat([r_stat, r_feas, r_cl, r_cu], dim=-1).abs().amax(-1)

    # ---- initialization ---------------------------------------------------
    if x0 is None:
        x_init = torch.clamp(
            p.new_zeros(B, n),
            as_t(np.where(has_l[:n], lw[:n] + 0.5, -1.0)),
            as_t(np.where(has_u[:n], uw[:n] - 0.5, 1.0)),
        )
    else:
        x_init = torch.as_tensor(x0, device=dev).detach().to(dt).expand(B, n)
    cv0 = vmap(nlp.constraints)(x_init, p) if nc else p.new_zeros(B, 0)
    s0_geq = torch.clamp(cv0[:, nlp.geq_locs], min=1.0)
    s0_leq = torch.clamp(cv0[:, nlp.leq_locs], max=-1.0)
    # push strictly inside the bounds
    w = torch.clamp(torch.cat([x_init, s0_geq, s0_leq], dim=-1), lw_c + 0.1 * mask_l, uw_c - 0.1 * mask_u)
    yhat = p.new_zeros(B, nc)
    zl = torch.ones(B, len_w, dtype=dt, device=dev) * mask_l
    zu = torch.ones(B, len_w, dtype=dt, device=dev) * mask_u
    mu = torch.full((B,), 1e-1, dtype=dt, device=dev)
    lm = torch.full((B,), reg, dtype=dt, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)

    frac = 0.99
    n_active = max(float(has_l.sum() + has_u.sum()), 1.0)
    eye_nc = torch.eye(nc, dtype=dt, device=dev)

    def step_len(v, dv, mask):
        ratio = torch.where((dv < 0) & (mask > 0), -v / dv, torch.full_like(v, float("inf")))
        return torch.clamp(frac * ratio.amin(-1), max=1.0)

    for _ in range(max_iters):
        active = ~done & (it < max_iters)
        solve.host_syncs += 1
        if not bool(active.any()):
            break
        r_stat, r_feas, r_cl, r_cu, J, sl, su = residuals(w, yhat, zl, zu, mu)
        W = hess_L(w, yhat, p)
        # condensed: Wt = W + Zl/Sl + Zu/Su (+ lm); solve [Wt J'; J -reg][dw; dy] = [rhs_w; -r_feas]
        dl = (zl / sl) * mask_l
        du_ = (zu / su) * mask_u
        Wt = W + torch.diag_embed(dl + du_ + lm[:, None])
        rhs_w = -(
            r_stat
            - (mu[:, None] / sl - zl) * mask_l  # from eliminating dzl
            + (mu[:, None] / su - zu) * mask_u  # from eliminating dzu
        )
        if nc:
            K = torch.cat([torch.cat([Wt, J.transpose(1, 2)], dim=2),
                           torch.cat([J, (-reg * eye_nc).expand(B, nc, nc)], dim=2)], dim=1)
            rhs = torch.cat([rhs_w, -r_feas], dim=-1)
            if len_w + nc <= LDL_MAX_N:
                # quasi-definite once the Levenberg shift makes Wt positive definite (backtracking
                # rejects and grows lm otherwise): the batched LDL' and one refinement pass
                L, dvec = chol.ldl_batched(K)
                d = chol.ldl_solve_batched(L, dvec, rhs)
                d = d + chol.ldl_solve_batched(L, dvec, rhs - (K @ d[..., None])[..., 0])
            else:
                d = torch.linalg.solve_ex(K, rhs[..., None])[0][..., 0]
            dw, dy = d[:, :len_w], d[:, len_w:]
        else:
            dw = torch.linalg.solve_ex(Wt, rhs_w[..., None])[0][..., 0]
            dy = p.new_zeros(B, 0)
        dzl = ((mu[:, None] - sl * zl) * mask_l - zl * dw * mask_l) / sl
        dzu = ((mu[:, None] - su * zu) * mask_u + zu * dw * mask_u) / su

        a_p = torch.minimum(step_len(sl, dw * mask_l, mask_l), step_len(su, -dw * mask_u, mask_u))
        a_d = torch.minimum(step_len(zl, dzl, mask_l), step_len(zu, dzu, mask_u))

        # backtracking on the KKT error (simple merit): halve the step up to 3 times if the error does not
        # decrease; err0 is the KKT error of the current state at its own mu
        err0 = torch.cat([r_stat, r_feas, r_cl, r_cu], dim=-1).abs().amax(-1)

        def cand_err(ap, ad):
            ap, ad = ap[:, None], ad[:, None]
            return kkt_error(w + ap * dw, yhat + ad * dy, (zl + ad * dzl) * mask_l, (zu + ad * dzu) * mask_u, mu)

        # NaN-aware: a NaN candidate error counts as 'worse' (NaN <= x is False), else a NaN direction
        # from the unpivoted LDL' would shrink the Levenberg shift and livelock
        for _ in range(3):
            worse = ~(cand_err(a_p, a_d) <= err0 * 1.5)
            a_p = torch.where(worse, a_p * 0.5, a_p)
            a_d = torch.where(worse, a_d * 0.5, a_d)
        # Levenberg update: grow when even the backtracked step is bad, decay otherwise
        still_bad = ~(cand_err(a_p, a_d) <= err0 * 1.5)
        lm_n = torch.where(still_bad, torch.clamp(lm * 10.0, max=1e6), torch.clamp(lm / 3.0, min=reg))
        a_p = torch.where(still_bad, torch.zeros_like(a_p), a_p)[:, None]
        a_d = torch.where(still_bad, torch.zeros_like(a_d), a_d)[:, None]

        w_n = w + a_p * dw
        y_n = yhat + a_d * dy
        zl_n = (zl + a_d * dzl) * mask_l
        zu_n = (zu + a_d * dzu) * mask_u

        finite = torch.isfinite(torch.cat([w_n, y_n, zl_n, zu_n], dim=-1)).all(-1)
        fin = finite[:, None]
        w_n, y_n = torch.where(fin, w_n, w), torch.where(fin, y_n, yhat)
        zl_n, zu_n = torch.where(fin, zl_n, zl), torch.where(fin, zu_n, zu)

        # adaptive barrier: mu = 0.1 * average complementarity
        sl_n, su_n = slacks(w_n)
        compl = ((sl_n * zl_n * mask_l).sum(-1) + (su_n * zu_n * mask_u).sum(-1)) / n_active
        mu_n = torch.clamp(0.1 * compl, min=tol / 10.0)

        err = kkt_error(w_n, y_n, zl_n, zu_n, torch.zeros_like(mu))
        done_n = (err < tol) | ~finite

        # an instance that was already done keeps every field (the vmapped while_loop's select)
        keep = lambda new, old: torch.where(active.view(-1, *([1] * (new.ndim - 1))), new, old)
        w, yhat, zl, zu = keep(w_n, w), keep(y_n, yhat), keep(zl_n, zl), keep(zu_n, zu)
        mu, lm, it, done = keep(mu_n, mu), keep(lm_n, lm), keep(it + 1, it), keep(done_n, done)

    err = kkt_error(w, yhat, zl, zu, torch.zeros_like(mu))
    viol = torch.clamp(C_b(w, p).abs().amax(-1), min=0.0) if nc else p.new_zeros(B)
    sl, su = slacks(w)
    compl = torch.clamp(torch.cat([sl * zl * mask_l, su * zu * mask_u], dim=-1).amax(-1), min=0.0)
    info = NLPSolveInfo(iterations=it, kkt_residual=err, constraint_violation=viol, complementarity=compl,
                        converged=err < 10 * tol)

    # internal multipliers to the JuMP/MOI conventions nlp_diff ingests; the mapping is SENSE-INDEPENDENT:
    # the internal problem is min sigma*f, but the reported Lagrangian is stationarity of f - sigma*y*c,
    # which cancels the sigma (geq duals >= 0, leq <= 0, zL >= 0, zU <= 0 for Min AND Max)
    sol = NLPSolution(x=w[:, :n].clone(), y=-yhat, zL=zl[:, :n].clone(), zU=-zu[:, :n])
    if single:
        return sol.map(lambda t: t[0]), NLPSolveInfo(*(t[0] for t in info))
    return sol, info


solve.host_syncs = 0
