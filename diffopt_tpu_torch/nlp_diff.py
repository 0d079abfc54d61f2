"""Nonlinear-program (NLP) KKT sensitivity — the sIpopt method, batch-first.

Counterpart of ``diffopt_tpu/nlp_diff.py``: factorize the KKT-system Jacobian
``M`` at a local optimum of a parameterized NLP and solve ``M ds = -N dp`` for
primal AND dual sensitivities; reverse mode transposes the same system.

The user hands torch functions for ONE instance, ``objective(x, p) -> scalar``
and ``constraints(x, p) -> (nc,)``; the derivatives come from
``torch.func.jacrev`` / ``grad`` under ``torch.func.vmap`` over the batch, so
the functions must be written with operations ``torch.func`` can transform
(no in-place writes into captured tensors, no ``.item()``). Reverse mode
throughout (the Hessian as ``jacrev(jacrev(.))`` where the JAX package takes
``jacfwd(jacrev(.))``): ``torch.func``'s forward mode cannot run inside the
dual level of a caller's ``torch.autograd.forward_ad``, which is where
``solve_nlp``'s forward rule runs.

Problem form::

    min/max  f(x, p)
    s.t.     c_i(x, p) (=, <=, >=) 0     for each constraint kind
             lb <= x <= ub                (+-inf where absent)

Every verb takes a ``(B, np)`` batch of parameters with solutions of
``(B, n)`` / ``(B, nc)`` fields, or one instance (``p`` of shape ``(np,)``),
which gains a batch dimension on the way in and loses it on the way out.

Slack augmentation, bound handling, the M/N block layout, the LU-with-
inertia-correction loop and the JuMP-convention sign fixups are the JAX
package's — these sign conventions are load-bearing for parity.

Dual conventions (JuMP/MOI): y >= 0 for >= constraints, y <= 0 for <=
constraints; bound duals zL >= 0 (lower), zU <= 0 (upper) — for BOTH Min and
Max senses (the duals satisfy stationarity of ``f - sigma*y*c``; ``_sign_fix``
converts the internal sensitivity rows back to it).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import grad, jacrev, vmap

from .ir import default_device
from .utils.precision import full_precision

Tensor = torch.Tensor


class NLPProblem:
    """Static description of a parameterized NLP.

    ``objective(x, p) -> scalar``; ``constraints(x, p) -> (nc,)`` (may be None
    when nc == 0), both for one instance; ``kinds`` a tuple of 'eq' | 'leq' |
    'geq' per constraint; ``lb``/``ub`` concrete (n,) arrays with +-inf. The
    bound pattern and constraint kinds are static structure (they fix the KKT
    block layout). ``device`` is where parameters given as lists or numpy
    arrays are placed: the card unless ``"cpu"`` is named; a tensor parameter
    must live there.
    """

    def __init__(
        self,
        objective: Callable,
        constraints: Optional[Callable],
        kinds: Sequence[str],
        n: int,
        lb=None,
        ub=None,
        sense: str = "min",
        device=None,
    ):
        self.objective = objective
        self.constraints = constraints
        self.kinds = tuple(kinds)
        for k in self.kinds:
            if k not in ("eq", "leq", "geq"):
                raise ValueError(f"bad constraint kind {k!r}")
        self.n = int(n)
        self.lb = np.full(n, -np.inf) if lb is None else np.asarray(lb, float)
        self.ub = np.full(n, np.inf) if ub is None else np.asarray(ub, float)
        if sense not in ("min", "max"):
            raise ValueError("sense must be 'min' or 'max'")
        self.sense = sense
        self.device = default_device(device, "NLPProblem")
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())  # what a tensor made on "cuda" reports

        self.geq_locs = np.array([i for i, k in enumerate(self.kinds) if k == "geq"], int)
        self.leq_locs = np.array([i for i, k in enumerate(self.kinds) if k == "leq"], int)
        self.has_low = np.nonzero(np.isfinite(self.lb))[0]
        self.has_up = np.nonzero(np.isfinite(self.ub))[0]

    @property
    def nc(self) -> int:
        return len(self.kinds)

    @property
    def sense_mult(self) -> float:
        return 1.0 if self.sense == "min" else -1.0

    def param(self, p) -> Tensor:
        """``p`` as a tensor on the problem's device (lists and arrays are placed there; a tensor elsewhere
        raises rather than being copied)."""
        if isinstance(p, Tensor):
            if p.device != self.device:
                raise ValueError(f"NLPProblem on {self.device}: p lives on {p.device}")
            return p
        return torch.as_tensor(p, device=self.device)


class NLPSolution(NamedTuple):
    """Local optimum in JuMP conventions: primal ``x``; constraint duals ``y``
    (nc,); bound duals ``zL``/``zU`` (n,), zero where the bound is absent or
    inactive. Batch-first like every struct of the port."""

    x: Tensor
    y: Tensor
    zL: Tensor
    zU: Tensor

    def tensors(self):
        return tuple(self)

    def map(self, fn):
        return NLPSolution(*(fn(t) for t in self))


class NLPForward(NamedTuple):
    dx: Tensor  # (B, n) primal sensitivity (or (B, n, np) full Jacobian)
    dy: Tensor  # (B, nc) constraint-dual sensitivity
    dzL: Tensor  # (B, n) lower-bound-dual sensitivity (zeros where no bound)
    dzU: Tensor  # (B, n) upper-bound-dual sensitivity
    singular: Tensor  # (B,) bool: inertia correction failed -> zeros returned


def _batch(p: Tensor, *structs):
    """(single, p, structs...) with a batch dimension added where ``p`` is one instance."""
    if p.ndim == 1:
        return (True, p[None]) + tuple(None if s is None else s.map(lambda t: t[None]) for s in structs)
    return (False, p) + structs


def _unbatch(single: bool, out):
    if not single:
        return out
    if isinstance(out, Tensor):
        return out[0]
    return type(out)(*(t[0] for t in out))


def _derivatives(nlp: NLPProblem, sol: NLPSolution, p: Tensor):
    """Lagrangian Hessian blocks and constraint Jacobians at the solutions, ``(B, ...)`` each.

    The Lagrangian multiplier convention matches the reference's evaluator
    call (obj multiplier 1.0, constraint multipliers ``-sigma*y``).
    """
    sigma = nlp.sense_mult
    if nlp.nc:
        def lag(x_, p_, y_):
            return nlp.objective(x_, p_) + torch.dot(-sigma * y_, nlp.constraints(x_, p_))
    else:
        def lag(x_, p_, y_):
            return nlp.objective(x_, p_)

    W = vmap(jacrev(jacrev(lag, argnums=0), argnums=0))(sol.x, p, sol.y)  # (B, n, n)
    Wxp = vmap(jacrev(grad(lag, argnums=0), argnums=1))(sol.x, p, sol.y)  # (B, n, np)
    B = sol.x.shape[0]
    if nlp.nc:
        Jx = vmap(jacrev(nlp.constraints, argnums=0))(sol.x, p)  # (B, nc, n)
        Jp = vmap(jacrev(nlp.constraints, argnums=1))(sol.x, p)  # (B, nc, np)
    else:
        Jx = sol.x.new_zeros(B, 0, nlp.n)
        Jp = sol.x.new_zeros(B, 0, p.shape[-1])
    return W, Wxp, Jx, Jp


def _layout(nlp: NLPProblem) -> dict:
    n, nc = nlp.n, nlp.nc
    n_geq, n_leq = len(nlp.geq_locs), len(nlp.leq_locs)
    len_w = n + n_geq + n_leq
    nl_x, nu_x = len(nlp.has_low), len(nlp.has_up)
    num_low, num_up = nl_x + n_geq, nu_x + n_leq
    return dict(
        n=n, nc=nc, n_geq=n_geq, n_leq=n_leq, len_w=len_w,
        nl_x=nl_x, nu_x=nu_x, num_low=num_low, num_up=num_up, total=len_w + nc + num_low + num_up,
    )


def _build(nlp: NLPProblem, sol: NLPSolution, p: Tensor):
    """(M, N, layout) of a batch (the body of :func:`build_sensitivity_system`)."""
    sigma = nlp.sense_mult
    layout = _layout(nlp)
    n, nc, n_geq, n_leq = layout["n"], layout["nc"], layout["n_geq"], layout["n_leq"]
    len_w, num_low, num_up, total = layout["len_w"], layout["num_low"], layout["num_up"], layout["total"]
    B, dt, dev = sol.x.shape[0], sol.x.dtype, sol.x.device

    W, Wxp, Jx, Jp = _derivatives(nlp, sol, p)
    num_p = Wxp.shape[-1]

    cons_val = vmap(nlp.constraints)(sol.x, p) if nc else sol.x.new_zeros(B, 0)
    s_geq = cons_val[:, nlp.geq_locs]  # slack values: c(x) - 0 (>= 0)
    s_leq = cons_val[:, nlp.leq_locs]  # (<= 0)

    # w-space bound index sets: [primal bounds; slack bounds]
    low_idx_w = np.concatenate([nlp.has_low, n + np.arange(n_geq)]).astype(int)
    up_idx_w = np.concatenate([nlp.has_up, n + n_geq + np.arange(n_leq)]).astype(int)
    X_L = torch.as_tensor(np.concatenate([nlp.lb[nlp.has_low], np.zeros(n_geq)]), dtype=dt, device=dev)
    X_U = torch.as_tensor(np.concatenate([nlp.ub[nlp.has_up], np.zeros(n_leq)]), dtype=dt, device=dev)
    w = torch.cat([sol.x, s_geq, s_leq], dim=-1)

    # bound-dual values in the internal (sIpopt) convention: V_L = sigma * dual_low >= 0,
    # V_U = -sigma * dual_up >= 0; slack bounds carry the constraint dual
    V_L = torch.cat([sigma * sol.zL[:, nlp.has_low], sigma * sol.y[:, nlp.geq_locs]], dim=-1)
    V_U = torch.cat([-sigma * sol.zU[:, nlp.has_up], -sigma * sol.y[:, nlp.leq_locs]], dim=-1)

    # A over w: constraint Jacobian with -1 slack columns
    A = sol.x.new_zeros(B, nc, len_w)
    A[:, :, :n] = Jx
    if n_geq:
        A[:, nlp.geq_locs, n + np.arange(n_geq)] = -1.0
    if n_leq:
        A[:, nlp.leq_locs, n + n_geq + np.arange(n_leq)] = -1.0

    M = sol.x.new_zeros(B, total, total)
    M[:, :n, :n] = W
    M[:, :len_w, len_w:len_w + nc] = A.transpose(1, 2)
    M[:, len_w:len_w + nc, :len_w] = A
    lo0 = len_w + nc
    if num_low:
        rows = lo0 + np.arange(num_low)
        M[:, low_idx_w, rows] = -1.0  # I_L
        M[:, rows, low_idx_w] = V_L  # V_L rows
        M[:, rows, rows] = w[:, low_idx_w] - X_L
    up0 = lo0 + num_low
    if num_up:
        rows = up0 + np.arange(num_up)
        M[:, up_idx_w, rows] = 1.0  # I_U
        M[:, rows, up_idx_w] = V_U
        M[:, rows, rows] = X_U - w[:, up_idx_w]

    N = sol.x.new_zeros(B, total, num_p)
    N[:, :n, :] = Wxp
    N[:, len_w:len_w + nc, :] = Jp
    return M, N, layout


@full_precision
def build_sensitivity_system(nlp: NLPProblem, sol: NLPSolution, p):
    """Assemble (M, N, layout) in the JAX package's block layout: ``M (B, total, total)``,
    ``N (B, total, np)`` (without the batch dimension for one instance).

    Layout of the unknown block ``s = [w; y_cons; z_low; z_up]`` with
    ``w = [x; s_geq; s_leq]``, ``z_low = [primal-lower duals; geq-slack
    duals]``, ``z_up = [primal-upper duals; leq-slack duals]``; layout carries
    the static offsets.
    """
    single, p, sol = _batch(nlp.param(p), sol)
    M, N, layout = _build(nlp, sol, p)
    return (M[0], N[0], layout) if single else (M, N, layout)


def _is_singular(lu: Tensor, total: int) -> Tensor:
    eps = torch.finfo(lu.dtype).eps
    diagU = torch.diagonal(lu, dim1=-2, dim2=-1).abs()
    bad = ~torch.isfinite(diagU).all(-1)
    tiny = diagU.amin(-1) <= eps * torch.clamp(diagU.amax(-1), min=1.0) * total
    return bad | tiny


def factorize_with_inertia(
    M: Tensor,
    layout: dict,
    st: float | None = None,
    max_corrections: int | None = None,
):
    """Batched LU with the reference's inertia-correction loop: on a singular
    factorization, add ``st * diag(+1 on w/bound rows, -1 on constraint
    rows)`` repeatedly, to each still-singular instance alone (its own count
    of corrections; the others keep their first factorization).

    ``st``/``max_corrections`` default from the active config
    (``inertia_shift``/``inertia_max_corrections``). Returns ``(lu, piv,
    singular)`` with ``singular (B,)`` True after ``max_corrections`` failed
    shifts (that instance's sensitivities are then zero). One host sync per
    round that still finds a singular instance, and one to find none.
    """
    from .utils.config import get_config

    cfg = get_config()
    if st is None:
        st = cfg.inertia_shift
    if max_corrections is None:
        max_corrections = cfg.inertia_max_corrections
    total, len_w, nc = layout["total"], layout["len_w"], layout["nc"]
    d = torch.ones(total, dtype=M.dtype, device=M.device)
    d[len_w:len_w + nc] = -1.0
    Dm = torch.diag(d)

    lu, piv, _ = torch.linalg.lu_factor_ex(M)
    sing = _is_singular(lu, total)
    k = torch.zeros(M.shape[0], dtype=torch.int32, device=M.device)
    for _ in range(max_corrections):
        factorize_with_inertia.host_syncs += 1
        idx = torch.nonzero(sing).flatten()
        if idx.numel() == 0:
            break
        kk = k[idx] + 1
        J = M[idx] + (kk.to(M.dtype) * st)[:, None, None] * Dm
        lu2, piv2, _ = torch.linalg.lu_factor_ex(J)
        lu[idx], piv[idx], k[idx] = lu2, piv2, kk
        sing[idx] = _is_singular(lu2, total)
    return lu, piv, sing


factorize_with_inertia.host_syncs = 0


def _sign_fix(layout: dict, sigma: float, v: Tensor) -> Tensor:
    """JuMP-convention sign fixups on sensitivity rows ``v (B, total[, k])``:
    constraint-dual rows *= -sigma, lower bound dual rows *= sigma, upper
    bound dual rows *= -sigma."""
    len_w, nc, num_low = layout["len_w"], layout["nc"], layout["num_low"]
    scale = torch.ones(layout["total"], dtype=v.dtype, device=v.device)
    scale[len_w:len_w + nc] = -sigma
    scale[len_w + nc:len_w + nc + num_low] = sigma
    scale[len_w + nc + num_low:] = -sigma
    return v * scale if v.ndim == 2 else v * scale[:, None]


def _extract(nlp: NLPProblem, layout: dict, ds: Tensor, singular: Tensor) -> NLPForward:
    n, nc = layout["n"], layout["nc"]
    len_w, num_low = layout["len_w"], layout["num_low"]
    nl_x, nu_x = layout["nl_x"], layout["nu_x"]
    dx = ds[:, :n]
    dy = ds[:, len_w:len_w + nc]
    dzL = ds.new_zeros((ds.shape[0], n) + ds.shape[2:])
    if nl_x:
        dzL[:, nlp.has_low] = ds[:, len_w + nc:len_w + nc + nl_x]
    dzU = ds.new_zeros((ds.shape[0], n) + ds.shape[2:])
    if nu_x:
        up0 = len_w + nc + num_low
        dzU[:, nlp.has_up] = ds[:, up0:up0 + nu_x]
    return NLPForward(dx=dx, dy=dy, dzL=dzL, dzU=dzU, singular=singular)


def _zero_where(sing: Tensor, v: Tensor) -> Tensor:
    return torch.where(sing.view(-1, *([1] * (v.ndim - 1))), torch.zeros_like(v), v)


def tangent_from_factor(nlp, layout, lu, piv, sing, N, dp) -> NLPForward:
    """``ds = -M^{-1} N dp`` from a factorization, signs fixed, zero where singular (``dp (B, np)``)."""
    rhs = (N @ dp[..., None])[..., 0]
    ds = -torch.linalg.lu_solve(lu, piv, rhs[..., None])[..., 0]
    return _extract(nlp, layout, _zero_where(sing, _sign_fix(layout, nlp.sense_mult, ds)), sing)


def jacobian_from_factor(nlp, layout, lu, piv, sing, N) -> NLPForward:
    """The full ``ds/dp`` from a factorization (every output gains a trailing np dimension)."""
    ds = -torch.linalg.lu_solve(lu, piv, N)
    return _extract(nlp, layout, _zero_where(sing, _sign_fix(layout, nlp.sense_mult, ds)), sing)


def cotangent_from_factor(nlp, layout, lu, piv, sing, N, dx=None, dy=None, dzL=None, dzU=None) -> Tensor:
    """Parameter cotangent ``dp (B, np)`` from a factorization: one transposed solve."""
    n, nc = layout["n"], layout["nc"]
    len_w, num_low = layout["len_w"], layout["num_low"]
    nl_x, nu_x = layout["nl_x"], layout["nu_x"]
    seed = N.new_zeros(N.shape[0], layout["total"])
    if dx is not None:
        seed[:, :n] = dx
    if dy is not None and nc:
        seed[:, len_w:len_w + nc] = dy
    if dzL is not None and nl_x:
        seed[:, len_w + nc:len_w + nc + nl_x] = dzL[:, nlp.has_low]
    if dzU is not None and nu_x:
        up0 = len_w + nc + num_low
        seed[:, up0:up0 + nu_x] = dzU[:, nlp.has_up]
    seed = _sign_fix(layout, nlp.sense_mult, seed)
    t = torch.linalg.lu_solve(lu, piv, seed[..., None], adjoint=True)[..., 0]
    dp = -(N.transpose(1, 2) @ t[..., None])[..., 0]
    return _zero_where(sing, dp)


def _factored(nlp, sol, p, factorization):
    M, N, layout = _build(nlp, sol, p)
    lu, piv, sing = (factorization or factorize_with_inertia)(M, layout)
    return layout, lu, piv, sing, N


@full_precision
def forward_differentiate(nlp: NLPProblem, sol: NLPSolution, p, dp, factorization=None) -> NLPForward:
    """Directional sensitivity ``ds = -M^{-1} N dp`` with sign fixups.

    ``factorization(M, layout) -> (lu, piv, singular)`` overrides the default
    LU-with-inertia-correction (the reference's pluggable KKT-Jacobian
    factorization)."""
    single, p, sol = _batch(nlp.param(p), sol)
    dp = dp[None] if single else dp
    return _unbatch(single, tangent_from_factor(nlp, *_factored(nlp, sol, p, factorization), dp))


@full_precision
def solution_jacobian(nlp: NLPProblem, sol: NLPSolution, p, factorization=None) -> NLPForward:
    """Full Jacobian ``ds/dp`` (every output gains a trailing num_p dim) — the
    reference's materialized ``Delta s``."""
    single, p, sol = _batch(nlp.param(p), sol)
    return _unbatch(single, jacobian_from_factor(nlp, *_factored(nlp, sol, p, factorization)))


@full_precision
def reverse_differentiate(
    nlp: NLPProblem,
    sol: NLPSolution,
    p,
    dx: Optional[Tensor] = None,
    dy: Optional[Tensor] = None,
    dzL: Optional[Tensor] = None,
    dzU: Optional[Tensor] = None,
    factorization=None,
) -> Tensor:
    """Parameter cotangent ``dp = (ds/dp)' seed``, computed directionally via
    one transposed solve."""
    single, p, sol = _batch(nlp.param(p), sol)
    seeds = [None if s is None else (s[None] if single else s) for s in (dx, dy, dzL, dzU)]
    return _unbatch(single, cotangent_from_factor(nlp, *_factored(nlp, sol, p, factorization), *seeds))
