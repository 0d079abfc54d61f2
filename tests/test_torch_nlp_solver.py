"""Port parity of the embedded NLP interior-point solver (``solvers/nlp.py``):
the port's plain route (the LDL' pair's plain versions on CPU tensors) against
the JAX package's solver, f64, on a batch with equality, <= and >=
constraints and finite lower and upper bounds; the route past 128 rows; and,
with no JAX call, the reference's own numbers.

The JAX solve that reaches the LDL' Pallas kernels (interpret mode) runs once,
jitted and vmapped over the batch, for the whole file; the route past 128
compiles no Pallas kernel."""

import numpy as np
import pytest
import scipy.optimize as so
import torch

import jax
import jax.numpy as jnp

import diffopt_tpu_torch as dtt
from diffopt_tpu.nlp_diff import NLPProblem as JNLPProblem
from diffopt_tpu.solvers import nlp as jsolver
from diffopt_tpu_torch.solvers import nlp as tsolver

torch.set_num_threads(1)

FIELDS = ("x", "y", "zL", "zU")
KINDS = ("eq", "leq", "geq")
LB = [-1.0, -np.inf, 0.0, -np.inf]
UB = [np.inf, 0.5, np.inf, 3.0]
MAX_ITERS, TOL = 60, 1e-10


def _jobj(x, p):
    return jnp.sum((x - p[:4]) ** 2) + 0.1 * jnp.sum(x**4) + 0.2 * x[0] * x[1]


def _jcon(x, p):
    return jnp.array([jnp.sum(x) - p[4], x[0] ** 2 + x[1] ** 2 - p[5], x[2] - x[3] - p[6]])


def _tobj(x, p):
    return ((x - p[:4]) ** 2).sum() + 0.1 * (x**4).sum() + 0.2 * x[0] * x[1]


def _tcon(x, p):
    return torch.stack([x.sum() - p[4], x[0] ** 2 + x[1] ** 2 - p[5], x[2] - x[3] - p[6]])


def _params(B=6, seed=0):
    """Targets that push x0 onto its lower bound and x1 onto its upper one on some instances, and the
    <= and >= rows active on others."""
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [2.5 * rng.normal(size=(B, 4)) + np.array([-1.5, 1.0, 0.0, 0.0]), rng.uniform(-1.0, 1.0, size=(B, 1)),
         rng.uniform(0.2, 1.5, size=(B, 1)), rng.normal(size=(B, 1))], axis=1)


@pytest.fixture(scope="module")
def mixed():
    """The JAX package's solutions of the batch (one jitted, vmapped solve) and the port's, on the same p."""
    jnlp = JNLPProblem(_jobj, _jcon, KINDS, 4, lb=LB, ub=UB)
    P = _params()
    jsol, jinfo = jax.jit(jax.vmap(lambda p: jsolver.solve(jnlp, p, max_iters=MAX_ITERS, tol=TOL)))(jnp.asarray(P))
    tnlp = dtt.convert.nlpproblem_like(jnlp, _tobj, _tcon, device="cpu")
    tsol, tinfo = tsolver.solve(tnlp, torch.tensor(P), max_iters=MAX_ITERS, tol=TOL)
    return dict(P=P, jsol=jsol, jinfo=jinfo, tnlp=tnlp, tsol=tsol, tinfo=tinfo)


@pytest.mark.parametrize("field", FIELDS)
def test_solution_matches_jax(mixed, field):
    np.testing.assert_allclose(getattr(mixed["tsol"], field).numpy(), np.asarray(getattr(mixed["jsol"], field)),
                               rtol=0, atol=1e-7)


def test_info_matches_jax(mixed):
    """converged and iterations equal per instance; the residuals to the tolerance."""
    jinfo, tinfo = mixed["jinfo"], mixed["tinfo"]
    assert np.array_equal(tinfo.converged.numpy(), np.asarray(jinfo.converged))
    assert bool(tinfo.converged.all())
    assert np.array_equal(tinfo.iterations.numpy(), np.asarray(jinfo.iterations))
    for name in ("kkt_residual", "constraint_violation", "complementarity"):
        np.testing.assert_allclose(getattr(tinfo, name).numpy(), np.asarray(getattr(jinfo, name)), rtol=0,
                                   atol=10 * TOL, err_msg=name)


def test_fixture_exercises_every_block(mixed):
    """The batch has an active lower bound, an active upper bound and active <= and >= rows, so every block
    of the system is held above."""
    x, y = mixed["tsol"].x.numpy(), mixed["tsol"].y.numpy()
    assert np.isclose(x[:, 0], -1.0, atol=1e-8).any() and np.isclose(x[:, 1], 0.5, atol=1e-8).any()
    assert (np.abs(y[:, 1]) > 1e-3).any() and (np.abs(y[:, 2]) > 1e-3).any()
    assert (y[:, 1] <= 1e-9).all() and (y[:, 2] >= -1e-9).all()  # JuMP signs: <= rows <= 0, >= rows >= 0


def test_finished_instance_is_frozen(mixed):
    """An instance solved inside the batch ends exactly where it ends alone: the loop keeps every field
    of an instance that is done, while the others run on."""
    its = mixed["tinfo"].iterations
    i = int(torch.argmin(its))
    assert int(its.max()) > int(its[i])
    alone, info = tsolver.solve(mixed["tnlp"], torch.tensor(mixed["P"][i]), max_iters=MAX_ITERS, tol=TOL)
    assert int(info.iterations) == int(its[i])
    for field in FIELDS:
        assert torch.equal(getattr(alone, field), getattr(mixed["tsol"], field)[i]), field


def test_route_past_128_matches_jax():
    """len_w + nc = 130 (100 variables, 10 >= rows and 10 equalities): the library LU route in both packages."""
    n, ng, ne = 100, 10, 10
    rng = np.random.default_rng(5)
    A = rng.normal(size=(ng + ne, n)) / np.sqrt(n)
    At = torch.tensor(A)
    kinds = ("geq",) * ng + ("eq",) * ne
    jnlp = JNLPProblem(lambda x, p: jnp.sum((x - p[:n]) ** 2) + 0.05 * jnp.sum(x**4),
                       lambda x, p: jnp.asarray(A) @ x - p[n:], kinds, n)
    tnlp = dtt.convert.nlpproblem_like(jnlp, lambda x, p: ((x - p[:n]) ** 2).sum() + 0.05 * (x**4).sum(),
                                       lambda x, p: At @ x - p[n:], device="cpu")
    P = np.concatenate([rng.normal(size=(2, n)), 0.3 * rng.normal(size=(2, ng + ne))], axis=1)
    assert n + ng + ng + ne == 130
    jsol, jinfo = jax.jit(jax.vmap(lambda p: jsolver.solve(jnlp, p, max_iters=30, tol=TOL)))(jnp.asarray(P))
    tsol, tinfo = tsolver.solve(tnlp, torch.tensor(P), max_iters=30, tol=TOL)
    assert bool(tinfo.converged.all())
    assert np.array_equal(tinfo.iterations.numpy(), np.asarray(jinfo.iterations))
    for field in FIELDS:
        np.testing.assert_allclose(getattr(tsol, field).numpy(), np.asarray(getattr(jsol, field)), rtol=0,
                                   atol=1e-7, err_msg=field)


def _sipopt():
    return dtt.NLPProblem(
        lambda x, p: (x**2).sum(),
        lambda x, p: torch.stack([6 * x[0] + 3 * x[1] + 2 * x[2] - p[0], p[1] * x[0] + x[1] - x[2] - 1.0]),
        ("eq", "eq"), 3, lb=[0.0, 0.0, 0.0], device="cpu")


def test_sipopt_solution():
    """The reference's sIpopt example: min sum(x^2) s.t. 6x1+3x2+2x3 = p1, p2 x1 + x2 - x3 = 1, x >= 0,
    and its analytic Jacobian, solver output straight into the sensitivity rule."""
    nlp = _sipopt()
    p = torch.tensor([4.5, 1.0], dtype=torch.float64)
    sol, info = tsolver.solve(nlp, p, x0=torch.ones(3, dtype=torch.float64))
    assert bool(info.converged)
    np.testing.assert_allclose(sol.x.numpy(), [0.5, 0.5, 0.0], atol=1e-6)
    np.testing.assert_allclose(sol.y.numpy(), [0.0, 1.0], atol=1e-5)
    np.testing.assert_allclose(sol.zL.numpy(), [0.0, 0.0, 1.0], atol=1e-5)
    jac = dtt.nlp_diff.solution_jacobian(nlp, sol, p)
    np.testing.assert_allclose(jac.dx.numpy(), [[1 / 3, 1 / 2], [-1 / 3, -1.0], [0.0, 0.0]], atol=1e-5)


def _rosen(x):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2


def test_nonconvex_from_bad_start():
    """The reference's nonconvex Rosenbrock-style NLP from its deliberately bad start (-1, -2): the
    Levenberg shift and the NaN-aware backtracking carry the solver to a KKT point at least as good as
    scipy's SLSQP from the same start."""
    nlp = dtt.NLPProblem(
        lambda x, p: (1 - x[0]) ** 2 + p[2] * (x[1] - x[0] ** 2) ** 2,
        lambda x, p: torch.stack([x[0] ** 2 - p[0], p[0] * (x[0] + x[1]) ** 2 - p[1]]),
        ("leq", "leq"), 2, device="cpu")
    p = torch.tensor([1.0, 2.0, 100.0], dtype=torch.float64)
    sol, info = tsolver.solve(nlp, p, x0=torch.tensor([-1.0, -2.0], dtype=torch.float64), max_iters=200)
    assert bool(info.converged)
    res = so.minimize(_rosen, [-1.0, -2.0], method="SLSQP", tol=1e-12, constraints=[
        {"type": "ineq", "fun": lambda x: 1 - x[0] ** 2},
        {"type": "ineq", "fun": lambda x: 2 - (x[0] + x[1]) ** 2}])
    assert float(_rosen(sol.x)) <= res.fun + 1e-4, (sol.x, res.x)


def test_max_sense_softmax_and_leq_duals():
    """max p.y - sum(y log y) s.t. sum(y) = 1, y >= 0 gives softmax(p) and its Jacobian; and max x s.t.
    x <= p, x <= 2 gives leq duals <= 0 whatever the sense ([-1, 0])."""
    k = 4
    pv = np.linspace(0.5, 2.0, k)
    s = np.exp(pv) / np.exp(pv).sum()
    nlp = dtt.NLPProblem(lambda x, p: (p * x).sum() - (x * torch.log(x)).sum(), lambda x, p: (x.sum() - 1.0)[None],
                         ("eq",), k, lb=np.zeros(k), sense="max", device="cpu")
    p = torch.tensor(pv)
    sol, info = tsolver.solve(nlp, p, x0=torch.full((k,), 1.0 / k, dtype=torch.float64))
    assert bool(info.converged)
    np.testing.assert_allclose(sol.x.numpy(), s, atol=1e-6)
    jac = dtt.nlp_diff.solution_jacobian(nlp, sol, p)
    np.testing.assert_allclose(jac.dx.numpy(), np.diag(s) - np.outer(s, s), atol=1e-5)

    nlp = dtt.NLPProblem(lambda x, p: x[0], lambda x, p: torch.stack([x[0] - p[0], x[0] - 2.0]), ("leq", "leq"), 1,
                         sense="max", device="cpu")
    sol, info = tsolver.solve(nlp, torch.tensor([1.5], dtype=torch.float64))
    assert bool(info.converged)
    np.testing.assert_allclose(sol.x.numpy(), [1.5], atol=1e-6)
    np.testing.assert_allclose(sol.y.numpy(), [-1.0, 0.0], atol=1e-5)
