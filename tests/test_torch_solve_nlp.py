"""Port parity of the NLP entry points: ``solve_nlp`` (reverse rule through
``backward``, forward rule through ``torch.autograd.forward_ad``),
``NLPDiffContext`` and ``ParametricProgram(kind="nlp")``, f64 on the CPU.

They are held against the JAX package's sensitivity verbs at the port's own
solutions (no JAX solve: the verbs compile no Pallas kernel), against a
finite difference of the port's solves, and against the reference's sIpopt
layer."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import jax
import jax.numpy as jnp

import diffopt_tpu_torch as dtt
from diffopt_tpu import nlp_diff as jdiff
from diffopt_tpu_torch import nlp_diff as tdiff
from diffopt_tpu_torch.solvers import nlp as tsolver

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
P0 = torch.tensor([4.5, 1.0], **F64)
X0 = torch.ones(3, **F64)


def _tcon(x, p):
    return torch.stack([6 * x[0] + 3 * x[1] + 2 * x[2] - p[0], p[1] * x[0] + x[1] - x[2] - 1.0])


def _sipopt():
    """The reference's sIpopt example: min sum(x^2) s.t. 6x1+3x2+2x3 = p1, p2 x1 + x2 - x3 = 1, x >= 0."""
    return dtt.NLPProblem(lambda x, p: (x**2).sum(), _tcon, ("eq", "eq"), 3, lb=[0.0, 0.0, 0.0], device="cpu")


@pytest.fixture(scope="module")
def jax_verbs():
    """The JAX package's sIpopt problem and its jitted verbs at a given solution."""
    jnlp = jdiff.NLPProblem(
        lambda x, p: jnp.sum(x**2),
        lambda x, p: jnp.array([6 * x[0] + 3 * x[1] + 2 * x[2] - p[0], p[1] * x[0] + x[1] - x[2] - 1.0]),
        ("eq", "eq"), 3, lb=[0.0, 0.0, 0.0])

    @jax.jit
    def verbs(x, y, zL, zU, p, dp, sx, sy):
        s = jdiff.NLPSolution(x, y, zL, zU)
        return (jdiff.forward_differentiate(jnlp, s, p, dp), jdiff.solution_jacobian(jnlp, s, p),
                jdiff.reverse_differentiate(jnlp, s, p, dx=sx, dy=sy))

    return lambda sol, p, dp, sx, sy: verbs(*(jnp.asarray(t.detach().numpy()) for t in (*sol, p, dp, sx, sy)))


def _loss(sol):
    return (sol.x**2).sum() + (sol.y * sol.y).sum()


def test_vjp_matches_reverse_verb_jax_and_finite_difference(jax_verbs):
    nlp = _sipopt()
    p = P0.clone().requires_grad_()
    sol = dtt.solve_nlp(nlp, p, X0)
    _loss(sol).backward()
    sol = sol.map(torch.Tensor.detach)
    dp = tdiff.reverse_differentiate(nlp, sol, P0, dx=2 * sol.x, dy=2 * sol.y)
    np.testing.assert_allclose(p.grad.numpy(), dp.numpy(), rtol=0, atol=1e-12)
    ref = jax_verbs(sol, P0, torch.zeros(2, **F64), 2 * sol.x, 2 * sol.y)[2]
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref), rtol=0, atol=1e-9)
    eps = 1e-6
    for i in range(2):
        e = torch.zeros(2, **F64)
        e[i] = eps
        fd = (_loss(dtt.solve_nlp(nlp, P0 + e, X0)) - _loss(dtt.solve_nlp(nlp, P0 - e, X0))) / (2 * eps)
        np.testing.assert_allclose(float(p.grad[i]), float(fd), atol=2e-4)


def test_jvp_matches_solution_jacobian_and_jax(jax_verbs):
    nlp = _sipopt()
    sol = dtt.solve_nlp(nlp, P0, X0)
    full = tdiff.solution_jacobian(nlp, sol, P0)
    ref = jax_verbs(sol, P0, torch.zeros(2, **F64), torch.zeros(3, **F64), torch.zeros(2, **F64))[1]
    for i in range(2):
        e = torch.zeros(2, **F64)
        e[i] = 1.0
        with fwAD.dual_level():
            out = dtt.solve_nlp(nlp, fwAD.make_dual(P0, e), X0, mode="jvp")
            dx, dy = fwAD.unpack_dual(out.x).tangent, fwAD.unpack_dual(out.y).tangent
        np.testing.assert_allclose(dx.numpy(), full.dx[:, i].numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(dx.numpy(), np.asarray(ref.dx)[:, i], rtol=0, atol=1e-9)
        np.testing.assert_allclose(dy.numpy(), np.asarray(ref.dy)[:, i], rtol=0, atol=1e-9)


def test_batch_matches_instances_and_info():
    """A (B, np) batch gives each instance's own solve and gradient; with_info returns the solver's
    diagnostics as outputs without a gradient."""
    nlp = _sipopt()
    P = torch.tensor([[4.5, 1.0], [5.0, 1.2], [3.0, 0.8]], **F64).requires_grad_()
    sol, info = dtt.solve_nlp(nlp, P, X0, with_info=True)
    assert isinstance(info, tsolver.NLPSolveInfo) and bool(info.converged.all())
    assert not any(t.requires_grad for t in info)
    (sol.x**2).sum().backward()
    for i in range(3):
        p = P.detach()[i].clone().requires_grad_()
        s = dtt.solve_nlp(nlp, p, X0)
        (s.x**2).sum().backward()
        np.testing.assert_allclose(s.x.detach().numpy(), sol.x[i].detach().numpy(), rtol=0, atol=1e-14)
        np.testing.assert_allclose(p.grad.numpy(), P.grad[i].numpy(), rtol=0, atol=1e-12)


def test_unconverged_is_poisoned_on_request():
    nlp = _sipopt()
    cfg = dataclasses.replace(dtt.get_config(), nan_on_unconverged=True)
    with dtt.use_config(cfg):
        sol, info = dtt.solve_nlp(nlp, P0, X0, max_iters=1, with_info=True)
        assert not bool(info.converged)
        assert bool(torch.isnan(sol.x).all() and torch.isnan(sol.y).all())
        assert bool(torch.isfinite(dtt.solve_nlp(nlp, P0, X0).x).all())
    with pytest.raises(ValueError):
        dtt.solve_nlp(nlp, P0, mode="fwd")


def _mixed():
    return dtt.NLPProblem(
        lambda x, p: ((x - p[:3]) ** 2).sum() + 0.1 * (x**4).sum(),
        lambda x, p: torch.stack([x.sum() - p[3], x[0] ** 2 + x[1] ** 2 - 1.0, x[2] - x[0] - p[4]]),
        ("eq", "leq", "geq"), 3, lb=[-0.5, -np.inf, -np.inf], ub=[np.inf, np.inf, 2.0], device="cpu")


def test_diff_context_matches_uncached_verbs():
    nlp = _mixed()
    rng = np.random.default_rng(3)
    P = torch.tensor(np.concatenate([2 * rng.normal(size=(4, 3)), rng.normal(size=(4, 2))], axis=1))
    ctx = dtt.NLPDiffContext(nlp, P)
    assert bool(ctx.solve_info.converged.all()) and np.isnan(ctx.differentiate_time_sec)
    dp = torch.tensor(rng.normal(size=(4, 5)))
    fwd, ref = ctx.forward(dp), tdiff.forward_differentiate(nlp, ctx.sol, P, dp)
    assert ctx.differentiate_time_sec >= 0.0
    jac, jref = ctx.jacobian(), tdiff.solution_jacobian(nlp, ctx.sol, P)
    for name in ("dx", "dy", "dzL", "dzU"):
        np.testing.assert_allclose(getattr(fwd, name).numpy(), getattr(ref, name).numpy(), rtol=0, atol=1e-13)
        np.testing.assert_allclose(getattr(jac, name).numpy(), getattr(jref, name).numpy(), rtol=0, atol=1e-13)
    seeds = [torch.tensor(rng.normal(size=s)) for s in ((4, 3), (4, 3), (4, 3), (4, 3))]
    np.testing.assert_allclose(ctx.reverse(*seeds).numpy(),
                               tdiff.reverse_differentiate(nlp, ctx.sol, P, *seeds).numpy(), rtol=0, atol=1e-13)
    # one instance in, one instance out; a given solution is differentiated as it is
    one = dtt.NLPDiffContext(nlp, P[1], sol=ctx.sol.map(lambda t: t[1]))
    assert one.solve_info is None and one.sol.x.shape == (3,)
    np.testing.assert_allclose(one.forward(dp[1]).dx.numpy(), fwd.dx[1].numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(one.reverse(dx=seeds[0][1]).numpy(),
                               ctx.reverse(dx=seeds[0])[1].numpy(), rtol=0, atol=1e-13)
    with pytest.raises(dtt.NotSolvedError):
        dtt.NLPDiffContext(nlp, P, solver_kwargs=dict(max_iters=1))


def test_parametric_program_nlp_kind(jax_verbs):
    """The reference's sIpopt layer: p = [3 theta1, theta2^2] through build, x0 as a solve option."""
    nlp = _sipopt()
    layer = dtt.ParametricProgram(lambda th: torch.stack([3.0 * th[0], th[1] ** 2]), kind="nlp", nlp=nlp, x0=X0)
    theta = torch.tensor([1.5, 1.0], **F64)
    sol = layer.solve(theta)
    ref, _ = tsolver.solve(nlp, P0, X0)
    np.testing.assert_allclose(sol.x.detach().numpy(), ref.x.numpy(), atol=1e-7)

    fwd = layer.forward_differentiate(theta, torch.tensor([1.0, 0.0], **F64))
    jref = jax_verbs(ref, P0, torch.tensor([3.0, 0.0], **F64), torch.ones(3, **F64), torch.zeros(2, **F64))
    np.testing.assert_allclose(fwd.x.numpy(), np.asarray(jref[0].dx), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(fwd.x.numpy(), tdiff.forward_differentiate(nlp, ref, P0, torch.tensor([3.0, 0.0], **F64)
                                                                        ).dx.numpy(), rtol=0, atol=1e-12)
    dtheta = layer.reverse_differentiate(theta, dx=torch.ones(3, **F64))
    dp = np.asarray(jref[2])
    np.testing.assert_allclose(dtheta.numpy(), [3.0 * dp[0], 2.0 * dp[1]], rtol=1e-6, atol=1e-9)

    with pytest.raises(ValueError):
        dtt.ParametricProgram(lambda th: th, kind="nlp")  # missing nlp=
    with pytest.raises(ValueError):
        dtt.ParametricProgram(lambda th: th, kind="qp", nlp=nlp)


def test_problem_lands_on_the_card_unless_told(monkeypatch):
    """Without a device, an NLPProblem is for the card, and raises where there is none; a parameter given as a
    list lands on the problem's device, a tensor elsewhere is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dtt.NLPProblem(lambda x, p: (x**2).sum(), None, (), 2)
    nlp = dtt.NLPProblem(lambda x, p: ((x - p) ** 2).sum(), None, (), 2, device="cpu")
    sol, info = tsolver.solve(nlp, [1.0, -2.0], max_iters=20, tol=1e-9)
    assert bool(info.converged) and sol.x.device.type == "cpu"
    np.testing.assert_allclose(sol.x.numpy(), [1.0, -2.0], atol=1e-6)
    with pytest.raises(ValueError, match="lives on"):
        nlp.param(torch.zeros(2, device="meta"))
