"""Port parity of the NLP sensitivity verbs (``nlp_diff.py``): the KKT
Jacobian M and N, the forward, reverse and ``solution_jacobian`` verbs and the
inertia correction against ``diffopt_tpu.nlp_diff`` at the same points, f64;
and, with no JAX call, the reference's analytic sensitivities.

The points are the port's own solves (CPU); the JAX verbs run jitted and
vmapped over the batch and compile no Pallas kernel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diffopt_tpu_torch as dtt
from diffopt_tpu import nlp_diff as jdiff
from diffopt_tpu_torch import nlp_diff as tdiff
from diffopt_tpu_torch.solvers import nlp as tsolver

torch.set_num_threads(1)

KINDS = ("eq", "leq", "geq")
LB = [-1.0, -np.inf, 0.0, -np.inf]
UB = [np.inf, 0.5, np.inf, 3.0]
VERBS = ("dx", "dy", "dzL", "dzU")


def _problem(sense):
    """Both packages' form of one NLP with every block: an equality, a <= and a >= row, finite lower and
    upper bounds; the objective's sign follows the sense so that each is well posed."""
    s = 1.0 if sense == "min" else -1.0

    def jobj(x, p):
        return s * (jnp.sum((x - p[:4]) ** 2) + 0.1 * jnp.sum(x**4) + 0.2 * x[0] * x[1] * p[6])

    def jcon(x, p):
        return jnp.array([jnp.sum(x) - p[4], x[0] ** 2 + x[1] ** 2 - p[5], x[2] - x[3] - p[6]])

    def tobj(x, p):
        return s * (((x - p[:4]) ** 2).sum() + 0.1 * (x**4).sum() + 0.2 * x[0] * x[1] * p[6])

    def tcon(x, p):
        return torch.stack([x.sum() - p[4], x[0] ** 2 + x[1] ** 2 - p[5], x[2] - x[3] - p[6]])

    jnlp = jdiff.NLPProblem(jobj, jcon, KINDS, 4, lb=LB, ub=UB, sense=sense)
    return jnlp, dtt.convert.nlpproblem_like(jnlp, tobj, tcon, device="cpu")


def _jax_verbs(jnlp, sol, P, dP, seeds):
    """M, N, the three verbs and the inertia-corrected factorization of the JAX package, one vmapped jit."""

    def one(x, y, zL, zU, p, dp, sx, sy, szL, szU):
        s = jdiff.NLPSolution(x, y, zL, zU)
        M, N, _ = jdiff.build_sensitivity_system(jnlp, s, p)
        return (M, N, jdiff.forward_differentiate(jnlp, s, p, dp), jdiff.solution_jacobian(jnlp, s, p),
                jdiff.reverse_differentiate(jnlp, s, p, dx=sx, dy=sy, dzL=szL, dzU=szU))

    args = [jnp.asarray(a) for a in (*sol, P, dP, *seeds)]
    return jax.jit(jax.vmap(one))(*args)


@pytest.fixture(scope="module", params=["min", "max"])
def point(request):
    """A batch of solved instances (the port's solver) and both packages' sensitivities there."""
    jnlp, tnlp = _problem(request.param)
    rng = np.random.default_rng(1)
    B = 4
    P = np.concatenate([2.5 * rng.normal(size=(B, 4)) + np.array([-1.5, 1.0, 0.0, 0.0]),
                        rng.uniform(-1.0, 1.0, size=(B, 1)), rng.uniform(0.2, 1.5, size=(B, 1)),
                        rng.normal(size=(B, 1))], axis=1)
    sol, info = tsolver.solve(tnlp, torch.tensor(P), max_iters=60, tol=1e-10)
    assert bool(info.converged.all())
    dP = rng.normal(size=P.shape)
    seeds = [rng.normal(size=(B, 4)), rng.normal(size=(B, 3)), rng.normal(size=(B, 4)), rng.normal(size=(B, 4))]
    ref = _jax_verbs(jnlp, [t.numpy() for t in sol], P, dP, seeds)
    return dict(tnlp=tnlp, sol=sol, P=torch.tensor(P), dP=torch.tensor(dP), seeds=[torch.tensor(s) for s in seeds],
                ref=ref)


def test_sensitivity_system_matches_jax(point):
    M, N, layout = tdiff.build_sensitivity_system(point["tnlp"], point["sol"], point["P"])
    assert layout["total"] == 4 + 2 + 3 + 3 + 3  # w = [x; s_geq; s_leq], 3 rows, 2 + 1 lower, 1 + 1 upper bounds
    np.testing.assert_allclose(M.numpy(), np.asarray(point["ref"][0]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(N.numpy(), np.asarray(point["ref"][1]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("field", VERBS)
def test_forward_matches_jax(point, field):
    fwd = tdiff.forward_differentiate(point["tnlp"], point["sol"], point["P"], point["dP"])
    assert not bool(fwd.singular.any())
    np.testing.assert_allclose(getattr(fwd, field).numpy(), np.asarray(getattr(point["ref"][2], field)), rtol=0,
                               atol=1e-9)


def test_solution_jacobian_matches_jax(point):
    jac = tdiff.solution_jacobian(point["tnlp"], point["sol"], point["P"])
    assert jac.dx.shape == (4, 4, 7)
    for field in VERBS:
        np.testing.assert_allclose(getattr(jac, field).numpy(), np.asarray(getattr(point["ref"][3], field)), rtol=0,
                                   atol=1e-9, err_msg=field)


def test_reverse_matches_jax_and_is_the_adjoint(point):
    dx, dy, dzL, dzU = point["seeds"]
    rev = tdiff.reverse_differentiate(point["tnlp"], point["sol"], point["P"], dx=dx, dy=dy, dzL=dzL, dzU=dzU)
    np.testing.assert_allclose(rev.numpy(), np.asarray(point["ref"][4]), rtol=0, atol=1e-9)
    # <J dp, seed> == <dp, J' seed>
    fwd = tdiff.forward_differentiate(point["tnlp"], point["sol"], point["P"], point["dP"])
    lhs = sum((getattr(fwd, f) * s).sum(-1) for f, s in zip(VERBS, point["seeds"]))
    np.testing.assert_allclose(lhs.numpy(), (point["dP"] * rev).sum(-1).numpy(), rtol=1e-9, atol=1e-12)


def test_inertia_correction_shifts_only_the_singular_instance():
    """Duplicated active rows make M singular (the reference's inertia-correction case); in a batch with a
    regular instance, only the singular one is shifted, with the JAX package's count of shifts."""
    kinds = ("geq", "geq")
    jnlp = jdiff.NLPProblem(lambda x, p: x[0] ** 2, lambda x, p: jnp.array([x[0] - p[0], x[0] - p[1]]), kinds, 1)
    tnlp = dtt.convert.nlpproblem_like(jnlp, lambda x, p: x[0] ** 2, lambda x, p: torch.stack([x[0] - p[0], x[0] - p[1]]),
                                       device="cpu")
    P = np.array([[2.0, 2.0], [2.0, 1.0]])  # both rows active / the second inactive
    sol = dict(x=[[2.0], [2.0]], y=[[2.0, 2.0], [4.0, 0.0]], zL=[[0.0], [0.0]], zU=[[0.0], [0.0]])
    tsol = dtt.convert.nlpsolution_from_numpy(sol, dtype=torch.float64, device="cpu")
    M, N, layout = tdiff.build_sensitivity_system(tnlp, tsol, torch.tensor(P))
    lu, piv, sing = tdiff.factorize_with_inertia(M, layout)
    first = torch.linalg.lu_factor_ex(M)[0]
    assert tdiff._is_singular(first, layout["total"]).tolist() == [True, False]
    assert not torch.equal(lu[0], first[0])  # the singular instance was shifted ...
    assert torch.equal(lu[1], first[1])  # ... the regular one keeps its first factorization
    assert not bool(sing.any())

    def jax_one(x, y, zL, zU, p):
        s_ = jdiff.NLPSolution(x, y, zL, zU)
        jM, _, jl = jdiff.build_sensitivity_system(jnlp, s_, p)
        return jdiff.factorize_with_inertia(jM, jl), jdiff.forward_differentiate(jnlp, s_, p, jnp.ones(2))

    (jlu, _, jsing), jfwd = jax.jit(jax.vmap(jax_one))(*(jnp.asarray(sol[k]) for k in ("x", "y", "zL", "zU")),
                                                      jnp.asarray(P))
    np.testing.assert_allclose(lu.numpy(), np.asarray(jlu), rtol=0, atol=1e-12)
    assert np.array_equal(sing.numpy(), np.asarray(jsing))
    # the shifted instance's sensitivities are finite and agree with the JAX package's
    fwd = tdiff.forward_differentiate(tnlp, tsol, torch.tensor(P), torch.ones(2, 2, dtype=torch.float64))
    assert bool(torch.isfinite(fwd.dx).all() and torch.isfinite(fwd.dy).all())
    np.testing.assert_allclose(fwd.dx.numpy(), np.asarray(jfwd.dx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(fwd.dy.numpy(), np.asarray(jfwd.dy), rtol=0, atol=1e-9)


def test_singular_flag_zeroes_only_that_instance():
    """With no room for corrections, the singular instance is flagged and its sensitivities are zero; the
    regular instance's are the uncorrected ones."""
    tnlp = dtt.NLPProblem(lambda x, p: x[0] ** 2, lambda x, p: torch.stack([x[0] - p[0], x[0] - p[1]]),
                          ("geq", "geq"), 1, device="cpu")
    tsol = dtt.convert.nlpsolution_from_numpy(
        dict(x=[[2.0], [2.0]], y=[[2.0, 2.0], [4.0, 0.0]], zL=[[0.0], [0.0]], zU=[[0.0], [0.0]]),
        dtype=torch.float64, device="cpu")
    P = torch.tensor([[2.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    fact = lambda M, layout: tdiff.factorize_with_inertia(M, layout, max_corrections=0)
    fwd = tdiff.forward_differentiate(tnlp, tsol, P, torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64),
                                      factorization=fact)
    assert fwd.singular.tolist() == [True, False]
    assert float(fwd.dx[0].abs().max()) == 0.0 and float(fwd.dy[0].abs().max()) == 0.0
    np.testing.assert_allclose(fwd.dx[1].numpy(), [1.0], atol=1e-12)  # x = p1 moves with p1
    rev = tdiff.reverse_differentiate(tnlp, tsol, P, dx=torch.ones(2, 1, dtype=torch.float64), factorization=fact)
    assert float(rev[0].abs().max()) == 0.0
    np.testing.assert_allclose(rev[1].numpy(), [1.0, 0.0], atol=1e-12)


def _sipopt():
    return dtt.NLPProblem(
        lambda x, p: (x**2).sum(),
        lambda x, p: torch.stack([6 * x[0] + 3 * x[1] + 2 * x[2] - p[0], p[1] * x[0] + x[1] - x[2] - 1.0]),
        ("eq", "eq"), 3, lb=[0.0, 0.0, 0.0], device="cpu")


def test_sipopt_example():
    """The reference's sIpopt example at its analytic optimum: dx/dp = [[1/3, 1/2], [-1/3, -1], [0, 0]]."""
    sol = dtt.NLPSolution(*(torch.tensor(v, dtype=torch.float64) for v in
                            ([0.5, 0.5, 0.0], [0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 0.0])))
    jac = tdiff.solution_jacobian(_sipopt(), sol, torch.tensor([4.5, 1.0], dtype=torch.float64))
    assert not bool(jac.singular)
    np.testing.assert_allclose(jac.dx.numpy(), [[1 / 3, 1 / 2], [-1 / 3, -1.0], [0.0, 0.0]], atol=1e-6)


def test_reference_geq_and_leq_cases():
    """The reference's model_1 "geq impact" (dp = 0.2 -> dx = 0.2, dy = [0.4, 0]) and model_4 "leq impact
    max" (dx = 0.2, dy = [0, 0])."""
    geq = dtt.NLPProblem(lambda x, p: x[0] ** 2, lambda x, p: torch.stack([x[0] - p[0], x[0] - 2.0]),
                         ("geq", "geq"), 1, device="cpu")
    t = lambda *v: torch.tensor(v, dtype=torch.float64)
    fwd = tdiff.forward_differentiate(geq, dtt.NLPSolution(t(2.1), t(4.2, 0.0), t(0.0), t(0.0)), t(2.1), t(0.2))
    np.testing.assert_allclose(fwd.dx.numpy(), [0.2], atol=1e-6)
    np.testing.assert_allclose(fwd.dy.numpy(), [0.4, 0.0], atol=1e-6)
    leq = dtt.NLPProblem(lambda x, p: x[0], lambda x, p: torch.stack([x[0] - p[0], x[0] - 2.0]), ("leq", "leq"), 1,
                         sense="max", device="cpu")
    fwd = tdiff.forward_differentiate(leq, dtt.NLPSolution(t(1.5), t(-1.0, 0.0), t(0.0), t(0.0)), t(1.5), t(0.2))
    np.testing.assert_allclose(fwd.dx.numpy(), [0.2], atol=1e-6)
    np.testing.assert_allclose(fwd.dy.numpy(), [0.0, 0.0], atol=1e-6)
