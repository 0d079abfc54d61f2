"""Port parity of conic implicit differentiation: ``residual_matrix``, the
forward and reverse verbs through every route (``lstsq``, ``lu``, ``qr``,
``gram`` on the Cholesky pair, matrix-free ``lsqr``), ``refine_solution`` and
``residual_map`` against ``diffopt_tpu.conic_diff`` (``vmap``-ed over the
batch, its Pallas Cholesky in interpret mode) on the same numpy inputs and
the same solution, f64; and the adjoint identity <JVP(d), seed> = <d,
VJP(seed)> of the port's verbs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu as dj
from diffopt_tpu import conic_diff as jcd
from diffopt_tpu_torch import conic_diff as tcd
from diffopt_tpu_torch.cones import ConeSpec
from diffopt_tpu_torch.ir import ConeProgram, ConeSolution, ConeTangent
from diffopt_tpu_torch.solvers import conic_ipm as tipm

torch.set_num_threads(1)

B, N_VARS = 3, 3
# the cones' own parity (PSD included) is test_torch_cones.py's; here a zero + nonneg + soc layout
BLOCKS = [("zero", 1), ("nonneg", 2), ("soc", 3)]
METHODS = ["lstsq", "gram", "lsqr"]
# lsqr stops at its own relative tolerance (1e-10 on ||M' r||), the direct routes agree to rounding
TOL = {"lstsq": 1e-8, "gram": 1e-8, "lsqr": 1e-6}


def _batch(rng):
    m = sum(d for _, d in BLOCKS)
    A, x0 = rng.normal(size=(B, m, N_VARS)), rng.normal(size=(B, N_VARS))
    s0 = np.zeros((B, m))
    s0[:, 1:3] = rng.uniform(0.5, 1.5, size=(B, 2))
    s0[:, 3:6] = rng.normal(size=(B, 3))
    s0[:, 3] = np.linalg.norm(s0[:, 4:6], axis=1) + 1.0
    y0 = np.zeros((B, m))
    y0[:, 0] = rng.normal(size=B)
    y0[:, 1:3] = rng.uniform(0.5, 1.5, size=(B, 2))
    y0[:, 3:6] = rng.normal(size=(B, 3))
    y0[:, 3] = np.linalg.norm(y0[:, 4:6], axis=1) + 1.0
    return A, np.einsum("bij,bj->bi", A, x0) + s0, -np.einsum("bij,bi->bj", A, y0)


@pytest.fixture(scope="module")
def case():
    """The batch, its solution (the port's staged solver, f64), a data
    tangent and solution seeds, all numpy; and the JAX package's results."""
    rng = np.random.default_rng(22)
    A, b, c = _batch(np.random.default_rng(21))
    cp = ConeProgram(*(torch.from_numpy(a) for a in (A, b, c)), ConeSpec(BLOCKS))
    sol, info = tipm.solve_batched(cp)
    assert bool(info.converged.all())
    S = {k: getattr(sol, k).numpy() for k in "xys"}
    tan = {"dA": rng.normal(size=A.shape), "db": rng.normal(size=b.shape), "dc": rng.normal(size=c.shape)}
    seeds = {k: rng.normal(size=S[k].shape) for k in "xys"}
    # a perturbed point for the Newton polish
    pert = {k: v + 1e-4 * rng.normal(size=v.shape) for k, v in S.items()}
    spec = dj.ConeSpec(BLOCKS)
    jcp = lambda A_, b_, c_: dj.ConeProgram(A=A_, b=b_, c=c_, cones=spec)
    jsol = lambda x, y, s: dj.ConeSolution(x=x, y=y, s=s)

    def ref(A_, b_, c_, x, y, s, dA, db, dc, sx, sy, ss, px, py, ps):
        p, so = jcp(A_, b_, c_), jsol(x, y, s)
        out = {"M": jcd.residual_matrix(p, so), "N": jcd.residual_map(p, jsol(px, py, ps))}
        for m in METHODS:
            f = jcd.forward_differentiate(p, so, dj.ConeTangent(dA=dA, db=db, dc=dc), method=m)
            r = jcd.reverse_differentiate(p, so, sx, sy, ss, method=m)
            out[m] = (f.dx, f.dy, f.ds, r.dA, r.db, r.dc)
        pol = jcd.refine_solution(p, jsol(px, py, ps), steps=1)
        out["polish"] = (pol.x, pol.y, pol.s)
        return out

    args = [A, b, c, S["x"], S["y"], S["s"], tan["dA"], tan["db"], tan["dc"], seeds["x"], seeds["y"], seeds["s"],
            pert["x"], pert["y"], pert["s"]]
    jres = jax.jit(jax.vmap(ref))(*map(jnp.asarray, args))
    jres = jax.tree.map(np.asarray, jres)
    return cp, sol, tan, seeds, pert, jres


def test_residual_matrix_and_map_match_jax(case):
    cp, sol, _, _, pert, jres = case
    np.testing.assert_allclose(tcd.residual_matrix(cp, sol).numpy(), jres["M"], rtol=0, atol=1e-12)
    psol = ConeSolution(*(torch.from_numpy(pert[k]) for k in "xys"))
    np.testing.assert_allclose(tcd.residual_map(cp, psol).numpy(), jres["N"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("method", METHODS)
def test_forward_and_reverse_match_jax(case, method):
    cp, sol, tan, seeds, _, jres = case
    fwd = tcd.forward_differentiate(cp, sol, ConeTangent(*(torch.from_numpy(tan[k]) for k in ("dA", "db", "dc"))), method=method)
    rev = tcd.reverse_differentiate(cp, sol, *(torch.from_numpy(seeds[k]) for k in "xys"), method=method)
    got = (fwd.dx, fwd.dy, fwd.ds, rev.dA, rev.db, rev.dc)
    for name, a, b in zip(("dx", "dy", "ds", "dA", "db", "dc"), got, jres[method]):
        scale = 1.0 + np.abs(b).max()
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=TOL[method] * scale, err_msg=f"{method} {name}")


def test_refine_solution_matches_jax_and_reduces_the_residual(case):
    cp, _, _, _, pert, jres = case
    psol = ConeSolution(*(torch.from_numpy(pert[k]) for k in "xys"))
    pol = tcd.refine_solution(cp, psol, steps=1)
    for k, ref in zip("xys", jres["polish"]):
        np.testing.assert_allclose(getattr(pol, k).numpy(), ref, rtol=0, atol=1e-9, err_msg=k)
    before = torch.linalg.vector_norm(tcd.residual_map(cp, psol), dim=-1)
    after = torch.linalg.vector_norm(tcd.residual_map(cp, pol), dim=-1)
    assert bool((after < 1e-3 * before).all())


@pytest.mark.parametrize("method", ["lu", "qr"])
def test_square_routes_go_through_linalg(case, method):
    """M is singular at a solution (the HSDE map is positively homogeneous:
    M z* = 0), so 'lu' and 'qr' return a solution whose null-space part is
    rounding-dependent, in the JAX package as here; what the route must do is
    hand M and the right-hand side to ``ops/linalg.py`` and read the result."""
    from diffopt_tpu_torch.ops import linalg

    cp, sol, tan, seeds, _, _ = case
    d = ConeTangent(*(torch.from_numpy(tan[k]) for k in ("dA", "db", "dc")))
    fwd = tcd.forward_differentiate(cp, sol, d, method=method)
    v = sol.y - sol.s
    rhs = tcd._forward_rhs(cp, sol, d, tcd._cones.pi(cp.cones, v))
    ref = tcd._forward_from(cp, sol, v, linalg.solve(tcd.residual_matrix(cp, sol), rhs, method))
    for a, b in zip(fwd, ref):
        assert torch.equal(a, b)
    rev = tcd.reverse_differentiate(cp, sol, *(torch.from_numpy(seeds[k]) for k in "xys"), method=method)
    assert all(t.shape == r.shape for t, r in zip(rev.tensors(), cp.tensors()))


@pytest.mark.parametrize("method", ["lstsq", "gram"])
def test_adjoint_identity(case, method):
    cp, sol, tan, seeds, _, _ = case
    d = ConeTangent(*(torch.from_numpy(tan[k]) for k in ("dA", "db", "dc")))
    fwd = tcd.forward_differentiate(cp, sol, d, method=method)
    rev = tcd.reverse_differentiate(cp, sol, *(torch.from_numpy(seeds[k]) for k in "xys"), method=method)
    lhs = sum((getattr(fwd, "d" + k) * torch.from_numpy(seeds[k])).sum(-1) for k in "xys")
    rhs = (rev.dA * d.dA).sum((-1, -2)) + (rev.db * d.db).sum(-1) + (rev.dc * d.dc).sum(-1)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-8, atol=1e-10)
    # 'auto' takes the dense least-squares route below the LSQR threshold
    assert tcd.resolve_method(cp, "auto") == "lstsq" and tcd.resolve_method(cp, None) == "lstsq"


def test_lsqr_dense_matches_jax_per_instance():
    """Batch-first LSQR: every instance runs to its own tolerance and keeps its
    state once there, as the JAX package's vmap of while_loop does; a singular
    instance gets the minimum-norm least-squares solution."""
    from diffopt_tpu.ops.lsqr import lsqr_dense as jlsqr_dense
    from diffopt_tpu_torch.ops.lsqr import lsqr_dense

    rng = np.random.default_rng(31)
    M = rng.normal(size=(3, 6, 4))
    M[1, :, 3] = M[1, :, 2]  # rank-deficient instance
    b = rng.normal(size=(3, 6))
    ref = jax.jit(jax.vmap(lambda m, v: jlsqr_dense(m, v, max_iters=50)))(jnp.asarray(M), jnp.asarray(b))
    res = lsqr_dense(torch.from_numpy(M), torch.from_numpy(b), max_iters=50)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(ref.converged))
    np.testing.assert_allclose(res.x.numpy(), np.stack([np.linalg.lstsq(m, v, rcond=None)[0] for m, v in zip(M, b)]),
                               rtol=0, atol=1e-8)
