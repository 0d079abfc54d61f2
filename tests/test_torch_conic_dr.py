"""Port parity of the DR splitting (``solvers/conic.py``) against ``diffopt_tpu.solvers.conic``, f64, on
the same numpy inputs: an equality-only program (run to its tolerance) and the entropy program with
exp blocks (capped at 300 iterations: the splitting needs tens of thousands there). The DR map is
nonexpansive, so the two runs stay as close as their first steps: 1e-9 relative on both (the exp
projection's Newton root is the one place they round differently, ``test_torch_ns_cones.py``). Also
the routes that reach DR (``solve_conic(solver="dr")``, ``auto`` on an equality-only program, the fused
route), its Anderson acceleration and its equilibration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu as dj
from diffopt_tpu.solvers import conic as jdr
import diffopt_tpu_torch as dtt
from diffopt_tpu_torch.solvers import conic as tdr
from diffopt_tpu_torch.solvers import conic_ipm as tipm
from diffopt_tpu_torch.utils.testing import make_entropy_batch

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

CAP = 300


def _eq_batch():
    """min c'x s.t. A x = b (zero cone), c = -A'y0 so the program is bounded (every feasible x is optimal,
    with the objective -y0'b); B = 3, n = 4, m = 2."""
    rng = np.random.default_rng(21)
    A = rng.normal(size=(3, 2, 4))
    b = rng.normal(size=(3, 2))
    c = -np.einsum("bij,bi->bj", A, rng.normal(size=(3, 2)))
    return A, b, c, [("zero", 2)]


def _exp_batch():
    cp = make_entropy_batch(2, k=2, seed=3, dtype=torch.float64, device="cpu")
    return (*(t.numpy() for t in cp.tensors()), list(cp.cones.blocks))


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name, make, kw in (("eq", _eq_batch, {}), ("exp", _exp_batch, dict(max_iters=CAP))):
        A, b, c, blocks = make()
        spec = dj.ConeSpec(blocks)
        sol, info = jax.jit(lambda A_, b_, c_: jdr.solve_batched(dj.ConeProgram(A=A_, b=b_, c=c_, cones=spec), **kw))(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
        out[name] = ((A, b, c, blocks), kw, [np.asarray(t) for t in (sol.x, sol.y, sol.s)], [np.asarray(t) for t in info])
    return out


def _cp(A, b, c, blocks):
    return dtt.ConeProgram(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (A, b, c)), dtt.ConeSpec(blocks))


@pytest.mark.parametrize("name", ["eq", "exp"])
def test_dr_matches_the_jax_package(ref, name):
    data, kw, jsol, jinfo = ref[name]
    sol, info = tdr.solve_batched(_cp(*data), **kw)
    for k, got, want in zip("xys", sol.tensors(), jsol):
        err = np.abs(got.numpy() - want).max() / (1.0 + np.abs(want).max())
        assert err <= 1e-9, (k, err)
    np.testing.assert_array_equal(info.iterations.numpy(), jinfo[0])
    np.testing.assert_array_equal(info.converged.numpy(), jinfo[4])
    for got, want in zip(info[1:4], jinfo[1:4]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    if name == "eq":
        assert bool(info.converged.all())


def test_the_routes_to_dr(ref):
    data, _, jsol, _ = ref["eq"]
    cp = _cp(*data)
    plain, _ = tdr.solve_batched(cp)
    # solve_conic: 'auto' takes DR for an equality-only program, as does the fused route
    for sol in (dtt.solve_conic(cp), dtt.solve_conic(cp, solver="dr"), tipm.solve_batched_fused(cp)[0],
                dtt.solve_conic_batched(cp, polish=0)):
        torch.testing.assert_close(sol.x.detach(), plain.x, rtol=0, atol=1e-12)
    # an equality-only solve differentiates through the HSDE adjoint
    g = cp.map(lambda t: t.clone().requires_grad_())
    (dtt.solve_conic(g, solver="dr").x ** 2).sum().backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in g.tensors())
    # one instance without a batch dimension
    one, oi = tdr.solve(cp.map(lambda t: t[0]))
    assert one.x.shape == (4,) and oi.iterations.shape == ()


def test_acceleration_and_equilibration_reach_the_same_solution(ref):
    data, _, _, _ = ref["eq"]
    cp = _cp(*data)
    base, binfo = tdr.solve_batched(cp)
    acc, ainfo = tdr.solve_batched(cp, accel=True)
    eq, einfo = tdr.solve_batched(cp, equilibrate=True)
    assert bool(ainfo.converged.all()) and bool(einfo.converged.all())
    assert bool((ainfo.iterations <= binfo.iterations).all())
    # the solution set is the affine set A x = b: each run lands on a point of it with the same objective
    for sol in (acc, eq):
        torch.testing.assert_close(torch.einsum("bij,bj->bi", cp.A, sol.x), cp.b, rtol=0, atol=1e-7)
        torch.testing.assert_close((cp.c * sol.x).sum(-1), (cp.c * base.x).sum(-1), rtol=0, atol=1e-7)
        torch.testing.assert_close(sol.y, base.y, rtol=0, atol=1e-7)
