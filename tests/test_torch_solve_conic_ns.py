"""Port parity of the conic entry points on the nonsymmetric cones, f64, on the same numpy inputs.

One JAX reference feeds the file: ``jax.grad`` of ``sum(x**2)`` through
``diffopt_tpu.solve_conic_batched`` on the entropy benchmark family (k = 2 exp blocks, B = 4), which
runs the fused nonsymmetric kernel in interpret mode and the ``gram`` adjoint, plus the JAX package's
``conic_diff`` reverse and forward rules at that solution. Against it:

* ``torch.autograd.grad`` through ``solve_conic_batched`` (K7's plain version, the gram VJP), to 1e-6;
  the solutions to 1e-6 relative (the two IPM runs stop within the f64 tolerance, 1e-8, of each other,
  a line-search step apart at most: ``test_torch_ns_pdip.py``) and iteration counts at most one apart;
* ``solve_conic(solver="nsipm")`` (the staged solver) VJP and JVP, to 1e-6;
* ``ConicDiffContext`` on the exp program, against the JAX rules and the port's uncached verbs;
* the padding of a heterogeneous exp/pow batch against per-instance solves, and the rejection of
  mismatched pow exponents, as the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import diffopt_tpu as dj
import diffopt_tpu_torch as dtt
from diffopt_tpu import conic_diff as jdiff
from diffopt_tpu_torch.utils import batching as tbatching
from diffopt_tpu_torch.utils.testing import make_entropy_batch

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

GRAD_TOL = 1e-6
SOL_TOL = 1e-6


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (1.0 + np.abs(b).max()))


@pytest.fixture(scope="module")
def ref():
    cp = make_entropy_batch(4, k=2, seed=0, dtype=torch.float64, device="cpu")
    A, b, c = (t.numpy() for t in cp.tensors())
    spec = dj.ConeSpec(cp.cones.blocks)
    rng = np.random.default_rng(5)
    seeds = [rng.normal(size=s) for s in (c.shape, b.shape, b.shape)]
    tan = [0.1 * rng.normal(size=t.shape) for t in (A, b, c)]

    def loss(A_, b_, c_):
        sol, info = dj.solve_conic_batched(dj.ConeProgram(A=A_, b=b_, c=c_, cones=spec), with_info=True)
        return jnp.sum(sol.x**2), (sol, info)

    (_, (sol, info)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))

    @jax.jit
    def rules(A_, b_, c_, x, y, s):
        def one(A1, b1, c1, x1, y1, s1, dx, dy, ds, tA, tb, tc):
            cp1, sol1 = dj.ConeProgram(A=A1, b=b1, c=c1, cones=spec), dj.ConeSolution(x=x1, y=y1, s=s1)
            r = jdiff.reverse_differentiate(cp1, sol1, dx, dy, ds, method="lstsq")
            f = jdiff.forward_differentiate(cp1, sol1, dj.ConeTangent(dA=tA, db=tb, dc=tc), method="lstsq")
            return (r.dA, r.db, r.dc), (f.dx, f.dy, f.ds)
        return jax.vmap(one)(A_, b_, c_, x, y, s, *(jnp.asarray(t) for t in seeds + tan))

    rev, fwd = rules(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), sol.x, sol.y, sol.s)
    np_ = lambda t: [np.asarray(u) for u in t]
    return dict(cp=cp, sol=np_((sol.x, sol.y, sol.s)), it=np.asarray(info.iterations), conv=np.asarray(info.converged),
                grads=np_(grads), seeds=seeds, tan=tan, rev=np_(rev), fwd=np_(fwd))


def test_solve_conic_batched_on_exp_matches_jax_grad(ref):
    cp = ref["cp"].map(lambda t: t.detach().clone().requires_grad_())
    sol, info = dtt.solve_conic_batched(cp, with_info=True)
    assert bool(info.converged.all()) and bool(ref["conv"].all())
    for name, got, want in zip("xys", sol.tensors(), ref["sol"]):
        assert _rel(got.detach(), want) <= SOL_TOL, name
    assert np.abs(info.iterations.numpy() - ref["it"]).max() <= 1
    (g,) = torch.autograd.grad((sol.x**2).sum(), [cp.b])
    (sol2, _) = dtt.solve_conic_batched(cp, with_info=True)
    gA, gb, gc = torch.autograd.grad((sol2.x**2).sum(), cp.tensors())
    for name, got, want in zip("Abc", (gA, gb, gc), ref["grads"]):
        assert _rel(got, want) <= GRAD_TOL, name
    torch.testing.assert_close(g, gb, rtol=0, atol=0)


def test_solve_conic_nsipm_vjp_and_jvp(ref):
    cp = ref["cp"].map(lambda t: t.detach().clone().requires_grad_())
    sol, info = dtt.solve_conic(cp, solver="nsipm", with_info=True)
    assert bool(info.converged.all())
    dx, dy, ds = (torch.from_numpy(s) for s in ref["seeds"])
    loss = (sol.x * dx).sum() + (sol.y * dy).sum() + (sol.s * ds).sum()
    for name, got, want in zip("Abc", torch.autograd.grad(loss, cp.tensors()), ref["rev"]):
        assert _rel(got, want) <= GRAD_TOL, name
    # 'auto' takes the nonsymmetric IPM for exp blocks: the same solution
    auto = dtt.solve_conic(cp.map(torch.Tensor.detach))
    torch.testing.assert_close(auto.x, sol.x.detach(), rtol=0, atol=0)
    with fwAD.dual_level():
        base = ref["cp"]
        dual = dtt.ConeProgram(*(fwAD.make_dual(t, torch.from_numpy(d)) for t, d in zip(base.tensors(), ref["tan"])),
                               base.cones)
        out = dtt.solve_conic(dual, solver="nsipm", mode="jvp")
        for name, want in zip("xys", ref["fwd"]):
            assert _rel(fwAD.unpack_dual(getattr(out, name)).tangent, want) <= GRAD_TOL, name


def test_conic_diff_context_on_an_exp_program(ref):
    cp = ref["cp"]
    ctx = dtt.ConicDiffContext(cp)
    assert bool(ctx.solve_info.converged.all())
    seeds = [torch.from_numpy(s) for s in ref["seeds"]]
    r = ctx.reverse(*seeds)
    for name, got, want in zip("Abc", r.tensors(), ref["rev"]):
        assert _rel(got, want) <= GRAD_TOL, name
    f = ctx.forward(dtt.ConeTangent(*(torch.from_numpy(t) for t in ref["tan"])))
    for name, got, want in zip("xys", f, ref["fwd"]):
        assert _rel(got, want) <= GRAD_TOL, name
    u = dtt.conic_diff.reverse_differentiate(cp, ctx.sol, *seeds, method="lstsq", refine_iters=2)
    for got, want in zip(r.tensors(), u.tensors()):
        assert _rel(got, want) <= 1e-8
    # an explicit solver name reaches the same solver
    ctx2 = dtt.ConicDiffContext(cp, solver="nsipm")
    torch.testing.assert_close(ctx2.sol.x, ctx.sol.x, rtol=0, atol=0)


def test_heterogeneous_exp_pow_padding():
    """An entropy instance and one with an extra pow block, padded to one spec (the first gets the pow
    block appended): the padded rows are strictly interior with zero dual, so each instance's solution is
    its own."""
    big = make_entropy_batch(1, k=3, seed=2, dtype=torch.float64, device="cpu").map(lambda t: t[0])
    with_pow = dtt.ConeProgram(
        torch.cat([big.A, torch.zeros(3, 6, dtype=torch.float64)]),
        torch.cat([big.b, torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64)]), big.c,
        dtt.ConeSpec(list(big.cones.blocks) + [("pow", 3, 0.3)]))
    batch, specs = tbatching.pad_and_stack_cones([big, with_pow])
    assert batch.cones == dtt.ConeSpec(list(big.cones.blocks) + [("pow", 3, 0.3)])
    sol, info = dtt.solve_conic_batched(batch, with_info=True)
    assert bool(info.converged.all())
    parts = tbatching.unpad_cone_solution(sol, specs, batch.cones)
    for cp_i, part in zip((big, with_pow), parts):
        own, _ = dtt.solve_conic_batched(cp_i.map(lambda t: t[None]), with_info=True)
        assert _rel(part.x, own.x[0]) <= SOL_TOL and _rel(part.y, own.y[0]) <= SOL_TOL
    # the padded rows of the first instance: zero dual, the interior padding point as slack
    assert float(sol.y[0, big.num_rows:].abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="parameters"):
        tbatching.cone_pad_spec([dtt.ConeSpec([("pow", 3, 0.3)]), dtt.ConeSpec([("pow", 3, 0.4)])])
    with pytest.raises(ValueError, match="kinds"):
        tbatching.cone_pad_spec([dtt.ConeSpec([("exp", 3)]), dtt.ConeSpec([("dual_exp", 3)])])
