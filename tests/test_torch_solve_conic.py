"""Port parity of the conic entry points, f64, on the same numpy inputs:
``solve_conic_batched`` gradients against ``jax.grad`` of
``diffopt_tpu.solve_conic_batched`` (the fused kernel in interpret mode and
the ``gram`` adjoint) on a small SOCP batch of the benchmark family;
``solve_conic`` (staged IPM) value, VJP and JVP against the JAX package on one
instance; ``ConicDiffContext``; ``ParametricProgram(kind="conic")``; and the
conic padding, through to a padded solve + backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import diffopt_tpu as dj
import diffopt_tpu_torch as dtt
from diffopt_tpu.utils import batching as jbatching
from diffopt_tpu_torch.utils import batching as tbatching
from diffopt_tpu_torch.utils.testing import make_socp_batch

torch.set_num_threads(1)

# gradients of two f64 solves that met tol = 1e-9, through the same adjoint: agreement to 1e-6 of the largest entry
GRAD_TOL = 1e-6


def _t(a, grad=False):
    t = torch.from_numpy(np.asarray(a, dtype=np.float64))
    return t.requires_grad_() if grad else t


def _w(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def _jloss(sol, w):
    return jnp.sum(sol.x**2) + jnp.sum(w[0] * sol.y) + jnp.sum(w[1] * sol.s)


def _tloss(sol, w):
    return (sol.x**2).sum() + (_t(w[0]) * sol.y).sum() + (_t(w[1]) * sol.s).sum()


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / (1.0 + np.abs(np.asarray(b)).max()))


def test_solve_conic_batched_gradients_match_jax_grad():
    cp = make_socp_batch(4, n=4, seed=3, dtype=torch.float64, device="cpu")
    A, b, c = (t.numpy() for t in cp.tensors())
    w = (_w(b.shape, 1), _w(b.shape, 2))
    spec = dj.ConeSpec(cp.cones.blocks)
    jgrad = jax.jit(jax.grad(
        lambda A_, b_, c_: _jloss(dj.solve_conic_batched(dj.ConeProgram(A=A_, b=b_, c=c_, cones=spec)), w), argnums=(0, 1, 2)
    ))(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    tcp = cp.map(lambda t: t.detach().clone().requires_grad_())
    sol, info = dtt.solve_conic_batched(tcp, with_info=True)
    assert bool(info.converged.all()) and info.iterations.dtype == torch.int32
    _tloss(sol, w).backward()
    for name, t, g in zip("Abc", tcp.tensors(), jgrad):
        assert _rel(t.grad, g) <= GRAD_TOL, name


@pytest.fixture(scope="module")
def one():
    """One SOC + nonneg instance: the JAX package's solve_conic value, VJP of
    the loss and JVP along a data direction."""
    rng = np.random.default_rng(7)
    cp = make_socp_batch(1, n=3, seed=5, dtype=torch.float64, device="cpu")
    A, b, c = (t[0].numpy() for t in cp.tensors())
    # add two nonneg rows (x_0 <= 2, x_1 <= 2) to the SOC block
    A = np.concatenate([A, np.eye(2, 3)], 0)
    b = np.concatenate([b, [2.0, 2.0]])
    blocks = list(cp.cones.blocks) + [("nonneg", 2)]
    w = (_w(b.shape, 3), _w(b.shape, 4))
    tan = (0.1 * rng.normal(size=A.shape), 0.1 * rng.normal(size=b.shape), 0.1 * rng.normal(size=c.shape))
    spec = dj.ConeSpec(blocks)
    mk = lambda A_, b_, c_: dj.ConeProgram(A=A_, b=b_, c=c_, cones=spec)

    def ref(A_, b_, c_):
        loss = lambda *d: (lambda sol: (_jloss(sol, w), sol))(dj.solve_conic(mk(*d)))
        (_, sol), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(A_, b_, c_)
        _, tangent = jax.jvp(lambda *d: dj.solve_conic(mk(*d), mode="jvp"), (A_, b_, c_), tuple(map(jnp.asarray, tan)))
        return sol, grads, tangent

    sol, jg, jt = jax.jit(ref)(*map(jnp.asarray, (A, b, c)))
    as_np = lambda s: {k: np.asarray(getattr(s, k)) for k in "xys"}
    return dict(A=A, b=b, c=c, blocks=blocks, w=w, tan=tan, sol=as_np(sol), grad=[np.asarray(g) for g in jg], jvp=as_np(jt))


def test_solve_conic_value_vjp_and_jvp_match_jax(one):
    cp = dtt.ConeProgram(_t(one["A"], True), _t(one["b"], True), _t(one["c"], True), dtt.ConeSpec(one["blocks"]))
    sol = dtt.solve_conic(cp)
    for k in "xys":
        assert _rel(getattr(sol, k).detach(), one["sol"][k]) <= 1e-8, k
    _tloss(sol, one["w"]).backward()
    for name, t, g in zip("Abc", cp.tensors(), one["grad"]):
        assert _rel(t.grad, g) <= GRAD_TOL, name
    # the forward rule (torch.autograd.forward_ad) against jax.jvp
    with fwAD.dual_level():
        dual = dtt.ConeProgram(*(fwAD.make_dual(_t(one[k]), _t(d)) for k, d in zip("Abc", one["tan"])), cp.cones)
        out = dtt.solve_conic(dual, mode="jvp")
        for k in "xys":
            assert _rel(fwAD.unpack_dual(getattr(out, k)).tangent, one["jvp"][k]) <= GRAD_TOL, k
    # solvers of later slices name it
    for solver in ("nsipm", "dr"):
        with pytest.raises(NotImplementedError, match="K7"):
            dtt.solve_conic(cp, solver=solver)


def test_conic_diff_context_matches_jax_context(one):
    cp = dtt.ConeProgram(_t(one["A"]), _t(one["b"]), _t(one["c"]), dtt.ConeSpec(one["blocks"]))
    ctx = dtt.ConicDiffContext(cp)
    assert bool(ctx.solve_info.converged) and ctx.sol.x.shape == (3,)
    S = dtt.convert.to_numpy(ctx.sol)
    jcp = dj.ConeProgram(*(jnp.asarray(one[k]) for k in "Abc"), cones=dj.ConeSpec(one["blocks"]))
    jctx = dj.ConicDiffContext(jcp, dj.ConeSolution(**{k: jnp.asarray(v) for k, v in S.items()}), polish=0)
    dA, db, dc = one["tan"]
    jf = jctx.forward(dj.ConeTangent(dA=jnp.asarray(dA), db=jnp.asarray(db), dc=jnp.asarray(dc)))
    seeds = [_w(S[k].shape, 10 + i) for i, k in enumerate("xys")]
    jr = jctx.reverse(*map(jnp.asarray, seeds))
    tf = ctx.forward(dtt.ConeTangent(_t(dA), _t(db), _t(dc)))
    tr = ctx.reverse(*map(_t, seeds))
    for a, b in zip(tf, jf):
        assert _rel(a, b) <= 1e-8
    for a, b in zip(tr.tensors(), (jr.dA, jr.db, jr.dc)):
        assert _rel(a, b) <= 1e-8
    # and the cached route gives what the uncached verbs give
    d = dtt.conic_diff.reverse_differentiate(ctx._cp, ctx._sol, *(_t(s)[None] for s in seeds), method="lstsq", refine_iters=2)
    assert _rel(tr.dA, d.dA[0]) <= 1e-8
    assert ctx.differentiate_time_sec > 0


def test_parametric_program_conic_matches_jax(one):
    """build(theta) puts theta into b and c; at theta = (1, 1) it is the instance
    above, so the layer's value and parameter gradients follow from the JAX
    package's solution and data gradients by the chain rule."""
    A, b, c = one["A"], one["b"], one["c"]
    spec = dtt.ConeSpec(one["blocks"])
    build = lambda th: dtt.ConeProgram(_t(A), th["b"] * _t(b), th["c"] * _t(c), spec)
    layer = dtt.ParametricProgram(build, kind="conic")
    theta = {"b": torch.tensor(1.0, dtype=torch.float64), "c": torch.tensor(1.0, dtype=torch.float64)}
    assert _rel(layer.solve(theta).x, one["sol"]["x"]) <= 1e-8
    w = one["w"]
    sol = one["sol"]
    dth = layer.reverse_differentiate(theta, dx=_t(2 * sol["x"]), dy=_t(w[0]), ds=_t(w[1]))
    gA, gb, gc = one["grad"]
    np.testing.assert_allclose(float(dth["b"]), float(gb @ b), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(dth["c"]), float(gc @ c), rtol=GRAD_TOL)
    dsol = layer.forward_differentiate(theta, {"b": torch.tensor(1.0, dtype=torch.float64), "c": torch.tensor(0.0, dtype=torch.float64)})
    assert dsol.x.shape == (3,) and bool(torch.isfinite(dsol.x).all())


def test_conic_padding_matches_jax_and_padded_gradients_match_per_instance_solves():
    rng = np.random.default_rng(9)
    specs = [[("zero", 1), ("nonneg", 2), ("soc", 3)], [("zero", 1), ("nonneg", 3), ("soc", 2), ("psd", 3)],
             [("zero", 1), ("nonneg", 1), ("soc", 3)]]
    n = 3
    datas = []
    for blocks in specs:
        from test_torch_conic_ipm import _interior

        m = sum(d for _, d in blocks)
        A, x0 = rng.normal(size=(m, n)), rng.normal(size=n)
        s0 = np.concatenate([np.zeros(d) if k == "zero" else _interior(rng, k, d)[0] for k, d in blocks])
        y0 = np.concatenate([rng.normal(size=d) if k == "zero" else _interior(rng, k, d)[0] for k, d in blocks])
        datas.append((A, A @ x0 + s0, -A.T @ y0, blocks))
    jb, _ = jbatching.pad_and_stack_cones(
        [dj.ConeProgram(A=jnp.asarray(A), b=jnp.asarray(b), c=jnp.asarray(c), cones=dj.ConeSpec(bl)) for A, b, c, bl in datas])
    tcps = [dtt.ConeProgram(_t(A, True), _t(b, True), _t(c, True), dtt.ConeSpec(bl)) for A, b, c, bl in datas]
    tb, tspecs = tbatching.pad_and_stack_cones(tcps)
    assert tb.cones.blocks == jb.cones.blocks
    for k in "Abc":
        np.testing.assert_array_equal(getattr(tb, k).detach().numpy(), np.asarray(getattr(jb, k)))
    # padded solve + backward = per-instance solves + backward, on the original rows (solved
    # tightly: the two programs' scale-relative stopping tests differ)
    tight = dict(tol=1e-12)
    sol = dtt.solve_conic(tb, **tight)
    parts = tbatching.unpad_cone_solution(sol, tspecs, tb.cones)
    sum((p.x**2).sum() + p.y.sum() for p in parts).backward()
    for tcp, part in zip(tcps, parts):
        ref = dtt.solve_conic(tcp.map(lambda t: t.detach()), **tight)
        assert _rel(part.x.detach(), ref.x.detach()) <= 1e-7
        assert part.y.shape == (tcp.num_rows,)
    ref_cps = [tcp.map(lambda t: t.detach().clone().requires_grad_()) for tcp in tcps]
    for rcp in ref_cps:
        s = dtt.solve_conic(rcp, **tight)
        ((s.x**2).sum() + s.y.sum()).backward()
    for tcp, rcp in zip(tcps, ref_cps):
        for a, b in zip(tcp.tensors(), rcp.tensors()):
            assert _rel(a.grad, b.grad) <= 1e-6
    # the unpad of a padded gradient struct keeps the original shapes
    g = dtt.ConeTangent(*(torch.ones_like(t) for t in tb.tensors()))
    back = tbatching.unpad_cone_tangent(g, tspecs, tb.cones)
    assert [t.dA.shape for t in back] == [tuple(tcp.A.shape) for tcp in tcps]
