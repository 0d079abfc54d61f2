"""Port parity of the upper QP layers: ``QPDiffContext``, ``ParametricProgram``
and the QP padding utilities against their JAX counterparts, f64, and the
slice as a whole (pad -> ``solve_qp`` -> backward) end to end. The JAX side
runs unbatched per instance, so no Pallas kernel is compiled here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu as dj
import diffopt_tpu_torch as dtt
from diffopt_tpu.utils import batching as jbatching
from diffopt_tpu_torch.ops import kkt as tkkt
from diffopt_tpu_torch.utils import batching as tbatching

torch.set_num_threads(1)

NAMES = ("Q", "q", "A", "b", "G", "h")
TNAMES = tuple("d" + k for k in NAMES)
DIMS = [(3, 2, 1), (5, 3, 0), (4, 0, 2)]


def _instance(n, m, p, seed, batch=()):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=batch + (n, n))
    return dict(
        Q=L @ np.swapaxes(L, -1, -2) + n * np.eye(n), q=rng.normal(size=batch + (n,)),
        A=rng.normal(size=batch + (p, n)), b=rng.normal(size=batch + (p,)),
        G=rng.normal(size=batch + (m, n)), h=rng.normal(size=batch + (m,)) + 1.0,
    )


def _jq(data):
    return dj.QuadProgram(**{k: jnp.asarray(v) for k, v in data.items()})


def _tq(data, grad=False):
    qp = dtt.convert.quadprogram_from_numpy(data, dtype=torch.float64, device="cpu")
    return qp.map(lambda t: t.requires_grad_()) if grad else qp


_jax_padded = []


def _padded_by_jax():
    """Three differently sized programs (numpy) and the JAX package's padded
    batch of them, made once for the tests below."""
    if not _jax_padded:
        datas = [_instance(*d, seed=40 + i) for i, d in enumerate(DIMS)]
        _jax_padded.append((datas, *jbatching.pad_and_stack([_jq(d) for d in datas])))
    return _jax_padded[0]


def test_qp_diff_context_cached_forward_reverse_match_jax():
    data = _instance(4, 3, 2, seed=3, batch=(3,))
    rng = np.random.default_rng(4)
    ctx = dtt.QPDiffContext(_tq(data))
    assert bool(ctx.solve_info.converged.all()) and np.isnan(ctx.differentiate_time_sec)
    # the JAX context gets the same solution (its own batched solve would compile the Pallas kernels)
    sol_np = dtt.convert.to_numpy(ctx.sol)
    jctx = dj.QPDiffContext(_jq(data), dj.QPSolution(**{k: jnp.asarray(v) for k, v in sol_np.items()}))
    tan = {"d" + k: 0.1 * rng.normal(size=v.shape) for k, v in data.items()}
    seeds = [rng.normal(size=(3, k)) for k in (4, 3, 2)]
    jd = jctx.forward(dj.QPTangent(**{k: jnp.asarray(v) for k, v in tan.items()}))
    jg = jctx.reverse(*map(jnp.asarray, seeds))
    ttan = dtt.convert.qptangent_from_numpy(tan, dtype=torch.float64, device="cpu")
    td = ctx.forward(ttan)
    assert ctx.differentiate_time_sec > 0
    tg = ctx.reverse(*(torch.from_numpy(s) for s in seeds))
    for name in ("dz", "dlam", "dnu"):
        # one LU of the same KKT matrix on both sides
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)), rtol=0, atol=1e-9, err_msg=name)
    for name in TNAMES:
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), rtol=0, atol=1e-9, err_msg=name)
    # and the cached factor gives what the uncached verbs give
    d2 = tkkt.qp_forward(_tq(data), ctx.sol, ttan)
    g2, _ = tkkt.qp_reverse(_tq(data), ctx.sol, *(torch.from_numpy(s) for s in seeds))
    np.testing.assert_allclose(td.dz.numpy(), d2.dz.numpy(), rtol=0, atol=1e-11)
    np.testing.assert_allclose(tg.dG.numpy(), g2.dG.numpy(), rtol=0, atol=1e-11)
    # reverse with a primal seed only
    assert ctx.reverse(torch.from_numpy(seeds[0])).dh.shape == (3, 3)
    # the hand-over of tangents and infos through numpy keeps names and dtypes
    back = dtt.convert.kktsplit_from_numpy(dtt.convert.to_numpy(td), dtype=torch.float64, device="cpu")
    assert torch.equal(back.dlam, td.dlam)
    info = dtt.convert.qpsolveinfo_from_numpy(dtt.convert.to_numpy(ctx.solve_info), device="cpu")
    assert info.iterations.dtype == torch.int32 and info.converged.dtype == torch.bool


def test_qp_diff_context_takes_one_unbatched_instance_as_jax_does():
    data = _instance(4, 3, 2, seed=5)
    rng = np.random.default_rng(6)
    ctx = dtt.QPDiffContext(_tq(data))
    assert ctx.sol.z.shape == (4,) and ctx.solve_info.converged.shape == ()
    jctx = dj.QPDiffContext(_jq(data))  # the JAX class solves the one instance itself
    np.testing.assert_allclose(ctx.sol.z.numpy(), np.asarray(jctx.sol.z), rtol=0, atol=1e-8)
    sol_np = dtt.convert.to_numpy(ctx.sol)
    jctx = dj.QPDiffContext(_jq(data), dj.QPSolution(**{k: jnp.asarray(v) for k, v in sol_np.items()}))
    tan = {"d" + k: 0.1 * rng.normal(size=v.shape) for k, v in data.items()}
    seeds = [rng.normal(size=k) for k in (4, 3, 2)]
    jd = jctx.forward(dj.QPTangent(**{k: jnp.asarray(v) for k, v in tan.items()}))
    jg = jctx.reverse(*map(jnp.asarray, seeds))
    td = ctx.forward(dtt.convert.qptangent_from_numpy(tan, dtype=torch.float64, device="cpu"))
    tg = ctx.reverse(*(torch.from_numpy(x) for x in seeds))
    for name in ("dz", "dlam", "dnu"):
        assert getattr(td, name).shape == np.asarray(getattr(jd, name)).shape
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)), rtol=0, atol=1e-9, err_msg=name)
    for name in TNAMES:
        assert getattr(tg, name).shape == np.asarray(getattr(jg, name)).shape
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), rtol=0, atol=1e-9, err_msg=name)


def test_qp_diff_context_refuses_unconverged():
    data = _instance(4, 3, 0, seed=5, batch=(2,))
    data["G"][1, :2] = 0.0  # z_0 <= -1 and -z_0 <= -1 contradict each other
    data["G"][1, 0, 0], data["G"][1, 1, 0] = 1.0, -1.0
    data["h"][1, :2] = -1.0
    with pytest.raises(dtt.NotSolvedError, match="did not converge"):
        dtt.QPDiffContext(_tq(data))
    ctx = dtt.QPDiffContext(_tq(data), check=False)
    assert ctx.solve_info.converged.tolist() == [True, False]
    assert issubclass(dtt.NotSolvedError, RuntimeError)
    assert dtt.QPDiffContext(_tq(data), ctx.sol).solve_info is None


def _readme_layers(method):
    """min 2x s.t. pc*x >= 3p with theta = (p, pc): x*(p, pc) = 3p/pc."""
    jbuild = lambda th: dj.QuadProgram.make(q=jnp.array([2.0]), G=(-th[1]).reshape(1, 1), h=(-3.0 * th[0]).reshape(1))
    tbuild = lambda th: dtt.QuadProgram.make(
        q=torch.tensor([2.0], dtype=torch.float64), G=(-th[1]).reshape(1, 1), h=(-3.0 * th[0]).reshape(1)
    )
    kw = {} if method is None else {"method": method}
    return dj.ParametricProgram(jbuild, kind="qp", **kw), dtt.ParametricProgram(tbuild, kind="qp", **kw)


@pytest.mark.parametrize("method", ["lstsq", None], ids=["lstsq", "auto"])
def test_parametric_program_readme_numbers_and_jax_parity(method):
    jlayer, tlayer = _readme_layers(method)
    theta = np.array([4.0, 2.0])
    tth = torch.tensor(theta)
    sol = tlayer.solve(tth)
    np.testing.assert_allclose(sol.z.numpy(), [6.0], rtol=0, atol=1e-7)  # x* = 3p/pc
    dsol = tlayer.forward_differentiate(tth, torch.tensor([3.0, 0.0], dtype=torch.float64))
    np.testing.assert_allclose(dsol.z.numpy(), [4.5], rtol=0, atol=1e-6)  # dx/dp . dp = 3/pc * 3
    dth = tlayer.reverse_differentiate(tth, dz=torch.tensor([1.0], dtype=torch.float64))
    np.testing.assert_allclose(dth.numpy(), [1.5, -3.0], rtol=0, atol=1e-6)  # [3/pc, -3p/pc^2]
    jd = jax.jit(jlayer.forward_differentiate)(jnp.asarray(theta), jnp.array([3.0, 0.0]))
    jth = jax.jit(lambda th, dz: jlayer.reverse_differentiate(th, dz=dz))(jnp.asarray(theta), jnp.array([1.0]))
    for name in ("z", "lam", "nu"):
        np.testing.assert_allclose(getattr(dsol, name).numpy(), np.asarray(getattr(jd, name)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dth.numpy(), np.asarray(jth), rtol=0, atol=1e-6)


def test_parametric_program_quadratic_and_bilinear_parameters_dict_theta():
    # x >= p^2 + 3p (quadratic in the parameter) with coefficient c on x (bilinear c * x): x* = (p^2 + 3p) / c
    def build(th):
        one = torch.ones(1, dtype=torch.float64)
        return dtt.QuadProgram.make(
            Q=2.0 * one.reshape(1, 1), q=0.0 * one, G=(-th["c"]).reshape(1, 1), h=(-(th["p"] ** 2) - 3 * th["p"]).reshape(1)
        )

    layer = dtt.ParametricProgram(build, kind="qp")
    theta = {"p": torch.tensor(2.0, dtype=torch.float64), "c": torch.tensor(2.0, dtype=torch.float64)}
    np.testing.assert_allclose(layer.solve(theta).z.numpy(), [5.0], rtol=0, atol=1e-6)
    one, zero = torch.tensor(1.0, dtype=torch.float64), torch.tensor(0.0, dtype=torch.float64)
    dsol = layer.forward_differentiate(theta, {"p": one, "c": zero})
    np.testing.assert_allclose(dsol.z.numpy(), [(2 * 2.0 + 3.0) / 2.0], rtol=0, atol=1e-5)
    dth = layer.reverse_differentiate(theta, dz=torch.tensor([1.0], dtype=torch.float64))
    assert set(dth) == {"p", "c"}
    np.testing.assert_allclose([float(dth["p"]), float(dth["c"])], [3.5, -10.0 / 4.0], rtol=0, atol=1e-5)
    # no seed, no gradient; the kind of a later slice says what it waits for
    assert float(layer.reverse_differentiate(theta)["p"]) == 0.0
    with pytest.raises(NotImplementedError, match="waits for"):
        dtt.ParametricProgram(build, kind="nlp")
    with pytest.raises(ValueError):
        dtt.ParametricProgram(build, kind="sdp")


def test_pad_qp_and_buckets_match_jax():
    datas, jb, jdims = _padded_by_jax()
    tb, tdims = tbatching.pad_and_stack([_tq(d) for d in datas])
    assert tdims == jdims == DIMS
    for name in NAMES:
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name))), name
    # every padded equality row binds its own padding variable
    assert tb.A.shape == (3, 2, 7) and tb.A[1, 0, 5] == 1.0 and tb.A[1, 1, 6] == 1.0 and tb.A[0, 1, 3] == 1.0
    with pytest.raises(ValueError, match="padding"):
        tbatching.pad_qp(_tq(datas[1]), 5, 3, 2)
    assert tbatching.pad_qp(_tq(datas[0]), 3, 2, 1) is not None
    many = [_instance(n, m, p, seed=0) for n, m, p in [(2, 1, 0), (3, 1, 0), (4, 2, 1), (5, 2, 1), (6, 3, 2), (7, 3, 2)]]
    for k in (4, 8):
        assert tbatching.bucket_by_shape([_tq(d) for d in many], max_buckets=k) == jbatching.bucket_by_shape(
            [_jq(d) for d in many], max_buckets=k
        )


def test_padded_batch_gradients_match_per_instance_solves():
    datas = [_instance(*d, seed=20 + i) for i, d in enumerate(DIMS)]
    qps = [_tq(d, grad=True) for d in datas]
    batched, dims = tbatching.pad_and_stack(qps)
    sol = dtt.solve_qp(batched)
    # padding variables solve to 0, padded inequality rows are inactive
    assert float(sol.z[0, 3:].detach().abs().max()) < 1e-9 and float(sol.lam[2].detach().abs().max()) < 1e-9
    loss = sum((s.z**2).sum() + s.lam.sum() for s in tbatching.unpad_solution(sol, dims))
    seeds = torch.autograd.grad(loss, (sol.z, sol.lam), retain_graph=True)
    loss.backward()
    # (a) gradients reach the original tensors through the padding; (b) slicing the padded batch's
    # cotangents gives the same thing
    cot = tbatching.unpad_tangent(dtt.reverse_differentiate(batched.map(torch.Tensor.detach), sol.map(torch.Tensor.detach), *seeds), dims)
    for qp, data, c in zip(qps, datas, cot):
        alone = _tq(data, grad=True)
        s = dtt.solve_qp(alone)
        ((s.z**2).sum() + s.lam.sum()).backward()
        for name, tname in zip(NAMES, TNAMES):
            want = getattr(alone, name).grad
            # the padded program's solution map equals the unpadded one on the original coordinates
            np.testing.assert_allclose(getattr(qp, name).grad.numpy(), want.numpy(), rtol=0, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(getattr(c, tname).numpy(), want.numpy(), rtol=0, atol=1e-7, err_msg=tname)
    as_qp = tbatching.unpad_tangent(batched.map(torch.Tensor.detach), dims)
    assert isinstance(as_qp[1], dtt.QuadProgram) and torch.equal(as_qp[1].G, qps[1].G.detach())


def test_slice_end_to_end_pad_solve_backward_matches_jax():
    """Three differently sized programs: pad, solve with ``solve_qp``,
    backpropagate a loss on the unpadded solutions, unpad the gradients — in
    both packages on the same numpy data."""
    datas, jb, jdims = _padded_by_jax()

    def jloss(qp, masks):  # one padded instance, unbatched; masks pick its original coordinates
        sol = dj.solve_qp(qp)
        return jnp.sum((sol.z * masks[0]) ** 2) + jnp.sum(sol.lam * masks[1]) + jnp.sum((sol.nu * masks[2]) ** 2)

    n, m, p = jb.q.shape[1], jb.h.shape[1], jb.b.shape[1]
    step = jax.jit(jax.value_and_grad(jloss))  # all three share a shape: one compile
    jvals, jgrads = [], []
    for i, (n0, m0, p0) in enumerate(jdims):
        masks = tuple(jnp.asarray(np.arange(k) < k0, dtype=jnp.float64) for k, k0 in ((n, n0), (m, m0), (p, p0)))
        v, g = step(jax.tree.map(lambda x: x[i], jb), masks)
        jvals.append(float(v))
        jgrads.append(g)
    jgrads = jbatching.unpad_tangent(jax.tree.map(lambda *xs: jnp.stack(xs), *jgrads), jdims)

    qps = [_tq(d, grad=True) for d in datas]
    tb, tdims = tbatching.pad_and_stack(qps)
    sols = tbatching.unpad_solution(dtt.solve_qp(tb), tdims)
    tvals = [(s.z**2).sum() + s.lam.sum() + (s.nu**2).sum() for s in sols]
    sum(tvals).backward()
    np.testing.assert_allclose([float(v) for v in tvals], jvals, rtol=0, atol=1e-8)
    for qp, jg in zip(qps, jgrads):
        for name in NAMES:
            # same staged solve, same LU adjoint ('auto' on strictly convex programs), f64
            np.testing.assert_allclose(getattr(qp, name).grad.numpy(), np.asarray(getattr(jg, name)), rtol=0, atol=1e-6, err_msg=name)
