"""Port parity: ``diffopt_tpu_torch.solve_qp`` (staged solver, reverse and
forward rules) against ``jax.grad`` / ``jax.jvp`` of ``diffopt_tpu.solve_qp``
on the same numpy inputs, f64. The JAX side runs unbatched (no Pallas
compile) except for the one comparison whose subject is the batched route."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import diffopt_tpu as dj
import diffopt_tpu_torch as dtt
from diffopt_tpu.utils.config import get_config as jget_config, use_config as juse_config
from diffopt_tpu_torch.ops.cuda import pdip as tpdip

torch.set_num_threads(1)

NAMES = ("Q", "q", "A", "b", "G", "h")
n, m, p = 4, 3, 2


def _instance(seed, n=n, m=m, p=p):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, n))
    data = dict(
        Q=L @ L.T + n * np.eye(n), q=rng.normal(size=n), A=rng.normal(size=(p, n)), b=rng.normal(size=p),
        G=rng.normal(size=(m, n)), h=rng.normal(size=m) + 1.0,
    )
    return data, rng


def _jq(data):
    return dj.QuadProgram(**{k: jnp.asarray(v) for k, v in data.items()})


def _tq(data, grad=False):
    qp = dtt.convert.quadprogram_from_numpy(data, dtype=torch.float64, device="cpu")
    return qp.map(lambda t: t.requires_grad_()) if grad else qp


def _loss_j(sol):
    return jnp.sum(sol.z**2) + jnp.sum(jnp.sin(sol.lam)) + jnp.sum(sol.nu**3)


def _loss_t(sol):
    return (sol.z**2).sum() + torch.sin(sol.lam).sum() + (sol.nu**3).sum()


@pytest.fixture(scope="module")
def both():
    """One instance through both packages: value, all six gradients of a loss
    on (z, lam, nu), and the tangent of the solution along a random direction."""
    data, rng = _instance(1)
    tan = {k: 0.1 * rng.normal(size=v.shape) for k, v in data.items()}
    tan["Q"] = 0.5 * (tan["Q"] + tan["Q"].T)
    jgrad = jax.jit(jax.grad(lambda qp: _loss_j(dj.solve_qp(qp))))(_jq(data))
    jsol, jtan = jax.jit(lambda qp, dqp: jax.jvp(lambda x: dj.solve_qp(x, mode="jvp"), (qp,), (dqp,)))(_jq(data), _jq(tan))

    qp = _tq(data, grad=True)
    tsol = dtt.solve_qp(qp)
    tgrad = torch.autograd.grad(_loss_t(tsol), qp.tensors())
    with fwAD.dual_level():
        dual = dtt.QuadProgram(*(fwAD.make_dual(x, torch.from_numpy(tan[k])) for k, x in zip(NAMES, _tq(data).tensors())))
        ttan = dtt.solve_qp(dual, mode="jvp").map(lambda t: fwAD.unpack_dual(t).tangent)
    return dict(data=data, tan=tan, jsol=jsol, jgrad=jgrad, jtan=jtan, tsol=tsol, tgrad=tgrad, ttan=ttan)


def test_value_matches_jax(both):
    for name in ("z", "lam", "nu"):
        # the same staged iteration in f64
        np.testing.assert_allclose(
            getattr(both["tsol"], name).detach().numpy(), np.asarray(getattr(both["jsol"], name)), rtol=0, atol=1e-8
        )
    assert both["tsol"].z.shape == (n,) and both["tsol"].lam.shape == (m,)


def test_vjp_all_six_gradients_match_jax_grad(both):
    for name, g in zip(NAMES, both["tgrad"]):
        assert g.shape == both["data"][name].shape
        # both differentiate the same KKT point with an LU solve ('auto' on a strictly convex QP)
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(both["jgrad"], name)), rtol=0, atol=1e-6, err_msg=name)


def test_jvp_matches_jax_jvp_and_is_adjoint_of_vjp(both):
    for name in ("z", "lam", "nu"):
        np.testing.assert_allclose(
            getattr(both["ttan"], name).numpy(), np.asarray(getattr(both["jtan"], name)), rtol=0, atol=1e-6, err_msg=name
        )
    # <JVP(d), dloss/dsol> = <d, VJP(dloss/dsol)> ties the forward rule to the reverse rule
    sol = both["tsol"].map(lambda t: t.detach().requires_grad_())
    seeds = torch.autograd.grad(_loss_t(sol), sol.tensors())
    lhs = sum(float((s * t).sum()) for s, t in zip(seeds, both["ttan"].tensors()))
    rhs = sum(float((g * torch.from_numpy(both["tan"][k])).sum()) for k, g in zip(NAMES, both["tgrad"]))
    assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))


def test_jvp_with_some_tangents_absent_and_mode_check(both):
    data, tan = both["data"], both["tan"]
    base = _tq(data)
    with fwAD.dual_level():
        dual = dtt.QuadProgram(base.Q, base.q, base.A, base.b, base.G, fwAD.make_dual(base.h, torch.from_numpy(tan["h"])))
        sol, info = dtt.solve_qp(dual, mode="jvp", with_info=True)
        dz = fwAD.unpack_dual(sol.z).tangent
        assert fwAD.unpack_dual(info.primal_residual).tangent is None
    only_h = dtt.QPTangent(*(torch.from_numpy(tan[k]) if k == "h" else torch.zeros_like(x) for k, x in zip(NAMES, base.tensors())))
    ref = dtt.forward_differentiate(base, both["tsol"].map(torch.Tensor.detach), only_h)
    np.testing.assert_allclose(dz.numpy(), ref.dz.numpy(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="mode must be"):
        dtt.solve_qp(base, mode="both")


def test_mixed_lp_and_qp_batch_through_auto():
    """A batch mixing an LP (Q = 0) and a strictly convex QP: each instance is
    routed on its own, the LP to the least-squares solve, and neither poisons
    the other with NaN."""
    G = np.array([[1.0, 2.0], [3.0, 1.0]])
    Qs = np.stack([np.zeros((2, 2)), 2.0 * np.eye(2)])
    hs = np.array([[4.0, 6.0], [4.0, 6.0]])

    def jloss(Q, h):
        return jnp.sum(dj.solve_qp(dj.QuadProgram.make(Q=Q, q=[-1.0, -1.0], G=G, h=h)).z ** 2)

    jgrad = jax.jit(jax.grad(jloss, argnums=1))  # Q is traced: the LP-or-QP decision is made at run time
    jg = [np.asarray(jgrad(jnp.asarray(Qs[i]), jnp.asarray(hs[i]))) for i in range(2)]
    h = torch.tensor(hs, requires_grad=True)
    qp = dtt.QuadProgram.make(Q=torch.tensor(Qs), q=torch.tensor([[-1.0, -1.0]] * 2, dtype=torch.float64),
                              G=torch.tensor(np.stack([G, G])), h=h)
    (dtt.solve_qp(qp).z ** 2).sum().backward()  # method=None -> config 'auto'
    assert bool(torch.isfinite(h.grad).all())
    # LP instance: analytic dz/dh = G^-1 at the active vertex, and the JAX package's value
    z0 = np.linalg.solve(G, hs[0])
    np.testing.assert_allclose(h.grad[0].numpy(), np.linalg.solve(G.T, 2 * z0), rtol=0, atol=1e-6)
    np.testing.assert_allclose(h.grad[0].numpy(), jg[0], rtol=0, atol=1e-6)
    # QP instance keeps LU-grade accuracy
    np.testing.assert_allclose(h.grad[1].numpy(), jg[1], rtol=0, atol=1e-8)
    # the same LP alone, one instance without a batch dimension: resolved to 'lstsq' on the host
    h1 = torch.tensor(hs[0], requires_grad=True)
    one = dtt.QuadProgram.make(q=torch.tensor([-1.0, -1.0], dtype=torch.float64), G=torch.tensor(G), h=h1)
    (dtt.solve_qp(one).z ** 2).sum().backward()
    np.testing.assert_allclose(h1.grad.numpy(), jg[0], rtol=0, atol=1e-6)
    # explicit routes on the LP: 'lstsq' and 'qr' agree, 'lu' of the singular matrix is not finite
    sol = dtt.solve_qp(one).map(torch.Tensor.detach)
    seed = 2 * sol.z
    g_ls = dtt.reverse_differentiate(one.map(torch.Tensor.detach), sol, seed, method="lstsq")
    np.testing.assert_allclose(g_ls.dh.numpy(), jg[0], rtol=0, atol=1e-6)
    assert dtt.qp_diff._resolve_method(one, None) == "lstsq" and dtt.qp_diff._resolve_method(qp, None) == "auto"


def test_with_info_and_nan_poisoning_match_jax():
    data, _ = _instance(2, m=3, p=0)
    bad = {k: v.copy() for k, v in data.items()}
    bad["G"][:2] = 0.0  # z_0 <= -1 and -z_0 <= -1 contradict each other
    bad["G"][0, 0], bad["G"][1, 0] = 1.0, -1.0
    bad["h"][:2] = -1.0
    jsol, jinfo = dj.solve_qp(_jq(data), with_info=True)
    with juse_config(dataclasses.replace(jget_config(), nan_on_unconverged=True)):
        jbad, jbinfo = dj.solve_qp(_jq(bad), with_info=True)
    batch = {k: np.stack([data[k], bad[k]]) for k in NAMES}
    with dtt.use_config(dataclasses.replace(dtt.get_config(), nan_on_unconverged=True)):
        qp = _tq(batch, grad=True)
        tsol, tinfo = dtt.solve_qp(qp, with_info=True)
        grads = torch.autograd.grad(torch.nansum(tsol.z**2), qp.tensors())
    assert isinstance(tinfo, dtt.QPSolveInfo) and not any(t.requires_grad for t in tinfo)
    assert tinfo.converged.tolist() == [bool(jinfo.converged), bool(jbinfo.converged)] == [True, False]
    # the feasible instance stops on the same body; the infeasible one diverges until the NaN guard
    # fires, and where exactly it fires is decided by rounding
    assert int(tinfo.iterations[0]) == int(jinfo.iterations) < min(int(tinfo.iterations[1]), int(jbinfo.iterations))
    np.testing.assert_allclose(tsol.z[0].detach().numpy(), np.asarray(jsol.z), rtol=0, atol=1e-8)
    # the unconverged instance is NaN in both packages, value and gradient; the other one is untouched
    assert np.isnan(np.asarray(jbad.z)).all() and bool(torch.isnan(tsol.z[1]).all() and torch.isnan(tsol.lam[1]).all())
    assert bool(torch.isfinite(grads[1][0]).all() and torch.isnan(grads[1][1]).all())
    assert float(tinfo.primal_residual[0]) < 1e-8 and float(jinfo.primal_residual) < 1e-8
    assert float(tinfo.primal_residual[1]) > 0.1 and float(jbinfo.primal_residual) > 0.1
    # off by default: the unconverged iterate comes back as it is
    assert bool(torch.isfinite(dtt.solve_qp(_tq(batch)).z).all())


def test_fused_entry_takes_the_staged_route_for_p0_as_jax_does():
    from diffopt_tpu.ops.pallas.pdip import solve_batched_fused as jax_fused

    rng = np.random.default_rng(8)
    B, n0, m0 = 2, 3, 2
    L = rng.normal(size=(B, n0, n0))
    data = dict(
        Q=L @ np.swapaxes(L, 1, 2) + n0 * np.eye(n0), q=rng.normal(size=(B, n0)), A=np.zeros((B, 0, n0)),
        b=np.zeros((B, 0)), G=rng.normal(size=(B, m0, n0)), h=rng.normal(size=(B, m0)) + 1.0,
    )
    jsol, jit = jax.jit(lambda qp: jax_fused(qp, max_iters=30, return_iters=True))(_jq(data))
    launches = tpdip.solve_batched_fused.launches
    tsol, tit = tpdip.solve_batched_fused(_tq(data), max_iters=30, return_iters=True)
    for name in ("z", "lam", "nu"):
        # both route p = 0 to their staged solver: the same iteration in f64
        np.testing.assert_allclose(getattr(tsol, name).numpy(), np.asarray(getattr(jsol, name)), rtol=0, atol=1e-8)
    assert tsol.nu.shape == (B, 0) and np.array_equal(tit.numpy(), np.asarray(jit))
    assert tpdip.solve_batched_fused.launches == launches
    # and solve_qp_batched differentiates that point: same gradients as solve_qp on the same data
    qa, qb = _tq(data, grad=True), _tq(data, grad=True)
    ga = torch.autograd.grad((dtt.solve_qp_batched(qa, max_iters=30).z ** 2).sum(), qa.tensors())
    gb = torch.autograd.grad((dtt.solve_qp(qb).z ** 2).sum(), qb.tensors())
    for name, a, b_ in zip(NAMES, ga, gb):
        # polished point + LDL' adjoint against the staged point + LU adjoint
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=1e-6, err_msg=name)
