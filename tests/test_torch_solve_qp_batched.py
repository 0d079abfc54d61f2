"""Port parity for the slice as a whole: ``diffopt_tpu_torch.solve_qp_batched``
(forward + VJP) against ``diffopt_tpu.solve_qp_batched`` (Pallas kernels in
interpret mode) on the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu as dj
import diffopt_tpu_torch as dtt
from diffopt_tpu.utils.config import get_config as jget_config, use_config as juse_config

torch.set_num_threads(1)

NAMES = ("Q", "q", "A", "b", "G", "h")


def _random_batch(B, n, m, p, seed, h_shift=2.0):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, n, n))
    return dict(
        Q=L @ np.swapaxes(L, -1, -2) + n * np.eye(n),
        q=rng.normal(size=(B, n)),
        A=rng.normal(size=(B, p, n)),
        b=rng.normal(size=(B, p)),
        G=rng.normal(size=(B, m, n)),
        h=rng.normal(size=(B, m)) + h_shift,
    )


def _jq(data):
    return dj.QuadProgram(**{k: jnp.asarray(v) for k, v in data.items()})


def _tq(data, dtype=torch.float64, grad=False):
    qp = dtt.convert.quadprogram_from_numpy(data, dtype=dtype, device="cpu")
    return qp.map(lambda t: t.requires_grad_()) if grad else qp


def _partly_infeasible(B, n, m, p, seed):
    """Instances 0 and 3 get contradictory inequalities z_0 <= -1, -z_0 <= -1."""
    data = _random_batch(B, n, m, p, seed)
    for i in (0, 3):
        data["G"][i, 0] = 0.0
        data["G"][i, 1] = 0.0
        data["G"][i, 0, 0], data["G"][i, 1, 0] = 1.0, -1.0
        data["h"][i, 0] = data["h"][i, 1] = -1.0
    return data


@pytest.fixture(scope="module")
def both():
    """ONE JAX solve + VJP and one port solve of a batch whose instances 0 and
    3 are infeasible, with ``with_info`` and ``nan_on_unconverged`` (the Pallas
    kernels compile for tens of seconds in interpret mode, so every comparison
    with the JAX package below reads from this one run)."""
    data = _partly_infeasible(8, 4, 3, 1, seed=3)
    with juse_config(dataclasses.replace(jget_config(), nan_on_unconverged=True)):
        jsol, jvjp, jinfo = jax.vjp(
            jax.jit(lambda qp: dj.solve_qp_batched(qp, max_iters=30, with_info=True)), _jq(data), has_aux=True
        )
        jvjp = jax.jit(jvjp)  # one compile of the backward pass for both seeds
        # NaN rows of the poisoned instances are seeded with zeros
        clean = lambda a: jnp.where(jnp.isnan(a), 0.0, a)
        zeros = lambda a: jnp.zeros_like(a)
        jg_z = jvjp(dj.QPSolution(z=2 * clean(jsol.z), lam=zeros(jsol.lam), nu=zeros(jsol.nu)))[0]
        jg_all = jvjp(dj.QPSolution(z=jnp.ones_like(jsol.z), lam=2 * clean(jsol.lam), nu=2 * clean(jsol.nu)))[0]
    with dtt.use_config(dataclasses.replace(dtt.get_config(), nan_on_unconverged=True)):
        qp = _tq(data, grad=True)
        tsol, tinfo = dtt.solve_qp_batched(qp, max_iters=30, with_info=True)
        tg_z = torch.autograd.grad(torch.nansum(tsol.z ** 2), qp.tensors(), retain_graph=True)
        tg_all = torch.autograd.grad(
            tsol.z.sum() + torch.nansum(tsol.lam ** 2) + torch.nansum(tsol.nu ** 2), qp.tensors()
        )
    return dict(
        data=data, jsol=jsol, jinfo=jinfo, jg_z=jg_z, jg_all=jg_all,
        tsol=tsol.map(torch.Tensor.detach), tinfo=tinfo, tg_z=tg_z, tg_all=tg_all,
    )


def test_gradients_match_jax_f64(both):
    conv = np.asarray(both["jinfo"].converged)
    assert conv.sum() == 6
    np.testing.assert_allclose(
        np.nansum(both["tsol"].z.numpy() ** 2), np.nansum(np.asarray(both["jsol"].z) ** 2), rtol=1e-9
    )
    # both differentiate the same polished KKT point through a twice-refined
    # LDL' adjoint solve; f64 leaves ~1e-9, 1e-6 is the reference suite's gate.
    # Two seeds: d sum(z**2), and a seed on every output (z, lam, nu).
    for tg, jg in ((both["tg_z"], both["jg_z"]), (both["tg_all"], both["jg_all"])):
        for name, g in zip(NAMES, tg):
            assert g.shape == both["data"][name].shape
            np.testing.assert_allclose(
                g.numpy()[conv], np.asarray(getattr(jg, name))[conv], atol=1e-6, err_msg=name
            )


def test_lu_method_and_no_polish_match_ldl():
    data = _random_batch(6, 5, 3, 2, seed=4)
    grads = {}
    for method, polish in (("ldl", True), ("lu", True), ("ldl", False)):
        qp = _tq(data, grad=True)
        loss = (dtt.solve_qp_batched(qp, method=method, polish=polish).z ** 2).sum()
        grads[method, polish] = torch.autograd.grad(loss, qp.tensors())
    for a, b in zip(grads["ldl", True], grads["lu", True]):
        # same KKT point, two linear solvers
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-8)
    for a, b in zip(grads["ldl", True], grads["ldl", False]):
        # the unpolished f64 point is converged to ~1e-9 already
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_with_info_fields_match_jax(both):
    jsol, jinfo, tsol, tinfo = both["jsol"], both["jinfo"], both["tsol"], both["tinfo"]
    conv = np.asarray(jinfo.converged)
    assert isinstance(tinfo, dtt.QPSolveInfo)
    assert np.array_equal(tinfo.converged.numpy(), conv)
    for name in ("z", "lam", "nu"):
        np.testing.assert_allclose(
            getattr(tsol, name).numpy()[conv], np.asarray(getattr(jsol, name))[conv], atol=1e-8
        )
    # the iteration count is the kernel's own (never the -1 of kkt_metrics),
    # within one iteration of the reference's (rounding can move an exit)
    its = tinfo.iterations.numpy()
    assert tinfo.iterations.dtype == torch.int32 and its.shape == (8,)
    assert np.all(its > 0) and np.all(its <= 30)
    assert np.all(np.abs(its - np.asarray(jinfo.iterations)) <= 1)
    for name in ("primal_residual", "dual_residual", "duality_gap"):
        t, j = getattr(tinfo, name).numpy(), np.asarray(getattr(jinfo, name))
        assert t.shape == (8,) and np.all(np.isfinite(t))
        # residuals of a converged point are rounding noise: compare magnitudes
        assert np.all(t[conv] < 1e-8) and np.all(j[conv] < 1e-8), name
    # the infeasible instances show their violation in the primal residual
    np.testing.assert_allclose(
        tinfo.primal_residual.numpy()[~conv], np.asarray(jinfo.primal_residual)[~conv], rtol=1e-3
    )
    for t in tinfo:
        assert not t.requires_grad


def test_with_info_gradients_unchanged():
    data = _random_batch(4, 5, 3, 2, seed=6)
    out = []
    for with_info in (False, True):
        qp = _tq(data, grad=True)
        res = dtt.solve_qp_batched(qp, with_info=with_info)
        sol = res[0] if with_info else res
        out.append(torch.autograd.grad((sol.z ** 2).sum(), qp.tensors()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_nan_on_unconverged_poisons_same_instances_as_jax(both):
    data, jsol, jinfo, tsol, tinfo, grads = (both[k] for k in ("data", "jsol", "jinfo", "tsol", "tinfo", "tg_z"))
    conv = tinfo.converged.numpy()
    assert np.array_equal(conv, np.asarray(jinfo.converged))
    assert np.array_equal(conv, np.array([False, True, True, False, True, True, True, True]))
    nan_rows = np.isnan(tsol.z.numpy()).all(axis=1)
    assert np.array_equal(nan_rows, ~conv)
    assert np.array_equal(nan_rows, np.isnan(np.asarray(jsol.z)).all(axis=1))
    assert np.isnan(tsol.lam.numpy()[~conv]).all() and np.isnan(tsol.nu.numpy()[~conv]).all()
    # converged instances keep finite gradients, poisoned ones get NaN
    assert np.isfinite(grads[1].numpy()[conv]).all() and np.isnan(grads[1].numpy()[~conv]).all()
    # off by default: the unconverged iterate is returned as it is
    tsol2, tinfo2 = dtt.solve_qp_batched(_tq(data), max_iters=30, with_info=True)
    assert np.array_equal(tinfo2.converged.numpy(), conv) and bool(torch.isfinite(tsol2.z).all())


def test_zero_seed_gives_exactly_zero_grads():
    data = _random_batch(4, 5, 3, 2, seed=2)
    qp = _tq(data, grad=True)
    sol = dtt.solve_qp_batched(qp)
    grads = torch.autograd.grad((0.0 * sol.z).sum() + (0.0 * sol.lam).sum(), qp.tensors())
    for name, g in zip(NAMES, grads):
        assert g.shape == data[name].shape and bool((g == 0).all()), name


def test_f32_gradients_close_to_f64():
    data = _random_batch(8, 6, 4, 2, seed=12)
    out = {}
    for dt in (torch.float64, torch.float32):
        qp = _tq(data, dtype=dt, grad=True)
        out[dt] = torch.autograd.grad((dtt.solve_qp_batched(qp).z ** 2).sum(), qp.tensors())
        assert all(g.dtype == dt for g in out[dt])
    for a, b in zip(out[torch.float64], out[torch.float32]):
        # the polish takes the f32 KKT point to f32-linear accuracy
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-5)


def test_empty_blocks_raise_not_implemented():
    """With an empty block ``solve_qp_batched`` takes the staged route (nothing
    raises) and differentiates the result like any other."""
    data = _random_batch(2, 4, 3, 2, seed=1)
    qp = _tq(data)
    no_ineq = dtt.QuadProgram(qp.Q, qp.q, qp.A, qp.b, qp.G[:, :0], qp.h[:, :0])
    no_eq = dtt.QuadProgram(qp.Q, qp.q, qp.A[:, :0], qp.b[:, :0], qp.G, qp.h)
    neither = dtt.QuadProgram(qp.Q, qp.q, qp.A[:, :0], qp.b[:, :0], qp.G[:, :0], qp.h[:, :0])
    for case in (no_ineq, no_eq, neither):
        a = case.map(lambda t: t.clone().requires_grad_())
        sol, info = dtt.solve_qp_batched(a, with_info=True)
        assert bool(info.converged.all()) and bool((info.iterations >= 1).all())
        ga = torch.autograd.grad((sol.z ** 2).sum(), a.tensors())
        b_ = case.map(lambda t: t.clone().requires_grad_())
        gb = torch.autograd.grad((dtt.solve_qp(b_, method="lu").z ** 2).sum(), b_.tensors())
        for x, y in zip(ga, gb):
            # polished point + LDL' adjoint against the staged point + LU adjoint, f64
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0, atol=1e-6)


def test_make_batch_and_ir_helpers():
    from diffopt_tpu_torch.utils.testing import make_batch

    g = torch.Generator(device="cpu").manual_seed(5)
    qp = make_batch(4, 6, 3, 2, torch.float64, "cpu", g)
    assert (qp.batch_size, qp.num_vars, qp.num_ineq, qp.num_eq) == (4, 6, 3, 2)
    assert bool((torch.linalg.eigvalsh(qp.Q) > 0).all())
    g.manual_seed(5)
    again = make_batch(4, 6, 3, 2, torch.float64, "cpu", g)
    assert all(torch.equal(a, b) for a, b in zip(qp.tensors(), again.tensors()))
    assert qp.to(dtype=torch.float32).Q.dtype == torch.float32
    tan = dtt.QPTangent.zeros_like(qp)
    assert tan.dG.shape == qp.G.shape and float(tan.dQ.abs().sum()) == 0.0
    made = dtt.QuadProgram.make(q=np.zeros((3, 4)), G=np.ones((3, 2, 4)), h=np.ones((3, 2)), device="cpu")
    assert made.Q.shape == (3, 4, 4) and made.A.shape == (3, 0, 4) and made.num_eq == 0
    # tensors decide where the program lands; plain arrays go to the card, and fail where there is none
    assert dtt.QuadProgram.make(q=torch.zeros(2), h=[1.0], G=[[1.0, 0.0]]).G.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dtt.QuadProgram.make(q=np.zeros((3, 4)))
    back = dtt.convert.to_numpy(qp)
    assert set(back) == set(NAMES) and back["Q"].shape == (4, 6, 6)
