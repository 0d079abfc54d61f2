"""Port parity: the staged interior-point solver
(``diffopt_tpu_torch.solvers.qp.solve_batched``) against
``diffopt_tpu.solvers.qp.solve`` on the same numpy inputs, f64: under ``vmap``
(the Pallas Cholesky kernels in interpret mode) for one batch, and unbatched
(no Pallas compile) for the empty-block branches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu_torch as dtt
from diffopt_tpu import QuadProgram
from diffopt_tpu.solvers import qp as jqp
from diffopt_tpu_torch.ops.cuda import chol as tchol
from diffopt_tpu_torch.solvers import qp as tqp

torch.set_num_threads(1)


def _random_batch(B, n, m, p, seed):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, n, n))
    return dict(
        Q=L @ np.swapaxes(L, -1, -2) + n * np.eye(n),
        q=rng.normal(size=(B, n)),
        A=rng.normal(size=(B, p, n)),
        b=rng.normal(size=(B, p)),
        G=rng.normal(size=(B, m, n)),
        h=rng.normal(size=(B, m)) + 2.0,
    )


def _jq(data, i=None):
    pick = (lambda v: v) if i is None else (lambda v: v[i])
    return QuadProgram(**{k: jnp.asarray(pick(v)) for k, v in data.items()})


def _tq(data):
    return dtt.convert.quadprogram_from_numpy(data, dtype=torch.float64, device="cpu")


def _assert_same(tsol, tinfo, jsol, jinfo, atol):
    for name in ("z", "lam", "nu"):
        np.testing.assert_allclose(
            getattr(tsol, name).numpy(), np.asarray(getattr(jsol, name)), rtol=0, atol=atol, err_msg=name
        )
    assert tinfo.iterations.dtype == torch.int32
    assert np.array_equal(tinfo.iterations.numpy(), np.asarray(jinfo.iterations))
    assert np.array_equal(tinfo.converged.numpy(), np.asarray(jinfo.converged))
    for name in ("primal_residual", "dual_residual", "duality_gap"):
        # residuals of a converged point are rounding noise: both below the solver's tolerance
        t, j = getattr(tinfo, name).numpy(), np.asarray(getattr(jinfo, name))
        assert t.shape == j.shape and np.all(np.abs(t - j) < 1e-8), name


def test_solve_batched_matches_vmapped_jax_solve():
    data = _random_batch(4, 6, 4, 2, seed=21)
    data["h"][2] += 30.0  # one instance with every inequality far inactive: its own iteration count
    before = (tchol.cholesky_batched.launches, tchol.cholesky_solve_batched.launches, tqp.solve_batched.host_syncs)
    jsol, jinfo = jax.jit(jax.vmap(jqp.solve))(_jq(data))  # jit: one compile instead of one per op
    tsol, tinfo = tqp.solve_batched(_tq(data))
    # the same Mehrotra iteration in the same order, f64: the iterates agree to rounding,
    # amplified by the conditioning of the last Newton systems (mu ~ 1e-10)
    _assert_same(tsol, tinfo, jsol, jinfo, atol=1e-8)
    its = tinfo.iterations.numpy()
    assert bool(tinfo.converged.all()) and its.min() >= 3 and len(set(its.tolist())) > 1
    # one device-to-host copy per body, and no kernel launch for CPU tensors
    assert tqp.solve_batched.host_syncs - before[2] == its.max()
    assert (tchol.cholesky_batched.launches, tchol.cholesky_solve_batched.launches) == before[:2]


@pytest.mark.parametrize("shape", [(5, 0, 2), (4, 3, 0), (4, 0, 0)], ids=["m0", "p0", "m0p0"])
def test_empty_block_branches_match_unbatched_jax_solve(shape):
    n, m, p = shape
    data = _random_batch(3, n, m, p, seed=30 + m + 2 * p)
    tsol, tinfo = tqp.solve_batched(_tq(data))
    jsolve = jax.jit(jqp.solve)
    for i in range(3):
        jsol, jinfo = jsolve(_jq(data, i))
        _assert_same(tsol.map(lambda t: t[i]), dtt.QPSolveInfo(*(t[i] for t in tinfo)), jsol, jinfo, atol=1e-8)
    assert tsol.lam.shape == (3, m) and tsol.nu.shape == (3, p) and bool(tinfo.converged.all())
    # one instance without a batch dimension gives the same numbers
    one = _tq({k: v[0] for k, v in data.items()})
    sol1, info1 = tqp.solve(one)
    assert sol1.z.shape == (n,) and info1.iterations.ndim == 0
    assert torch.equal(sol1.z, tsol.z[0]) and int(info1.iterations) == int(tinfo.iterations[0])


def test_infeasible_program_reports_not_converged_as_jax_does():
    data = _random_batch(3, 4, 3, 0, seed=5)
    # instance 1: z_0 <= -1 and -z_0 <= -1 contradict each other
    data["G"][1, :2] = 0.0
    data["G"][1, 0, 0], data["G"][1, 1, 0] = 1.0, -1.0
    data["h"][1, :2] = -1.0
    tsol, tinfo = tqp.solve_batched(_tq(data))
    assert tinfo.converged.tolist() == [True, False, True]
    # a finished instance keeps its state and its count while the infeasible one runs on
    assert int(tinfo.iterations[0]) < int(tinfo.iterations[1])
    assert bool(torch.isfinite(tsol.z).all())
    jsol, jinfo = jax.jit(jqp.solve)(_jq(data, 1))
    # where the diverging iteration trips the NaN guard is decided by rounding: no equal counts there
    assert not bool(jinfo.converged) and int(jinfo.iterations) > int(tinfo.iterations[0])
    for i in (0, 2):
        jsol, jinfo = jax.jit(jqp.solve)(_jq(data, i))
        np.testing.assert_allclose(tsol.z[i].numpy(), np.asarray(jsol.z), rtol=0, atol=1e-8)
        assert int(jinfo.iterations) == int(tinfo.iterations[i])


def test_iteration_cap_and_config_defaults():
    import dataclasses

    data = _random_batch(2, 4, 3, 1, seed=9)
    _, capped = tqp.solve_batched(_tq(data), max_iters=2)
    assert capped.iterations.tolist() == [2, 2] and not bool(capped.converged.any())
    with dtt.use_config(dataclasses.replace(dtt.get_config(), qp_max_iters=3)):
        _, info = tqp.solve_batched(_tq(data))
    assert info.iterations.tolist() == [3, 3]
    # f32 runs in f32 and meets the f32 tolerance of the config on this small, well-scaled batch
    sol32, info32 = tqp.solve_batched(_tq(data).to(dtype=torch.float32))
    sol64, _ = tqp.solve_batched(_tq(data))
    assert sol32.z.dtype == torch.float32
    np.testing.assert_allclose(sol32.z.numpy(), sol64.z.numpy(), rtol=0, atol=1e-4)
