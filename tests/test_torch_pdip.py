"""Port parity: the plain version of the fused PDIP kernel
(``diffopt_tpu_torch.ops.cuda.pdip``) against the Pallas kernel of the JAX
package in interpret mode, on the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu_torch as dtt
from diffopt_tpu import QuadProgram
from diffopt_tpu.ops.pallas.pdip import solve_batched_fused as jax_fused
from diffopt_tpu_torch.ops.cuda import pdip as tpdip

torch.set_num_threads(1)


def _random_batch(B, n, m, p, seed=0, dtype=np.float64, h_shift=2.0):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, n, n))
    data = dict(
        Q=L @ np.swapaxes(L, -1, -2) + n * np.eye(n),
        q=rng.normal(size=(B, n)),
        A=rng.normal(size=(B, p, n)),
        b=rng.normal(size=(B, p)),
        G=rng.normal(size=(B, m, n)),
        h=rng.normal(size=(B, m)) + h_shift,
    )
    return {k: v.astype(dtype) for k, v in data.items()}


@functools.partial(jax.jit, static_argnames="max_iters")
def _jax_fused(qp, max_iters):
    """The Pallas kernel (interpret mode) under jit: one compile of the whole
    call per shape and dtype, shared by the tests below."""
    return jax_fused(qp, max_iters=max_iters, return_iters=True)


def _both(data, max_iters):
    jsol, jit = _jax_fused(QuadProgram(**{k: jnp.asarray(v) for k, v in data.items()}), max_iters=max_iters)
    tdt = torch.float64 if data["Q"].dtype == np.float64 else torch.float32
    tsol, tit = tpdip.solve_batched_fused(
        dtt.convert.quadprogram_from_numpy(data, dtype=tdt, device="cpu"),
        max_iters=max_iters, return_iters=True,
    )
    return jsol, np.asarray(jit), tsol, tit.numpy()


@pytest.mark.parametrize("shape,seed", [((16, 6, 4, 2), 0), ((16, 6, 4, 2), 3)])
def test_plain_pdip_matches_pallas_f64(shape, seed):
    data = _random_batch(*shape, seed=seed)
    jsol, jit, tsol, tit = _both(data, max_iters=30)
    # same algorithm and constants; only the order of f64 sums differs, and
    # the iterates are converged to ~1e-9 relative residual
    for name in ("z", "lam", "nu"):
        np.testing.assert_allclose(
            getattr(tsol, name).numpy(), np.asarray(getattr(jsol, name)), atol=1e-7, err_msg=name
        )
    # a rounding difference can move an exit by one iteration, not more
    assert tit.dtype == np.int32 and np.all(np.abs(tit - jit) <= 1)
    assert np.all(tit > 0) and np.all(tit <= 30)


def test_plain_pdip_matches_pallas_f32():
    data = _random_batch(16, 6, 4, 2, seed=1, dtype=np.float32)
    jsol, jit, tsol, tit = _both(data, max_iters=30)
    # f32 iterates stop at the sqrt(eps) complementarity floor (~5e-6
    # relative); the two summation orders agree to well inside 1e-4
    for name in ("z", "lam", "nu"):
        np.testing.assert_allclose(
            getattr(tsol, name).numpy(), np.asarray(getattr(jsol, name)), atol=1e-4, err_msg=name
        )
    assert tsol.z.dtype == torch.float32


def test_plain_pdip_iteration_cap_and_best_iterate():
    data = _random_batch(8, 6, 4, 2, seed=5)
    qp = dtt.convert.quadprogram_from_numpy(data, dtype=torch.float64, device="cpu")
    capped, its = tpdip.solve_batched_fused(qp, max_iters=3, return_iters=True)
    full = tpdip.solve_batched_fused(qp, max_iters=30)
    # an unconverged run reports the cap and exports its best iterate: finite,
    # and already within a few percent of the solution after three bodies
    assert np.all(its.numpy() == 3)
    assert bool(torch.isfinite(capped.z).all())
    assert float((capped.z - full.z).abs().max()) < 0.1
    assert float((capped.z - full.z).abs().max()) > 1e-9


def test_fused_refuses_empty_blocks_and_oversize():
    """What the fused kernel does not take (an empty block, n = 144 past its
    register tiles) it hands, by shape, to
    the staged solver: same result as calling that solver, no kernel launch."""
    from diffopt_tpu_torch.solvers import qp as tqp

    qp = dtt.convert.quadprogram_from_numpy(
        _random_batch(2, 4, 3, 2), dtype=torch.float64, device="cpu"
    )
    no_eq = dtt.QuadProgram(qp.Q, qp.q, qp.A[:, :0], qp.b[:, :0], qp.G, qp.h)
    no_ineq = dtt.QuadProgram(qp.Q, qp.q, qp.A, qp.b, qp.G[:, :0], qp.h[:, :0])
    rng = np.random.default_rng(0)
    cases = [no_eq, no_ineq]
    assert not tpdip.in_envelope(400, 1, 1, 8)
    for n in (144,):
        assert not tpdip.in_envelope(n, 1, 1, 8)
        X = torch.from_numpy(rng.normal(size=(1, n, 8)))
        cases.append(dtt.QuadProgram(
            X @ X.transpose(1, 2) + torch.eye(n, dtype=torch.float64), torch.ones(1, n, dtype=torch.float64),
            torch.ones(1, 1, n, dtype=torch.float64), torch.ones(1, 1, dtype=torch.float64),
            -torch.eye(n, dtype=torch.float64)[None, :1], torch.ones(1, 1, dtype=torch.float64),
        ))
    assert tpdip.in_envelope(4, 3, 2, 8) and not tpdip.in_envelope(4, 0, 2, 8) and not tpdip.in_envelope(4, 3, 0, 8)
    launches = tpdip.solve_batched_fused.launches
    for case in cases:
        sol, its = tpdip.solve_batched_fused(case, max_iters=30, return_iters=True)
        ref, info = tqp.solve_batched(case, max_iters=30)
        assert bool(info.converged.all())
        assert all(torch.equal(a, b) for a, b in zip(sol.tensors(), ref.tensors()))
        assert its.dtype == torch.int32 and torch.equal(its, info.iterations)
        # and it is the solution: stationarity and feasibility to the solver's tolerance
        assert float(tkkt_residual(case, sol)) < 1e-7
    assert tpdip.solve_batched_fused.launches == launches
    # the plain version itself is the fused algorithm and says what it needs
    with pytest.raises(ValueError, match="m >= 1 and p >= 1"):
        tpdip.solve_batched_fused_plain(no_eq)


def tkkt_residual(qp, sol):
    from diffopt_tpu_torch.ops import kkt

    return kkt.kkt_residual(qp, sol).abs().max()


def test_smem_envelope_of_main_size():
    # the headline size keeps Q, G, A staged and leaves room for 4 blocks per SM
    assert tpdip.smem_bytes(64, 32, 16, 4, stage=True) <= 227 * 1024 // 4
    # n = 100, m = 48, p = 24 fits staged in f32 and unstaged in f64
    assert tpdip.smem_bytes(100, 48, 24, 4, stage=True) <= tpdip.MAX_SMEM_BYTES
    assert tpdip.smem_bytes(100, 48, 24, 8, stage=True) > tpdip.MAX_SMEM_BYTES
    assert tpdip.smem_bytes(100, 48, 24, 8, stage=False) <= tpdip.MAX_SMEM_BYTES
