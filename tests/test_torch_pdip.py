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
    # the headline size leaves Q, G, A in device memory and holds eight two-warp teams per SM by
    # shared memory (27 KB a team) as its launch bounds do by registers
    assert tpdip.team_for(64, 32, 16, 4) == 2 and not tpdip.stage_for(64, 32, 16, 4, 2)
    assert tpdip.smem_bytes(64, 32, 16, 4, stage=False, team=2) <= 28 * 1024
    assert tpdip.instances_per_sm(64, 32, 16, 4, 2, stage=False) == 8
    # n = 100, m = 48, p = 24 goes to eight warps, unstaged in f32 and f64, three resident in f32 (not one)
    assert tpdip.team_for(100, 48, 24, 4) == 8 and tpdip.team_for(100, 48, 24, 8) == 8
    assert not tpdip.stage_for(100, 48, 24, 4, 8) and not tpdip.stage_for(100, 48, 24, 8, 8)
    assert tpdip.instances_per_sm(100, 48, 24, 4, 8, stage=False) == 3
    assert tpdip.smem_bytes(100, 48, 24, 8, stage=True, team=8) > tpdip.MAX_SMEM_BYTES


_NS = (1, 8, 24, 25, 32, 40, 41, 63, 64, 65, 100, 127, 128)
_MS = (1, 16, 48, 128, 520, 540, 900, 1000, 2000, 3300, 3700)


def _old_in_envelope(n, m, p, itemsize):
    """The kernel's envelope before teams: one block of 256 threads, W as an n x p block, 12 m-vectors."""
    odd = lambda k: k | 1
    words = n * odd(n) + n * odd(p) + p * odd(p) + 9 * n + 12 * m + 7 * p + 32 + 256
    return m >= 1 and 1 <= p <= 128 and n <= 128 and words * itemsize <= tpdip.MAX_SMEM_BYTES


@pytest.mark.parametrize("itemsize", [4, 8])
def test_launch_rule_staging_and_envelope(itemsize):
    """The launch rule (team_for), the staging choice (stage_for) and the envelope over a grid of shapes up
    to n, p = 128: the smallest team whose register tiles (tile_max_n) hold max(n, p) rows and whose unstaged
    working set (smem_bytes(..., team=)) fits a block, one warp only to 32 rows; Q, G, A staged only where
    they fit and cost no resident instance; and every shape the envelope took before teams is still taken."""
    for n in _NS:
        for p in _NS:
            for m in _MS:
                fits = {
                    t: max(n, p) <= tpdip.tile_max_n(t)
                    and tpdip.smem_bytes(n, m, p, itemsize, False, t) + 512 <= tpdip.MAX_SMEM_BYTES
                    for t in tpdip.TEAMS
                }
                team = tpdip.team_for(n, m, p, itemsize)
                ruled = [t for t in (1, 2, 8) if fits[t] and max(n, p) <= {1: 32, 2: 64, 8: 128}[t]]
                assert team == (ruled or [t for t in (1, 2, 8) if fits[t]] or [0])[0], (n, m, p)
                assert tpdip.in_envelope(n, m, p, itemsize) == (team > 0)
                if _old_in_envelope(n, m, p, itemsize):
                    assert team > 0, (n, m, p, itemsize)
                for t in tpdip.TEAMS:
                    assert tpdip.team_takes(n, m, p, itemsize, t) == fits[t]
                    if not fits[t]:
                        continue
                    staged = tpdip.smem_bytes(n, m, p, itemsize, True, t)
                    assert staged == tpdip.smem_bytes(n, m, p, itemsize, False, t) + (n + m + p) * n * itemsize
                    want = staged + 512 <= tpdip.MAX_SMEM_BYTES and tpdip.instances_per_sm(
                        n, m, p, itemsize, t, True
                    ) >= tpdip.instances_per_sm(n, m, p, itemsize, t, False)
                    assert tpdip.stage_for(n, m, p, itemsize, t) == want
                    assert 1 <= tpdip.instances_per_sm(n, m, p, itemsize, t, tpdip.stage_for(n, m, p, itemsize, t))
    assert tpdip.tile_max_n(1) == 40 and tpdip.tile_max_n(2) == 64 and tpdip.tile_max_n(8) == 128
    assert tpdip.team_for(32, 16, 8, itemsize) == 1 and tpdip.team_for(40, 20, 10, itemsize) == 2


def test_forced_team_refused_where_it_does_not_take_the_shape():
    """A team that does not take a shape raises, on any device, and is never replaced by another."""
    qp = dtt.convert.quadprogram_from_numpy(_random_batch(2, 48, 4, 2), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="team of 1 warps"):
        tpdip.solve_batched_fused(qp, team=1)
    with pytest.raises(ValueError, match="team of 4 warps"):
        tpdip.solve_batched_fused(qp, team=4)
    # a team that takes it runs (the plain version on the CPU)
    sol = tpdip.solve_batched_fused(qp, team=2)
    assert bool(torch.isfinite(sol.z).all())
