"""Port parity of the fused conic IPM (K6): the plain PyTorch version
``solve_tile_fused_plain`` against ``diffopt_tpu``'s ``solve_tile_fused`` (the
Pallas kernel in interpret mode) on the same numpy inputs, f64, on a zero +
nonneg + soc + psd(side 2) layout (side 2: the interpret-mode Jacobi compiles
quickly). x, y and s agree to 1e-8; iteration
counts are compared on instances that met the criterion (for the others the
TPU kernel reports its tile's loop count, the port the instance's own). Also
the wrapper's CPU route and the kernel's envelope."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu.ops.pallas import conic_pdip as jk6
from diffopt_tpu_torch.ops.cuda import conic_pdip as tk6

torch.set_num_threads(1)

B = 6
LAYOUTS = {"zero+nonneg+soc+psd2": (3, (1, 2, (3,), (2,)))}
KW = dict(max_iters=30, tol=1e-9, reg=1e-11, eps=1e-14)


def _interior(rng, l, soc_dims, psd_sides):
    parts = [rng.uniform(0.5, 1.5, size=(B, l))]
    for d in soc_dims:
        t = rng.normal(size=(B, d))
        t[:, 0] = np.linalg.norm(t[:, 1:], axis=1) + 1.0
        parts.append(t)
    for d in psd_sides:
        M = rng.normal(size=(B, d, d))
        S = M @ np.swapaxes(M, 1, 2) + d * np.eye(d)
        parts.append(np.stack([S[:, r, c] * (1.0 if r == c else np.sqrt(2.0)) for c in range(d) for r in range(c + 1)], 1))
    return np.concatenate(parts, axis=1)


def _data(n, layout, seed=0):
    """A strictly feasible, bounded batch in the internal layout: b from an
    interior slack, c from an interior dual."""
    p, l, soc_dims, psd_sides = layout
    rng = np.random.default_rng(seed)
    mC = l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides)
    AC, AE, x0 = rng.normal(size=(B, mC, n)), rng.normal(size=(B, p, n)), rng.normal(size=(B, n))
    bC = np.einsum("bij,bj->bi", AC, x0) + _interior(rng, l, soc_dims, psd_sides)
    bE = np.einsum("bij,bj->bi", AE, x0)
    yC, yE = _interior(rng, l, soc_dims, psd_sides), rng.normal(size=(B, p))
    c = -np.einsum("bij,bi->bj", AC, yC) - np.einsum("bij,bi->bj", AE, yE)
    return c, bE, bC, AE, AC


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, (n, layout) in LAYOUTS.items():
        run = jax.jit(lambda *a, layout=layout: jk6.solve_tile_fused(*a, layout, **KW))
        out[name] = [np.asarray(t) for t in run(*map(jnp.asarray, _data(n, layout)))]
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_fused_ipm_matches_pallas_kernel(jax_results, name):
    n, layout = LAYOUTS[name]
    data = [torch.from_numpy(a) for a in _data(n, layout)]
    jx, jyE, jyC, js, jit, jpres, jdres = jax_results[name]
    out = tk6.solve_tile_fused_plain(*data, layout, **KW)
    x, yE, yC, s, it, pres, dres = (t.numpy() for t in out)
    for label, a, b in (("x", x, jx), ("yE", yE, jyE), ("yC", yC, jyC), ("s", s, js)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8, err_msg=label)
    np.testing.assert_allclose(pres, jpres, rtol=0, atol=1e-10)
    np.testing.assert_allclose(dres, jdres, rtol=0, atol=1e-10)
    met = np.maximum(jpres, jdres) < KW["tol"]
    assert met.sum() >= B - 1
    np.testing.assert_array_equal(it[met], jit[met].astype(np.int32))
    # the wrapper takes the plain version for CPU tensors
    wrapped = tk6.solve_tile_fused(*data, layout, **KW)
    for a, b in zip(wrapped, out):
        assert torch.equal(a, b)


def test_envelope_and_shared_memory():
    f64 = 8
    # the reference's envelope (N <= 128, psd side <= 6) fits in f32 and f64, at its largest corners
    assert tk6.in_envelope(64, 0, 0, (64,), (), f64)  # one soc block as wide as N allows, N = 128
    assert tk6.in_envelope(2, 0, 0, (), (6,) * 6, f64)  # six side-6 psd blocks, N = 128
    assert tk6.in_envelope(40, 24, 64, (), (), f64)
    # extended: side 12 where it fits, the side-8 SDP of the benchmark family
    assert tk6.in_envelope(3, 0, 0, (4,), (12,), f64)
    assert tk6.in_envelope(3, 0, 0, (4,), (8,), 4)
    # past it: N > 128, a side past the Jacobi range, no cone rows
    assert not tk6.in_envelope(64, 1, 0, (64,), (), 4)
    assert not tk6.in_envelope(3, 0, 0, (), (13,), 4)
    assert not tk6.in_envelope(3, 2, 0, (), (), 4)
    # the wrapper's shared-memory count at the SOCP and SDP shapes (the kernel's own count agreed
    # with these on an H100: the wrapper compares the two before every launch)
    assert tk6.smem_bytes(16, 0, 0, (17,), (), 4) == 9160
    assert tk6.smem_bytes(16, 0, 0, (17,), (), 8) == 18160
    assert tk6.smem_bytes(3, 0, 0, (4,), (4,), 8) == 14432


def _old_envelope(n, p, l, soc_dims, psd_sides, itemsize):
    """The envelope of the one-block-of-eight-warps kernel: N <= 128, psd side <= 12, the block counts, and
    its working set (the eight-warp team's) in 227 KB less the static table."""
    mC = l + sum(soc_dims) + sum(d * (d + 1) // 2 for d in psd_sides)
    return (mC >= 1 and n >= 1 and n + p + mC <= 128 and max(psd_sides, default=0) <= 12
            and len(soc_dims) <= tk6.MAX_SOC_BLOCKS and len(psd_sides) <= tk6.MAX_PSD_BLOCKS
            and tk6.smem_bytes(n, p, l, soc_dims, psd_sides, itemsize, 8) <= tk6.MAX_SMEM_BYTES - 1024)


def _layouts(rng, count):
    """Random layouts around the envelope's edges, plus its corners."""
    out = [(64, 0, 0, (64,), ()), (2, 0, 0, (), (6,) * 6), (40, 24, 64, (), ()), (3, 0, 0, (4,), (12,)),
           (1, 0, 0, (), (12,) * 2), (1, 0, 1, (), ()), (16, 0, 0, (17,), ()), (3, 0, 0, (4,), (4,)),
           (3, 0, 0, (4,), (8,)), (5, 2, 5, (4, 3), (3,)), (10, 5, 2, (2,) * 15, (1,) * 3)]
    for _ in range(count):
        n, p, l = int(rng.integers(1, 70)), int(rng.integers(0, 30)), int(rng.integers(0, 40))
        socs = tuple(int(d) for d in rng.integers(1, 30, size=int(rng.integers(0, 4))))
        psds = tuple(int(d) for d in rng.integers(1, 14, size=int(rng.integers(0, 4))))
        out.append((n, p, l, socs, psds))
    return out


def test_launch_rule_takes_every_layout_of_the_old_envelope():
    """The Python mirror of K6's launch rule picks a team for every layout the eight-warp kernel took (the
    envelope does not shrink), the smallest team that takes it, whose tiles hold N and whose working set
    fits one block's shared memory; a layout past the envelope gets none. No card and no JAX needed."""
    rng = np.random.default_rng(0)
    taken = 0
    for itemsize in (4, 8):
        for lay in _layouts(rng, 3000):
            n, p, l, socs, psds = lay
            old = _old_envelope(*lay, itemsize)
            team = tk6.team_for(*lay, itemsize)
            assert tk6.in_envelope(*lay, itemsize) >= old, lay
            if not old:
                continue
            taken += 1
            assert team in tk6.TEAMS and tk6.team_takes(*lay, itemsize, team), (lay, team)
            assert all(not tk6.team_takes(*lay, itemsize, t) for t in tk6.TEAMS if t < team), (lay, team)
            N = n + p + l + sum(socs) + sum(d * (d + 1) // 2 for d in psds)
            assert N <= tk6.tile_max_n(team)
            assert tk6.smem_bytes(*lay, itemsize, team) + 1024 <= tk6.MAX_SMEM_BYTES  # 227 KB with the static table
    assert taken > 1000  # the sample reaches deep into the envelope
    # past it: N > 128, a side past the Jacobi range, no cone rows
    for lay in ((64, 1, 0, (64,), ()), (3, 0, 0, (), (13,)), (3, 2, 0, (), ())):
        assert not tk6.in_envelope(*lay, 4)
    assert tk6.team_for(64, 1, 0, (64,), (), 4) == 0


def test_launch_rule_puts_many_socp_and_sdp_instances_on_an_sm():
    """At the SOCP of the [conic] path and the SDP of psd side 4, f32, the rule's team gets more than two
    instances per SM by shared memory (the eight-warp kernel held two), a one-warp team, and its shared
    memory is the instance's working set with a pivot column and one psd workspace per warp."""
    for lay in ((16, 0, 0, (17,), ()), (3, 0, 0, (4,), (4,))):
        team = tk6.team_for(*lay, 4)
        assert team == 1
        assert tk6.instances_per_sm(*lay, 4, team) > 2
        assert tk6.smem_bytes(*lay, 4, team) < tk6.smem_bytes(*lay, 4, 8)
    # the eight-warp team's count is the kernel's earlier one (test_envelope_and_shared_memory), the
    # smaller teams' differ by the pivot column (2 tile_max_n words) and the per-warp psd workspaces
    assert tk6.smem_bytes(16, 0, 0, (17,), (), 4, 1) == 9160 - 4 * (256 - 80)
    assert tk6.smem_bytes(3, 0, 0, (4,), (4,), 8, 2) == 14432 - 8 * ((256 - 128) + 6 * (5 * 16 + 4))
