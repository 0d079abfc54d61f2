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
