"""Port parity of the cone algebra shared by the staged conic IPM and the
plain version of K6 (``diffopt_tpu_torch/ops/jordan.py``) against the JAX
package's helpers in ``diffopt_tpu/solvers/conic_ipm.py`` (``vmap``ped over
the batch, jitted once per file), f64, on interior points of a nonneg(2) +
soc(4) + soc(3) + psd(side 3) block. Every quantity agrees to
1e-10 relative to its largest entry: the port associates products as the
CUDA kernel does and writes the soc block of W^2 as eta^2 (2 wb wb' - J)
where the reference squares eta (2 v v' - J), the same matrix."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu.solvers import conic_ipm as jipm
from diffopt_tpu_torch.ops import jordan

torch.set_num_threads(1)

B = 4
L, SOCS, PSDS = 2, (4, 3), (3,)
CONES = (L, SOCS, PSDS)
TOL = 1e-10


def _interior(rng):
    parts = [rng.uniform(0.5, 1.5, size=(B, L))]
    for d in SOCS:
        t = rng.normal(size=(B, d))
        t[:, 0] = np.linalg.norm(t[:, 1:], axis=1) + rng.uniform(0.2, 1.0, size=B)
        parts.append(t)
    for d in PSDS:
        M = rng.normal(size=(B, d, d))
        S = M @ np.swapaxes(M, 1, 2) + 0.5 * np.eye(d)
        parts.append(np.stack([S[:, r, c] * (1.0 if r == c else np.sqrt(2.0)) for c in range(d) for r in range(c + 1)], 1))
    return np.concatenate(parts, axis=1)


def _inputs():
    rng = np.random.default_rng(0)
    s, y = _interior(rng), _interior(rng)
    mC = s.shape[1]
    return s, y, rng.normal(size=(B, mC)), rng.normal(size=(B, mC)), rng.normal(size=(B, mC))


def _jax_all(s, y, u, da, db):
    sc = jipm._nt_scaling(*CONES, s, y)
    lam = jipm._w_apply(*CONES, sc, s, True)
    eigs = jipm._lam_psd_eigs(*CONES, lam)
    isq = jipm._lam_psd_isqrts(eigs, 1e-14, jnp.float64)
    return dict(
        w2=jipm._w2_dense(*CONES, sc, jnp.float64),
        W=jipm._w_apply(*CONES, sc, u, False),
        Winv=jipm._w_apply(*CONES, sc, u, True),
        lam=lam,
        jmul=jipm._jmul(*CONES, u, da),
        jsolve=jipm._jsolve(*CONES, lam, u, psd_eigs=eigs),
        steps=jnp.stack(jipm._max_step_scaled_pair(*CONES, lam, da, db, isq, jnp.float64)),
    )


def _torch_all(s, y, u, da, db):
    eps = jordan.eps_for(s.dtype)
    sc = jordan.nt_scaling(*CONES, s, y, eps)
    lam = jordan.w_apply(*CONES, sc, s, True)
    eigs = jordan.lam_psd_eigs(*CONES, lam)
    isq = jordan.lam_psd_isqrts(eigs, eps)
    return dict(
        w2=jordan.w2_dense(*CONES, sc),
        W=jordan.w_apply(*CONES, sc, u, False),
        Winv=jordan.w_apply(*CONES, sc, u, True),
        lam=lam,
        jmul=jordan.jmul(*CONES, u, da),
        jsolve=jordan.jsolve(*CONES, lam, u, eps, eigs),
        steps=torch.stack(jordan.max_step_pair(*CONES, lam, da, db, isq), dim=-1),
    )


@pytest.fixture(scope="module")
def results():
    inputs = _inputs()
    ref = jax.jit(jax.vmap(_jax_all))(*map(jnp.asarray, inputs))
    out = _torch_all(*(torch.from_numpy(a) for a in inputs))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", ["w2", "W", "Winv", "lam", "jmul", "jsolve", "steps"])
def test_cone_algebra_matches_jax(results, name):
    ref, out = results
    assert out[name].shape == ref[name].shape
    scale = 1.0 + np.abs(ref[name]).max()
    np.testing.assert_allclose(out[name], ref[name], rtol=0, atol=TOL * scale, err_msg=name)


def test_identity_and_interior_shift():
    e = jordan.identity_elem(*CONES, torch.float64, "cpu")
    np.testing.assert_array_equal(e.numpy(), np.asarray(jipm._identity_elem(*CONES, jnp.float64)))
    # a point far outside every block lands strictly inside after the shift; one inside moves by one e
    rng = np.random.default_rng(1)
    inside = torch.from_numpy(_interior(rng))
    outside = -3.0 * inside
    for s0 in (inside, outside):
        s = jordan.shift_into_interior(*CONES, s0, e.expand_as(s0))
        sc = jordan.nt_scaling(*CONES, s, e.expand_as(s), 1e-14)  # finite only strictly inside
        assert all(bool(torch.isfinite(t).all()) for t in (sc.w, *sc.etas, *sc.wnts))
        assert bool((s[:, :L] > 0).all())
        for sl in jordan.soc_slices(L, SOCS):
            assert bool((s[:, sl][:, 0] > s[:, sl][:, 1:].norm(dim=1)).all())
        for d, sl in zip(PSDS, jordan.psd_slices(L, SOCS, PSDS)):
            assert bool((torch.linalg.eigvalsh(jordan.mat(s[:, sl], d)) > 0).all())
    np.testing.assert_allclose(jordan.shift_into_interior(*CONES, inside, e.expand_as(inside)).numpy(),
                               (inside + e).numpy(), rtol=0, atol=1e-14)
