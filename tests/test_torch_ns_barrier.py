"""Port parity of the barrier algebra of the nonsymmetric IPM (``diffopt_tpu_torch/ops/ns_barrier.py``),
f64, on the same numpy inputs: against the fused TPU kernel's helpers (``ops/pallas/ns_pdip.py``:
``_ns_parts`` / ``_ns_grad`` / ``_ns_hess`` / ``_ns_interior_ll`` / ``_solve3_sym_ll`` /
``_ns_central_np``, plain jnp on ``(3, LANE)`` values, no Pallas) to 1e-12, and against the staged JAX
solver's autodiff barriers (``solvers/conic_nsipm.py``: ``jax.grad`` / ``jax.hessian``) and its
whole-cone helpers (``_grad_barrier``, ``_hbar_pair``, ``_prox_sq``, ``_interior_measure``) on a
layout with every kind of block, relative 1e-9 (the closed forms and autodiff associate differently;
the Hessian entries span the 1/margin^2 scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu.ops.pallas import ns_pdip as jk
from diffopt_tpu.solvers import conic_nsipm as jns
from diffopt_tpu_torch.ops import ns_barrier as nb
from diffopt_tpu_torch.solvers import conic_nsipm as tns

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

KINDS = [("exp", None), ("dual_exp", None), ("pow", 0.3), ("dual_pow", 0.7)]
LANE = 16


def _interior_points(kind, a, seed, count=LANE):
    """Points strictly inside the cone ``kind`` (and a few outside it for the interiority measure)."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(0.3, 2.0, count), rng.uniform(0.3, 2.0, count)
    if kind == "exp":  # (x, y, z) with y e^(x/y) < z
        u = np.stack([x - 1.0, y, y * np.exp((x - 1.0) / y) * rng.uniform(1.1, 3.0, count)])
    elif kind == "dual_exp":  # (-t, v, w): v + t + t log(w/t) > 0
        t, w = x, y
        u = np.stack([-t, -t - t * np.log(w / t) + rng.uniform(0.1, 1.0, count), w])
    else:
        sx, sy = (1.0, 1.0) if kind == "pow" else (a, 1.0 - a)
        cap = (x / sx) ** a * (y / sy) ** (1 - a)
        u = np.stack([x, y, rng.uniform(-0.9, 0.9, count) * cap])
    return u


@pytest.mark.parametrize("kind,a", KINDS)
def test_block_helpers_match_the_fused_kernels(kind, a):
    u = _interior_points(kind, a, 1)
    eps = 1e-15
    jg = np.asarray(jk._ns_grad(kind, a, jnp.asarray(u), eps))
    jh = np.asarray(jk._ns_hess(kind, a, jnp.asarray(u), eps))
    tu = torch.from_numpy(u.T.copy())
    np.testing.assert_allclose(nb.grad(kind, a, tu, eps).numpy(), jg.T, rtol=1e-12, atol=0)
    np.testing.assert_allclose(nb.hess(kind, a, tu, eps).numpy(), np.moveaxis(jh, -1, 0), rtol=1e-12, atol=0)
    g, *_ = jk._ns_parts(kind, a, jnp.asarray(u), eps)
    np.testing.assert_allclose(nb.parts(kind, a, tu, eps)[0].numpy(), np.asarray(g), rtol=1e-12, atol=0)
    # the interiority measure, on interior points and on points moved out of the cone or its domain
    out = u.copy()
    out[:, ::2] *= -1.0
    for pts in (u, out):
        ji = np.asarray(jk._ns_interior_ll(kind, a, jnp.asarray(pts)))
        np.testing.assert_allclose(nb.interior(kind, a, torch.from_numpy(pts.T.copy())).numpy(), ji, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(nb.central(kind, a), jk._ns_central_np(kind, a))
    # the Cramer 3x3 solve, on the Jacobi-scaled Hessian as the proximity uses it
    rhs = np.random.default_rng(2).normal(size=(3, LANE))
    js = np.asarray(jk._solve3_sym_ll(jnp.asarray(jh), jnp.asarray(rhs)))
    ts = nb.solve3_sym(torch.from_numpy(np.moveaxis(jh, -1, 0).copy()), torch.from_numpy(rhs.T.copy()), 1e-30)
    np.testing.assert_allclose(ts.numpy(), js.T, rtol=1e-9, atol=0)


@pytest.mark.parametrize("kind,a", KINDS)
def test_closed_forms_match_the_autodiff_barriers(kind, a):
    u = _interior_points(kind, a, 3).T
    F = jns._barrier_fn(kind, a)
    jg = np.asarray(jax.vmap(jax.grad(F))(jnp.asarray(u)))
    jh = np.asarray(jax.vmap(jax.hessian(F))(jnp.asarray(u)))
    tu = torch.from_numpy(u)
    np.testing.assert_allclose(nb.grad(kind, a, tu, 1e-15).numpy(), jg, rtol=1e-9, atol=1e-12)
    H = nb.hess(kind, a, tu, 1e-15).numpy()
    scale = np.abs(jh).reshape(len(u), -1).max(1)[:, None, None]
    np.testing.assert_allclose(H / scale, jh / scale, rtol=0, atol=1e-9)
    # the staged solver's central points (jax.grad for the dual kinds) agree to rounding
    np.testing.assert_allclose(nb.central(kind, a), np.asarray(jns._ns_central(kind, a, jnp.float64)), rtol=1e-14)


LAYOUT = dict(l=2, soc_dims=(3,), psd_sides=(2,), ns_blocks=(("exp", None), ("pow", 0.4), ("dual_exp", None),
                                                              ("dual_pow", 0.6)))


def _layout_points(seed, count=5):
    """Strictly interior (s, y) pairs of the layout, rows [nonneg | soc | psd (svec) | ns...]."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(count):
        def one():
            parts = [rng.uniform(0.5, 2.0, 2)]
            v = rng.normal(size=2) * 0.5
            parts.append(np.concatenate([[np.linalg.norm(v) + 0.5], v]))
            M = rng.normal(size=(2, 2))
            S = M @ M.T + np.eye(2)
            parts.append(np.array([S[0, 0], np.sqrt(2) * S[0, 1], S[1, 1]]))
            return parts
        s_parts, y_parts = one(), one()
        for i, (kind, a) in enumerate(LAYOUT["ns_blocks"]):
            s_parts.append(_interior_points(kind, a, seed * 10 + i, 1)[:, 0])
            dk = nb.DUAL_KIND[kind]
            y_parts.append(_interior_points(dk, a, seed * 10 + i + 5, 1)[:, 0])
        rows.append((np.concatenate(s_parts), np.concatenate(y_parts)))
    return np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def test_whole_cone_helpers_match_the_staged_solvers():
    s, y = _layout_points(4)
    mu = np.array([0.3, 1.0, 0.05, 2.0, 0.7])
    jlay = jns._Layout(**LAYOUT)

    @jax.jit
    def ref(s, y, mu):
        one = lambda s, y, mu: (
            jns._grad_barrier(jlay, s), *jns._hbar_pair(jlay, s, mu, jnp.float64), jns._prox_sq(jlay, s, y, mu),
            jns._interior_measure(jlay, s, False), jns._interior_measure(jlay, y, True),
            jns._init_point(jlay, jnp.float64),
        )
        return jax.vmap(one)(s, y, mu)

    jg, jH, jHi, jq, jis, jiy, j0 = (np.asarray(t) for t in ref(jnp.asarray(s), jnp.asarray(y), jnp.asarray(mu)))
    lay = nb.Layout(**LAYOUT)
    psd = tns._Psd()
    ts, ty, tmu = (torch.from_numpy(a) for a in (s, y, mu))
    rel = lambda a, b: np.abs(a - b).max() / (1.0 + np.abs(b).max())
    assert rel(nb.grad_barrier(lay, ts, 1e-15, 1e-14, psd).numpy(), jg) <= 1e-9
    H, Hi = nb.hbar_pair(lay, ts, tmu, 1e-15, 1e-14, 1e-14, psd)
    assert rel(H.numpy(), jH) <= 1e-9 and rel(Hi.numpy(), jHi) <= 1e-9
    assert rel(nb.prox_sq(lay, ts, ty, tmu, 1e-15, 1e-14, 1e-300, psd).numpy(), jq) <= 1e-9
    assert rel(nb.interior_measure(lay, ts, False, psd).numpy(), jis) <= 1e-12
    assert rel(nb.interior_measure(lay, ty, True, psd).numpy(), jiy) <= 1e-12
    assert rel(nb.init_point(lay, torch.float64, "cpu").numpy(), j0[0]) <= 1e-14
    assert nb.nu_total(lay) == jns._nu_total(jlay)
