"""Port parity of the exp / pow cones: Pi and DPi (dense, apply, rmatvec, prepared operator, autograd)
of the four 3-dim kinds against ``diffopt_tpu.cones`` on the same numpy inputs, f64, on points inside
the cone, in the polar cone and in the Newton region.

Pi agrees to 1e-10. DPi agrees to 1e-10 except in the exp family's Newton region: there the projection
is the root of a scalar equation whose value is a difference of terms of size e^rho, and XLA's exp and
the C library's differ in the last bit, so the two roots differ by up to ~1e-11 and DPi, which divides
by the small multiplier mu z of such points, by up to ~1e-9 (measured 6.2e-10 on these inputs); it is
held at 1e-8 there, and separately the port's derivative formula, fed the JAX package's projected
point, is held to the JAX DPi at 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu import cones as jcones
from diffopt_tpu_torch import cones as tcones

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

B = 48
KINDS = [("exp", None), ("dual_exp", None), ("pow", 0.3), ("dual_pow", 0.6)]
TOL = 1e-10
TOL_EXP_NEWTON = 1e-8


def _points(seed):
    """Random points (the Newton region mostly) with a few inside each primal cone and in each polar."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, 3)) * 2.0
    v[0] = [0.2, 1.0, 3.0]  # inside K_exp (1 e^0.2 < 3)
    v[1] = [-0.2, -1.0, -3.0]  # its negative: in the polar of K_exp
    v[2] = [1.0, 1.0, 0.1]  # inside K_pow(a), any a
    v[3] = [-1.0, -1.0, 0.1]  # in the polar of K_pow(a)
    v[4] = [-1.0, -0.5, 2.0]  # the r, s <= 0 region of the exp projection
    return v, rng.normal(size=(B, 3))


def _spec(kind, a):
    return (kind, 3) if a is None else (kind, 3, a)


@pytest.fixture(scope="module")
def ref():
    """Pi, dense DPi, DPi dv and DPi' dv of the JAX package per kind, one jitted function per kind."""
    out = {}
    for i, (kind, a) in enumerate(KINDS):
        spec = jcones.ConeSpec([_spec(kind, a)])
        v, dv = _points(i)

        @jax.jit
        def f(v, dv, spec=spec):
            one = lambda u, d: (jcones.pi(spec, u), jcones.dpi_dense(spec, u), jcones.dpi_apply(spec, u, d),
                                jcones.dpi_rmatvec(spec, u, d))
            return jax.vmap(one)(v, dv)

        out[kind] = (v, dv, [np.asarray(t) for t in f(jnp.asarray(v), jnp.asarray(dv))])
    return out


def _newton_exp(kind, v):
    """Points where the exp-family projection takes its Newton branch."""
    u = torch.from_numpy(-v if kind == "exp" else v)
    cone, polar, special = tcones._exp_regions(u)
    return (~(cone | polar | special)).numpy()


@pytest.mark.parametrize("kind,a", KINDS)
def test_pi_and_dpi_match_the_jax_package(ref, kind, a):
    v, dv, (jp, jd, ja, jr) = ref[kind]
    spec = tcones.ConeSpec([_spec(kind, a)])
    tv, tdv = torch.from_numpy(v), torch.from_numpy(dv)
    np.testing.assert_allclose(tcones.pi(spec, tv).numpy(), jp, rtol=0, atol=TOL)
    tol = np.full((B, 1), TOL)
    if kind in ("exp", "dual_exp"):
        tol[_newton_exp(kind, v)] = TOL_EXP_NEWTON
    dense = tcones.dpi_dense(spec, tv).numpy()
    assert np.all(np.abs(dense - jd).reshape(B, -1).max(1, keepdims=True) <= tol)
    for got, want in ((tcones.dpi_apply(spec, tv, tdv), ja), (tcones.dpi_rmatvec(spec, tv, tdv), jr)):
        assert np.all(np.abs(got.numpy() - want).max(1, keepdims=True) <= tol)
    # the prepared operator gives the same blocks; apply and its transpose
    fa, fr = tcones.dpi_operator(spec, tv)
    np.testing.assert_allclose(fa(tdv).numpy(), tcones.dpi_apply(spec, tv, tdv).numpy(), rtol=0, atol=1e-14)
    np.testing.assert_allclose(fr(tdv).numpy(), tcones.dpi_rmatvec(spec, tv, tdv).numpy(), rtol=0, atol=1e-14)
    # autograd reaches Pi through the implicit derivative: backward = DPi' g, jvp = DPi dv
    t = tv.clone().requires_grad_()
    (tcones.pi(spec, t) * tdv).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), tcones.dpi_rmatvec(spec, tv, tdv).numpy(), rtol=0, atol=1e-14)
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        out = tcones.pi(spec, fwAD.make_dual(tv, tdv))
        np.testing.assert_allclose(fwAD.unpack_dual(out).tangent.numpy(), tcones.dpi_apply(spec, tv, tdv).numpy(),
                                   rtol=0, atol=1e-14)


def test_exp_derivative_formula_at_the_jax_point(ref):
    """The port's implicit derivative of the exp projection, at the JAX package's projected point,
    against the JAX DPi: the formula agrees to rounding; only the Newton root differs."""
    v, _, (_, jd, _, _) = ref["exp"]
    u = -v
    p = np.asarray(jax.vmap(jcones._proj_exp_primal)(jnp.asarray(u)))
    eye = torch.eye(3, dtype=torch.float64).expand(B, 3, 3)
    cols = tcones._exp_jvp(torch.from_numpy(u)[:, None, :], torch.from_numpy(p)[:, None, :], eye)
    D = np.eye(3) - np.swapaxes(cols.numpy(), 1, 2)
    np.testing.assert_allclose(D, jd, rtol=0, atol=1e-12)


def test_mixed_spec_and_membership():
    """A spec mixing symmetric and nonsymmetric blocks projects blockwise, and Pi(v) is in the dual cone
    (to 1e-8: a projected point lies on the boundary, where projecting it again takes the Newton branch,
    which the JAX package's projection also leaves 1e-9 off on these points)."""
    spec = tcones.ConeSpec([("soc", 3), ("exp", 3), ("pow", 3, 0.4), ("nonneg", 2)])
    v = torch.from_numpy(np.random.default_rng(9).normal(size=(6, 11)))
    p = tcones.pi(spec, v)
    assert bool(tcones.contains_dual(spec, p, tol=1e-8).all())
    parts = [tcones.pi(tcones.ConeSpec([b]), v[:, o:o + d]) for b, (_, o, d) in zip(spec.blocks, spec.offsets())]
    torch.testing.assert_close(p, torch.cat(parts, dim=-1), rtol=0, atol=0)
