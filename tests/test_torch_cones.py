"""Port parity of the symmetric cones: Pi and DPi (dense, apply, rmatvec,
prepared operator) per kind, the svec helpers, membership and the Jacobi
eigensolver, against ``diffopt_tpu.cones`` / ``diffopt_tpu.ops.smalleig`` on
the same numpy inputs, f64 (agreement to 1e-12; the PSD blocks go through
the same cyclic Jacobi on both sides). The exp/pow kinds are held against the
JAX package in ``test_torch_ns_cones.py``; here, that a spec mixing them with
the symmetric kinds projects and differentiates blockwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu import cones as jcones
from diffopt_tpu.ops import smalleig as jsmalleig
from diffopt_tpu_torch import cones as tcones
from diffopt_tpu_torch.ops import smalleig as tsmalleig

torch.set_num_threads(1)

B = 5
KINDS = [("zero", 3), ("nonneg", 4), ("nonpos", 4), ("soc", 5), ("rsoc", 4), ("psd", 3)]
TOL = 1e-12


def _v(kind, d, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, d))
    if kind in ("soc", "rsoc"):  # one instance in each regime: inside, polar, boundary
        v[0, 0] = np.linalg.norm(v[0, 1:]) + 1.0
        v[1, 0] = -np.linalg.norm(v[1, 1:]) - 1.0
    return v, rng.normal(size=(B, d))


@pytest.fixture(scope="module")
def jax_ref():
    """Pi, dense DPi, DPi dv and DPi' dv of the JAX package per kind, one jitted function per kind."""
    out = {}
    for kind, d in KINDS:
        spec = jcones.ConeSpec([(kind, d)])

        def one(v, dv, spec=spec):
            return (jcones.pi(spec, v), jcones.dpi_dense(spec, v), jcones.dpi_apply(spec, v, dv),
                    jcones.dpi_rmatvec(spec, v, dv))

        v, dv = _v(kind, d, 7)
        out[kind] = [np.asarray(a) for a in jax.jit(jax.vmap(one))(jnp.asarray(v), jnp.asarray(dv))]
    return out


@pytest.mark.parametrize("kind,d", KINDS)
def test_pi_and_dpi_match_jax(jax_ref, kind, d):
    v, dv = _v(kind, d, 7)
    spec = tcones.ConeSpec([(kind, d)])
    tv, tdv = torch.from_numpy(v), torch.from_numpy(dv)
    jpi, jdense, japply, jrmat = jax_ref[kind]
    np.testing.assert_allclose(tcones.pi(spec, tv).numpy(), jpi, rtol=0, atol=TOL)
    dense = tcones.dpi_dense(spec, tv)
    np.testing.assert_allclose(dense.numpy(), jdense, rtol=0, atol=TOL)
    np.testing.assert_allclose(tcones.dpi_apply(spec, tv, tdv).numpy(), japply, rtol=0, atol=TOL)
    np.testing.assert_allclose(tcones.dpi_rmatvec(spec, tv, tdv).numpy(), jrmat, rtol=0, atol=TOL)
    apply, rapply = tcones.dpi_operator(spec, tv)
    np.testing.assert_allclose(apply(tdv).numpy(), japply, rtol=0, atol=TOL)
    np.testing.assert_allclose(rapply(tdv).numpy(), jrmat, rtol=0, atol=TOL)
    # the dense block is the operator: DPi @ dv
    np.testing.assert_allclose((dense @ tdv[..., None])[..., 0].numpy(), japply, rtol=0, atol=1e-11)


def test_product_spec_and_membership_match_jax():
    blocks = [k for k in KINDS]
    m = sum(d for _, d in blocks)
    rng = np.random.default_rng(3)
    v, dv = rng.normal(size=(B, m)), rng.normal(size=(B, m))
    jspec, tspec = jcones.ConeSpec(blocks), tcones.ConeSpec(blocks)
    assert tspec.blocks == jspec.blocks and tspec.total_dim == jspec.total_dim == m
    assert list(tspec.offsets_params()) == list(jspec.offsets_params())
    tv = torch.from_numpy(v)
    ref = jax.jit(jax.vmap(lambda a, b: (jcones.pi(jspec, a), jcones.dpi_apply(jspec, a, b), jcones.contains_dual(jspec, a))))
    jpi, japply, jin = (np.asarray(x) for x in ref(jnp.asarray(v), jnp.asarray(dv)))
    np.testing.assert_allclose(tcones.pi(tspec, tv).numpy(), jpi, rtol=0, atol=TOL)
    apply, _ = tcones.dpi_operator(tspec, tv)
    np.testing.assert_allclose(apply(torch.from_numpy(dv)).numpy(), japply, rtol=0, atol=TOL)
    # projections lie in the dual cone; a generic point does not
    inside = tcones.contains_dual(tspec, tcones.pi(tspec, tv))
    assert bool(inside.all())
    assert np.array_equal(tcones.contains_dual(tspec, tv).numpy(), jin)


def test_svec_helpers_match_jax():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(B, 4, 4))
    X = M + np.swapaxes(M, 1, 2)
    u = np.asarray(jcones.sym_to_svec(jnp.asarray(X)))
    np.testing.assert_allclose(tcones.sym_to_svec(torch.from_numpy(X)).numpy(), u, rtol=0, atol=1e-15)
    np.testing.assert_allclose(tcones.svec_to_sym(torch.from_numpy(u)).numpy(), X, rtol=0, atol=1e-14)
    for name in ("moi_tri_to_svec", "svec_to_moi_tri", "moi_tri_seed_to_svec"):
        ref = np.asarray(getattr(jcones, name)(jnp.asarray(u)))
        np.testing.assert_allclose(getattr(tcones, name)(torch.from_numpy(u)).numpy(), ref, rtol=0, atol=1e-15, err_msg=name)
    assert [tuple(r) for r in tcones._tri_order(3)] == [tuple(r) for r in jcones._tri_order(3)]
    with pytest.raises(ValueError, match="triangle"):
        tcones.ConeSpec([("psd", 5)])


@pytest.mark.parametrize("side", [1, 3, 5])
def test_jacobi_eigh_matches_jax(side):
    rng = np.random.default_rng(side)
    M = rng.normal(size=(B, side, side))
    A = M + np.swapaxes(M, 1, 2)
    jw, jV = (np.asarray(a) for a in jax.jit(jsmalleig.jacobi_eigh)(jnp.asarray(A)))
    tw, tV = tsmalleig.jacobi_eigh(torch.from_numpy(A))
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tV.numpy(), jV, rtol=0, atol=1e-11)
    w_only, none = tsmalleig.jacobi_eigh(torch.from_numpy(A), vectors=False)
    assert none is None and torch.equal(w_only, tw)
    # past the Jacobi sides the library eigensolver takes over, as in the JAX module
    big = torch.from_numpy(np.eye(13) * 2.0)
    assert torch.allclose(tsmalleig.eigvalsh_small(big), torch.full((13,), 2.0, dtype=torch.float64))


def test_nonsymmetric_kinds_are_metadata_and_raise_naming_their_slice():
    """The exp/pow kinds carry their exponent as the JAX spec does, and every verb takes them (the
    slice that brings them is in): Pi, DPi applied, dense and prepared agree blockwise."""
    spec = tcones.ConeSpec([("exp", 3), ("pow", 3, 0.3), ("soc", 3)])
    assert spec.blocks == jcones.ConeSpec([("exp", 3), ("pow", 3, 0.3), ("soc", 3)]).blocks
    rng = np.random.default_rng(4)
    v, dv = (torch.from_numpy(rng.normal(size=(2, 9))) for _ in range(2))
    p = tcones.pi(spec, v)
    D = tcones.dpi_dense(spec, v)
    fa, fr = tcones.dpi_operator(spec, v)
    np.testing.assert_allclose(tcones.dpi_apply(spec, v, dv).numpy(), (D @ dv[..., None])[..., 0].numpy(), atol=1e-14)
    np.testing.assert_allclose(fa(dv).numpy(), tcones.dpi_apply(spec, v, dv).numpy(), atol=1e-14)
    np.testing.assert_allclose(fr(dv).numpy(), (D.transpose(1, 2) @ dv[..., None])[..., 0].numpy(), atol=1e-14)
    for k, (_, off, d) in enumerate(spec.offsets()):
        one = tcones.ConeSpec([spec.blocks[k]])
        np.testing.assert_allclose(p[:, off:off + d].numpy(), tcones.pi(one, v[:, off:off + d]).numpy(), atol=0)
    with pytest.raises(ValueError, match="exponent"):
        tcones.ConeSpec([("pow", 3)])
