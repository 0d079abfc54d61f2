"""Port parity: the plain versions of the Cholesky and LDL' kernels
(``diffopt_tpu_torch.ops.cuda.chol``) against the Pallas kernels of the JAX
package in interpret mode, on the same numpy inputs, f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu.ops.pallas import chol as jchol
from diffopt_tpu_torch.ops.cuda import chol as tchol

torch.set_num_threads(1)


def _quasi_definite(B, N, seed):
    """Symmetric quasi-definite K = [[P, C'], [C, -R]] with P, R SPD."""
    rng = np.random.default_rng(seed)
    n1 = (N + 1) // 2
    n2 = N - n1
    mk = lambda k: (lambda L: L @ np.swapaxes(L, 1, 2) + k * np.eye(k))(rng.normal(size=(B, k, k)))
    C = rng.normal(size=(B, n2, n1))
    top = np.concatenate([mk(n1), np.swapaxes(C, 1, 2)], axis=2)
    bot = np.concatenate([C, -mk(n2)], axis=2)
    return np.concatenate([top, bot], axis=1), rng


_jax_factors = {}


def _jax_factor(N):
    """(K, rng, L, d) with the Pallas factor of K, computed once per N."""
    if N not in _jax_factors:
        K, rng = _quasi_definite(8, N, seed=N)
        Lj, dj = jax.jit(jchol.ldl_batched)(jnp.asarray(K))
        _jax_factors[N] = (K, rng, Lj, dj)
    return _jax_factors[N]


@pytest.mark.parametrize("N", [5, 12])
def test_ldl_factor_plain_matches_pallas(N):
    K, _, Lj, dj = _jax_factor(N)
    Lt, dt = tchol.ldl_batched(torch.from_numpy(K))
    # same elimination order in f64: agreement to rounding
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-10, atol=1e-12)
    # and it is a factorisation of K: unit-lower L, L D L' = K
    L = Lt.numpy()
    assert np.allclose(np.triu(L, 1), 0.0) and np.allclose(np.diagonal(L, axis1=1, axis2=2), 1.0)
    np.testing.assert_allclose(
        L @ (dt.numpy()[:, :, None] * np.swapaxes(L, 1, 2)), K, rtol=1e-10, atol=1e-10
    )


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("N", [5, 12])
def test_ldl_solve_plain_matches_pallas(N, k):
    K, rng, Lj, dj = _jax_factor(N)
    rhs = rng.normal(size=(8, N, k))
    xj = jax.jit(jchol.ldl_solve_batched)(Lj, dj, jnp.asarray(rhs))
    L, d = torch.tensor(np.asarray(Lj)), torch.tensor(np.asarray(dj))
    xt = tchol.ldl_solve_batched(L, d, torch.from_numpy(rhs))
    # same factor, same substitution order in f64: agreement to rounding
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(K @ xt.numpy(), rhs, rtol=1e-8, atol=1e-8)


def test_ldl_solve_vector_rhs_and_wrapper_routes_cpu_to_plain():
    K, rng = _quasi_definite(4, 7, seed=3)
    rhs = rng.normal(size=(4, 7))
    Kt = torch.from_numpy(K)
    before = (tchol.ldl_batched.launches, tchol.ldl_solve_batched.launches)
    L, d = tchol.ldl_batched(Kt)
    x = tchol.ldl_solve_batched(L, d, torch.from_numpy(rhs))
    assert x.shape == (4, 7)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", K, x.numpy()), rhs, rtol=1e-9, atol=1e-9)
    # a CPU tensor never launches a kernel
    assert (tchol.ldl_batched.launches, tchol.ldl_solve_batched.launches) == before


def test_ldl_envelope_and_shape_checks():
    assert tchol.ldl_max_n(torch.float32) >= 230
    assert 160 <= tchol.ldl_max_n(torch.float64) < tchol.ldl_max_n(torch.float32)
    with pytest.raises(ValueError):
        tchol.ldl_batched(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        tchol.ldl_solve_batched(torch.zeros(2, 3, 3), torch.zeros(2, 4), torch.zeros(2, 3))


# --- Cholesky pair -----------------------------------------------------------


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, n, n))
    return X @ np.swapaxes(X, 1, 2) + n * np.eye(n), rng


_jax_chol = {}


def _jax_cholesky(n):
    """(H, rng, L) with the Pallas Cholesky factor of H, computed once per n
    (n = 8 fits the kernel's tiling, n = 5 goes through its pad-to-8 path)."""
    if n not in _jax_chol:
        H, rng = _spd(8, n, seed=100 + n)
        _jax_chol[n] = (H, rng, jax.jit(jchol.cholesky_batched)(jnp.asarray(H)))
    return _jax_chol[n]


@pytest.mark.parametrize("n", [5, 8])
def test_cholesky_factor_plain_matches_pallas(n):
    H, _, Lj = _jax_cholesky(n)
    Lt = tchol.cholesky_batched(torch.from_numpy(H)).numpy()
    # same elimination order in f64: agreement to rounding
    np.testing.assert_allclose(Lt, np.asarray(Lj), rtol=0, atol=1e-12)
    # lower triangular with zeros above, and a factorisation of H
    assert np.array_equal(np.triu(Lt, 1), np.zeros_like(Lt))
    np.testing.assert_allclose(Lt @ np.swapaxes(Lt, 1, 2), H, rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_cholesky_solve_plain_matches_pallas(n, k):
    H, rng, Lj = _jax_cholesky(n)
    rhs = rng.normal(size=(8, n, k))
    xj = jax.jit(jchol.cholesky_solve_batched)(Lj, jnp.asarray(rhs))
    xt = tchol.cholesky_solve_batched(torch.tensor(np.asarray(Lj)), torch.from_numpy(rhs)).numpy()
    # same factor, same substitution order in f64: agreement to rounding
    np.testing.assert_allclose(xt, np.asarray(xj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(H @ xt, rhs, rtol=0, atol=1e-12)


def test_cholesky_not_positive_definite_gives_nan_and_no_exception():
    H, _ = _spd(4, 6, seed=7)
    H[1] = -H[1]  # first pivot negative: everything NaN
    H[2, 3, 3] = -50.0  # pivot 3 fails: columns 0..2 stay finite
    before = (tchol.cholesky_batched.launches, tchol.cholesky_solve_batched.launches)
    L = tchol.cholesky_batched(torch.from_numpy(H))
    fin = torch.isfinite(L)
    assert bool(fin[0].all() and fin[3].all())
    low = torch.tril(torch.ones(6, 6, dtype=torch.bool))
    assert not bool(fin[1][low].any())
    assert bool(fin[2][:, :3].all()) and not bool(fin[2][:, 3:][low[:, 3:]].any())
    assert bool((L[~low.expand_as(L)] == 0).all())  # zeros above the diagonal even there
    # a solve with such a factor is NaN throughout: what the solver's guard looks for
    x = tchol.cholesky_solve_batched(L, torch.ones(4, 6, dtype=torch.float64))
    assert x.shape == (4, 6)
    assert bool(torch.isnan(x[1]).all() and torch.isnan(x[2]).all() and torch.isfinite(x[0]).all())
    # the library route past the kernel's envelope leaves the same pattern
    Llib = tchol._cholesky_library(torch.from_numpy(H))
    assert torch.equal(torch.isfinite(Llib), fin)
    np.testing.assert_allclose(Llib[fin].numpy(), L[fin].numpy(), rtol=0, atol=1e-12)
    # a CPU tensor never launches a kernel
    assert (tchol.cholesky_batched.launches, tchol.cholesky_solve_batched.launches) == before


def test_cholesky_envelope_and_shape_checks():
    assert tchol.cholesky_max_n(torch.float32) >= 230
    assert 160 <= tchol.cholesky_max_n(torch.float64) < tchol.cholesky_max_n(torch.float32)
    # the sizes the staged solver uses at full width need little shared memory
    assert tchol._chol_factor_smem_bytes(64, 4) < 2048 and tchol._chol_solve_smem_bytes(64, 16, 4) < 24 * 1024
    with pytest.raises(ValueError):
        tchol.cholesky_batched(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        tchol.cholesky_solve_batched(torch.zeros(2, 3, 3), torch.zeros(2, 4))
