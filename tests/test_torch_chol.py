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


# --- the Cholesky pair's launch rule (mirror of chol_team in csrc/chol.cu) -----------------


def _rule_table(n, k, itemsize):
    """chol_team of csrc/chol.cu written out as a table: the factor on one warp to 40 rows (two
    instances to a block), two warps to 64, eight past that; the solve on
    one warp per instance at k = 1, four to a block while their packed triangles fit 227 KB (f32 to
    n = 169, f64 to 120), then two (f32 to 240, f64 to 169), then one; at k = 16 a team of two
    warps, one instance to a block."""
    if k == 0:
        return (1, 2) if n <= 40 else (2, 1) if n <= 64 else (8, 1)
    if k == 16:
        return (2, 1)
    four, two = (169, 240) if itemsize == 4 else (120, 169)
    return (1, 4) if n <= four else (1, 2) if n <= two else (1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cholesky_launch_rule_takes_every_shape_and_is_monotone(dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    top = tchol.cholesky_max_n(dtype)
    for k in (0, 1, 16):
        threads = 0
        for n in range(1, top + 1):
            team, per = tchol.team_for(n, k, itemsize)
            assert (team, per) == _rule_table(n, k, itemsize), (n, k)
            assert tchol.team_takes(n, k, itemsize, team), (n, k, team)
            assert per == tchol.per_block_of(n, k, itemsize, team)
            assert tchol.smem_bytes(n, k, itemsize, team) <= tchol.MAX_SMEM_BYTES
            assert 32 * team >= threads  # never fewer warps per instance for a larger n
            threads = 32 * team
            if k == 0 and n <= 128:  # the factor's team holds n rows in its register tiles
                assert n <= tchol.tile_max_n(team)
    # the solve takes every n to 256 in f32, and its packed triangle is what bounds f64 (n <= 240)
    assert tchol.team_for(256, 1, 4) == (1, 1) and tchol.team_for(257, 1, 4) == (0, 0)
    assert tchol.team_for(240, 1, 8) == (1, 1) and tchol.team_for(241, 1, 8) == (0, 0)


def test_cholesky_envelope_unchanged():
    # the factor's envelope is what the shared-memory route past 128 rows holds, as before
    assert tchol.cholesky_max_n(torch.float32) == 240 and tchol.cholesky_max_n(torch.float64) == 169
    assert tchol.team_for(241, 0, 4) == (0, 0) and tchol.team_for(170, 0, 8) == (0, 0)
    assert tchol.team_for(129, 0, 4) == (8, 1)  # past 128 rows: eight warps


def test_cholesky_register_route_pinned():
    # the factor in eight warps' registers to 176 rows in f32 and 128 in f64, the shared-memory route past them
    assert tchol.chol_tile_max_n(8, 4) == 176 and tchol.chol_tile_max_n(8, 8) == 128
    assert [tchol.chol_tile_max_n(t, i) for t in (1, 2) for i in (4, 8)] == [40, 40, 64, 64]
    for n, itemsize in ((144, 4), (160, 4), (176, 4), (128, 8)):
        assert tchol.team_for(n, 0, itemsize) == (8, 1)
        assert tchol.smem_bytes(n, 0, itemsize, 8) == (n + 2 * tchol.chol_tile_max_n(8, itemsize)) * itemsize < 4096
    for n, itemsize in ((177, 4), (240, 4), (129, 8), (169, 8)):
        assert tchol.team_for(n, 0, itemsize) == (8, 1)
        assert tchol.smem_bytes(n, 0, itemsize, 8) == (n * (n | 1) + n) * itemsize  # the matrix in shared memory
    for team in (1, 2):  # the smaller teams' tiles as before; past them only eight warps
        top = tchol.chol_tile_max_n(team, 4)
        assert tchol.team_takes(top, 0, 4, team) and not tchol.team_takes(top + 1, 0, 4, team)


def test_cholesky_forced_launch_off_its_shape_raises_and_cpu_launches_nothing():
    H, rng = _spd(4, 64, seed=11)
    Ht = torch.from_numpy(H)
    rhs = torch.from_numpy(rng.normal(size=(4, 64)))
    for team in (1, 4, 3):  # one warp's tiles hold 40 rows; teams of 3 and 4 warps are not built
        with pytest.raises(ValueError):
            tchol.cholesky_batched(Ht, team=team)
    for team in (2, 8):  # one right-hand side: one warp
        with pytest.raises(ValueError):
            tchol.cholesky_solve_batched(Ht, rhs, team=team)
    for team in (1, 8):  # several right-hand sides: two warps
        with pytest.raises(ValueError):
            tchol.cholesky_solve_batched(Ht, rhs[..., None].expand(4, 64, 3), team=team)
    before = (tchol.cholesky_batched.launches, tchol.cholesky_solve_batched.launches,
              dict(tchol.cholesky_batched.launches_by_shape), dict(tchol.cholesky_solve_batched.launches_by_shape))
    # a launch that takes the shape runs the plain version on CPU tensors: the same result as the rule's
    L = tchol.cholesky_batched(Ht, team=8)
    assert torch.equal(L, tchol.cholesky_batched(Ht))
    x = tchol.cholesky_solve_batched(L, rhs, team=1)
    np.testing.assert_allclose(H @ x.numpy()[..., None], rhs.numpy()[..., None], rtol=0, atol=1e-10)
    after = (tchol.cholesky_batched.launches, tchol.cholesky_solve_batched.launches,
             dict(tchol.cholesky_batched.launches_by_shape), dict(tchol.cholesky_solve_batched.launches_by_shape))
    assert after == before


@pytest.fixture(scope="module")
def staged_schur_case():
    """The staged QP solver's Schur complement shape, n = p = 16 with k = p = 16 right-hand sides,
    factored and solved by the Pallas kernels (interpret mode) in one jitted call."""
    H, rng = _spd(8, 16, seed=16)
    rhs = rng.normal(size=(8, 16, 16))

    def both(h, r):
        L = jchol.cholesky_batched(h)
        return L, jchol.cholesky_solve_batched(L, r)

    Lj, xj = jax.jit(both)(jnp.asarray(H), jnp.asarray(rhs))
    return H, rhs, np.asarray(Lj), np.asarray(xj)


def test_cholesky_pair_plain_matches_pallas_at_the_staged_schur_shape(staged_schur_case):
    H, rhs, Lj, xj = staged_schur_case
    Lt = tchol.cholesky_batched(torch.from_numpy(H))
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=0, atol=1e-12)
    xt = tchol.cholesky_solve_batched(Lt, torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(H @ xt, rhs, rtol=0, atol=1e-11)


# --- the LDL' pair's launch rule (pure Python: the mirror of csrc/ldl.cu's ldl_team) -------------------------


def _ldl_factor_rule(N, itemsize):
    """The factor's team written from the C++ rule: one warp to 40 rows, two warps to 128 rows in f32 and
    64 in f64 (their register tiles), eight warps past that (registers to 176 rows in f32 and 128 in f64,
    shared memory beyond)."""
    return 1 if N <= 40 else 2 if N <= (128 if itemsize == 4 else 64) else 8


def _ldl_solve_rule(N, k):
    """The solve's team written from the C++ rule: at k = 1 one warp to 64 rows, four to 128, eight past
    that (one solves, the rest help to copy L); two warps for k > 1."""
    return (1 if N <= 64 else 4 if N <= 128 else 8) if k == 1 else 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ldl_launch_rule_takes_every_shape_with_the_smallest_team_and_is_monotone(dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    top = tchol.ldl_max_n(dtype)
    for k in (0, 1, 3):
        teams = tchol.FACTOR_TEAMS if k == 0 else tchol.LDL_SOLVE_TEAMS
        threads = 0
        for N in range(1, top + 1):
            team, per = tchol.ldl_team_for(N, k, itemsize)
            takers = [t for t in teams if tchol.ldl_team_takes(N, k, itemsize, t)]
            assert team in takers, (N, k, team, takers)
            if k == 0:  # the factor's smallest team that takes N
                assert team == takers[0], (N, team, takers)
            assert team == (_ldl_factor_rule(N, itemsize) if k == 0 else _ldl_solve_rule(N, k)), (N, k)
            assert per == tchol.ldl_per_block_of(N, k, itemsize, team) >= 1
            assert tchol.ldl_smem_bytes(N, k, itemsize, team) <= tchol.MAX_SMEM_BYTES
            assert 32 * team >= threads  # never fewer warps per instance for a larger N
            threads = 32 * team
            if k == 0 and N <= tchol.ldl_tile_max_n(8, itemsize):  # the team holds N rows in its register tiles
                assert N <= tchol.ldl_tile_max_n(team, itemsize)
    # the [main] path's N = 112 and [qp100]'s N = 172 in f32
    assert tchol.ldl_team_for(112, 0, 4)[0] == 2 and tchol.ldl_team_for(172, 0, 4) == (8, 1)
    assert tchol.ldl_team_for(112, 1, 4) == (4, 1) and tchol.ldl_team_for(172, 1, 4) == (8, 1)
    # one-warp solve instances packed for the most on an SM: one to a block at N = 32 would hold 32, four 64
    assert tchol.ldl_team_for(32, 1, 4) == (1, 4)


def test_ldl_envelope_pinned():
    # ops/kkt.py chooses LDL' against LU by this: the packed layouts would hold more, and must not move it
    assert tchol.ldl_max_n(torch.float32) == 239 and tchol.ldl_max_n(torch.float64) == 169
    for k in (0, 1, 16):
        assert tchol.ldl_team_for(239, k, 4)[0] and tchol.ldl_team_for(169, k, 8)[0]
        assert tchol.ldl_team_for(240, k, 4) == (0, 0) and tchol.ldl_team_for(170, k, 8) == (0, 0)
    assert tchol.ldl_team_for(129, 0, 4) == (8, 1) and tchol.ldl_team_for(177, 0, 4) == (8, 1)  # eight warps
    assert tchol.ldl_smem_bytes(176, 0, 4, 8) < 4096 < tchol.ldl_smem_bytes(177, 0, 4, 8)  # registers, then shared memory


def test_ldl_forced_launch_off_its_shape_raises_and_cpu_launches_nothing():
    K, rng = _quasi_definite(4, 48, seed=12)
    Kt = torch.from_numpy(K)
    rhs = torch.from_numpy(rng.normal(size=(4, 48)))
    for team in (1, 4, 3):  # one warp's tiles hold 40 rows; teams of 3 and 4 warps are not built
        with pytest.raises(ValueError):
            tchol.ldl_batched(Kt, team=team)
    for team in (3, 16):  # one right-hand side: 1, 2, 4 or 8 warps
        with pytest.raises(ValueError):
            tchol.ldl_solve_batched(Kt, Kt[:, 0], rhs, team=team)
    for team in (1, 8):  # several right-hand sides: two warps
        with pytest.raises(ValueError):
            tchol.ldl_solve_batched(Kt, Kt[:, 0], rhs[..., None].expand(4, 48, 3), team=team)
    K70, _ = _quasi_definite(2, 70, seed=13)
    with pytest.raises(ValueError):  # two warps hold 64 rows in f64
        tchol.ldl_batched(torch.from_numpy(K70), team=2)
    with pytest.raises(ValueError):  # past 128 rows only eight warps
        tchol.ldl_batched(torch.zeros(1, 130, 130, dtype=torch.float32), team=2)
    counts = lambda: (tchol.ldl_batched.launches, tchol.ldl_solve_batched.launches,
                      dict(tchol.ldl_batched.launches_by_shape), dict(tchol.ldl_solve_batched.launches_by_shape))
    before = counts()
    # a launch that takes the shape runs the plain version on CPU tensors: the same result as the rule's
    L, d = tchol.ldl_batched(Kt, team=8)
    Lr, dr = tchol.ldl_batched(Kt)
    assert torch.equal(L, Lr) and torch.equal(d, dr)
    x = tchol.ldl_solve_batched(L, d, rhs, team=1)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", K, x.numpy()), rhs.numpy(), rtol=0, atol=1e-9)
    assert counts() == before
