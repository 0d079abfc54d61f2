"""Port parity: ``diffopt_tpu_torch.ops.linalg`` against
``diffopt_tpu.ops.linalg`` on the same numpy systems, f64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu.ops import linalg as jlin
from diffopt_tpu_torch.ops import linalg as tlin
from diffopt_tpu_torch.utils.precision import residual_dtype

torch.set_num_threads(1)


def _systems(seed=0, B=3, n=6):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(B, n, n)) + 3.0 * np.eye(n)
    return M, rng.normal(size=(B, n)), rng.normal(size=(B, n, 2))


@pytest.mark.parametrize("method", ["lu", "qr", "lstsq"])
def test_solve_matches_jax(method):
    M, rv, rm = _systems()
    for rhs in (rv, rm):
        xj = jlin.solve(jnp.asarray(M), jnp.asarray(rhs), method)
        xt = tlin.solve(torch.from_numpy(M), torch.from_numpy(rhs), method)
        assert xt.shape == rhs.shape
        # well-conditioned 6 x 6 systems in f64; lstsq squares the condition number
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_singular_system_through_lstsq_matches_jax():
    M, rv, _ = _systems(seed=1)
    # rank n - 1 with an exactly representable null space (a zero row and
    # column), so that both sides drop the same eigenvalue of M'M
    M[:, -1, :] = 0.0
    M[:, :, -1] = 0.0
    rv[:, -1] = 0.0  # consistent right-hand side
    xj = np.asarray(jlin.solve(jnp.asarray(M), jnp.asarray(rv), "lstsq"))
    xt = tlin.solve(torch.from_numpy(M), torch.from_numpy(rv), "lstsq").numpy()
    # both drop the same null eigenvalue of M'M and return the minimum-norm solution
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", M, xt), rv, rtol=0, atol=1e-9)
    # LU on the singular system neither raises nor is finite; a ridge regularises lstsq
    assert not np.isfinite(tlin.solve(torch.from_numpy(M), torch.from_numpy(rv), "lu").numpy()).all()
    xr = tlin.solve(torch.from_numpy(M), torch.from_numpy(rv), "lstsq", ridge=1e-10).numpy()
    np.testing.assert_allclose(xr, np.asarray(jlin.solve(jnp.asarray(M), jnp.asarray(rv), "lstsq", ridge=1e-10)), atol=1e-6)


def test_callable_method_and_refine_match_jax():
    M, rv, _ = _systems(seed=2)
    # a deliberately sloppy inner solver: refinement must repair it on both sides alike
    sloppy_j = lambda A, r: 0.9 * jlin.lu_solve_dense(A, r)
    sloppy_t = lambda A, r: 0.9 * tlin.lu_solve_dense(A, r)
    for iters, tol in ((0, None), (3, 2e-3), (8, 2e-8)):
        xj = np.asarray(jlin.solve(jnp.asarray(M), jnp.asarray(rv), sloppy_j, refine_iters=iters))
        xt = tlin.solve(torch.from_numpy(M), torch.from_numpy(rv), sloppy_t, refine_iters=iters).numpy()
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)
        if tol is not None:  # the error shrinks by 10 x a pass
            exact = np.linalg.solve(M, rv[..., None])[..., 0]
            assert np.abs(xt - exact).max() < tol * np.abs(exact).max()
    with pytest.raises(ValueError, match="unknown solve method"):
        tlin.solve(torch.from_numpy(M), torch.from_numpy(rv), "cholesky")


def test_refine_accumulates_in_f64_and_tri_solve():
    M, rv, rm = _systems(seed=3)
    assert residual_dtype(torch.float32) == torch.float64 == residual_dtype(torch.float64)
    M32, r32 = torch.from_numpy(M).float(), torch.from_numpy(rv).float()
    x0 = tlin.solve(M32, r32, "lu")
    x2 = tlin.solve(M32, r32, "lu", refine_iters=2)
    assert x2.dtype == torch.float32
    exact = np.linalg.solve(M32.double().numpy(), r32.double().numpy()[..., None])[..., 0]
    e0, e2 = np.abs(x0.numpy() - exact).max(), np.abs(x2.numpy() - exact).max()
    # f64 residuals take the f32 solve to the f32 storage epsilon
    assert e2 <= e0 and e2 < 5e-7 * np.abs(exact).max()
    L = np.tril(M)
    for lower, trans, A in ((True, False, L), (True, True, np.swapaxes(L, 1, 2)),
                            (False, False, np.swapaxes(L, 1, 2)), (False, True, L)):
        tri = L if lower else np.swapaxes(L, 1, 2)
        xt = tlin.tri_solve(torch.from_numpy(tri.copy()), torch.from_numpy(rm), lower=lower, trans=trans).numpy()
        xj = np.asarray(jlin.tri_solve(jnp.asarray(tri), jnp.asarray(rm), lower=lower, trans=trans))
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)
        np.testing.assert_allclose(A @ xt, rm, rtol=0, atol=1e-11)
