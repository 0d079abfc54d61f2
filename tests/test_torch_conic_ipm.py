"""Port parity of the staged conic IPM: ``diffopt_tpu_torch.solvers.conic_ipm
.solve_batched`` against ``diffopt_tpu.solvers.conic_ipm.solve_batched`` (the
``vmap`` of the per-instance solver, its Pallas LDL' and Cholesky kernels in
interpret mode) on the same numpy inputs, f64: the quasi-definite LDL' route
(N <= 128) on a layout with every symmetric kind but psd, and the condensed
Cholesky route (N > 128). Solutions agree to 1e-8, iteration counts and flags
exactly. (A psd block would add a quarter of a minute of JAX compile time;
the staged psd path is held against the fused one below, whose plain version
test_torch_conic_pdip.py holds against the Pallas kernel, and the psd cone
algebra against the JAX package in test_torch_cones.py.) Also the fused
entry's route by shape and the kinds that wait for a later slice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu as dj
from diffopt_tpu.solvers import conic_ipm as jipm
from diffopt_tpu_torch.cones import ConeSpec
from diffopt_tpu_torch.ir import ConeProgram
from diffopt_tpu_torch.solvers import conic_ipm as tipm

torch.set_num_threads(1)

B = 3
ROUTES = {
    "ldl": (3, [("zero", 1), ("nonneg", 2), ("nonpos", 1), ("soc", 3), ("rsoc", 3)]),
    "condensed": (2, [("zero", 1), ("nonneg", 127)]),
}


def _interior(rng, kind, d):
    if kind == "nonneg":
        return rng.uniform(0.5, 1.5, size=(B, d))
    if kind == "nonpos":
        return -rng.uniform(0.5, 1.5, size=(B, d))
    if kind == "soc":
        t = rng.normal(size=(B, d))
        t[:, 0] = np.linalg.norm(t[:, 1:], axis=1) + 1.0
        return t
    if kind == "rsoc":  # 2 t u >= ||x||^2
        t = rng.normal(size=(B, d))
        t[:, 0] = 1.0 + (t[:, 2:] ** 2).sum(1)
        t[:, 1] = 1.0
        return t
    side = int(round(((8 * d + 1) ** 0.5 - 1) / 2))
    M = rng.normal(size=(B, side, side))
    S = M @ np.swapaxes(M, 1, 2) + side * np.eye(side)
    return np.stack([S[:, r, c] * (1.0 if r == c else np.sqrt(2.0)) for c in range(side) for r in range(c + 1)], 1)


def conic_batch(n, blocks, seed):
    """A strictly feasible, bounded batch (b from an interior slack, c from an interior dual), numpy."""
    rng = np.random.default_rng(seed)
    m = sum(d for _, d in blocks)
    A, x0 = rng.normal(size=(B, m, n)), rng.normal(size=(B, n))
    s0 = np.concatenate([np.zeros((B, d)) if k == "zero" else _interior(rng, k, d) for k, d in blocks], 1)
    y0 = np.concatenate([rng.normal(size=(B, d)) if k == "zero" else _interior(rng, k, d) for k, d in blocks], 1)
    return A, np.einsum("bij,bj->bi", A, x0) + s0, -np.einsum("bij,bi->bj", A, y0)


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for route, (n, blocks) in ROUTES.items():
        A, b, c = conic_batch(n, blocks, 11)
        jcp = dj.ConeProgram(A=jnp.asarray(A), b=jnp.asarray(b), c=jnp.asarray(c), cones=dj.ConeSpec(blocks))
        sol, info = jax.jit(jipm.solve_batched)(jcp)
        out[route] = ({k: np.asarray(getattr(sol, k)) for k in "xys"}, {k: np.asarray(v) for k, v in info._asdict().items()})
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_staged_solver_matches_jax(jax_results, route):
    n, blocks = ROUTES[route]
    A, b, c = conic_batch(n, blocks, 11)
    cp = ConeProgram(*(torch.from_numpy(a) for a in (A, b, c)), ConeSpec(blocks))
    assert (cp.num_vars + cp.num_rows <= 128) == (route == "ldl")
    sol, info = tipm.solve_batched(cp)
    jsol, jinfo = jax_results[route]
    for k in "xys":
        np.testing.assert_allclose(getattr(sol, k).numpy(), jsol[k], rtol=0, atol=1e-8, err_msg=k)
    np.testing.assert_array_equal(info.iterations.numpy(), jinfo["iterations"])
    np.testing.assert_array_equal(info.converged.numpy(), jinfo["converged"])
    assert bool(info.converged.all())
    for k in ("primal_residual", "dual_residual", "gap"):
        # residuals of two f64 solves that met tol = 1e-9: equal to a tenth of it
        np.testing.assert_allclose(getattr(info, k).numpy(), jinfo[k], rtol=0, atol=1e-10 if k == "gap" else 1e-9, err_msg=k)


def test_fused_entry_routes_by_shape_and_unported_kinds_raise():
    # inside K6's envelope the fused entry runs the fused algorithm (on the CPU: its plain version);
    # with a psd block both IPMs reach the same solution
    n, blocks = 3, ROUTES["ldl"][1] + [("psd", 6)]
    A, b, c = conic_batch(n, blocks, 11)
    cp = ConeProgram(*(torch.from_numpy(a) for a in (A, b, c)), ConeSpec(blocks))
    sol, info = tipm.solve_batched_fused(cp)
    ref, rinfo = tipm.solve_batched(cp)
    assert bool(info.converged.all()) and bool(rinfo.converged.all())
    np.testing.assert_allclose(sol.x.numpy(), ref.x.numpy(), rtol=0, atol=1e-7)
    # past it (N > 128) the staged solver takes the batch: the same answer as calling it
    n, blocks = ROUTES["condensed"]
    A, b, c = conic_batch(n, blocks, 12)
    cp = ConeProgram(*(torch.from_numpy(a) for a in (A, b, c)), ConeSpec(blocks))
    f, fi = tipm.solve_batched_fused(cp)
    s, si = tipm.solve_batched(cp)
    assert torch.equal(f.x, s.x) and torch.equal(fi.iterations, si.iterations)
    # one instance without a batch dimension
    one, oi = tipm.solve(cp.map(lambda t: t[0]))
    assert one.x.shape == (n,) and oi.iterations.shape == ()
    np.testing.assert_allclose(one.x.numpy(), s.x[0].numpy(), rtol=0, atol=1e-10)
    # exp/pow blocks and equality-only programs name the slice that brings them
    z = torch.zeros(1, 3, 1, dtype=torch.float64)
    for spec in (ConeSpec([("exp", 3)]), ConeSpec([("zero", 3)])):
        with pytest.raises(NotImplementedError, match="K7"):
            tipm.solve_batched_fused(ConeProgram(z, z[..., 0], z[:, 0], spec))
