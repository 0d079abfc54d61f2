"""Port parity of the staged nonsymmetric-cone IPM (``solvers/conic_nsipm.py::solve_batched``) against
the JAX package's ``conic_nsipm.solve_batched`` (its vmapped solver, autodiff barriers), f64, on the same
numpy inputs, on two layouts the fused kernel does not take:

equality-free (``p == 0``), with a psd block and a dual_exp block:
``min u s.t. (u, beta, gamma) in K_exp*, 2 I + u G >= 0`` (one JAX compile feeds the file).

Both solvers meet the f64 tolerance (1e-8) on every instance. The two take the same steps through the
first bodies (x to 3e-13 through 14 bodies, the gap down to 1e-4); then, the dual-scaling Hessian
conditioning like 1/mu^2, the closed-form barriers' rounding and JAX's autodiff barriers' part until a
grid step of a line search flips (body 15 or 16 here), after which the runs end on different iterates
within the tolerance, here two or three bodies apart (the port's the earlier). So the solutions are
compared to 1e-6 relative and the iteration counts to within three. Also the routing of
``solve_batched_fused`` by shape and of ``conic_ipm.solve_batched_fused``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu as dj
from diffopt_tpu.solvers import conic_nsipm as jns
from diffopt_tpu_torch import ConeProgram, ConeSpec
from diffopt_tpu_torch.ops.cuda import ns_pdip
from diffopt_tpu_torch.solvers import conic_ipm as tipm
from diffopt_tpu_torch.solvers import conic_nsipm as tns
from diffopt_tpu_torch.utils.testing import make_entropy_batch

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

SOL_TOL = 1e-6


def _batch():
    """``min u s.t. (u, beta, gamma) in K_exp*, svec(2 I + u G) in PSD`` (side 2), B = 3: no equality row
    (p == 0), a psd block and an ns block — the layouts only the staged solver takes."""
    rng = np.random.default_rng(11)
    B = 3
    G = 0.3 * rng.normal(size=(B, 2, 2))
    G = (G + np.swapaxes(G, -1, -2)) / 2
    svec = lambda X: np.stack([X[..., 0, 0], np.sqrt(2) * X[..., 0, 1], X[..., 1, 1]], -1)
    A = np.zeros((B, 6, 1))
    A[:, 0, 0] = -1.0
    A[:, 3:, 0] = -svec(G)
    b = np.concatenate([np.zeros((B, 1)), rng.uniform(0.5, 2.0, (B, 2)), np.broadcast_to(svec(2 * np.eye(2)), (B, 3))], 1)
    return A, b, np.ones((B, 1)), [("dual_exp", 3), ("psd", 3)]


BATCHES = {"p0_psd_exp": _batch}


@pytest.fixture(scope="module")
def ref():
    out = {}
    for name, make in BATCHES.items():
        A, b, c, blocks = make()
        spec = dj.ConeSpec(blocks)
        sol, info = jax.jit(lambda A_, b_, c_: jns.solve_batched(dj.ConeProgram(A=A_, b=b_, c=c_, cones=spec)))(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
        out[name] = ((A, b, c, blocks), [np.asarray(t) for t in (sol.x, sol.y, sol.s)],
                     [np.asarray(t) for t in info])
    return out


def _rel(a, b):
    return np.abs(np.asarray(a) - b).max(-1) / (1.0 + np.abs(b).max(-1))


@pytest.mark.parametrize("name", list(BATCHES))
def test_staged_solver_matches_the_jax_package(ref, name):
    (A, b, c, blocks), jsol, jinfo = ref[name]
    cp = ConeProgram(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (A, b, c)), ConeSpec(blocks))
    sol, info = tns.solve_batched(cp)
    assert bool(info.converged.all()) and bool(jinfo[4].all())
    for k, got, want in zip("xys", sol.tensors(), jsol):
        assert _rel(got, want).max() <= SOL_TOL, k
    assert np.abs(info.iterations.numpy() - jinfo[0]).max() <= 3
    assert info.iterations.dtype == torch.int32
    # by shape, the fused route sends the layout to the staged solver (p == 0, a psd block)
    launches = ns_pdip.solve_tile_fused_ns.launches
    fsol, finfo = tns.solve_batched_fused(cp)
    torch.testing.assert_close(fsol.x, sol.x, rtol=0, atol=0)
    assert torch.equal(finfo.iterations, info.iterations) and ns_pdip.solve_tile_fused_ns.launches == launches
    # so does the symmetric-cone IPM's fused route, for programs with exp blocks
    isol, _ = tipm.solve_batched_fused(cp)
    torch.testing.assert_close(isol.x, sol.x, rtol=0, atol=0)
    # one instance without a batch dimension
    one, oi = tns.solve(cp.map(lambda t: t[0]))
    assert one.x.shape == sol.x.shape[1:] and oi.iterations.shape == ()
    torch.testing.assert_close(one.x, sol.x[0], rtol=0, atol=1e-12)


def test_rejects_unknown_and_equality_only_and_routes_the_fused_kernel():
    z = torch.zeros(1, 2, 1, dtype=torch.float64)
    with pytest.raises(ValueError):
        tns.solve_batched(ConeProgram(z, z[..., 0], z[:, 0], ConeSpec([("zero", 2)])))
    assert tns.supports(ConeSpec([("exp", 3), ("psd", 3)])) and tns.has_nonsymmetric(ConeSpec([("pow", 3, 0.2)]))
    assert not tns.has_nonsymmetric(ConeSpec([("soc", 3)]))
    # inside the envelope with an equality row, a 2-D batch takes the fused kernel (its plain version here)
    cp = make_entropy_batch(3, k=2, seed=5, dtype=torch.float64, device="cpu")
    fsol, finfo = tns.solve_batched_fused(cp)
    x, *_ = ns_pdip.solve_tile_fused_ns_plain(
        cp.c, cp.b[:, :1], cp.b[:, 1:], cp.A[:, :1], cp.A[:, 1:], (1, 0, (), (("exp", None),) * 2),
        max_iters=150, tol=1e-8, reg=1e-11, eps=1e-15)
    torch.testing.assert_close(fsol.x, x, rtol=0, atol=0)
    assert bool(finfo.converged.all())
