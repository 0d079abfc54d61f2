"""Port parity of the Schur-coupled two-stage path (``parallel/schur.py``):
``solve_two_stage`` and the forward and reverse sensitivities against the JAX
package's on the same problem (f64, the shape of ``tests/test_schur.py``:
S = 6, n = 4, m = 3, p = 2, c = 3), and, with no JAX call, against the port's
own monolithic oracle (``to_monolithic`` + the staged QP solver and its
forward rule), the adjoint identity, a dense solve of the arrow system, and
the solver's best iterate past a breakdown of its factors.

The JAX calls (whose LDL' runs the Pallas kernels in interpret mode) run once
for the whole file, in one jitted function. On CPU tensors the port's LDL'
wrappers run their plain versions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffopt_tpu.parallel import schur as jschur
from diffopt_tpu_torch import QPTangent, forward_differentiate
from diffopt_tpu_torch.ops.cuda import chol
from diffopt_tpu_torch.parallel import schur
from diffopt_tpu_torch.solvers import qp as qpsolver

torch.set_num_threads(1)

FIELDS = ("Qs", "qs", "As", "bs", "Gs", "hs", "Bs", "Q0", "q0")
# the port against the JAX package: the same algorithm on the same inputs, other summation orders; relative to
# 1 + the largest entry of the JAX value (the readings are ~1e-15)
TOL_JAX = 1e-8
# the port against its monolithic oracle, as tests/test_schur.py holds the JAX package (two solvers that end on
# different iterates of the same tolerance)
TOL_MONO = 1e-6


def _two_stage(S=6, n=4, m=3, p=2, c=3, seed=0):
    """``tests/test_schur.py::_random_two_stage``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(S, n, n))
    L0 = rng.normal(size=(c, c))
    return dict(
        Qs=L @ np.transpose(L, (0, 2, 1)) + n * np.eye(n), qs=rng.normal(size=(S, n)), As=rng.normal(size=(S, p, n)),
        bs=rng.normal(size=(S, p)), Gs=rng.normal(size=(S, m, n)), hs=rng.normal(size=(S, m)) + 2.0,
        Bs=rng.normal(size=(S, p, c)), Q0=L0 @ L0.T + c * np.eye(c), q0=rng.normal(size=c),
    )


def _tangent(data, seed=8):
    """``tests/test_schur.py::_random_tangent``, as numpy arrays."""
    rng = np.random.default_rng(seed)
    S, n = data["qs"].shape
    p, m, c = data["bs"].shape[1], data["hs"].shape[1], data["q0"].shape[0]
    dQ = rng.normal(size=(S, n, n))
    dQ0 = rng.normal(size=(c, c))
    return dict(
        Qs=(dQ + np.transpose(dQ, (0, 2, 1))) / 2, qs=rng.normal(size=(S, n)), As=rng.normal(size=(S, p, n)),
        bs=rng.normal(size=(S, p)), Gs=rng.normal(size=(S, m, n)), hs=rng.normal(size=(S, m)),
        Bs=rng.normal(size=(S, p, c)), Q0=(dQ0 + dQ0.T) / 2, q0=rng.normal(size=c),
    )


def _port(arrays):
    return schur.TwoStageQP(**{k: torch.as_tensor(arrays[k]) for k in FIELDS})


@pytest.fixture(scope="module")
def case():
    """The problem, a tangent and seeds; the JAX package's solve, forward and reverse sensitivities (one jitted
    call); the port's, chained the same way."""
    data, dt = _two_stage(), _tangent(_two_stage())
    rng = np.random.default_rng(7)
    seed_x, seed_z = rng.normal(size=(6, 4)), rng.normal(size=3)

    @jax.jit
    def reference(t, d, sx, sz):
        sol, info = jschur.solve_two_stage(t)
        return (sol, info, jschur.two_stage_forward_sensitivity(t, sol, d),
                jschur.two_stage_reverse_sensitivity(t, sol, sx, sz))

    as_jax = lambda a: jschur.TwoStageQP(**{k: jnp.asarray(a[k]) for k in FIELDS})
    jsol, jinfo, jfwd, jrev = jax.tree.map(np.asarray, reference(as_jax(data), as_jax(dt), seed_x, seed_z))

    ts, dts = _port(data), _port(dt)
    sol, info = schur.solve_two_stage(ts)
    fwd = schur.two_stage_forward_sensitivity(ts, sol, dts)
    rev = schur.two_stage_reverse_sensitivity(ts, sol, torch.as_tensor(seed_x), torch.as_tensor(seed_z))
    return dict(ts=ts, dts=dts, seed_x=seed_x, seed_z=seed_z, jax=(jsol, jinfo, jfwd, jrev), port=(sol, info, fwd, rev))


def _close(port, ref, tol, what):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    err = float(np.abs(port - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), (what, err)


def test_solve_two_stage_matches_jax(case):
    jsol, jinfo, _, _ = case["jax"]
    sol, info, _, _ = case["port"]
    assert bool(info.converged) and bool(jinfo.converged)
    assert int(info.iterations) == int(jinfo.iterations)
    for name in ("xs", "lams", "nus", "z"):
        _close(getattr(sol, name), getattr(jsol, name), TOL_JAX, name)
    for name in ("primal_residual", "dual_residual", "duality_gap"):
        _close(getattr(info, name), getattr(jinfo, name), TOL_JAX, name)


def test_forward_sensitivity_matches_jax(case):
    jfwd, fwd = case["jax"][2], case["port"][2]
    for name in ("xs", "lams", "nus", "z"):
        _close(getattr(fwd, name), getattr(jfwd, name), TOL_JAX, name)


def test_reverse_sensitivity_matches_jax(case):
    jrev, rev = case["jax"][3], case["port"][3]
    for name in FIELDS:
        _close(getattr(rev, name), getattr(jrev, name), TOL_JAX, name)


def _monolithic(ts):
    """The port's monolithic oracle: the flattened QP through the staged solver, split back into scenarios."""
    S, n, m, p, c = ts.dims
    qp = schur.to_monolithic(ts)
    sol, info = qpsolver.solve(qp)
    assert bool(info.converged)
    split = schur.TwoStageSolution(xs=sol.z[: S * n].reshape(S, n), lams=sol.lam.reshape(S, m),
                                   nus=sol.nu.reshape(S, p), z=sol.z[S * n :])
    return qp, sol, split


def test_solve_two_stage_matches_monolithic(case):
    _, _, ref = _monolithic(case["ts"])
    sol = case["port"][0]
    for name in ("xs", "lams", "nus", "z"):
        assert float((getattr(sol, name) - getattr(ref, name)).abs().max()) <= TOL_MONO, name


def test_forward_sensitivity_matches_monolithic(case):
    ts, dts = case["ts"], case["dts"]
    S, n, m, p, c = ts.dims
    qp, sol, split = _monolithic(ts)
    d = schur.to_monolithic(dts)
    mono = forward_differentiate(qp, sol, QPTangent(dQ=d.Q, dq=d.q, dA=d.A, db=d.b, dG=d.G, dh=d.h))
    fwd = schur.two_stage_forward_sensitivity(ts, split, dts)
    for name, a, b in (("xs", fwd.xs.reshape(-1), mono.dz[: S * n]), ("z", fwd.z, mono.dz[S * n :]),
                       ("lams", fwd.lams.reshape(-1), mono.dlam), ("nus", fwd.nus.reshape(-1), mono.dnu)):
        assert float((a - b).abs().max()) <= TOL_MONO, name


def test_reverse_adjoint_identity(case):
    """<fwd(dData), seeds> == <dData, rev(seeds)> for the coupled program."""
    dts = case["dts"]
    _, _, fwd, rev = case["port"]
    seed_x, seed_z = torch.as_tensor(case["seed_x"]), torch.as_tensor(case["seed_z"])
    lhs = float((fwd.xs * seed_x).sum() + fwd.z @ seed_z)
    rhs = float(sum((getattr(dts, f) * getattr(rev, f)).sum() for f in FIELDS))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs)), (lhs, rhs)


def test_schur_arrow_solve_matches_dense(monkeypatch):
    """The arrow solve against a dense solve of the whole system; one LDL' factor at N = nb and solves with
    k = c, 1 and 1 right-hand sides."""
    rng = np.random.default_rng(11)
    S, nb, c = 5, 6, 3
    M = rng.normal(size=(S, nb, nb))
    Kloc = M @ np.transpose(M, (0, 2, 1)) + nb * np.eye(nb)
    Kloc[:, 4:, 4:] *= -1.0  # quasi-definite: a negative definite trailing block
    Kloc[:, 4:, :4] = rng.normal(size=(S, 2, 4))
    Kloc[:, :4, 4:] = np.transpose(Kloc[:, 4:, :4], (0, 2, 1))
    C = rng.normal(size=(S, nb, c))
    K0 = 50.0 * np.eye(c)
    rloc, r0 = rng.normal(size=(S, nb)), rng.normal(size=c)
    dense = np.zeros((S * nb + c, S * nb + c))
    for s in range(S):
        dense[s * nb : (s + 1) * nb, s * nb : (s + 1) * nb] = Kloc[s]
        dense[s * nb : (s + 1) * nb, S * nb :] = C[s]
        dense[S * nb :, s * nb : (s + 1) * nb] = C[s].T
    dense[S * nb :, S * nb :] = K0
    ref = np.linalg.solve(dense, np.concatenate([rloc.reshape(-1), r0]))

    calls = []
    factor, solve = chol.ldl_batched, chol.ldl_solve_batched
    monkeypatch.setattr(chol, "ldl_batched", lambda K: calls.append(("factor", tuple(K.shape))) or factor(K))
    monkeypatch.setattr(chol, "ldl_solve_batched",
                        lambda L, d, r: calls.append(("solve", tuple(r.shape))) or solve(L, d, r))
    xloc, x0 = schur.schur_arrow_solve(*(torch.as_tensor(a) for a in (Kloc, C, K0, rloc, r0)))
    assert calls == [("factor", (S, nb, nb)), ("solve", (S, nb, c)), ("solve", (S, nb)), ("solve", (S, nb))]
    np.testing.assert_allclose(xloc.numpy().reshape(-1), ref[: S * nb], atol=1e-12)
    np.testing.assert_allclose(x0.numpy(), ref[S * nb :], atol=1e-12)


@pytest.mark.parametrize("broken_from", [2, 3, 4])
def test_solve_two_stage_returns_best_iterate(case, monkeypatch, broken_from):
    """Past a breakdown the solver returns its best iterate, not its last. From body ``broken_from`` on, one pivot
    of every factor changes sign (as the unpivoted LDL' does once lam/s passes about 1/eps): the updates stay
    finite but leave the central path, the loop runs to ``max_iters``, and the result is, bit for bit, that of the
    bodies before the breakdown."""
    ts = case["ts"]
    before, info_before = schur.solve_two_stage(ts, max_iters=broken_from - 1)
    factor, calls = chol.ldl_batched, []

    def broken(K):
        L, d = factor(K)
        calls.append(None)
        if len(calls) > 1 + 2 * (broken_from - 1):  # the starting point's factor, then two a body
            d = d.clone()
            d[0, 0] = -d[0, 0]
        return L, d

    monkeypatch.setattr(chol, "ldl_batched", broken)
    sol, info = schur.solve_two_stage(ts, max_iters=12)
    assert int(info.iterations) == 12 and not bool(info.converged)
    for name, a, b in zip(schur.TwoStageSolution._fields, sol, before):
        assert torch.equal(a, b), name
    for name in ("primal_residual", "dual_residual", "duality_gap"):
        assert torch.equal(getattr(info, name), getattr(info_before, name)), name
