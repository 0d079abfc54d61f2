"""Port parity of the differentiable rewrites (``bridges.py``): every rewrite
against the JAX package's on the same numpy inputs (f64; no solver, no Pallas
kernel), and ``qp_via_conic`` — the conic backend after the epigraph
lowering — against the port's QP backend and the reference's golden QP
gradients, with no JAX call, and against the JAX package's at tol=1e-11,
where both stop short of the QP backend's solution."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diffopt_tpu as dj
import diffopt_tpu_torch as dtt
from diffopt_tpu import bridges as jbridges
from diffopt_tpu_torch import bridges as tbridges
from diffopt_tpu_torch.utils.testing import make_batch

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).parent / "data"
QP_NAMES = ("Q", "q", "A", "b", "G", "h")


def _qp_data(seed, n=4, m=3, p=2, batch=()):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=batch + (n, n))
    return dict(Q=L @ np.swapaxes(L, -1, -2) + n * np.eye(n), q=rng.normal(size=batch + (n,)),
                A=rng.normal(size=batch + (p, n)), b=rng.normal(size=batch + (p,)),
                G=rng.normal(size=batch + (m, n)), h=rng.normal(size=batch + (m,)) + 1.0)


def _tq(data, grad=False):
    qp = dtt.convert.quadprogram_from_numpy(data, dtype=torch.float64, device="cpu")
    return qp.map(lambda t: t.requires_grad_()) if grad else qp


def _jq(data):
    return dj.QuadProgram(**{k: jnp.asarray(v) for k, v in data.items()})


def _close(t, j, atol=1e-12):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0, atol=atol)


def test_sign_and_bound_rewrites_match_jax():
    rng = np.random.default_rng(0)
    G, h, Q, q = rng.normal(size=(3, 4)), rng.normal(size=3), rng.normal(size=(4, 4)), rng.normal(size=4)
    for t, j in zip(tbridges.geq_to_leq(torch.tensor(G), torch.tensor(h)), jbridges.geq_to_leq(G, h)):
        _close(t, j, atol=0)
    for t, j in zip(tbridges.max_to_min(torch.tensor(Q), torch.tensor(q)), jbridges.max_to_min(Q, q)):
        _close(t, j, atol=0)
    lb, ub = [-1.0, -np.inf, 0.0, 2.0], [np.inf, 3.0, 1.0, np.inf]
    for t, j in zip(tbridges.bounds_to_rows(lb, ub, device="cpu"), jbridges.bounds_to_rows(lb, ub)):
        assert t.dtype == torch.float64 and t.device.type == "cpu"
        _close(t, j, atol=0)
    G0, h0 = tbridges.bounds_to_rows([-np.inf] * 3, [np.inf] * 3, device="cpu")
    assert G0.shape == (0, 3) and h0.shape == (0,)


@pytest.mark.parametrize("case", ["lp", "quadratic", "psd_singular", "batched"])
def test_qp_to_cone_matches_jax(case):
    data = _qp_data(1, batch=(3,) if case == "batched" else ())
    if case == "lp":
        data["Q"] = np.zeros_like(data["Q"])
    if case == "psd_singular":
        V = np.random.default_rng(7).normal(size=(4, 2))
        data["Q"] = V @ V.T  # rank 2
    tcp = tbridges.qp_to_cone(_tq(data))
    jcp = jbridges.qp_to_cone(_jq(data))
    assert tcp.cones.blocks == tuple((k, d, None) for k, d, *_ in jcp.cones.blocks)
    # the eigh route's U is fixed up to the sign of each eigenvector: compare U'U and the other rows
    n = 4
    rows = -n if case == "psd_singular" else None
    for name in ("A", "b", "c"):
        t, j = getattr(tcp, name), np.asarray(getattr(jcp, name))
        if rows is not None and name == "A":
            Ut, Uj = -t[rows:, :n].detach().numpy(), -j[rows:, :n]
            np.testing.assert_allclose(Ut.T @ Ut, Uj.T @ Uj, rtol=0, atol=1e-12)
            np.testing.assert_allclose(Ut.T @ Ut, data["Q"], rtol=0, atol=1e-12)
            t, j = t[:rows], j[:rows]
        _close(t, j)


def test_indefinite_q_raises():
    data = _qp_data(2)
    data["Q"] = np.diag([1.0, -1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="indefinite"):
        tbridges.qp_to_cone(_tq(data))


def test_quad_constraint_to_soc_and_cholesky_pair_match_jax():
    rng = np.random.default_rng(3)
    n = 5
    L = rng.normal(size=(n, n))
    Q = L @ L.T + n * np.eye(n)
    a, beta = rng.normal(size=n), 0.3
    t_rows = tbridges.quad_constraint_to_soc(torch.tensor(Q), torch.tensor(a), torch.tensor(beta, dtype=torch.float64))
    j_rows = jbridges.quad_constraint_to_soc(jnp.asarray(Q), jnp.asarray(a), jnp.asarray(beta))
    _close(t_rows[0], j_rows[0])
    _close(t_rows[1], j_rows[1])
    assert t_rows[2].blocks == (("soc", n + 2, None),)
    U = np.linalg.cholesky(Q).T
    dQr = rng.normal(size=(n, n))
    dQ, dUr = (dQr + dQr.T) / 2, np.triu(rng.normal(size=(n, n)))
    dU = tbridges.dU_from_dQ(torch.tensor(dQ), torch.tensor(U))
    _close(dU, jbridges.dU_from_dQ(jnp.asarray(dQ), jnp.asarray(U)), atol=1e-12)
    np.testing.assert_allclose(np.tril(dU.numpy(), -1), 0.0, atol=1e-12)
    np.testing.assert_allclose(dU.numpy().T @ U + U.T @ dU.numpy(), dQ, atol=1e-9)
    dQb = tbridges.dQ_from_dU(torch.tensor(dUr), torch.tensor(U))
    _close(dQb, jbridges.dQ_from_dU(jnp.asarray(dUr), jnp.asarray(U)), atol=1e-12)
    np.testing.assert_allclose(np.triu(dUr), 2 * np.triu(U @ dQb.numpy()), atol=1e-9)


@pytest.mark.parametrize("seed", [2, 3])
def test_qp_via_conic_matches_qp_backend(seed):
    """Solution and the gradient of sum(z**2) for every data tensor (Q through the Cholesky calculus) agree
    between the conic route after the lowering and the QP KKT route."""
    data = _qp_data(seed)
    qa, qb = _tq(data, grad=True), _tq(data, grad=True)
    sol_qp = dtt.solve_qp(qa, tol=1e-11)
    sol_cone = tbridges.qp_via_conic(qb, quadratic=True, tol=1e-11)
    for name, atol in (("z", 1e-6), ("lam", 1e-5), ("nu", 1e-5)):  # the JAX package's test's tolerances
        np.testing.assert_allclose(getattr(sol_cone, name).detach().numpy(), getattr(sol_qp, name).detach().numpy(),
                                   atol=atol, err_msg=name)
    (sol_qp.z**2).sum().backward()
    (sol_cone.z**2).sum().backward()
    for name in QP_NAMES:
        e = getattr(qa, name).grad.numpy()
        np.testing.assert_allclose(getattr(qb, name).grad.numpy(), e, atol=2e-5 * (1.0 + np.abs(e).max()),
                                   err_msg=name)


def test_qp_via_conic_stops_where_jax_does():
    """At tol=1e-11 the conic route ends at its floor, within a few 1e-6 of the QP backend's solution, in the
    JAX package as in the port: its stall exit stops some instances with residuals of 1e-10 or a little more,
    just past the converged test. On the draw that ``chip_smoke.py``'s [nlp-routes] holds on the card
    (``make_batch(8, 4, 3, 2)``, host generator seeded with 0) both packages end every instance with residuals
    under 1e-9 and their solutions part by less than 1e-6, so that much is what two f64 runs of the route that
    round differently may part by."""
    qp = make_batch(8, 4, 3, 2, torch.float64, "cpu", torch.Generator().manual_seed(0))
    n = qp.num_vars
    tz = tbridges.qp_via_conic(qp, quadratic=True, tol=1e-11).z
    tsol, tinfo = dtt.solve_conic(tbridges.qp_to_cone(qp, quadratic=True), tol=1e-11, with_info=True)
    assert torch.equal(tz, tsol.x[:, :n])  # qp_via_conic is this solve, sliced
    jsolve = jax.jit(jax.vmap(lambda q: dj.solve_conic(jbridges.qp_to_cone(q, quadratic=True), tol=1e-11,
                                                       with_info=True)))
    jsol, jinfo = jsolve(_jq({k: getattr(qp, k).numpy() for k in QP_NAMES}))
    jz = np.asarray(jsol.x)[:, :n]
    for info in (tinfo, jinfo):
        assert max(float(np.max(np.asarray(info.primal_residual))), float(np.max(np.asarray(info.dual_residual)))) < 1e-9
    ref = dtt.solve_qp(qp, tol=1e-11).z.numpy()
    tgap, jgap = np.abs(tz.numpy() - ref).max(1), np.abs(jz - ref).max(1)
    assert tgap.max() <= 1e-5 and jgap.max() <= 1e-5  # [nlp-routes]' hold against solve_qp
    np.testing.assert_allclose(tz.numpy(), jz, rtol=0, atol=1e-6)


def test_golden_file_qp_through_the_conic_route():
    """The reference's golden-file QP (10 variables, 25 inequalities, 10 equalities): the gradient of
    sum(z) through the conic route against the stored dq / dh at the golden tolerance (1e-3)."""
    ld = lambda f: np.loadtxt(DATA / f)
    qp = _tq(dict(Q=ld("P.txt"), q=ld("q.txt"), A=ld("A.txt"), b=ld("b.txt"), G=ld("G.txt"), h=ld("h.txt")),
             grad=True)
    sol = tbridges.qp_via_conic(qp, quadratic=True, tol=1e-11)
    sol.z.sum().backward()
    np.testing.assert_allclose(qp.q.grad.numpy(), ld("dq.txt"), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(qp.h.grad.numpy(), ld("dh.txt"), atol=1e-3, rtol=1e-3)
