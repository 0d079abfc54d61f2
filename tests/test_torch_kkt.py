"""Port parity: ``diffopt_tpu_torch.ops.kkt`` and ``solvers.qp.kkt_metrics``
against their JAX counterparts under ``vmap``; the same numpy problem and the
same solution are fed to both sides, f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu_torch as dtt
from diffopt_tpu import QPSolution, QuadProgram
from diffopt_tpu.ops import kkt as jkkt
from diffopt_tpu.solvers import qp as jqp
from diffopt_tpu_torch.ops import kkt as tkkt
from diffopt_tpu_torch.solvers import qp as tqp

torch.set_num_threads(1)

B, n, m, p = 8, 5, 2, 1  # n + m + p = 8: the Pallas LDL' kernels need no padding, and compile fastest


@pytest.fixture(scope="module")
def problem():
    """A random batch, its tight solution and a loose one (numpy)."""
    rng = np.random.default_rng(11)
    L = rng.normal(size=(B, n, n))
    data = dict(
        Q=L @ np.swapaxes(L, 1, 2) + n * np.eye(n),
        q=rng.normal(size=(B, n)),
        A=rng.normal(size=(B, p, n)),
        b=rng.normal(size=(B, p)),
        G=rng.normal(size=(B, m, n)),
        h=rng.normal(size=(B, m)) + 2.0,
    )
    jq = QuadProgram(**{k: jnp.asarray(v) for k, v in data.items()})
    # the solutions come from the port's own solver (cheap on the CPU); what
    # the tests compare is what each side computes FROM a given solution
    from diffopt_tpu_torch.ops.cuda.pdip import solve_batched_fused

    tight = solve_batched_fused(_tq(data), max_iters=30)
    loose = solve_batched_fused(_tq(data), max_iters=30, tol=1e-3)
    to_np = lambda s: dtt.convert.to_numpy(s)
    return data, jq, to_np(tight), to_np(loose), rng


def _tq(data):
    return dtt.convert.quadprogram_from_numpy(data, dtype=torch.float64, device="cpu")


def _ts(sol):
    return dtt.convert.qpsolution_from_numpy(sol, dtype=torch.float64, device="cpu")


def _tangent(data, rng):
    tan = {f"d{k}": 0.1 * rng.normal(size=v.shape) for k, v in data.items()}
    tan["dQ"] = 0.5 * (tan["dQ"] + np.swapaxes(tan["dQ"], 1, 2))
    return tan


def _js(sol):
    return QPSolution(**{k: jnp.asarray(v) for k, v in sol.items()})


def test_kkt_jacobian_and_residual_match(problem):
    data, jq, tight, _, _ = problem
    J, r = jax.jit(lambda q, s: (jax.vmap(jkkt.kkt_jacobian)(q, s), jax.vmap(jkkt.kkt_residual)(q, s)))(jq, _js(tight))
    # pure assembly / matvecs: identical up to summation order
    np.testing.assert_allclose(tkkt.kkt_jacobian(_tq(data), _ts(tight)).numpy(), np.asarray(J), atol=1e-13)
    np.testing.assert_allclose(tkkt.kkt_residual(_tq(data), _ts(tight)).numpy(), np.asarray(r), atol=1e-13)


def test_kkt_metrics_matches_and_reports_iterations(problem):
    data, jq, tight, loose, _ = problem
    jmetrics = jax.jit(jqp.kkt_metrics)
    for sol in (tight, loose):
        ji = jmetrics(jq, _js(sol))
        ti = tqp.kkt_metrics(_tq(data), _ts(sol))
        for name in ("primal_residual", "dual_residual", "duality_gap"):
            # sums and maxima of a few f64 terms
            np.testing.assert_allclose(
                getattr(ti, name).numpy(), np.asarray(getattr(ji, name)), rtol=1e-9, atol=1e-15, err_msg=name
            )
        assert np.array_equal(ti.converged.numpy(), np.asarray(ji.converged))
        # without a solver count the field is -1 (unknown), as in the reference
        assert ti.iterations.dtype == torch.int32
        assert np.array_equal(ti.iterations.numpy(), np.asarray(ji.iterations))
    assert bool(tqp.kkt_metrics(_tq(data), _ts(tight)).converged.all())
    # a solver's own count is passed through in the one place that builds the info
    its = torch.arange(B, dtype=torch.int64)
    ti = tqp.kkt_metrics(_tq(data), _ts(tight), iterations=its)
    assert ti.iterations.dtype == torch.int32 and np.array_equal(ti.iterations.numpy(), np.arange(B))


def test_kkt_metrics_flags_nonfinite_and_infeasible(problem):
    data, _, tight, _, _ = problem
    bad = {k: v.copy() for k, v in tight.items()}
    bad["z"][0, 0] = np.nan
    bad["z"][1] += 10.0
    conv = tqp.kkt_metrics(_tq(data), _ts(bad)).converged.numpy()
    assert not conv[0] and not conv[1] and conv[2:].all()


def test_qp_polish_matches(problem):
    data, jq, _, loose, _ = problem
    jp = jax.jit(jax.vmap(lambda q, s: jkkt.qp_polish(q, s)))(jq, _js(loose))
    tp = tkkt.qp_polish(_tq(data), _ts(loose))
    # both run one LDL' factor + 2 refinements on the same active set; the
    # polished point solves a well-conditioned linear system to ~1e-12
    for name in ("z", "lam", "nu"):
        np.testing.assert_allclose(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), atol=1e-9, err_msg=name
        )
    res_old = tkkt.kkt_residual(_tq(data), _ts(loose)).abs().amax(dim=1)
    res_new = tkkt.kkt_residual(_tq(data), tp).abs().amax(dim=1)
    assert bool((res_new <= res_old).all()) and bool((tp.lam >= 0).all())
    assert float(res_new.median()) < 1e-2 * float(res_old.median())


_jax_reverse = {}


def _reverse_both(problem, method):
    """(seeds, JAX cotangents, JAX adjoint solution) of ``qp_reverse`` under
    ``vmap``, computed once per method (the LDL' route compiles the Pallas
    kernels in interpret mode)."""
    if method not in _jax_reverse:
        data, jq, tight, _, rng = problem
        seeds = [rng.normal(size=(B, k)) for k in (n, m, p)]
        jg, jadj = jax.jit(jax.vmap(
            lambda q, s, a, b_, c: jkkt.qp_reverse(q, s, a, b_, c, method=method, refine_iters=2)
        ))(jq, _js(tight), *map(jnp.asarray, seeds))
        _jax_reverse[method] = (seeds, jg, jadj)
    return _jax_reverse[method]


def test_qp_kkt_solve_ldl_matches(problem):
    data, jq, tight, _, rng = problem
    # the adjoint solution of qp_reverse(method="ldl") is -qp_kkt_solve_ldl(seed, transpose=True)
    seeds, _, jadj = _reverse_both(problem, "ldl")
    rhs = np.concatenate(seeds, axis=1)
    jx = -np.concatenate([np.asarray(a) for a in jadj], axis=1)
    txt = tkkt.qp_kkt_solve_ldl(_tq(data), _ts(tight), torch.from_numpy(rhs.copy()), transpose=True)
    # J is ill-conditioned on inactive rows (slack * dlam with lam at the
    # floor); both sides refine twice from the same factorisation
    np.testing.assert_allclose(txt.numpy(), jx, rtol=1e-6, atol=1e-8)
    # both J' x = rhs and J x = rhs are solved to the residual (the forward
    # route is tied to the adjoint one in test_qp_forward_is_adjoint_of_reverse)
    J = tkkt.kkt_jacobian(_tq(data), _ts(tight))
    np.testing.assert_allclose(torch.einsum("bji,bj->bi", J, txt).numpy(), rhs, atol=1e-7)
    tx = tkkt.qp_kkt_solve_ldl(_tq(data), _ts(tight), torch.from_numpy(rhs.copy()), transpose=False)
    np.testing.assert_allclose(torch.einsum("bij,bj->bi", J, tx).numpy(), rhs, atol=1e-7)


@pytest.mark.parametrize("method", ["ldl", "lu"])
def test_qp_reverse_matches(problem, method):
    data, jq, tight, _, rng = problem
    seeds, jg, jadj = _reverse_both(problem, method)
    tg, tadj = tkkt.qp_reverse(
        _tq(data), _ts(tight), *(torch.from_numpy(s.copy()) for s in seeds), method=method, refine_iters=2
    )
    # refined adjoint solves of the same system, contracted the same way
    for name in ("dQ", "dq", "dA", "db", "dG", "dh"):
        np.testing.assert_allclose(
            getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), rtol=1e-6, atol=1e-8, err_msg=name
        )
    for name in ("dz", "dlam", "dnu"):
        np.testing.assert_allclose(
            getattr(tadj, name).numpy(), np.asarray(getattr(jadj, name)), rtol=1e-6, atol=1e-8, err_msg=name
        )


def test_qp_forward_matches_jax_lu(problem):
    from diffopt_tpu import QPTangent

    data, jq, tight, _, rng = problem
    tan = _tangent(data, rng)
    jd = jax.vmap(lambda q, s, t: jkkt.qp_forward(q, s, t, method="lu", refine_iters=2))(
        jq, _js(tight), QPTangent(**{k: jnp.asarray(v) for k, v in tan.items()})
    )
    td = tkkt.qp_forward(
        _tq(data), _ts(tight),
        dtt.convert.qptangent_from_numpy(tan, dtype=torch.float64, device="cpu"),
        method="lu", refine_iters=2,
    )
    for name in ("dz", "dlam", "dnu"):
        np.testing.assert_allclose(
            getattr(td, name).numpy(), np.asarray(getattr(jd, name)), rtol=1e-6, atol=1e-8, err_msg=name
        )


@pytest.mark.parametrize("method", ["ldl", "lu"])
def test_qp_forward_is_adjoint_of_reverse(problem, method):
    """<JVP(d), s> = <d, VJP(s)> for every instance (AK17 eq. (6)/(7)): holds
    the forward rule, LDL' route included, against the reverse rule that is
    compared with JAX above."""
    data, _, tight, _, rng = problem
    tan = dtt.convert.qptangent_from_numpy(_tangent(data, rng), dtype=torch.float64, device="cpu")
    seeds = [torch.from_numpy(rng.normal(size=(B, k))) for k in (n, m, p)]
    qp, sol = _tq(data), _ts(tight)
    d = tkkt.qp_forward(qp, sol, tan, method=method, refine_iters=2)
    g, _ = tkkt.qp_reverse(qp, sol, *seeds, method=method, refine_iters=2)
    lhs = sum((a * b).sum(dim=1) for a, b in zip(d, seeds))
    rhs = sum((getattr(tan, k) * getattr(g, k)).flatten(1).sum(dim=1) for k in ("dQ", "dq", "dA", "db", "dG", "dh"))
    # two refined solves of one linear system and its transpose
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), rtol=1e-7, atol=1e-9)


def test_unported_methods_raise(problem):
    """Every method of the reference is there: 'lstsq', 'qr', 'auto' and a
    callable give the LU result on these well-posed QPs; only an unknown name
    raises."""
    data, _, tight, _, rng = problem
    seed = torch.from_numpy(rng.normal(size=(B, n)))
    ref, _ = tkkt.qp_reverse(_tq(data), _ts(tight), seed, method="lu")
    syncs = tkkt._auto_solve.host_syncs
    for method in ("lstsq", "qr", "auto", lambda M, r: torch.linalg.solve(M, r)):
        g, _ = tkkt.qp_reverse(_tq(data), _ts(tight), seed, method=method, refine_iters=1)
        for name in ("dQ", "dq", "dA", "db", "dG", "dh"):
            # lstsq squares the condition number of J (1e4 here); one refinement pass repairs it
            np.testing.assert_allclose(getattr(g, name).numpy(), getattr(ref, name).numpy(), rtol=0, atol=1e-8, err_msg=name)
    assert tkkt._auto_solve.host_syncs == syncs + 1  # 'auto' reads the LP count once
    with pytest.raises(ValueError, match="unknown solve method"):
        tkkt.qp_reverse(_tq(data), _ts(tight), seed, method="cholesky")


def test_ldl_past_128_matches_jax_lu_route():
    """Between N = 129 and the port's LDL' envelope (``chol.ldl_max_n``: 169
    in f64) the reference's ``method="ldl"`` takes LU (``diffopt_tpu/ops/kkt.py``
    switches past 128 rows) while the port keeps its LDL'; both solve the same
    KKT system with two refinement passes, so the VJP and the JVP agree to
    1e-8 (here N = 130: n = 100, m = 20, p = 10, B = 2, f64)."""
    from diffopt_tpu import QPTangent
    from diffopt_tpu_torch.ops.cuda import chol
    from diffopt_tpu_torch.ops.cuda.pdip import solve_batched_fused

    Bb, nb, mb, pb = 2, 100, 20, 10
    rng = np.random.default_rng(12)
    L = rng.normal(size=(Bb, nb, nb))
    data = dict(
        Q=L @ np.swapaxes(L, 1, 2) + nb * np.eye(nb), q=rng.normal(size=(Bb, nb)), A=rng.normal(size=(Bb, pb, nb)),
        b=rng.normal(size=(Bb, pb)), G=rng.normal(size=(Bb, mb, nb)), h=rng.normal(size=(Bb, mb)) + 2.0,
    )
    tq = _tq(data)
    assert 128 < nb + mb + pb <= chol.ldl_max_n(torch.float64) and tkkt._ldl_fits(tq)  # the port factors by LDL'
    sol = dtt.convert.to_numpy(solve_batched_fused(tq, max_iters=30))  # the port's own solver, on the CPU
    jq = QuadProgram(**{k: jnp.asarray(v) for k, v in data.items()})
    seeds = [rng.normal(size=(Bb, k)) for k in (nb, mb, pb)]
    jg, jadj = jax.jit(jax.vmap(
        lambda q, s, a, b_, c: jkkt.qp_reverse(q, s, a, b_, c, method="ldl", refine_iters=2)
    ))(jq, _js(sol), *map(jnp.asarray, seeds))
    tg, tadj = tkkt.qp_reverse(tq, _ts(sol), *(torch.from_numpy(s.copy()) for s in seeds), method="ldl", refine_iters=2)
    for name in ("dQ", "dq", "dA", "db", "dG", "dh"):
        np.testing.assert_allclose(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), rtol=0, atol=1e-8,
                                   err_msg=name)
    for name in ("dz", "dlam", "dnu"):
        np.testing.assert_allclose(getattr(tadj, name).numpy(), np.asarray(getattr(jadj, name)), rtol=0, atol=1e-8,
                                   err_msg=name)
    tan = _tangent(data, rng)
    jd = jax.jit(jax.vmap(lambda q, s, t: jkkt.qp_forward(q, s, t, method="ldl", refine_iters=2)))(
        jq, _js(sol), QPTangent(**{k: jnp.asarray(v) for k, v in tan.items()})
    )
    td = tkkt.qp_forward(tq, _ts(sol), dtt.convert.qptangent_from_numpy(tan, dtype=torch.float64, device="cpu"),
                         method="ldl", refine_iters=2)
    for name in ("dz", "dlam", "dnu"):
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)), rtol=0, atol=1e-8,
                                   err_msg=name)
