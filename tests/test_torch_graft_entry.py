"""The port's compile gate and multi-process dry run (``diffopt_tpu_torch/graft_entry.py``) on the CPU.

- The five example builders give the JAX builders' arrays (``__graft_entry__._example_*``) bit for bit, in f32
  and f64.
- ``entry()``'s step on the host in f64 (the kernels' plain versions): finite, its gradient the QP n = 16
  part's. Its QP n = 16 and SOCP parts are held to the JAX package in one jitted JAX call on the port's
  solutions, to 1e-8 relative: the QP point by the JAX package's ``kkt_metrics``, the step's gradients by its
  reverse rules (``qp_diff`` / ``conic_diff.reverse_differentiate``, the LU route) at the same points, and the
  SOCP point refined by its ``conic_diff.refine_solution`` against the port's refinement of it. (The f64
  interior-point solvers of both packages stop at an interior iterate some sqrt(mu) from the strictly
  complementary solution, 1e-5 in x here, so a conic value is held after refinement.) The JAX package's own
  solvers are not run here: at these shapes they compile for 25-65 s on the CPU (the batched routes reach the
  Pallas kernels in interpret mode); the fused routes are held to the port's plain versions at small shapes in
  ``test_torch_{pdip,conic_pdip,solve_qp_batched}.py``.
- ``dryrun_multichip(4, device="cpu")``: one spawn of four gloo processes (started with the module, beside the
  step), every part's check holding.
- ``device="cuda"`` raises on a host without a card, and the dry run with fewer cards than processes.
"""

import concurrent.futures
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffopt_tpu as dj
from diffopt_tpu import conic_diff as jconic_diff
from diffopt_tpu import qp_diff as jqp_diff
from diffopt_tpu.solvers import qp as jqp_solver
from diffopt_tpu_torch import conic_diff, graft_entry
from diffopt_tpu_torch.solve import solve_conic_batched, solve_qp_batched

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILDERS = ("_example_batch", "_example_psd_batch", "_example_conic_loop_batch", "_example_ns_batch",
            "_example_conic_batch")
TOL = 1e-8


def _jax_gate():
    spec = importlib.util.spec_from_file_location("__graft_entry__", ROOT / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_GATE = _jax_gate()


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def dryrun():
    """dryrun_multichip(4, device="cpu"), started with the module: its four processes run beside the step's
    fixtures, and the dry run's test reads the result."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        yield pool.submit(graft_entry.dryrun_multichip, 4, device="cpu", timeout=240)


@pytest.mark.parametrize("name", BUILDERS)
def test_builders_match_jax_bitwise(name):
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        jp = getattr(JAX_GATE, name)(dtype=jdt)
        tp = getattr(graft_entry, name)(dtype=tdt, device="cpu")
        fields = ("Q", "q", "A", "b", "G", "h") if name == "_example_batch" else ("A", "b", "c")
        for f in fields:
            a, t = np.asarray(getattr(jp, f)), getattr(tp, f)
            assert t.device.type == "cpu" and t.dtype == tdt, (name, f)
            assert a.dtype == t.numpy().dtype and a.shape == t.shape, (name, f)
            assert np.array_equal(a, t.numpy()), (name, f, jdt)
        if name != "_example_batch":
            assert tp.cones.blocks == jp.cones.blocks


@pytest.fixture(scope="module")
def step():
    """entry()'s step on the host in f64, and its QP n = 16 and SOCP parts again on their own."""
    fn, args = graft_entry.entry(dtype=torch.float64, device="cpu")
    val, gq = fn(*args)
    qp, cp = args[0], args[2]
    qpl = qp.map(lambda t: t.detach().requires_grad_())
    sol = solve_qp_batched(qpl, max_iters=25)
    lq = (sol.z**2).sum() + (sol.lam**2).sum()
    gq_part = torch.autograd.grad(lq, qpl.q)[0]
    cpl = cp.map(lambda t: t.detach().requires_grad_())
    csol = solve_conic_batched(cpl, max_iters=30)
    lc = (csol.x**2).sum()
    gc = torch.autograd.grad(lc, cpl.tensors())
    csol = csol.map(torch.Tensor.detach)
    refined = conic_diff.refine_solution(cp, csol, method="lstsq")
    return dict(args=args, val=val, gq=gq, lq=float(lq.detach()), gq_part=gq_part, lc=float(lc.detach()), gc=gc,
                sol=sol.map(torch.Tensor.detach), csol=csol, refined=refined)


@pytest.fixture(scope="module")
def jax_reference(step):
    """ONE jitted JAX call on the port's solutions of the QP n = 16 and SOCP parts."""
    qp, cp = step["args"][0], step["args"][2]
    jq = dj.QuadProgram(**{f: jnp.asarray(getattr(qp, f).numpy()) for f in ("Q", "q", "A", "b", "G", "h")})
    jsol = dj.QPSolution(*(jnp.asarray(t.numpy()) for t in step["sol"].tensors()))
    jcs = dj.ConeSolution(*(jnp.asarray(t.numpy()) for t in step["csol"].tensors()))
    cones = cp.cones

    def reference(jq, jsol, A, b, c, jcs):
        info = jqp_solver.kkt_metrics(jq, jsol)
        # the step's loss sum(z^2) + sum(lam^2) pulled back by the JAX package's reverse rule
        gq = jax.vmap(lambda q, s: jqp_diff.reverse_differentiate(q, s, 2 * s.z, 2 * s.lam, method="lu"))(jq, jsol)

        def one(A, b, c, x, y, s):
            cpi, soli = dj.ConeProgram(A=A, b=b, c=c, cones=cones), dj.ConeSolution(x=x, y=y, s=s)
            # the step's loss sum(x^2) pulled back at the port's point, and the point refined
            grads = jconic_diff.reverse_differentiate(cpi, soli, 2 * x, method="lstsq")
            return grads, jconic_diff.refine_solution(cpi, soli, method="lstsq")

        gc, refined = jax.vmap(one)(A, b, c, jcs.x, jcs.y, jcs.s)
        return info, gq, gc, refined

    out = jax.jit(reference)(jq, jsol, *(jnp.asarray(t.numpy()) for t in cp.tensors()), jcs)
    return jax.tree.map(np.asarray, out)


def test_step_on_the_host_f64(step):
    val, gq, qp = step["val"], step["gq"], step["args"][0]
    assert val.dtype == torch.float64 and val.device.type == "cpu" and bool(torch.isfinite(val))
    assert gq.shape == qp.q.shape and bool(torch.isfinite(gq).all())
    # a sum of squares over six parts; of the data only the QP n = 16 part's depends on qp.q
    assert float(val) > step["lq"] + step["lc"]
    assert torch.equal(gq, step["gq_part"])
    # no kernel is launched on the host
    assert graft_entry.kernel_launches() == dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6", "K7"), 0)


def test_step_parts_against_jax_f64(step, jax_reference):
    info, gq, gc, refined = jax_reference
    # the port's QP point meets the JAX package's optimality measures (scale-relative residuals)
    assert info.converged.all()
    assert max(info.primal_residual.max(), info.dual_residual.max()) <= TOL * 1e-4
    # the step's gradients, by the JAX package's reverse rules at the same points
    assert _rel(step["gq"].numpy(), gq.dq) <= TOL
    for name, t, j in zip(("A", "b", "c"), step["gc"], (gc.dA, gc.db, gc.dc)):
        assert _rel(t.numpy(), j) <= TOL, name
    # the SOCP point refined by both packages: the same point and value; the refinement moves x by little
    for name in ("x", "y", "s"):
        assert _rel(getattr(step["refined"], name).numpy(), getattr(refined, name)) <= TOL, name
    x = step["csol"].x.numpy()
    assert abs(float((refined.x**2).sum()) - float((step["refined"].x ** 2).sum())) <= TOL * step["lc"]
    assert _rel(x, refined.x) <= 1e-4


def test_dryrun_four_gloo_processes(dryrun):
    report = dryrun.result()
    assert report["n_devices"] == 4 and report["device"] == "cpu"
    ranks = report["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    parts = ("a_data_parallel", "b_fused_kernels", "c_hybrid_mesh", "d_two_stage", "e_tp_solve_psd")
    for r in ranks:
        assert r["world"] == 4 and "gloo" in r["backend"], r
        for part in parts:
            assert max(r[part].values()) <= graft_entry.DRYRUN_TOL, (r["rank"], part, r[part])
        assert sum(r["b_launches"].values()) == 0  # the plain versions on the host


def test_the_card_is_not_replaced_by_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (graft_entry.entry, lambda: graft_entry.entry(device="cuda"),
                 lambda: graft_entry._example_ns_batch(device="cuda"), lambda: graft_entry.dryrun_multichip(1),
                 lambda: graft_entry.dryrun_multichip(2, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # fewer cards than processes: refused before anything is built or started
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 cards"):
        graft_entry.dryrun_multichip(2)
