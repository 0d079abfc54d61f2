"""The compile gate and the multi-process dry run of the port.

Counterpart of ``__graft_entry__.py`` at the root of the repository:

``entry()``                 — ``(fn, args)``: one value-and-gradient step through
                              every kernel family (K1-K7) at small shapes, built
                              on the card unless the caller names another device;
``dryrun_multichip(n)``     — the same kind of step on n processes, one a card,
                              in one NCCL group (gloo on the host with
                              ``device="cpu"``), every sharded result held
                              against the one-process result of the same data.

``python -m diffopt_tpu_torch.graft_entry`` runs ``entry()``'s step and prints
one ``graft_entry`` JSON line (the value, the seconds, the launches of K1-K7);
``--dryrun N`` runs the dry run on N processes instead; ``--device cpu`` runs
either on the host (the kernels' plain versions, no launch).

The example builders draw from ``np.random.default_rng`` with the JAX
package's seeds in its order: for the same arguments their arrays are the
JAX builders' bit for bit (64-bit JAX: the psd blocks' ``svec`` in f64).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .cones import ConeSpec, sym_to_svec
from .ir import ConeProgram, QuadProgram, default_device
from .utils.testing import _on_device

# the dry run's agreement between a sharded result and the one-process result of the same data, f32, relative to
# 1 + the largest entry of the one-process result: the same arithmetic but for the order of the cross-process sums
DRYRUN_TOL = 1e-4
DRYRUN_TIMEOUT_S = 600.0
_REPORT = "graft_entry_worker "


def _device(device, what: str) -> torch.device:
    """``device``, else the card; raises where the card is asked for (by name or by default) and there is none."""
    return _on_device(default_device(device, what))


def _as_tensors(dtype, device, *arrays):
    return tuple(torch.as_tensor(a).to(device=device, dtype=dtype) for a in arrays)


def _example_batch(B=8, n=16, m=8, p=4, dtype=torch.float32, device=None) -> QuadProgram:
    """Random strictly convex QP batch: ``Q = L L' + n I`` (in f32, as the JAX builder makes it)."""
    device = _device(device, "_example_batch")
    rng = np.random.default_rng(0)
    L = rng.normal(size=(B, n, n)).astype(np.float32)
    Q = L @ np.transpose(L, (0, 2, 1)) + n * np.eye(n, dtype=np.float32)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, p, n))
    b = rng.normal(size=(B, p))
    G = rng.normal(size=(B, m, n))
    h = rng.normal(size=(B, m)) + 2.0
    return QuadProgram(*_as_tensors(dtype, device, Q, q, A, b, G, h))


def _svec(M: np.ndarray) -> np.ndarray:
    return sym_to_svec(torch.as_tensor(M)).numpy()


def _example_psd_batch(B=8, side=4, n=3, dtype=torch.float32, device=None) -> ConeProgram:
    """Small SDP batch (a psd block of side ``side`` and an SOC(n + 1) block): K6's psd path."""
    device = _device(device, "_example_psd_batch")
    rng = np.random.default_rng(2)
    tri = side * (side + 1) // 2
    A_rows, b_rows = [], []
    for _ in range(B):
        L = rng.normal(size=(side, side))
        S0 = L @ L.T + side * np.eye(side)
        Gs = [(lambda M: (M + M.T) / 2)(rng.normal(size=(side, side))) for _ in range(n)]
        b_psd = _svec(S0)
        A_psd = -np.stack([_svec(G) for G in Gs], axis=1)
        A_soc = np.concatenate([np.zeros((1, n)), -np.eye(n)], axis=0)
        b_soc = np.concatenate([[3.0], np.zeros(n)])
        A_rows.append(np.concatenate([A_psd, A_soc], axis=0))
        b_rows.append(np.concatenate([b_psd, b_soc]))
    A, b, c = _as_tensors(dtype, device, np.stack(A_rows), np.stack(b_rows), rng.normal(size=(B, n)))
    return ConeProgram(A=A, b=b, c=c, cones=ConeSpec([("psd", tri), ("soc", n + 1)]))


def _example_conic_loop_batch(B=8, dtype=torch.float32, device=None) -> ConeProgram:
    """Conic batch of N = 90 with every symmetric kind (zero 2, nonneg 56, SOC(6), psd side 4), built from a
    strictly interior primal-dual pair; the JAX package's layout past its fused kernel's unrolled LDL'."""
    device = _device(device, "_example_conic_loop_batch")
    rng = np.random.default_rng(4)
    side = 4
    tri = side * (side + 1) // 2
    nn, sd, n, p = 56, 6, 16, 2
    cones = ConeSpec([("zero", p), ("nonneg", nn), ("soc", sd), ("psd", tri)])
    m = cones.total_dim
    A_b, b_b, c_b = [], [], []
    for _ in range(B):
        A = rng.normal(size=(m, n))
        xs = rng.normal(size=n)
        v = rng.normal(size=sd - 1)
        s_soc = np.concatenate([[np.linalg.norm(v) + 0.4], v])
        w = rng.normal(size=sd - 1) * 0.1
        y_soc = np.concatenate([[np.linalg.norm(w) + 0.3], w])
        Ls = rng.normal(size=(side, side))
        s_psd = _svec(Ls @ Ls.T + side * np.eye(side))
        Ly = rng.normal(size=(side, side))
        y_psd = _svec(Ly @ Ly.T + side * np.eye(side))
        s_star = np.concatenate([np.zeros(p), np.abs(rng.normal(size=nn)) + 0.2, s_soc, s_psd])
        y_star = np.concatenate([rng.normal(size=p), np.abs(rng.normal(size=nn)) + 0.2, y_soc, y_psd])
        A_b.append(A)
        b_b.append(A @ xs + s_star)
        c_b.append(-A.T @ y_star)
    A, b, c = _as_tensors(dtype, device, np.stack(A_b), np.stack(b_b), np.stack(c_b))
    return ConeProgram(A=A, b=b, c=c, cones=cones)


def _example_ns_batch(B=8, dtype=torch.float32, device=None) -> ConeProgram:
    """Small exp / pow batch (zero 1, nonneg 2, exp, pow(0.6); n = 4) for K7, built from a known strictly
    interior primal-dual pair."""
    device = _device(device, "_example_ns_batch")
    rng = np.random.default_rng(3)
    cones = ConeSpec([("zero", 1), ("nonneg", 2), ("exp", 3), ("pow", 3, 0.6)])
    m, n = cones.total_dim, 4
    exp_s = np.array([0.3, 1.1, 2.0 * 1.1 * np.exp(0.3 / 1.1)])
    exp_y = np.array([-1.0, 0.0, 1.0])  # -u e^{v/u} = 1 < e w
    pow_s = np.array([1.2, 1.2, 0.1])  # |z| < x^a y^(1-a)
    pow_y = np.array([1.0, 1.0, 0.1])  # |w| < (u/a)^a (v/(1-a))^(1-a)
    A_b, b_b, c_b = [], [], []
    for _ in range(B):
        A = rng.normal(size=(m, n))
        xs = rng.normal(size=n)
        s_star = np.concatenate([np.zeros(1), np.abs(rng.normal(size=2)) + 0.2, exp_s, pow_s])
        y_star = np.concatenate([rng.normal(size=1), np.abs(rng.normal(size=2)) + 0.2, exp_y, pow_y])
        A_b.append(A)
        b_b.append(A @ xs + s_star)
        c_b.append(-A.T @ y_star)
    A, b, c = _as_tensors(dtype, device, np.stack(A_b), np.stack(b_b), np.stack(c_b))
    return ConeProgram(A=A, b=b, c=c, cones=cones)


def _example_conic_batch(B=8, n=8, dtype=torch.float32, device=None) -> ConeProgram:
    """Small symmetric-cone batch (zero 2, nonneg 8, SOC(4)) for K6, built from a strictly interior pair."""
    device = _device(device, "_example_conic_batch")
    rng = np.random.default_rng(1)
    cones = ConeSpec([("zero", 2), ("nonneg", 8), ("soc", 4)])
    m = cones.total_dim
    A = rng.normal(size=(B, m, n))
    xs = rng.normal(size=(B, n))
    v = rng.normal(size=(B, 3))
    s_soc = np.concatenate([np.linalg.norm(v, axis=1, keepdims=True) + 0.4, v], axis=1)
    sstar = np.concatenate([np.zeros((B, 2)), np.abs(rng.normal(size=(B, 8))) + 0.2, s_soc], axis=1)
    w = rng.normal(size=(B, 3)) * 0.1
    y_soc = np.concatenate([np.linalg.norm(w, axis=1, keepdims=True) + 0.3, w], axis=1)
    ystar = np.concatenate([rng.normal(size=(B, 2)), np.abs(rng.normal(size=(B, 8))) + 0.2, y_soc], axis=1)
    b = np.einsum("bmn,bn->bm", A, xs) + sstar
    c = -np.einsum("bmn,bm->bn", A, ystar)
    A, b, c = _as_tensors(dtype, device, A, b, c)
    return ConeProgram(A=A, b=b, c=c, cones=cones)


def _leaves(programs):
    """Each program with its data tensors as fresh leaves that require a gradient, and the list of them."""
    programs = tuple(p.map(lambda t: t.detach().requires_grad_()) for p in programs)
    return programs, [t for p in programs for t in p.tensors()]


def _step(qp, qp_big, cp, cp_psd, cp_loop, cp_ns):
    """One step of the gate: the fused QP solver (K1) with its LDL' VJP (K2 / K3) on the n = 16 and the n = 100
    batches, and the fused conic solvers (K6 on the SOCP, the SDP and the N = 90 layout; K7 on the exp / pow
    batch) with their gram polish and VJP (K4 / K5); the loss is the JAX step's sum of squares, and its
    gradient is taken with respect to every data tensor of the six programs. Returns ``(value, grad of
    qp.q)``."""
    from .solve import solve_conic_batched, solve_qp_batched

    programs, leaves = _leaves((qp, qp_big, cp, cp_psd, cp_loop, cp_ns))
    qp, qp_big, cp, cp_psd, cp_loop, cp_ns = programs
    sol = solve_qp_batched(qp, max_iters=25)
    sol_big = solve_qp_batched(qp_big, max_iters=25)
    csol = solve_conic_batched(cp, max_iters=30)
    psol = solve_conic_batched(cp_psd, max_iters=30)
    lsol = solve_conic_batched(cp_loop, max_iters=40)
    nsol = solve_conic_batched(cp_ns, max_iters=60)
    val = (
        (sol.z**2).sum() + (sol.lam**2).sum() + (sol_big.z**2).sum() + (csol.x**2).sum() + (psol.x**2).sum()
        + (lsol.x**2).sum() + (nsol.x**2).sum()
    )
    grads = torch.autograd.grad(val, leaves)
    return val.detach(), grads[1]


def entry(dtype=torch.float32, device=None):
    """Return ``(fn, example_args)``: ``fn(*example_args)`` is the gate's step, its programs built on the card
    unless ``device`` names another (it raises where there is no card and none is named)."""
    device = _device(device, "entry")
    return _step, (
        _example_batch(dtype=dtype, device=device),
        # n = 100: K1's eight-warp team, the VJP's LDL' at N = 172
        _example_batch(B=8, n=100, m=48, p=24, dtype=dtype, device=device),
        _example_conic_batch(dtype=dtype, device=device),
        _example_psd_batch(dtype=dtype, device=device),
        _example_conic_loop_batch(dtype=dtype, device=device),
        _example_ns_batch(dtype=dtype, device=device),
    )


def kernel_launches() -> dict:
    """The launch counts of K1-K7's wrappers, by kernel."""
    from .ops.cuda import chol, conic_pdip, ns_pdip, pdip

    wrappers = {"K1": pdip.solve_batched_fused, "K2": chol.ldl_batched, "K3": chol.ldl_solve_batched,
                "K4": chol.cholesky_batched, "K5": chol.cholesky_solve_batched, "K6": conic_pdip.solve_tile_fused,
                "K7": ns_pdip.solve_tile_fused_ns}
    return {k: w.launches for k, w in wrappers.items()}


# ---------------------------------------------------------------------------------------------------------------
# The multi-process dry run
# ---------------------------------------------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None, timeout: float = DRYRUN_TIMEOUT_S) -> dict:
    """The scenario-parallel step on ``n_devices`` processes, one a card, in one process group (NCCL on the
    card, gloo with ``device="cpu"``). Each process runs, each part against the one-process result of the same
    data (:data:`DRYRUN_TOL`):

    (a) the staged QP solve + VJP (``solve_qp(method="lu")``) on its shard of a (B = 2n, n = 6, m = 4, p = 2)
        batch of a 1-D mesh, the loss all-reduced, its rows of the gradient;
    (b) the fused solvers inside the group: ``solve_qp_batched`` (K1, K2 / K3) and ``solve_conic_batched`` (K6,
        K4 / K5) on its shards of two batches, the loss all-reduced (on the card every kernel must launch);
    (c) where n is even, step (a) on a (dcn = 2, ici = n / 2) mesh, sharded over both axes;
    (d) the sharded ``solve_two_stage`` and ``two_stage_forward_sensitivity`` (S = 2n, n = 3, m = 2, p = 1,
        c = 2), the coupling reductions over the group;
    (e) ``tp_solve_psd`` at n = 8 x n_devices, each process holding one column block, against a local solve.

    The processes are started here (not by a launcher), each on the card of its rank; the parent builds the
    kernels once before it starts them. Raises where there are fewer cards than ``n_devices``, where a process
    fails or a check does not hold, and after ``timeout`` seconds. Returns the processes' reports."""
    dev = _device(device, "dryrun_multichip")
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}")
    if dev.type == "cuda":
        if n_devices > torch.cuda.device_count():
            raise RuntimeError(f"dryrun_multichip: {n_devices} processes need {n_devices} cards, this machine has"
                               f" {torch.cuda.device_count()}")
        from .ops.cuda import _build

        _build.load("pdip")  # builds every source once, before the processes load the libraries
    elif dev.type != "cpu":
        raise ValueError(f"dryrun_multichip runs on the card or the host, not on {dev}")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(Path(__file__).resolve().parents[1]), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, "-m", "diffopt_tpu_torch.graft_entry", "--worker", str(rank),
                          str(n_devices), str(port), dev.type], env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for rank in range(n_devices)
    ]
    outs = [""] * n_devices
    try:
        deadline = time.monotonic() + timeout
        # a process that fails leaves the others waiting in a collective: stop them all at the first failure
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=60)[0]
    failed = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip: processes {failed} (rank, exit code) failed:\n"
                           + "\n".join(f"--- rank {i} ---\n{outs[i][-4000:]}" for i, _ in failed))
    reports = []
    for i, out in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(_REPORT)]
        if not lines:
            raise RuntimeError(f"dryrun_multichip: rank {i} printed no report:\n{out[-4000:]}")
        reports.append(json.loads(lines[-1][len(_REPORT):]))
    return {"n_devices": n_devices, "device": dev.type, "seconds": time.perf_counter() - t0, "ranks": reports}


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _rel(a, b) -> float:
    """max |a - b| relative to 1 + the largest |b|."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / (1.0 + b.abs().max()))


def _hold(report, part, **pairs):
    """Record each (sharded, one-process) pair's relative difference under ``part`` and check it."""
    diffs = {name: _rel(a, b) for name, (a, b) in pairs.items()}
    report[part] = diffs
    _check(all(d <= DRYRUN_TOL for d in diffs.values()), f"part {part}: sharded results off the one-process"
                                                         f" results {diffs} (tol {DRYRUN_TOL:.0e})")


def _staged_step(qp):
    """The JAX dry run's plain-XLA step: the staged solver with the LU KKT route, loss sum(z^2) + sum(lam^2),
    its gradient with respect to every field; returns (loss, grad of q)."""
    from .solve import solve_qp

    (qp,), leaves = _leaves((qp,))
    sol = solve_qp(qp, max_iters=30, method="lu")
    loss = (sol.z**2).sum() + (sol.lam**2).sum()
    return loss.detach(), torch.autograd.grad(loss, leaves)[1]


def _fused_step(qp, cp):
    """solve_qp_batched and solve_conic_batched, loss sum(z^2) + sum(x^2); returns (loss, grad of q, grad of c)."""
    from .solve import solve_conic_batched, solve_qp_batched

    (qp, cp), leaves = _leaves((qp, cp))
    loss = (solve_qp_batched(qp, max_iters=25).z ** 2).sum() + (solve_conic_batched(cp, max_iters=30).x ** 2).sum()
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads[1], grads[-1]


def _dryrun_parts(n: int, rank: int, device: torch.device) -> dict:
    """Parts (a)-(e) of :func:`dryrun_multichip` in one process of the group."""
    from .parallel import hybrid_mesh, make_mesh, scenario_sharding, shard_batch
    from .parallel.schur import TwoStageQP, solve_two_stage, two_stage_forward_sensitivity
    from .parallel.tp_chol import tp_solve_psd

    dt = torch.float32
    report = {"rank": rank, "backend": str(dist.get_backend()), "world": dist.get_world_size()}
    if device.type == "cuda":
        report["card"] = torch.cuda.get_device_name(device)

    def summed(x, group):
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    # (a) data-parallel staged QP step over a 1-D mesh
    mesh = make_mesh(n, device=device)
    group = mesh.get_group("batch")
    qp = _example_batch(B=2 * n, n=6, m=4, p=2, dtype=dt, device=device)
    rows = slice(2 * rank, 2 * rank + 2)
    val, gq = _staged_step(shard_batch(qp, mesh))
    ref_val, ref_gq = _staged_step(qp)
    _hold(report, "a_data_parallel", loss=(summed(val, group), ref_val), grad_q=(gq, ref_gq[rows]))

    # (b) the fused kernels inside the group, each process on its shard
    qpf = _example_batch(B=2 * n, n=6, m=4, p=2, dtype=dt, device=device)
    cpf = _example_conic_batch(B=2 * n, dtype=dt, device=device)
    before = kernel_launches()
    val, gq, gc = _fused_step(shard_batch(qpf, mesh), shard_batch(cpf, mesh))
    if device.type == "cuda":
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in kernel_launches().items()}
    report["b_launches"] = launched
    if device.type == "cuda":
        _check(all(launched[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")),
               f"part b: a kernel of the fused path was not launched inside the group ({launched})")
    ref_val, ref_gq, ref_gc = _fused_step(qpf, cpf)
    _hold(report, "b_fused_kernels", loss=(summed(val, group), ref_val), grad_q=(gq, ref_gq[rows]),
          grad_c=(gc, ref_gc[rows]))

    # (c) the hybrid DCN x ICI mesh, the batch over both axes
    if n % 2 == 0:
        mesh_h = hybrid_mesh(dcn=2, ici=n // 2, device=device)
        sh = scenario_sharding(mesh_h)
        qp_h = _example_batch(B=n, n=4, m=3, p=1, dtype=dt, device=device)
        val, gq = _staged_step(sh.shard(qp_h))
        ref_val, ref_gq = _staged_step(qp_h)
        _hold(report, "c_hybrid_mesh", loss=(summed(val, sh.group), ref_val),
              grad_q=(gq, ref_gq[sh.index : sh.index + 1]))

    # (d) the coupled two-stage solve and forward sensitivity, the Schur reductions over the group
    rng = np.random.default_rng(1)
    S, n2, m2, p2, c2 = 2 * n, 3, 2, 1, 2
    L2 = rng.normal(size=(S, n2, n2)).astype(np.float32)
    fields = dict(
        Qs=L2 @ np.transpose(L2, (0, 2, 1)) + n2 * np.eye(n2, dtype=np.float32),
        qs=rng.normal(size=(S, n2)).astype(np.float32), As=rng.normal(size=(S, p2, n2)).astype(np.float32),
        bs=rng.normal(size=(S, p2)).astype(np.float32), Gs=rng.normal(size=(S, m2, n2)).astype(np.float32),
        hs=(rng.normal(size=(S, m2)) + 2).astype(np.float32), Bs=rng.normal(size=(S, p2, c2)).astype(np.float32),
        Q0=np.eye(c2, dtype=np.float32) * c2, q0=rng.normal(size=c2).astype(np.float32),
    )
    ts = TwoStageQP(**{k: torch.as_tensor(v, device=device) for k, v in fields.items()})

    def coupled(t, g):
        sol, info = solve_two_stage(t, group=g)
        fwd = two_stage_forward_sensitivity(t, sol, t, group=g)
        out = (fwd.xs**2).sum()
        return (summed(out, g) if g is not None else out) + (sol.z**2).sum(), sol, fwd, info

    local = TwoStageQP(*shard_batch(ts.tensors()[:7], mesh), ts.Q0, ts.q0)
    out, sol, fwd, info = coupled(local, group)
    ref_out, ref_sol, ref_fwd, ref_info = coupled(ts, None)
    _check(bool(info.converged) and bool(ref_info.converged), "part d: the two-stage solve did not converge")
    report["d_bodies"] = [int(info.iterations), int(ref_info.iterations)]
    _hold(report, "d_two_stage", out=(out, ref_out), z=(sol.z, ref_sol.z), xs=(sol.xs, ref_sol.xs[rows]),
          dxs=(fwd.xs, ref_fwd.xs[rows]), dz=(fwd.z, ref_fwd.z))

    # (e) the tensor-parallel Cholesky solve, one column block a process
    tp_mesh = make_mesh(n, "tp", device=device)
    ntp = 8 * n
    Mtp = rng.normal(size=(ntp, ntp))
    Htp = torch.as_tensor((Mtp @ Mtp.T + ntp * np.eye(ntp)).astype(np.float32), device=device)
    rtp = torch.as_tensor(rng.normal(size=ntp).astype(np.float32), device=device)
    cols = slice(8 * rank, 8 * rank + 8)
    z = tp_solve_psd(Htp[:, cols].contiguous(), rtp[cols].contiguous(), tp_mesh.get_group("tp"))
    _hold(report, "e_tp_solve_psd", z=(z, torch.linalg.solve(Htp, rtp)[cols]))
    return report


def _worker(rank: int, n: int, port: int, device_type: str) -> None:
    """One process of :func:`dryrun_multichip`: binds the card of its rank before the group is made, runs the
    parts and prints its report."""
    from .parallel import initialize_multihost
    from .parallel.runtime import default_backend

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    address = f"127.0.0.1:{port}"
    if n > 1:
        initialize_multihost(coordinator_address=address, num_processes=n, process_id=rank)
    else:  # initialize_multihost makes no group for one process; the dry run's collectives want a real one
        dist.init_process_group(default_backend(), init_method=f"tcp://{address}", world_size=1, rank=0)
    try:
        report = _dryrun_parts(n, rank, device)
        # a barrier on the group's own backend for this device: no process leaves while another still talks
        dist.all_reduce(torch.zeros(1, device=device))
    finally:
        dist.destroy_process_group()
    print(_REPORT + json.dumps(report), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", type=int, metavar="N", help="run the dry run on N processes instead of the step")
    ap.add_argument("--device", default=None, help='"cpu" to run on the host (default: the card)')
    ap.add_argument("--worker", nargs=4, metavar=("RANK", "N", "PORT", "DEVICE"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, n, port, device_type = args.worker
        _worker(int(rank), int(n), int(port), device_type)
        return 0
    if args.dryrun is not None:
        report = dryrun_multichip(args.dryrun, device=args.device)
        print(json.dumps({"dryrun": report}))
        return 0
    fn, fargs = entry(device=args.device)
    on_card = fargs[0].Q.device.type == "cuda"
    build_s = None
    if on_card:  # the build first, so that the seconds are the step's
        from .ops.cuda import _build

        t0 = time.perf_counter()
        _build.load("pdip")
        build_s = time.perf_counter() - t0
    before = kernel_launches()
    t0 = time.perf_counter()
    val, gq = fn(*fargs)
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    line = {"value": float(val), "seconds": seconds, "build_seconds": build_s, "launches": launches,
            "device": str(fargs[0].Q.device)}
    if on_card:
        line["card"] = torch.cuda.get_device_name(fargs[0].Q.device)
    print(json.dumps({"graft_entry": line}))
    ok = bool(torch.isfinite(val)) and bool(torch.isfinite(gq).all()) and gq.shape == fargs[0].q.shape
    if on_card and not all(v > 0 for v in launches.values()):
        print(f"graft_entry: a kernel was not launched: {launches}", file=sys.stderr)
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
