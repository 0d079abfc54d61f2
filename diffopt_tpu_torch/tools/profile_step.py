"""Where one solve + VJP step spends its device time.

    python3 -m diffopt_tpu_torch.tools.profile_step [--batch 32768] [--path main|staged|qp100|conic|exp|sdp|nlp|two_stage] [--side 16]

Runs one step forward + backward once to warm up and once under
``torch.profiler``, and prints the device time by kernel, the step's wall
time, and the card's name and power limit. ``--path main`` is
``solve_qp_batched`` (fused solver, polish, LDL' VJP) and ``--path staged``
``solve_qp`` with its defaults (staged solver on the Cholesky kernels, LU
VJP), both on dense QPs with n = 64, m = 32, p = 16, f32; ``--path qp100`` is
``solve_qp_batched`` on n = 100, m = 48, p = 24 (N = 172; ``--batch`` is
capped at its 8192); ``--path conic`` is
``solve_conic_batched(max_iters=50, tol=1e-5, method="gram")`` (fused conic
IPM, gram polish and VJP on the Cholesky kernels) on the SOCP of BASELINE
config 3 (n = 16, SOC(17), f32); ``--path exp`` is ``solve_conic_batched``
with its defaults (fused nonsymmetric IPM K7, gram polish and VJP) on the
entropy family of the exp benchmark (k = 3, f32; ``--batch`` is capped at its
16384); ``--path sdp`` is ``solve_conic_batched`` with its defaults on the SDP
family of ``chip_smoke.py``'s ``[sdp]`` line (n = 3, psd side ``--side`` and
SOC(4), f32; ``--batch`` is capped at its 4096); ``--path nlp`` is the NLP
benchmark's step (the embedded NLP solver, ``max_iters=40, tol=1e-6``, then
``nlp_diff.forward_differentiate(...).dx``) on its problem (n = 16, nc = 8
equalities, f32; ``--batch`` is capped at its 16384), with the device time of
K2, K3, the sensitivity LU and the rest (the ``torch.func`` derivatives and
elementwise glue); ``--path two_stage`` is the two-stage benchmark's step
(``parallel/schur.py``: ``solve_two_stage``, then the forward sensitivity
along the data) on its scenario-coupled QP (n = 8, m = 4, p = 2, c = 4, f32;
``--batch`` is the number of scenarios S, 8192 unless given), with the device
time of K2, K3, the c x c coupling solves and the rest. The host syncs and the step's time without the profiler are
printed too.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None, help="instances (default 32768; scenarios S of two_stage: 8192)")
    ap.add_argument("--path", choices=("main", "staged", "qp100", "conic", "exp", "sdp", "nlp", "two_stage"), default="main",
                    help="which entry point to profile")
    ap.add_argument("--side", type=int, default=16, help="psd side of --path sdp")
    ap.add_argument("--rows", type=int, default=16, help="rows of the table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.utils.testing import make_batch, make_entropy_batch, make_sdp_batch, make_socp_batch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if args.batch is None:
        args.batch = 8192 if args.path == "two_stage" else 32768
    if args.path == "two_stage":
        from diffopt_tpu_torch.utils.testing import make_two_stage_bench

        two_stage = make_two_stage_bench(args.batch)
    elif args.path == "nlp":
        from diffopt_tpu_torch.utils.testing import NLP_BENCH_BATCH, make_nlp_bench

        args.batch = min(args.batch, NLP_BENCH_BATCH)
        nlp, nlp_p, nlp_dp = make_nlp_bench(args.batch)
    elif args.path == "conic":
        prog = make_socp_batch(args.batch, n=16, seed=0).map(lambda t: t.requires_grad_())
    elif args.path == "exp":
        args.batch = min(args.batch, 16384)
        prog = make_entropy_batch(args.batch, k=3, seed=0).map(lambda t: t.requires_grad_())
    elif args.path == "sdp":
        args.batch = min(args.batch, 4096)
        prog = make_sdp_batch(args.batch, args.side, n=3, seed=args.side).map(lambda t: t.requires_grad_())
    elif args.path == "qp100":
        args.batch = min(args.batch, 8192)
        prog = make_batch(args.batch, 100, 48, 24, torch.float32, "cuda", gen).map(lambda t: t.requires_grad_())
    else:
        prog = make_batch(args.batch, 64, 32, 16, torch.float32, "cuda", gen).map(lambda t: t.requires_grad_())

    from diffopt_tpu_torch import nlp_diff
    from diffopt_tpu_torch.ops import kkt
    from diffopt_tpu_torch.parallel import schur
    from diffopt_tpu_torch.solvers import conic_ipm, conic_nsipm
    from diffopt_tpu_torch.solvers import nlp as nlpsolver
    from diffopt_tpu_torch.solvers import qp as qpsolver

    def step():
        if args.path == "two_stage":
            sol, _ = schur.solve_two_stage(two_stage)
            fwd = schur.two_stage_forward_sensitivity(two_stage, sol, two_stage)
            ((sol.z**2).sum() + (fwd.xs**2).sum()).item()
            return
        if args.path == "nlp":
            sol, _ = nlpsolver.solve(nlp, nlp_p, max_iters=40, tol=1e-6)
            nlp_diff.forward_differentiate(nlp, sol, nlp_p, nlp_dp)
            return
        for t in prog.tensors():
            t.grad = None
        if args.path in ("main", "qp100"):
            sol, _ = dtt.solve_qp_batched(prog, max_iters=25, with_info=True)
        elif args.path == "staged":
            sol, _ = dtt.solve_qp(prog, with_info=True)
        elif args.path == "conic":
            sol, _ = dtt.solve_conic_batched(prog, max_iters=50, tol=1e-5, method="gram", with_info=True)
        else:
            sol, _ = dtt.solve_conic_batched(prog, with_info=True)
        (sol.tensors()[0] ** 2).sum().backward()

    count_syncs = lambda: (qpsolver.solve_batched.host_syncs + kkt._auto_solve.host_syncs
                           + conic_ipm.solve_batched.host_syncs + conic_nsipm.solve_batched.host_syncs
                           + nlpsolver.solve.host_syncs + nlp_diff.factorize_with_inertia.host_syncs
                           + schur.solve_two_stage.host_syncs)
    step()
    torch.cuda.synchronize()
    syncs = count_syncs()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    syncs = count_syncs() - syncs
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only: an operator's entry repeats the time of the kernels it launched
    on_device = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.key_averages() if e.device_type == on_device and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"{'device ms':>10} {'share':>7} {'calls':>6}  kernel / op")
    for e in events[: args.rows]:
        ms = e.self_device_time_total / 1e3
        print(f"{ms:10.3f} {ms / busy_ms:7.1%} {e.count:6d}  {e.key[:90]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(
        f"device busy {busy_ms:.2f} ms of a {wall_ms:.2f} ms step under the profiler"
        f" (idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}), {bare_ms:.2f} ms without it, {syncs} host syncs"
        f" in the solvers' loops, the inertia loop and the 'auto' KKT route; path = {args.path}, B = {args.batch},"
        f" on {card}"
    )
    by = lambda *keys: sum(e.self_device_time_total for e in events if any(k in e.key for k in keys)) / 1e3
    # (K3 and K5 are one kernel template, tri_solve_kernel, told apart by its diagonal policy)
    ours = {"K1 pdip": by("pdip_kernel"), "K2 ldl_factor": by("ldl_factor_"), "K3 ldl_solve": by("LdlDiag"),
            "K4 chol_factor": by("chol_factor_"), "K5 chol_solve": by("CholDiag"),
            "K6 conic_pdip": by("conic_kernel"), "K7 ns_pdip": by("ns_kernel")}
    own_ms = sum(ours.values())
    print("hand-written kernels: " + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items() if v)
          + f"; everything else (PyTorch glue and library calls) {busy_ms - own_ms:.2f} ms of {busy_ms:.2f} ms busy")
    if args.path == "nlp":
        # the sensitivity's LU factor and solve (and the solver's library route, were N past 128) by kernel name
        lu_keys = ("getrf", "getrs", "lu_factor", "lu_solve", "laswp", "trsm", "trsv")
        lu_ms = by(*lu_keys)
        glue_ms = busy_ms - own_ms - lu_ms
        n_glue = sum(e.count for e in events if not any(k in e.key for k in ("ldl_factor_", "LdlDiag") + lu_keys))
        print(f"nlp step: K2 {ours['K2 ldl_factor']:.2f} ms, K3 {ours['K3 ldl_solve']:.2f} ms, the LU {lu_ms:.2f} ms,"
              f" the rest (torch.func derivatives, the residuals and elementwise glue) {glue_ms:.2f} ms in {n_glue}"
              f" kernel launches")
    if args.path == "two_stage":
        # the replicated c x c coupling solves (torch.linalg.solve: an LU factor and solve a Schur solve)
        lu_keys = ("getrf", "getrs", "lu_factor", "lu_solve", "laswp", "trsm", "trsv", "linalg_solve")
        lu_ms = by(*lu_keys)
        n_rest = sum(e.count for e in events if not any(k in e.key for k in ("ldl_factor_", "LdlDiag") + lu_keys))
        print(f"two-stage step: K2 {ours['K2 ldl_factor']:.2f} ms, K3 {ours['K3 ldl_solve']:.2f} ms, the coupling"
              f" solves {lu_ms:.2f} ms, the rest (block assembly, einsums, residuals, step lengths) "
              f"{busy_ms - own_ms - lu_ms:.2f} ms in {n_rest} kernel launches")


if __name__ == "__main__":
    main()
