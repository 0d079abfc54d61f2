"""Where one solve + VJP step spends its device time.

    python3 -m diffopt_tpu_torch.tools.profile_step [--batch 32768] [--path main|staged]

Runs one step forward + backward (n = 64, m = 32, p = 16, f32) once to warm up
and once under ``torch.profiler``, and prints the device time by kernel, the
step's wall time, and the card's name and power limit. ``--path main`` is
``solve_qp_batched`` (fused solver, polish, LDL' VJP); ``--path staged`` is
``solve_qp`` with its defaults (staged solver on the Cholesky kernels, LU
VJP), for which the host syncs and the step's time without the profiler are
printed too.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--path", choices=("main", "staged"), default="main", help="which entry point to profile")
    ap.add_argument("--rows", type=int, default=16, help="rows of the table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")

    from torch.profiler import ProfilerActivity, profile

    import diffopt_tpu_torch as dtt
    from diffopt_tpu_torch.utils.testing import make_batch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qp = make_batch(args.batch, 64, 32, 16, torch.float32, "cuda", gen).map(lambda t: t.requires_grad_())

    from diffopt_tpu_torch.ops import kkt
    from diffopt_tpu_torch.solvers import qp as qpsolver

    def step():
        for t in qp.tensors():
            t.grad = None
        if args.path == "main":
            sol, _ = dtt.solve_qp_batched(qp, max_iters=25, with_info=True)
        else:
            sol, _ = dtt.solve_qp(qp, with_info=True)
        (sol.z**2).sum().backward()

    step()
    torch.cuda.synchronize()
    syncs = qpsolver.solve_batched.host_syncs + kkt._auto_solve.host_syncs
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    syncs = qpsolver.solve_batched.host_syncs + kkt._auto_solve.host_syncs - syncs
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
        f" in the solver's loop and the 'auto' KKT route; path = {args.path}, B = {args.batch}, on {card}"
    )
    by = lambda *keys: sum(e.self_device_time_total for e in events if any(k in e.key for k in keys)) / 1e3
    ours = {"K1 pdip": by("pdip_kernel"), "K2 ldl_factor": by("ldl_factor_kernel"), "K3 ldl_solve": by("ldl_solve_kernel"),
            "K4 chol_factor": by("chol_factor_kernel"), "K5 chol_solve": by("chol_solve_kernel")}
    own_ms = sum(ours.values())
    print("hand-written kernels: " + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items() if v)
          + f"; everything else (PyTorch glue and library calls) {busy_ms - own_ms:.2f} ms of {busy_ms:.2f} ms busy")


if __name__ == "__main__":
    main()
