"""Cycle counts of the fused PDIP kernel's (K1) phases, per instance.

    python3 -m diffopt_tpu_torch.tools.pdip_phase_cycles [--shape 64 32 16] [--team 0 2 8] [--batch B]

Where no kernel profiler can be used this is the substitute: ``csrc/pdip.cu``
carries ``DK_PROF`` probes (``csrc/prof.cuh``) after each phase (a barrier,
then one thread adds the cycles since the last probe to a counter in device
memory) that compile to nothing in the package's own build. This script
compiles the source once more with ``-DDK_PROFILE`` into the build directory
(``ops/cuda/_build.py::variant``) and runs the package's wrapper on that
build, once on each shape (n m p; default the headline 64 32 16 at B = 32768
and 100 48 24 at B = 8192) and team size asked for (``--team 0``, the
default, is the launch rule's team), f32, on the batches of
``utils/testing.py::make_batch`` at ``max_iters=25``. It prints the cycles
per instance by phase, absolute and as shares, the teams resident per SM (the
occupancy calculator), the kernel's time in the package's own build beside
the probed one, and what ptxas reported for each instantiation. Cycles are
counted per instance from its team's start to its end, so they include the
time its warps wait while other teams on the same SM run: the cycles of two
team sizes differ by the residency as much as by the work. The probes'
barriers cost a few percent.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

PHASES = [  # counter k of the source's enum PdipProf
    "factor: [H; A] assembled + eliminated (L, W')", "factor: S assembled + factorised",
    "direction: right-hand side", "direction: substitution chain (warp 0)", "direction: ds, dlam",
    "residuals + scalars", "step lengths, sigma, update", "init (staging, pointers, shift)", "exit (scoring, output)",
]
TOTAL, BODIES = 14, 15


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", nargs=3, type=int, action="append", metavar=("N", "M", "P"),
                    help="n m p (repeatable; default: 64 32 16 and 100 48 24)")
    ap.add_argument("--team", nargs="+", type=int, choices=(0, 1, 2, 8), default=[0],
                    help="warps per instance (0: the launch rule's choice)")
    ap.add_argument("--batch", type=int, default=None, help="instances (default 32768; 8192 at n > 64)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pdip_phase_cycles: no CUDA device")

    from diffopt_tpu_torch.ops.cuda import _build, pdip
    from diffopt_tpu_torch.utils.testing import make_batch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1)

    shapes = args.shape or [[64, 32, 16], [100, 48, 24]]
    for n, m, p in shapes:
        B = args.batch or (32768 if n <= 64 else 8192)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        qp = make_batch(B, n, m, p, torch.float32, "cuda", gen)
        for team in dict.fromkeys(t or pdip.team_for(n, m, p, 4) for t in args.team):
            if not pdip.team_takes(n, m, p, 4, team):
                print(f"[n={n} m={m} p={p} team {team}] a team of {team} warps does not take the shape")
                continue
            run = lambda: pdip.solve_batched_fused(qp, max_iters=25, team=team)
            own_ms = timed(run)  # the package's own build
            with _build.variant("pdip", "-DDK_PROFILE") as lib:
                lib.pdip_prof_read.argtypes = [ctypes.c_void_p]
                run()
                torch.cuda.synchronize()
                lib.pdip_prof_zero()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                run()
                e1.record()
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 16)()
                lib.pdip_prof_read(ctypes.cast(buf, ctypes.c_void_p))
            total = buf[TOTAL] / B
            tag = f"n={n} m={m} p={p} team {team}"
            stage = pdip.stage_for(n, m, p, 4, team)
            print(f"[{tag}] kernel {own_ms:.2f} ms (probed build {e0.elapsed_time(e1):.2f} ms) for B = {B}, f32,"
                  f" a team of {team} warps per instance, Q, G, A {'staged' if stage else 'in device memory'},"
                  f" {pdip.smem_bytes(n, m, p, 4, stage, team)} bytes of shared memory a team,"
                  f" {pdip.blocks_per_sm(n, m, p, torch.float32, team)} resident per SM"
                  f" ({pdip.instances_per_sm(n, m, p, 4, team, stage)} by the model), on {card}")
            print(f"[{tag}] mean per instance: {total:.0f} cycles; the init and {buf[BODIES] / B - 1:.2f} loop bodies")
            for k, name in enumerate(PHASES):
                print(f"[{tag}]   {name:48s} {buf[k] / B:10.0f} cycles  {buf[k] / B / total:6.1%}")
    # ptxas on each instantiation of the package's own build: registers, stack, spills
    entry = None
    for line in (_build.build_dir() / "pdip.nvcc.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry, spill = line.split("'")[1], ""
        elif entry and "spill" in line:
            spill = line.strip()
        elif entry and "Used" in line:
            print(f"[ptxas] {entry}: {line.split(':', 1)[1].strip()}; {spill}")
            entry = None


if __name__ == "__main__":
    main()
