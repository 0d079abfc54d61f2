"""The fused conic IPM kernel (K6) with one-warp teams against the register
budget it is built for.

    python3 -m diffopt_tpu_torch.tools.k6_registers [--blocks 24 20 16] [--turns 2]

``csrc/conic_pdip.cu`` asks ``ptxas``, through ``__launch_bounds__``, for
registers that let ``DK_CONIC_F32_BLOCKS`` one-warp teams reside on an SM in
f32 (24 in the package's build, which caps a thread at 80 registers). This
script builds the source once for each count asked for, side by side
(``ops/cuda/_build.py::build_variants``), prints what ``ptxas`` reports for
the f32 one-warp kernel of each build (registers, stack frame, spill stores
and loads), and times that kernel (CUDA events, the mean of three calls after
one warm-up) at the SOCP of the ``[conic]`` path (n = 16, SOC(17), B =
32768) and the SDP of psd side 4 (B = 4096), f32, ``max_iters=50``, tol
5e-6, beside the teams resident per SM by the occupancy calculator. The
builds are taken in turns, forward and back, ``--turns`` times.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from .k6_phase_cycles import LAYOUTS, _batch


def _ptxas_line(log: str) -> str:
    """ptxas's report on the f32 one-warp instantiation of conic_kernel."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "conic_kernelIfLi1E" in line:
            return " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4])
    return "not found"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", nargs="+", type=int, default=[24, 20, 16],
                    help="one-warp teams per SM the registers must allow, f32 (DK_CONIC_F32_BLOCKS)")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_registers: no CUDA device")

    from diffopt_tpu_torch.ops.cuda import _build, conic_pdip
    from diffopt_tpu_torch.solvers.conic_ipm import internal_rows

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    flags = {b: (f"-DDK_CONIC_F32_BLOCKS={b}",) for b in args.blocks}
    paths = _build.build_variants("conic_pdip", *flags.values())
    for b, path in zip(args.blocks, paths):
        print(f"[build {b}] f32, one warp: {_ptxas_line(path.with_suffix('.log').read_text())}")

    order = (args.blocks + args.blocks[::-1]) * args.turns
    for layout, B in LAYOUTS.items():
        data, lay, _ = internal_rows(_batch(layout, B))
        n, (p, l, socs, psds) = data[0].shape[1], lay
        run = lambda: conic_pdip.solve_tile_fused(*data, lay, max_iters=50, tol=5e-6, team=1)
        ms, resident = {b: [] for b in args.blocks}, {}
        for b in order:
            with _build.variant("conic_pdip", *flags[b]):
                run()
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                for _ in range(3):
                    run()
                e1.record()
                torch.cuda.synchronize()
                ms[b].append(e0.elapsed_time(e1) / 3)
                resident[b] = conic_pdip.blocks_per_sm(n, p, l, socs, psds, torch.float32, 1)
        for b in args.blocks:
            print(f"[{layout} B={B}] build {b}: {resident[b]} resident per SM, ms "
                  + " / ".join(f"{t:.3f}" for t in ms[b]) + f" on {card}")


if __name__ == "__main__":
    main()
