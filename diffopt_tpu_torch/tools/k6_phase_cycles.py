"""Cycle counts of the fused conic IPM kernel's (K6) phases, per instance.

    python3 -m diffopt_tpu_torch.tools.k6_phase_cycles [--layout socp sdp4] [--team 0 1 2 8] [--batch B]

Where no kernel profiler can be used this is the substitute: ``csrc/conic_pdip.cu``
carries ``DK_PROF`` probes (``csrc/prof.cuh``) after each phase of a body
(a barrier, then one thread adds the cycles since the last probe to a counter
in device memory) that compile to nothing in the package's own build. This
script compiles the source once more with ``-DDK_PROFILE`` into the build
directory (``ops/cuda/_build.py::variant``) and runs the package's wrapper on
that build, once on each layout and team size asked for, f32:
``socp`` is the ``[conic]`` path's SOCP (n = 16, SOC(17), B = 32768), ``sdp4``
the SDP of psd side 4 (n = 3, SOC(4) + psd(4), B = 4096), each at
``max_iters=50`` and the tolerance ``chip_smoke.py`` times K6 at; ``--team 0``
(the default) is the launch rule's team. Cycles are counted per instance
from its team's start to its end, so they include the time its warps wait
while other teams on the same SM run: the shares are what to read, and
the cycles of two team sizes differ by the residency as much as by the
work. The probes' barriers cost a few percent.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

PHASES = [  # counter k of the source's enum ConicProf
    "metrics (residuals, sums, best iterate)", "nt_scaling", "factor (K assembled + LDL')", "w_apply (lam)",
    "lam_eigs", "solve_dir (predictor)", "max_step x2 + mu_aff (predictor)", "jmul x2 + jsolve",
    "solve_dir (corrector)", "max_step x2 (corrector)", "non-finite test + update", "init (staging + first solve)",
    "exit (scoring + output)",
]
TOTAL, BODIES = 13, 14
LAYOUTS = {"socp": 32768, "sdp4": 4096}


def _batch(layout, B):
    from diffopt_tpu_torch.utils.testing import make_sdp_batch, make_socp_batch

    if layout == "socp":
        return make_socp_batch(B, n=16, seed=1, device="cuda")
    return make_sdp_batch(B, 4, seed=3, device="cuda")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layout", nargs="+", choices=sorted(LAYOUTS), default=["socp", "sdp4"])
    ap.add_argument("--team", nargs="+", type=int, choices=(0, 1, 2, 8), default=[0],
                    help="warps per instance (0: the launch rule's choice)")
    ap.add_argument("--batch", type=int, default=None, help="instances (default: 32768 socp, 4096 sdp4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_phase_cycles: no CUDA device")

    from diffopt_tpu_torch.ops.cuda import _build, conic_pdip
    from diffopt_tpu_torch.solvers.conic_ipm import internal_rows

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    with _build.variant("conic_pdip", "-DDK_PROFILE") as lib:
        lib.conic_pdip_prof_read.argtypes = [ctypes.c_void_p]
        for layout, team in ((lay, t) for lay in args.layout for t in args.team):
            B = args.batch or LAYOUTS[layout]
            data, (p, l, socs, psds), _ = internal_rows(_batch(layout, B))
            n, mC = data[0].shape[1], data[2].shape[1]
            team = team or conic_pdip.team_for(n, p, l, socs, psds, 4)
            run = lambda: conic_pdip.solve_tile_fused(*data, (p, l, socs, psds), max_iters=50, tol=5e-6, team=team)
            run()
            torch.cuda.synchronize()
            lib.conic_pdip_prof_zero()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run()
            e1.record()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.conic_pdip_prof_read(ctypes.cast(buf, ctypes.c_void_p))
            total = buf[TOTAL] / B
            tag = f"{layout} team {team}"
            resident = conic_pdip.blocks_per_sm(n, p, l, socs, psds, torch.float32, team)
            print(f"[{tag}] probed kernel: {e0.elapsed_time(e1):.2f} ms for B = {B}, layout (p, l, soc, psd) ="
                  f" {(p, l, socs, psds)}, N = {n + p + mC}, f32, a team of {team} warps per instance,"
                  f" {resident} resident per SM, on {card}")
            print(f"[{tag}] mean per instance: {total:.0f} cycles; {buf[BODIES] / B:.2f} bodies")
            for k, name in enumerate(PHASES):
                print(f"[{tag}]   {name:42s} {buf[k] / B:10.0f} cycles  {buf[k] / B / total:6.1%}")


if __name__ == "__main__":
    main()
