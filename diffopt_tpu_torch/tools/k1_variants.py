"""The fused PDIP kernel (K1) built with extra nvcc flags, beside the package's build.

    python3 -m diffopt_tpu_torch.tools.k1_variants --defines "DK_PDIP_STAGE=1" "DK_PDIP_F32_BLOCKS_2=6 DK_PDIP_MATVEC_ROWS=8" [--probe]

``csrc/pdip.cu`` reads a few macros an experiment may set: the f32 teams per
SM its launch bounds ask the registers for (``DK_PDIP_F32_BLOCKS_1``, ``_2``,
``_8``; 24, 8, 3 in the package's build), the staging of Q, G, A
(``DK_PDIP_STAGE``: 0 never, 1 wherever it fits; the rule's choice
otherwise) and the rows a warp's matrix-vector products keep in flight
(``DK_PDIP_MATVEC_ROWS``, 4).
This script builds the source once for each set of macros (``-D`` each), side by side
(``ops/cuda/_build.py::build_variants``; with ``--probe`` once more with
``-DDK_PROFILE``), and for each build prints what ptxas reports for the f32
instantiations of the team the rule picks at each shape (the kernel and the
functions it calls: registers, stack, spills), the teams resident per SM
(occupancy calculator), the kernel's time (CUDA events, the mean of three
calls after one warm-up) at the headline shape (n = 64, m = 32, p = 16, B =
32768) and at n = 100, m = 48, p = 24 (B = 8192), f32, ``max_iters=25``, on
the batches of ``utils/testing.py::make_batch``, and with ``--probe`` the
cycles per instance by phase, and whether each build's outputs are bitwise
those of the package build. The builds are timed in turns, forward and
back. It calls the library's C entry with the launch rule's team (its
source decides the staging), not the package's wrapper, whose mirror of the
rules a variant may not match.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from .pdip_phase_cycles import BODIES, PHASES, TOTAL

SHAPES = {"headline": (64, 32, 16, 32768), "n100": (100, 48, 24, 8192)}


def _ptxas(log: str, team: int) -> list[str]:
    """ptxas's report on the f32 functions of a team's instantiation: one line each."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            name = line.split("'")[1] if "'" in line else line.rsplit(" ", 1)[-1]
        elif name and f"IfLi{team}E" in name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--defines", nargs="*", default=[],
                    help="sets of macros, one string each (space-separated NAME=VALUE or NAME)")
    ap.add_argument("--probe", action="store_true", help="also build with -DDK_PROFILE and print phase cycles")
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: no CUDA device")

    from diffopt_tpu_torch.ops.cuda import _build
    from diffopt_tpu_torch.ops.cuda.pdip import default_reg, default_tol
    from diffopt_tpu_torch.utils.testing import make_batch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    sets = [()] + [tuple(f"-D{d}" for d in ds.split()) for ds in args.defines]
    probed = [s + ("-DDK_PROFILE",) for s in sets] if args.probe else []
    paths = _build.build_variants("pdip", *sets, *probed)
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    libs = []
    for path in paths:
        lib = ctypes.CDLL(str(path))
        lib.pdip_fused_f32.argtypes = [vp] * 11 + [ci] * 5 + [cd, cd, ci, vp]
        lib.pdip_fused_f32.restype = ci
        lib.pdip_team.argtypes = [ci] * 4
        lib.pdip_stage.argtypes = [ci] * 5
        lib.pdip_blocks_per_sm.argtypes = [ci] * 5
        lib.pdip_smem_bytes.argtypes = [ci] * 6
        lib.pdip_smem_bytes.restype = ctypes.c_longlong
        libs.append(lib)
    name = lambda k: " ".join(sets[k]) or "package build"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for label, (n, m, p, B) in SHAPES.items():
        qp = make_batch(B, n, m, p, torch.float32, "cuda", gen)
        outs = [torch.empty(B, k, device="cuda") for k in (n, m, p, m)] + [torch.empty(B, dtype=torch.int32, device="cuda")]
        z, lam, nu, s, it = outs

        def run(lib):
            code = lib.pdip_fused_f32(
                qp.Q.data_ptr(), qp.q.data_ptr(), qp.A.data_ptr(), qp.b.data_ptr(), qp.G.data_ptr(), qp.h.data_ptr(),
                z.data_ptr(), lam.data_ptr(), nu.data_ptr(), s.data_ptr(), it.data_ptr(), B, n, m, p, 25,
                default_tol(torch.float32), default_reg(torch.float32), 0, torch.cuda.current_stream().cuda_stream,
            )
            if code != 0:
                raise SystemExit(f"k1_variants: launch failed with CUDA error {code}")

        team = libs[0].pdip_team(n, m, p, 4)
        results = []
        for lib in libs[:len(sets)]:
            run(lib)
            results.append([t.clone() for t in outs])
        ms = {k: [] for k in range(len(sets))}
        for k in (list(range(len(sets))) + list(range(len(sets)))[::-1]) * args.turns:
            run(libs[k])
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(3):
                run(libs[k])
            e1.record()
            torch.cuda.synchronize()
            ms[k].append(e0.elapsed_time(e1) / 3)
        for k in range(len(sets)):
            lib = libs[k]
            stage = lib.pdip_stage(n, m, p, 4, team)
            print(f"[{label} n={n} m={m} p={p} B={B}] {name(k)}: team {team}, staged {stage},"
                  f" {lib.pdip_smem_bytes(n, m, p, 4, team, stage)} bytes, {lib.pdip_blocks_per_sm(n, m, p, 4, team)}"
                  " resident per SM, ms " + " / ".join(f"{t:.3f}" for t in ms[k]) + f" on {card}; outputs"
                  f" {'bitwise equal to' if all(torch.equal(a, b) for a, b in zip(results[k], results[0])) else 'DIFFERENT from'}"
                  " the package build's")
            if label == "headline" or team != libs[0].pdip_team(*SHAPES["headline"][:3], 4):
                for line in _ptxas(paths[k].with_suffix(".log").read_text(), team):
                    print(f"[ptxas {name(k)}] {line}")
        for k, lib in enumerate(libs[len(sets):]):
            lib.pdip_prof_read.argtypes = [vp]
            run(lib)
            torch.cuda.synchronize()
            lib.pdip_prof_zero()
            run(lib)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.pdip_prof_read(ctypes.cast(buf, vp))
            total = buf[TOTAL] / B
            print(f"[{label} probe] {name(k)}: {total:.0f} cycles per instance, {buf[BODIES] / B - 1:.2f} bodies; "
                  + ", ".join(f"{ph.split(':')[-1].strip()} {buf[j] / B:.0f}" for j, ph in enumerate(PHASES)))


if __name__ == "__main__":
    main()
