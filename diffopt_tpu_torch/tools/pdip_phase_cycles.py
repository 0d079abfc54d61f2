"""Cycle counts of the fused PDIP kernel's phases, per block.

    python3 -m diffopt_tpu_torch.tools.pdip_phase_cycles [--batch 32768]

Where no kernel profiler can be used this is the substitute: ``csrc/pdip.cu``
carries ``DK_PROF`` probes after each phase (a block barrier, then thread 0
adds the cycles since the last probe to a counter in device memory) that
compile to nothing in the package's own build. This script compiles the source
once more with ``-DDK_PROFILE`` into the build directory and runs it once on
the main path's shape (n = 64, m = 32, p = 16, f32). The probes' barriers cost
a few percent; the shares are what to read.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

PHASES = [  # counter k of the source's DK_PROF(k)
    "factor: H assembled + factorised", "factor: W = L^-1 A'", "factor: S assembled + factorised",
    "direction: right-hand side", "direction: substitution chain (warp 0)", "direction: ds, dlam",
    "residuals + scalars", "staging + pointers",
]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32768)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pdip_phase_cycles: no CUDA device")

    from diffopt_tpu_torch.ops.cuda import _build
    from diffopt_tpu_torch.ops.cuda.pdip import MAX_SMEM_BYTES, default_reg, default_tol, smem_bytes
    from diffopt_tpu_torch.utils.testing import make_batch

    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libpdip_probed.so"
    subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-DDK_PROFILE", "-I", str(_build.CSRC), "-o", str(lib_path),
         str(_build.CSRC / "pdip.cu")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.pdip_fused_f32.argtypes = [vp] * 11 + [ci] * 5 + [cd, cd, ci, vp]
    lib.pdip_fused_f32.restype = ci
    lib.pdip_prof_read.argtypes = [vp]

    B, n, m, p = args.batch, 64, 32, 16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    qp = make_batch(B, n, m, p, torch.float32, "cuda", gen)
    new = lambda k, dt=torch.float32: torch.empty(B, k, dtype=dt, device="cuda")
    z, lam, nu, s, it = new(n), new(m), new(p), new(m), torch.empty(B, dtype=torch.int32, device="cuda")
    stage = int(smem_bytes(n, m, p, 4, True) <= MAX_SMEM_BYTES)

    def run():
        code = lib.pdip_fused_f32(
            qp.Q.data_ptr(), qp.q.data_ptr(), qp.A.data_ptr(), qp.b.data_ptr(), qp.G.data_ptr(), qp.h.data_ptr(),
            z.data_ptr(), lam.data_ptr(), nu.data_ptr(), s.data_ptr(), it.data_ptr(), B, n, m, p, 25,
            default_tol(torch.float32), default_reg(torch.float32), stage, torch.cuda.current_stream().cuda_stream,
        )
        if code != 0:
            raise SystemExit(f"pdip_phase_cycles: launch failed with CUDA error {code}")

    run()
    torch.cuda.synchronize()
    lib.pdip_prof_zero()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    lib.pdip_prof_read(ctypes.cast(buf, vp))
    total = buf[8] / B
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"probed kernel: {e0.elapsed_time(e1):.2f} ms for B = {B}, n = {n}, m = {m}, p = {p}, f32, on {card}")
    print(f"mean per block: {total:.0f} cycles; the init and {buf[9] / B - 1:.2f} loop bodies")
    for k, name in enumerate(PHASES):
        print(f"  {name:42s} {buf[k] / B:10.0f} cycles  {buf[k] / B / total:6.1%}")


if __name__ == "__main__":
    main()
