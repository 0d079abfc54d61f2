"""Times, residency and cycle counts by phase of the LDL' kernels K2 (factor)
and K3 (solve), per instance, at the shapes the QP paths launch them, for
this checkout's build and, beside it in the same call, a parent checkout's.

    python3 -m diffopt_tpu_torch.tools.ldl_phase_cycles [--parent DIR] [--parent-only]
        [--factor 112:32768 172:8192 ...] [--solve 112:1:32768 172:1:8192 ...]
        [--team 0 1 2 8] [--dtype f32] [--no-cycles] [--reps R]

Shapes are N:B for the factor and N:k:B for the solve (defaults: the
``[main]`` path's N = 112 at B = 32768 and ``[qp100]``'s N = 172 at B = 8192,
both with k = 1). The inputs are quasi-definite matrices made on the card from
a seed ([[P, C'], [C, -R]], P and R positive definite), the factor of the
parent's build (or of this one's) and random right-hand sides.

For each shape it prints the device time (``--reps`` launches captured in a
CUDA graph and replayed, timed by CUDA events) of the parent's build and of
this checkout's, in turns (parent, change, change, parent), whether the two
give the same bits, the bound (the bytes the function needs at 3.35 TB/s,
counted as ``chip_smoke.py`` counts them: the lower triangle of K read, L in
full and d written; the strict lower triangle of L, d and the right-hand sides
read, x written), the library call's time (``torch.linalg.lu_factor`` /
``lu_solve``), the instances resident per SM (the occupancy calculator) and,
unless ``--no-cycles``, the cycles per instance by phase (copy in, factor or
forward sweep, backward sweep, write out). This checkout's ``csrc/ldl.cu``
carries probes (``csrc/prof.cuh``) that compile to nothing in the package's
build; it is built once more with ``-DDK_PROFILE``. The parent's source has
no probes: it is compiled here twice from its own ``csrc/`` (once as it is,
once with probes inserted at its phase boundaries, its arithmetic untouched),
each with an occupancy query appended. A probe is a barrier of the instance's
team and one thread's clock read, so the phases add up to the instance's time
from its start to its end, including the time its warps wait while other
instances on the SM run. ``--team`` takes this checkout's launch rule (0) or a
team of warps; a team that does not take a shape is reported and skipped.
Registers and spills of every kernel of both builds are printed from
``nvcc -Xptxas -v``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12
PHASES = ["copy in", "factor / forward sweep", "backward sweep", "write out"]
INSTANCES = 15
FACTOR = ("112:32768", "172:8192")
SOLVE = ("112:1:32768", "172:1:8192")

# Probes for the parent's csrc/ldl.cu (the source before the redesign), inserted at its phase boundaries;
# each anchor must occur exactly once. Counters as in csrc/prof.cuh: 0 copy in, 1 factor or both sweeps
# (that source runs them back to back), 3 write out, 15 instances.
_PARENT_PROBES = [
    ('#include "dense.cuh"\n', '#include "dense.cuh"\n#include "prof.cuh"\n'),
    ("  T* colbuf = smem + N;\n", "  T* colbuf = smem + N;\n  DK_PROF_START();\n"),
    ("  factor_tile<T, kRows>(t, N, dvec, colbuf);\n",
     "  DK_PROF(0);\n  factor_tile<T, kRows>(t, N, dvec, colbuf);\n  DK_PROF(1);\n"),
    ("  for (int i = threadIdx.x; i < N; i += kThreads) dg[i] = dvec[i];\n}\n",
     "  for (int i = threadIdx.x; i < N; i += kThreads) dg[i] = dvec[i];\n  DK_PROF(3);\n"
     "  if (threadIdx.x == 0) DK_PROF_ADD(15, 1);\n}\n"),
    ("  T* dvec = M + size_t(N) * ld;\n  // a flat", "  T* dvec = M + size_t(N) * ld;\n  DK_PROF_START();\n  // a flat"),
    ("  __syncthreads();\n\n  factor_lower<T>(M, ld, N, dvec);\n",
     "  DK_PROF(0);\n  factor_lower<T>(M, ld, N, dvec);\n  DK_PROF(1);\n"),
    ("  for (int i = tid; i < N; i += kThreads) dg[i] = dvec[i];\n}\n",
     "  for (int i = tid; i < N; i += kThreads) dg[i] = dvec[i];\n  DK_PROF(3);\n  if (tid == 0) DK_PROF_ADD(15, 1);\n}\n"),
    ("  const T* rg = rhs + size_t(blockIdx.x) * N * k;\n",
     "  const T* rg = rhs + size_t(blockIdx.x) * N * k;\n  DK_PROF_START();\n"),
    ("  __syncthreads();\n\n  for (int c = warp; c < k; c += kWarps) {", "  DK_PROF(0);\n\n  for (int c = warp; c < k; c += kWarps) {"),
    ("  }\n  __syncthreads();\n\n  T* og =", "  }\n  DK_PROF(1);\n\n  T* og ="),
    ("    og[e] = X[c * N + i];\n  }\n}\n", "    og[e] = X[c * N + i];\n  }\n  DK_PROF(3);\n  if (tid == 0) DK_PROF_ADD(15, 1);\n}\n"),
]

# appended to the parent's source: its residency by the occupancy calculator and, with -DDK_PROFILE, the counters
_PARENT_EXPORTS = r"""
namespace dk {
template <typename T>
int parent_blocks_per_sm(int N, int k) {
  int blocks = 0;
  cudaError_t e;
  if (k == 0) {
    const size_t smem = ldl_factor_smem<T>(N);
    e = cudaFuncSetAttribute(ldl_factor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ldl_factor_kernel<T>, kThreads, smem);
  } else {
    const size_t smem = ldl_solve_smem<T>(N, k);
    e = cudaFuncSetAttribute(ldl_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ldl_solve_kernel<T>, kThreads, smem);
  }
  return e == cudaSuccess ? blocks : -int(e);
}
}  // namespace dk
extern "C" {
int ldl_blocks_per_sm(int N, int k, int itemsize, int /*team*/) {
  return itemsize == 4 ? dk::parent_blocks_per_sm<float>(N, k) : dk::parent_blocks_per_sm<double>(N, k);
}
#ifdef DK_PROFILE
int ldl_prof_read(unsigned long long* out) { return dk::prof_read(out); }
int ldl_prof_zero() { return dk::prof_zero(); }
#endif
}
"""


def probed_parent_source(text: str) -> str:
    for old, new in _PARENT_PROBES:
        if text.count(old) != 1:
            raise SystemExit(f"ldl_phase_cycles: the parent's ldl.cu does not have the anchor {old!r} exactly once")
        text = text.replace(old, new)
    return text


def build_parent(parent: Path, probed: bool) -> tuple[ctypes.CDLL, str]:
    """The parent's ldl.cu (with probes if ``probed``) and the exports above as one library; its ptxas log."""
    from diffopt_tpu_torch.ops.cuda import _build

    csrc = parent / "diffopt_tpu_torch" / "csrc"
    text = (csrc / "ldl.cu").read_text()
    text = (probed_parent_source(text) if probed else text) + _PARENT_EXPORTS
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256((text + (csrc / "dense.cuh").read_text() + str(probed)).encode()).hexdigest()[:12]
    src, lib = out / f"ldl_parent_{tag}.cu", out / f"libldl_parent_{tag}.so"
    log = lib.with_suffix(".log")
    if not lib.exists():
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *(["-DDK_PROFILE"] if probed else []), "-I", str(csrc),
               "-o", str(lib), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise SystemExit(f"ldl_phase_cycles: nvcc failed on the parent's source:\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for sfx in ("f32", "f64"):
        getattr(dll, f"ldl_factor_{sfx}").argtypes = [vp, vp, vp, ci, ci, vp]
        getattr(dll, f"ldl_solve_{sfx}").argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
    dll.ldl_blocks_per_sm.argtypes = [ci] * 4
    dll.dk_error_string.argtypes, dll.dk_error_string.restype = [ci], ctypes.c_char_p
    return dll, log.read_text()


def ptxas_lines(log: str) -> list[str]:
    """ptxas's 'Compiling entry' / 'Used N registers' / spill lines, one line per kernel."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and ("spill" in line or "Used" in line):
            out.append(f"{fn[:60]}: {line.split('info    :')[-1].strip()}")
    return out


def graph_ms(fn, reps):
    """Device time of one call: ``reps`` calls captured in a CUDA graph, replayed, timed by events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    del g
    return e0.elapsed_time(e1) / reps


def timed(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def quasi_definite(B, N, dt, gen):
    """[[P, C'], [C, -R]] with P, R positive definite (the first 58% of the rows positive, as the QP paths'
    n of N), symmetric, on the card."""
    M = torch.randn(B, N, N, dtype=dt, device="cuda", generator=gen)
    K = torch.baddbmm(torch.eye(N, dtype=dt, device="cuda").expand(B, N, N), M, M.transpose(1, 2), alpha=1.0 / N)
    del M
    n1 = (N * 58 + 99) // 100
    K[:, n1:, n1:] *= -1.0
    return torch.tril(K) + torch.tril(K, -1).transpose(1, 2)


def read_cycles(lib, run):
    lib.ldl_prof_read.argtypes = [ctypes.c_void_p]
    run()
    torch.cuda.synchronize()
    lib.ldl_prof_zero()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    lib.ldl_prof_read(ctypes.cast(buf, ctypes.c_void_p))
    inst = max(buf[INSTANCES], 1)
    return [buf[i] / inst for i in range(len(PHASES))]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of the parent commit, timed beside this one")
    ap.add_argument("--parent-only", action="store_true", help="time and probe the parent's build only")
    ap.add_argument("--factor", nargs="*", default=list(FACTOR), help="N:B of the factor shapes")
    ap.add_argument("--solve", nargs="*", default=list(SOLVE), help="N:k:B of the solve shapes")
    ap.add_argument("--team", nargs="+", type=int, default=[0], help="0 (the rule) or a team of warps")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-cycles", action="store_true", help="times only (no probed builds)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ldl_phase_cycles: no CUDA device")
    if args.parent_only and not args.parent:
        raise SystemExit("ldl_phase_cycles: --parent-only needs --parent")
    torch.backends.cuda.matmul.allow_tf32 = False

    from diffopt_tpu_torch.ops.cuda import _build, chol

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dt = torch.float32 if args.dtype == "f32" else torch.float64
    item, sfx = (4, "f32") if dt == torch.float32 else (8, "f64")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    parent = parent_probed = None
    if args.parent:
        parent, plog = build_parent(args.parent, probed=False)
        for line in ptxas_lines(plog):
            print(f"[ptxas parent] {line}")
        if not args.no_cycles:
            parent_probed, _ = build_parent(args.parent, probed=True)
    if not args.parent_only:
        _build.load("ldl")
        for line in ptxas_lines((_build.build_dir() / "ldl.nvcc.log").read_text()):
            print(f"[ptxas change] {line}")

    stream = lambda: torch.cuda.current_stream().cuda_stream  # the capture's stream inside a CUDA graph

    def parent_factor(lib, K, L, d):
        fn = getattr(lib, f"ldl_factor_{sfx}")
        return lambda: _build.check(lib, fn(K.data_ptr(), L.data_ptr(), d.data_ptr(), K.shape[0], K.shape[1],
                                            stream()), "parent ldl_factor")

    def parent_solve(lib, L, d, rhs, out, k):
        fn = getattr(lib, f"ldl_solve_{sfx}")
        return lambda: _build.check(lib, fn(L.data_ptr(), d.data_ptr(), rhs.data_ptr(), out.data_ptr(), L.shape[0],
                                            L.shape[1], k, stream()), "parent ldl_solve")

    def change_cycles(run):
        with _build.variant("ldl", "-DDK_PROFILE") as lib:
            return read_cycles(lib, run) if hasattr(lib, "ldl_prof_read") else None

    shapes = [("factor", int(s.split(":")[0]), 0, int(s.split(":")[1])) for s in args.factor]
    shapes += [("solve", *map(int, s.split(":"))) for s in args.solve]
    records = []
    for op, N, k, B in shapes:
        K = quasi_definite(B, N, dt, gen)
        if args.parent:
            Lq, dq = torch.empty_like(K), K.new_empty(B, N)
            parent_factor(parent, K, Lq, dq)()
        else:
            Lq, dq = chol.ldl_batched(K)
        rhs = torch.randn(*((B, N) if k == 1 else (B, N, k)), dtype=dt, device="cuda", generator=gen)
        if op == "factor":
            nbytes = B * item * (N * (N + 1) // 2 + N * N + N)
            lib_ms = timed(lambda: torch.linalg.lu_factor(K), 2)
            out_p = (torch.empty_like(K), K.new_empty(B, N))
            run_p = (lambda lib: parent_factor(lib, K, *out_p)) if args.parent else None
            change = lambda **kw: chol.ldl_batched(K, **kw)
        else:
            nbytes = B * item * (N * (N - 1) // 2 + N + 2 * N * k)
            lu, piv = torch.linalg.lu_factor(K)
            r3 = rhs[..., None] if k == 1 else rhs
            lib_ms = timed(lambda: torch.linalg.lu_solve(lu, piv, r3), 3)
            del lu, piv
            out_p = torch.empty_like(rhs)
            run_p = (lambda lib: parent_solve(lib, Lq, dq, rhs, out_p, k)) if args.parent else None
            change = lambda **kw: chol.ldl_solve_batched(Lq, dq, rhs, **kw)
            del K
            torch.cuda.empty_cache()
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        tag = f"{op} N={N}" + (f" k={k}" if k else "") + f" B={B} {args.dtype}"
        rec = dict(op=op, N=N, k=k, batch=B, bound_ms=bound_ms, library_ms=lib_ms)
        if args.parent:
            rec["parent_resident_per_sm"] = parent.ldl_blocks_per_sm(N, k, item, 0)
            rec["parent_cycles"] = None if args.no_cycles else read_cycles(parent_probed, run_p(parent_probed))
        teams = [] if args.parent_only else args.team
        for team in teams:
            kk = 0 if op == "factor" else k
            t_ = team or chol.ldl_team_for(N, kk, item)[0]
            if not chol.ldl_team_takes(N, kk, item, t_):
                print(f"[{tag} team {team}] not taken by that team")
                continue
            kw = {} if team == 0 else {"team": team}
            run_c = lambda: change(**kw)
            ms = {}
            for which in (("parent", "change", "change", "parent") if args.parent else ("change",)):
                ms.setdefault(which, []).append(graph_ms(run_p(parent) if which == "parent" else run_c, args.reps))
            same = None
            if args.parent:
                got = run_c()
                run_p(parent)()
                torch.cuda.synchronize()
                same = (all(torch.equal(a, b) for a, b in zip(got, out_p)) if op == "factor"
                        else torch.equal(got, out_p))
            r = dict(rec, team=t_, per_block=chol.ldl_team_for(N, kk, item)[1] if team == 0 else None,
                     ms=ms["change"], parent_ms=ms.get("parent"), bitwise_parent=same,
                     resident_per_sm=chol.ldl_blocks_per_sm(N, kk, dt, t_),
                     cycles=None if args.no_cycles else change_cycles(run_c))
            records.append(r)
            pm = f"; parent {', '.join(f'{v:.4f}' for v in ms['parent'])} ms, bitwise the same {same}" if args.parent else ""
            print(f"[{tag} team {t_}] {', '.join(f'{v:.4f}' for v in ms['change'])} ms{pm}; bound {bound_ms:.4f} ms by"
                  f" bytes ({bound_ms / min(ms['change']):.1%}); library {lib_ms:.4f} ms; resident per SM"
                  f" {r['resident_per_sm']}" + (f" (parent {rec['parent_resident_per_sm']})" if args.parent else "")
                  + f"; on {card}")
            if r["cycles"]:
                total = sum(r["cycles"])
                print(f"[{tag} team {t_}] cycles per instance {total:.0f}: " + ", ".join(
                    f"{nm} {c:.0f} ({c / total:.1%})" for nm, c in zip(PHASES, r["cycles"]) if c))
        if args.parent_only:
            pms = graph_ms(run_p(parent), args.reps)
            records.append(dict(rec, parent_ms=[pms]))
            print(f"[{tag} parent] {pms:.4f} ms; bound {bound_ms:.4f} ms by bytes ({bound_ms / pms:.1%}); library"
                  f" {lib_ms:.4f} ms; resident blocks per SM {rec['parent_resident_per_sm']}; on {card}")
        if args.parent and rec["parent_cycles"]:
            cyc = rec["parent_cycles"]
            total = sum(cyc)
            print(f"[{tag} parent] cycles per instance {total:.0f}: " + ", ".join(
                f"{nm} {c:.0f} ({c / total:.1%})" for nm, c in zip(PHASES, cyc) if c))
        del Lq, dq, rhs, out_p, change, run_p
        torch.cuda.empty_cache()
    print(json.dumps({"ldl_phase_cycles": records, "dtype": args.dtype, "card": card}))


if __name__ == "__main__":
    main()
