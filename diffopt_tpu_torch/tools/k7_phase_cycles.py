"""Times, residency and cycle counts by phase of the fused nonsymmetric-cone IPM kernel K7, per
instance, for this checkout's build at each team size and, beside it in the same call, a parent
checkout's.

    python3 -m diffopt_tpu_torch.tools.k7_phase_cycles [--parent DIR] [--shape entropy32 entropy64 pow dual_exp]
        [--team 0 1 2 8] [--reps R] [--no-cycles]

Shapes (the batches ``chip_smoke.py`` holds K7 at, made from the same seeds): ``entropy32`` the ``[exp]``
path's entropy family (k = 3, n = 6, p = 1, N = 16) in f32 at B = 16384, ``entropy64`` the same family in
f64 at B = 4096, ``pow`` the pow family (N = 16) and ``dual_exp`` the dual-exp family (N = 6) in f64 at
B = 1024; the tolerance and regularisation ``chip_smoke.py`` uses (5e-6 / 1e-7 in f32, 1e-8 / 1e-11 in
f64, 150 bodies at most).

For each shape it prints the device time (``--reps`` launches timed by CUDA events) of the parent's build
and of this checkout's at each team asked for, in turns (parent, change, change, parent), whether each
team gives the parent's bits (all eight outputs), the teams resident per SM (the occupancy calculator)
and, unless ``--no-cycles``, the cycles per instance by phase: the metrics (with the best-iterate copy and
the exit tests), grad F with the per-block Hbar data, the factorisation, the four direction solves (the
affine probe, the predictor's two with its refinement residual, the centering) and the three line
searches (the affine probe's with mu_aff and sigma, the predictor's, the centering's), the update, the
init and the exit. This checkout's ``csrc/ns_pdip.cu`` carries probes (``csrc/prof.cuh``) that compile to
nothing in the package's build; it is built once more with ``-DDK_PROFILE``. The parent's source has no
probes: it is compiled here twice from its own ``csrc/`` (as it is, and with probes inserted at the same
phase boundaries, its arithmetic untouched), each with an occupancy query appended. A probe is a barrier
of the instance's team and one thread's clock read, so the phases add up to the instance's time from its
start to its end, including the time its warps wait while other instances on the SM run: the shares are
what to read, and two team sizes differ by their residency as much as by their work.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

PHASES = [  # counter k of the source's enum NsProf
    "metrics", "grad F + Hbar data", "factor (K assembled + LDL')", "solve: affine probe",
    "search: affine probe + mu_aff", "solve: predictor (2, refined)", "search: predictor",
    "solve: centering", "search: centering", "non-finite test + update", "init", "exit",
]
TOTAL, BODIES = 13, 14
SHAPES = {"entropy32": 16384, "entropy64": 4096, "pow": 1024, "dual_exp": 1024}

# Probes for the parent's csrc/ns_pdip.cu (one 256-thread block per instance), inserted at the phase
# boundaries of this checkout's source; each anchor must occur exactly once.
_PARENT_PROBES = [
    ('#include "ipm.cuh"\n', '#include "ipm.cuh"\n#include "prof.cuh"\n'),
    ("  auto take = [&w](size_t count) { T* r = w; w += count; return r; };\n",
     "  auto take = [&w](size_t count) { T* r = w; w += count; return r; };\n"
     "  DK_PROF_START();\n  const long long tstart_ = t0_;\n"),
    ("  for (int i = tid; i < mC; i += kThreads) { c.yC[i] = -c.yC[i]; c.yCb[i] = c.yC[i]; c.sb[i] = c.s[i]; }\n"
     "  __syncthreads();\n",
     "  for (int i = tid; i < mC; i += kThreads) { c.yC[i] = -c.yC[i]; c.yCb[i] = c.yC[i]; c.sb[i] = c.s[i]; }\n"
     "  __syncthreads();\n  DK_PROF(10);\n"),
    ("    if (tid == 0) cs.mu = m.mu;\n", "    DK_PROF(0);\n    if (tid == 0) cs.mu = m.mu;\n"),
    ("    hbar_data(c, eps_w);\n    factor(c);\n", "    hbar_data(c, eps_w);\n    DK_PROF(1);\n    factor(c);\n    DK_PROF(2);\n"),
    ("    solve_once(c, c.rd, c.rpE, c.rpC, c.yC, c.tdx, c.tdyE, c.dyCa, c.dsa);\n",
     "    solve_once(c, c.rd, c.rpE, c.rpC, c.yC, c.tdx, c.tdyE, c.dyCa, c.dsa);\n    DK_PROF(3);\n"),
    ("    solve_dir(c, c.g, c.dx, c.dyE, c.dyC, c.ds);\n",
     "    DK_PROF(4);\n    solve_dir(c, c.g, c.dx, c.dyE, c.dyC, c.ds);\n    DK_PROF(5);\n"),
    ("    T alpha = line_search(c, c.s, c.yC, c.ds, c.dyC, 1);\n",
     "    T alpha = line_search(c, c.s, c.yC, c.ds, c.dyC, 1);\n    DK_PROF(6);\n"),
    ("      alpha = line_search(c, c.s, c.yC, c.ds, c.dyC, 2);\n",
     "      DK_PROF(7);\n      alpha = line_search(c, c.s, c.yC, c.ds, c.dyC, 2);\n      DK_PROF(8);\n"),
    ("    mu_prev = m.mu;\n", "    DK_PROF(9);\n    mu_prev = m.mu;\n"),
    ("    gap_out[inst] = m.gaprel;\n  }\n}\n",
     "    gap_out[inst] = m.gaprel;\n  }\n  DK_PROF(11);\n"
     "  if (tid == 0) { DK_PROF_ADD(13, clock64() - tstart_); DK_PROF_ADD(14, it); }\n}\n"),
]

# appended to the parent's source: its residency by the occupancy calculator and, with -DDK_PROFILE, the counters
_PARENT_EXPORTS = r"""
namespace dk {
template <typename T>
int parent_blocks_per_sm(const NsLayout& lay) {
  const size_t smem = ns_smem_bytes(lay, int(sizeof(T)));
  cudaError_t e = cudaFuncSetAttribute(ns_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ns_kernel<T>, kThreads, smem);
  return e == cudaSuccess ? blocks : -int(e);
}
}  // namespace dk
extern "C" {
int ns_pdip_blocks_per_sm(int n, int p, int l, int nsoc, const int* soc_dims, int nns, int itemsize, int /*team*/) {
  dk::NsLayout lay;
  if (!dk::make_layout(lay, n, p, l, nsoc, soc_dims, nns, nullptr, nullptr, nullptr, nullptr)) return -1;
  return itemsize == 4 ? dk::parent_blocks_per_sm<float>(lay) : dk::parent_blocks_per_sm<double>(lay);
}
#ifdef DK_PROFILE
int ns_pdip_prof_read(unsigned long long* out) { return dk::prof_read(out); }
int ns_pdip_prof_zero() { return dk::prof_zero(); }
#endif
}
"""


def probed_parent_source(text: str) -> str:
    for old, new in _PARENT_PROBES:
        if text.count(old) != 1:
            raise SystemExit(f"k7_phase_cycles: the parent's ns_pdip.cu does not have the anchor {old!r} exactly once")
        text = text.replace(old, new)
    return text


def start_parent_build(parent: Path, probed: bool):
    """Starts nvcc on the parent's ns_pdip.cu (with probes if ``probed``) and the exports above; returns
    (library path, process or None where the library is built already)."""
    from diffopt_tpu_torch.ops.cuda import _build

    csrc = parent / "diffopt_tpu_torch" / "csrc"
    text = (csrc / "ns_pdip.cu").read_text()
    text = (probed_parent_source(text) if probed else text) + _PARENT_EXPORTS
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    deps = "".join((csrc / f).read_text() for f in ("dense.cuh", "ipm.cuh", "prof.cuh"))
    tag = hashlib.sha256((text + deps + str(probed)).encode()).hexdigest()[:12]
    src, lib = out / f"ns_pdip_parent_{tag}.cu", out / f"libns_pdip_parent_{tag}.so"
    if lib.exists():
        return lib, None
    src.write_text(text)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.SOURCE_FLAGS["ns_pdip"],
           *(["-DDK_PROFILE"] if probed else []), "-I", str(csrc), "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def open_parent(lib: Path, proc) -> ctypes.CDLL:
    if proc is not None:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise SystemExit(f"k7_phase_cycles: nvcc failed on the parent's source:\n{log}")
    dll = ctypes.CDLL(str(lib))
    vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for sfx in ("f32", "f64"):
        f = getattr(dll, f"ns_pdip_{sfx}")
        f.argtypes = [vp] * 13 + [ci] * 5 + [vp, ci, vp, vp, vp, vp, ci] + [cd] * 4 + [vp]
        f.restype = ci
    dll.ns_pdip_blocks_per_sm.argtypes = [ci, ci, ci, ci, vp, ci, ci, ci]
    dll.ns_pdip_blocks_per_sm.restype = ci
    if hasattr(dll, "ns_pdip_prof_read"):
        dll.ns_pdip_prof_read.argtypes = [vp]
    return dll


def shape_batch(name: str, B: int):
    """(K7's inputs, layout, keyword arguments) of a shape, as chip_smoke.py makes them."""
    from diffopt_tpu_torch.utils.testing import make_dual_exp_batch, make_entropy_batch, make_pow_batch, ns_internal_rows

    if name == "entropy32":
        cp = make_entropy_batch(B, k=3, seed=1, device="cuda")
    elif name == "entropy64":
        cp = make_entropy_batch(B, k=3, seed=2, dtype=torch.float64, device="cuda")
    elif name == "pow":
        cp = make_pow_batch(B, seed=3, device="cuda")
    else:  # on a generator of its own
        gen = torch.Generator(device="cuda")
        gen.manual_seed(11)
        cp = make_dual_exp_batch(B, generator=gen)
    args, (p, l, socs, ns) = ns_internal_rows(cp)
    f64 = cp.A.dtype == torch.float64
    kw = dict(max_iters=150, tol=1e-8 if f64 else 5e-6, reg=1e-11 if f64 else 1e-7, eps=1e-15 if f64 else 1e-7)
    return tuple(t.contiguous() for t in args), (p, l, tuple(socs), tuple(ns)), kw


def parent_run(dll, args, lay, kw):
    """The parent's kernel on K7's inputs (its C interface has no team); returns the eight outputs."""
    from diffopt_tpu_torch.ops import ns_barrier
    from diffopt_tpu_torch.ops.cuda.ns_pdip import _KIND_CODE

    c, bE, bC, AE, AC = args
    p, l, socs, ns = lay
    B, n = c.shape
    mC = bC.shape[1]
    outs = (c.new_empty(B, n), c.new_empty(B, p), c.new_empty(B, mC), c.new_empty(B, mC),
            torch.empty(B, dtype=torch.int32, device=c.device), c.new_empty(B), c.new_empty(B), c.new_empty(B))
    keep = ((ctypes.c_int * max(len(socs), 1))(*socs),
            (ctypes.c_int * max(len(ns), 1))(*(_KIND_CODE[k] for k, _ in ns)),
            (ctypes.c_double * max(len(ns), 1))(*(0.0 if a is None else a for _, a in ns)),
            (ctypes.c_double * max(3 * len(ns), 1))(
                *np.concatenate([ns_barrier.central(k, a) for k, a in ns] or [np.zeros(0)]).tolist()),
            (ctypes.c_double * 18)(*ns_barrier.pred_grid(0.99)))
    ptrs = [ctypes.cast(a, ctypes.c_void_p) for a in keep]
    fn = getattr(dll, "ns_pdip_f32" if c.dtype == torch.float32 else "ns_pdip_f64")
    code = fn(*(t.data_ptr() for t in args), *(t.data_ptr() for t in outs), B, n, p, l, len(socs), ptrs[0], len(ns),
              ptrs[1], ptrs[2], ptrs[3], ptrs[4], kw["max_iters"], kw["tol"], kw["reg"], kw["eps"], 0.9,
              torch.cuda.current_stream().cuda_stream)
    if code:
        raise SystemExit(f"k7_phase_cycles: the parent's kernel failed with CUDA error {code}")
    return outs


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def read_cycles(read, zero, run, B):
    run()
    torch.cuda.synchronize()
    zero()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    read(ctypes.cast(buf, ctypes.c_void_p))
    return dict(total=buf[TOTAL] / B, bodies=buf[BODIES] / B, phases=[buf[k] / B for k in range(len(PHASES))])


def print_cycles(tag, cyc):
    total = cyc["total"]
    print(f"[{tag}] cycles per instance {total:.0f}, {cyc['bodies']:.2f} bodies: " + ", ".join(
        f"{name} {c:.0f} ({c / total:.1%})" for name, c in zip(PHASES, cyc["phases"]) if c))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None, help="a checkout of the parent commit")
    ap.add_argument("--shape", nargs="+", choices=list(SHAPES), default=list(SHAPES))
    ap.add_argument("--team", nargs="+", type=int, choices=(0, 1, 2, 8), default=[0, 1, 2, 8],
                    help="warps per instance (0: the launch rule's choice)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-cycles", action="store_true", help="times only (no probed builds)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k7_phase_cycles: no CUDA device")

    from diffopt_tpu_torch.ops.cuda import _build, ns_pdip

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    pending = {}
    if args.parent:
        pending["parent"] = start_parent_build(args.parent, False)
        if not args.no_cycles:
            pending["parent_probed"] = start_parent_build(args.parent, True)
    if not args.no_cycles:  # the probed build, compiled beside the parent's
        _build.build_variants("ns_pdip", ("-DDK_PROFILE",))
    ns_pdip._lib()
    libs = {k: open_parent(*v) for k, v in pending.items()}
    records = []
    for name in args.shape:
        B = SHAPES[name]
        data, lay, kw = shape_batch(name, B)
        p, l, socs, ns = lay
        n, item = data[0].shape[1], data[0].element_size()
        N = n + p + data[2].shape[1]
        rule = ns_pdip.team_for(n, p, l, socs, ns, item)
        teams = []
        for t in args.team:
            t = t or rule
            if t in teams:
                continue
            if not ns_pdip.team_takes(n, p, l, socs, ns, item, t):
                print(f"[{name} team {t}] not taken by that team")
                continue
            teams.append(t)
        change = {t: (lambda t=t: ns_pdip.solve_tile_fused_ns(*data, lay, team=t, **kw)) for t in teams}
        rec = dict(shape=name, batch=B, N=N, dtype=str(data[0].dtype).replace("torch.", ""), rule=rule, ms={},
                   resident={t: ns_pdip.blocks_per_sm(n, p, l, socs, ns, data[0].dtype, t) for t in teams},
                   cycles={})
        head = f"[{name}] B = {B}, N = {N}, layout {lay}, {rec['dtype']}, the rule's team {rule}, on {card}"
        print(head)
        if "parent" in libs:
            run_p = lambda: parent_run(libs["parent"], data, lay, kw)
            ref = run_p()
            socs_c = ctypes.cast((ctypes.c_int * max(len(socs), 1))(*socs), ctypes.c_void_p)
            rec["resident"]["parent"] = libs["parent"].ns_pdip_blocks_per_sm(n, p, l, len(socs), socs_c, len(ns), item, 0)
            p_ms = [event_ms(run_p, args.reps)]
        c_ms = {t: [event_ms(change[t], args.reps), event_ms(change[t], args.reps)] for t in teams}
        if "parent" in libs:
            p_ms.append(event_ms(run_p, args.reps))
            rec["ms"]["parent"] = sum(p_ms) / 2
            rec["same_bits_as_parent"] = {t: all(torch.equal(a, b) for a, b in zip(change[t](), ref)) for t in teams}
            print(f"[{name} parent] {rec['ms']['parent']:.3f} ms ({p_ms[0]:.3f}, {p_ms[1]:.3f}); one 256-thread block"
                  f" per instance, {rec['resident']['parent']} resident per SM")
        for t in teams:
            rec["ms"][t] = sum(c_ms[t]) / 2
            same = rec.get("same_bits_as_parent", {}).get(t)
            print(f"[{name} team {t}] {rec['ms'][t]:.3f} ms ({c_ms[t][0]:.3f}, {c_ms[t][1]:.3f}); {rec['resident'][t]}"
                  f" resident per SM" + ("" if same is None else f"; the parent's bits: {same}"))
        if not args.no_cycles:
            if "parent_probed" in libs:
                pl = libs["parent_probed"]
                cyc = read_cycles(pl.ns_pdip_prof_read, pl.ns_pdip_prof_zero, lambda: parent_run(pl, data, lay, kw), B)
                rec["cycles"]["parent"] = cyc
                print_cycles(f"{name} parent", cyc)
            with _build.variant("ns_pdip", "-DDK_PROFILE") as lib:
                lib.ns_pdip_prof_read.argtypes = [ctypes.c_void_p]
                for t in teams:
                    cyc = read_cycles(lib.ns_pdip_prof_read, lib.ns_pdip_prof_zero, change[t], B)
                    rec["cycles"][t] = cyc
                    print_cycles(f"{name} team {t}", cyc)
        records.append(rec)
        del data
        torch.cuda.empty_cache()
    print(json.dumps({"k7_phase_cycles": records, "card": card}))


if __name__ == "__main__":
    main()
