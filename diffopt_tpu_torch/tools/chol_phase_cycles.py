"""Times and cycle counts by phase of the Cholesky kernels K4 (factor) and K5
(solve), per instance, at the shapes the port launches them.

    python3 -m diffopt_tpu_torch.tools.chol_phase_cycles [--factor 3 6 16 ... 160]
        [--solve 3:1 6:1 16:1 ... 160:3] [--team 0 1 2 8] [--dtype f32]
        [--no-cycles] [--sass] [--reps R]

For each shape (the batch of the path that launches it, as
``chip_smoke.py::CHOL_FACTOR_SHAPES`` gives it; SPD matrices X X' / n + I
from a seed on the card) it prints the kernel's
device time (``--reps`` launches in the package's own build captured in a
CUDA graph and replayed, timed by CUDA events) beside the time of as many
calls one after another through the wrapper (which at small shapes is the
host's: the wrapper's Python takes longer than the kernel), the bound
(the bytes the function needs at 3.35 TB/s, counted as ``chip_smoke.py::bound``
counts the n = 34 row: the lower triangle of H read and L written in full;
the lower triangle of L and the right-hand sides read and x written), the
library call's time (``torch.linalg.cholesky_ex`` / ``torch.cholesky_solve``),
the instances resident per SM (the occupancy calculator) and, unless
``--no-cycles``, the cycles per instance by phase: ``csrc/chol.cu`` carries
probes (``csrc/prof.cuh``) that compile to nothing in the package's build;
this script builds the source once more with ``-DDK_PROFILE``
(``ops/cuda/_build.py::variant``) and reads the counters after one launch.
A probe is a barrier of the instance's team and one thread's clock read, so
the phases add up to the instance's time from its start to its end,
including the time its warps wait while other instances on the SM run.
``--team`` takes the launch rule's choice (0) or a team of warps (1, 2, 8 for
the factor; the solve takes one warp at k = 1 and two past it); a team that
does not take a shape is reported and skipped. ``--sass`` counts, per
kernel of the built library, the memory instructions ``cuobjdump -sass``
shows: generic ``LD`` / ``ST`` (64-bit addresses) against shared ``LDS`` /
``STS``, device ``LDG`` / ``STG`` and asynchronous ``LDGSTS`` copies.

Run against a checkout that lacks this file with ``PYTHONPATH=<checkout>
python3 <this file>``: where that checkout's wrappers take no team, or its
source has no probes or occupancy query, those columns are left out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from collections import Counter

import torch

PEAK_BYTES_PER_S = 3.35e12
PHASES = ["copy in", "factor / forward sweep", "backward sweep", "write out"]
INSTANCES = 15
FACTOR = (3, 6, 16, 17, 18, 34, 44, 64, 144, 160)
SOLVE = ("3:1", "6:1", "16:1", "16:16", "17:1", "18:1", "34:1", "44:1", "64:1", "64:16", "144:1", "160:3")
# the batch of the path that launches n (chip_smoke.py::CHOL_FACTOR_SHAPES): the [sdp] paths at n = 3,
# 18, 44 and 144, the [exp] gram route at n = 17 (and n = 6), 256 at n = 160; the staged QP path and
# the SOCP gram route elsewhere
BATCH = {3: 4096, 6: 16384, 17: 16384, 18: 4096, 44: 4096, 144: 4096, 160: 256}


def batch_for(n: int) -> int:
    return BATCH.get(n, 32768)


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


def graph_ms(fn, reps):
    """Device time of one call: ``reps`` calls captured in a CUDA graph, replayed, timed by events (as
    ``chip_smoke.py::graph_ms``: at small shapes the wrapper's host time is longer than the kernel's)."""
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


def sass_counts(path) -> dict[str, Counter]:
    """Memory instructions per kernel (entry function) of a built library, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)(\.[A-Z0-9.]+)?", line)
        if fn and m:
            op = m.group(1)
            if op in ("LD", "ST", "LDS", "STS", "LDG", "STG", "LDGSTS", "LDSM", "ATOMS", "SHFL", "BAR", "WARPSYNC"):
                counts[fn][op] += 1
    return counts


def _demangle(names):
    filt = shutil.which("c++filt") or shutil.which("cu++filt")
    if not filt:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--factor", nargs="*", type=int, default=list(FACTOR), help="n of the factor shapes")
    ap.add_argument("--solve", nargs="*", default=list(SOLVE), help="n:k of the solve shapes")
    ap.add_argument("--team", nargs="+", type=int, default=[0], help="0 (the rule) or a team of warps (1, 2, 8)")
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-cycles", action="store_true", help="times only (no probed build)")
    ap.add_argument("--sass", action="store_true", help="memory instructions per kernel, by cuobjdump")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chol_phase_cycles: no CUDA device")

    from diffopt_tpu_torch.ops.cuda import _build, chol

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dt = torch.float32 if args.dtype == "f32" else torch.float64
    item = 4 if dt == torch.float32 else 8
    teams = args.team
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    has_teams = hasattr(chol, "team_for")
    records = []

    def launcher(op, n, k, H, L, rhs, team):
        kw = {} if team == 0 else {"team": team}
        if op == "factor":
            return lambda: chol.cholesky_batched(H, **kw)
        return lambda: chol.cholesky_solve_batched(L, rhs, **kw)

    def cycles(run):
        with _build.variant("chol", "-DDK_PROFILE") as lib:
            if not hasattr(lib, "chol_prof_read"):
                return None
            lib.chol_prof_read.argtypes = [ctypes.c_void_p]
            run()
            torch.cuda.synchronize()
            lib.chol_prof_zero()
            run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 16)()
            lib.chol_prof_read(ctypes.cast(buf, ctypes.c_void_p))
        inst = max(buf[INSTANCES], 1)
        return [buf[i] / inst for i in range(len(PHASES))]

    shapes = [("factor", n, 0) for n in args.factor] + [
        ("solve", int(s.split(":")[0]), int(s.split(":")[1])) for s in args.solve]
    for op, n, k in shapes:
        B = batch_for(n)
        X = torch.randn(B, n, n, dtype=dt, device="cuda", generator=gen)
        H = X @ X.transpose(1, 2) / n + torch.eye(n, dtype=dt, device="cuda")
        del X
        L = chol.cholesky_batched(H)
        rhs = torch.randn(*((B, n) if k == 1 else (B, n, k)), dtype=dt, device="cuda", generator=gen)
        if op == "factor":
            nbytes = B * item * (n * (n + 1) // 2 + n * n)
            lib_ms = timed(lambda: torch.linalg.cholesky_ex(H), max(2, args.reps // 5))
        else:
            nbytes = B * item * (n * (n + 1) // 2 + 2 * n * k)
            r3 = rhs[..., None] if k == 1 else rhs
            lib_ms = timed(lambda: torch.cholesky_solve(r3, L), max(2, args.reps // 5))
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        for team in teams:
            if team and not has_teams:
                continue
            torch.cuda.empty_cache()
            if has_teams:
                kk = 0 if op == "factor" else k
                t_ = team or chol.team_for(n, kk, item)[0]
                if not chol.team_takes(n, kk, item, t_):
                    print(f"[{op} n={n} k={k} team {team}] not taken by that team")
                    continue
                p_ = chol.per_block_of(n, kk, item, t_)
            else:
                t_, p_ = 0, 0
            run = launcher(op, n, k, H, L, rhs, team)
            eager_ms = timed(run, args.reps)
            ms = graph_ms(run, args.reps)
            try:
                resident = chol.blocks_per_sm(n, 0 if op == "factor" else k, dt, t_)
            except (AttributeError, RuntimeError, TypeError):
                resident = None
            cyc = None if args.no_cycles else cycles(run)
            tag = f"{op} n={n}" + (f" k={k}" if k else "") + (f" team {t_} x{p_}" if has_teams else "")
            print(f"[{tag}] {ms:.4f} ms for B = {B} {args.dtype} ({eager_ms:.4f} ms a call through the wrapper;"
                  f" bound {bound_ms:.4f} ms by bytes, {bound_ms / ms:.1%}; library {lib_ms:.4f} ms);"
                  f" resident per SM: {resident}; on {card}")
            if cyc:
                total = sum(cyc)
                print(f"[{tag}] cycles per instance {total:.0f}: " + ", ".join(
                    f"{name} {c:.0f} ({c / total:.1%})" for name, c in zip(PHASES, cyc) if c))
            records.append(dict(op=op, n=n, k=k, batch=B, team=t_, per_block=p_, ms=ms, eager_ms=eager_ms,
                                bound_ms=bound_ms,
                                library_ms=lib_ms, resident_per_sm=resident, cycles=cyc))
        del H, L, rhs
        torch.cuda.empty_cache()
    if args.sass:
        path = _build._build_all()["chol"]
        counts = sass_counts(path)
        names = _demangle(list(counts))
        for fn, c in counts.items():
            print(f"[sass] {names[fn][:90]}: " + ", ".join(f"{op} {c[op]}" for op in sorted(c)))
    print(json.dumps({"chol_phase_cycles": records, "dtype": args.dtype, "card": card}))


if __name__ == "__main__":
    main()
