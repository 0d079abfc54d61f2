"""Readings that the limits of the comparison deciding ``correct`` are set from (the benchmark's own runs do
not run this).

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 ... [--control-seeds 7 8 9] [--device cpu --batch B]

For each ``--seeds`` seed: the cell's pool made from the seed, the timed path's own steps on it (two per
batch, dispatched ahead, at the cell's batch), and the check's readings against the float64 reference.
For each ``--control-seeds`` seed: the control, the plain reference put in the program's place and computed
one precision below the configuration's, over the whole batch, judged by the same check. The configurations
state float32 with TF32 off, so the control computes in TF32: every matrix product of the reference takes
its float32 operands rounded to TF32's 10-bit mantissa (what a tensor core reads), and cuBLAS's own
products run in TF32; factorisations and solves stay in float32, as TF32 leaves them. Besides the check's readings, each line holds the
tail's shares over a grid of thresholds and margins (``share_<output|grad>_m<margin>_t<threshold>``, %),
from which the tail limits are chosen. One JSON line per seed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


GRID_MARGINS = (0.0, 1e-3, 3e-3, 1e-2)
GRID_THRESHOLDS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)


def grid(verdict, out_name) -> dict:
    from portbench.harness import check

    readings = {}
    for m in GRID_MARGINS:
        if verdict.margins is None and m:
            continue
        if verdict.margins is not None:
            readings[f"kept_pct_m{m:g}"] = 100.0 * float((verdict.margins >= m).double().mean())
        for name, gaps in ((out_name, verdict.gaps[0]), ("grad", verdict.gaps[1])):
            for t in GRID_THRESHOLDS:
                readings[f"share_{name}_m{m:g}_t{t:g}"] = check.tail_pct(gaps, t, verdict.margins, m)
    return readings


def program_readings(cell, seed, device, batch):
    from portbench.harness import check, core

    r = core.Run(cell, seed, 0.0, False, device, T_PROCESS, batch)
    r.make_pool()
    r.bind_program()
    pool = len(r.programs)
    last = [None] * pool
    for k in range(2 * pool):
        last[k % pool] = r.step(k, [r.event() for _ in range(3)])
    r.sync()
    data, r.programs = r.pool, None
    verdict = check.judge(cell, data, last, seed, device)
    readings = {**verdict.readings, **grid(verdict, cell.config["output"])}
    if verdict.margins is not None:
        # the look at the tail: the worst instances' distance from degeneracy
        worst = verdict.gaps[0].argsort(descending=True)[:8].cpu()
        readings["worst_gaps"] = verdict.gaps[0].cpu()[worst].tolist()
        readings["worst_margins"] = verdict.margins[worst].tolist()
        readings["margin_median"] = verdict.margins.median().item()
        readings["margin_q01"] = verdict.margins.quantile(0.01).item()
    return readings


def to_tf32(t):
    """``t`` (float32) rounded to the nearest TF32 value (10 explicit mantissa bits), kept in float32."""
    import torch

    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_mode():
    """A torch function mode in which the reference's matrix products take their float32 operands rounded
    to TF32 (what TF32 changes on the card: products, not factorisations or solves)."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._pytree import tree_map

    ops = {"matmul", "__matmul__", "__rmatmul__", "bmm", "mm", "mv", "einsum"}  # by name: ``@`` arrives wrapped

    def rounded(x):  # the value rounded; autograd sees the identity
        if not (isinstance(x, torch.Tensor) and x.dtype == torch.float32):
            return x
        return x + (to_tf32(x.detach()) - x.detach())

    class TF32(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if getattr(func, "__name__", None) in ops:
                args, kwargs = tree_map(rounded, args), tree_map(rounded, kwargs)
            return func(*args, **kwargs)

    return TF32()


def control_outputs(cell, data, block):
    """The reference over the whole batch, in blocks, in the configuration's dtype computed in TF32."""
    import torch

    names = cell.reference.NAMES
    B = data[names[0]].shape[0]
    outs, grads = [], {k: [] for k in names}
    prev = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        with tf32_mode():
            for i in range(0, B, block):
                out, g, _, _ = cell.reference.solve_and_grad({k: data[k][i:i + block].detach() for k in names})
                outs.append(out)
                for k in names:
                    grads[k].append(g[k])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])
    return torch.cat(outs), tuple(torch.cat(grads[k]) for k in names)


def control_readings(cell, seed, device, batch, block=8192):
    from portbench.harness import check, core

    r = core.Run(cell, seed, 0.0, False, device, T_PROCESS, batch)
    r.make_pool()
    outputs = [control_outputs(cell, d, block) for d in r.pool]
    verdict = check.judge(cell, r.pool, outputs, seed, device)
    return {**verdict.readings, **grid(verdict, cell.config["output"])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    args = ap.parse_args()

    import torch

    from portbench.harness import card
    from portbench.harness.spec import load_cell

    torch.set_num_threads(1)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "host"
    for what, seeds, fn in (("program", args.seeds, program_readings), ("control", args.control_seeds, control_readings)):
        for seed in seeds:
            t0 = time.perf_counter()
            readings = fn(cell, seed, args.device, args.batch)
            print(json.dumps({"workload": cell.name, "run": what, "seed": seed, "device": kind,
                              "seconds": round(time.perf_counter() - t0, 3), **readings}), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    if card.forbidden_modules():
        print(f"calibrate: loaded {card.forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
