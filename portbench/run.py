"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/`` and the package
``diffopt_tpu_torch``. ``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics (the window under ``torch.profiler``). A run needs as many CUDA cards as the cell asks for and
exits with code 2, printing no result, where there are fewer. ``--rehearse-on-cpu B`` runs the same
steps on the host with the kernels' plain versions at batch B, to rehearse the harness without a card;
its numbers are no measurement.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-on-cpu", type=int, default=None, metavar="B",
                    help="run on the host at batch B with the plain kernels (no measurement)")
    args = ap.parse_args()

    import torch

    from portbench.harness import core
    from portbench.harness.spec import load_cell

    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    if args.rehearse_on_cpu is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {cell.workload['chips']} CUDA card(s), found {have}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    else:
        device = "cpu"
    return core.run(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS, args.rehearse_on_cpu)


if __name__ == "__main__":
    sys.exit(main())
