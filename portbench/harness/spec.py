"""What a cell is made of, found by name: ``BENCHMARK.json`` at the checkout's root, the configuration's
``configs/<config>.json`` with its plain reference ``configs/<config>.py`` and the binding of its data to
the measured program ``configs/<config>.program.py`` beside it, the traffic mix's ``traffic/<traffic>.json``,
a reader ``metrics/<metric>.py`` for each per-layer metric (a metric ``<base>.<variant>`` without a file of
its own is read by ``metrics/<base>.py``) and a work count ``roofline/<kernel>.py`` for each kernel whose
roofline is read. A cell, a mix or a metric is added by adding such files and entries."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


def load_file(path: Path, name: str | None = None):
    """Import the Python file ``path`` as a module of its own (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name or f"portbench_{path.parent.name}_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    reference: object  # the module configs/<config>.py
    program: object  # the module configs/<config>.program.py
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def dtype(self):
        return getattr(torch, self.config["dtype"])


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    reference = load_file(HERE / "configs" / f"{w['config']}.py", f"portbench_reference_{w['config']}")
    program = load_file(HERE / "configs" / f"{w['config']}.program.py", f"portbench_program_{w['config']}")
    return Cell(w, config, traffic, reference, program,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def reader(metric: str):
    """The ``read(rec)`` function of ``metrics/<metric>.py``, or of ``metrics/<base>.py`` for a metric
    ``<base>.<variant>`` that has no file of its own."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    return load_file(path, f"portbench_metric_{path.stem.replace('.', '_')}").read


def kernel_work(kernel: str):
    """The module ``roofline/<kernel>.py``: ``PATTERN`` (its device name), ``work(rec, iterations)`` and
    ``launches()`` (the port's own launch counter of the kernel, by shape)."""
    return load_file(HERE / "roofline" / f"{kernel}.py", f"portbench_roofline_{kernel}")


def kernels() -> list[str]:
    """The kernels that have a work count: every ``roofline/<kernel>.py`` with a ``launches()``."""
    names = sorted(p.stem for p in (HERE / "roofline").glob("*.py"))
    return [k for k in names if hasattr(kernel_work(k), "launches")]
