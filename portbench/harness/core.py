"""One run of one cell: inputs from the seed on the card, a warm-up on the cell's own shapes, a closed loop
of training steps for ``--seconds``, the check against the plain reference, and the result line.

The loop: a step is the entry's solve on batch ``k mod pool``, ``loss = sum(out**2)`` and
``torch.autograd.grad`` to every data tensor. Steps are dispatched ahead: before enqueueing step k the host
waits on the end event of step ``k - depth`` and on nothing else, so the card always has a step queued; the
host reads no value and makes no synchronize between steps, and synchronizes once at the window's end.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import sys
import time

import torch
from torch.profiler import record_function

from . import card, check as checks, trace
from .spec import Cell, kernel_work, kernels, reader

GIB = 2**30


class HostEvent:
    """Stands in for ``torch.cuda.Event`` in a rehearsal on the host (no card: nothing is queued)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool, device: str, t_process: float,
                 batch: int | None = None):
        self.cell, self.seed, self.seconds, self.traced, self.device = cell, seed, seconds, traced, device
        self.t_process = t_process
        self.on_card = device == "cuda"
        self.batch = batch or cell.traffic["batch"]
        self.lines: list[str] = []  # the earlier lines of standard output

    # -- set-up ------------------------------------------------------------------------------------------
    def event(self):
        return torch.cuda.Event(enable_timing=True) if self.on_card else HostEvent()

    def make_pool(self):
        """``pool`` batches of the configuration's distribution, made on the device from the seed."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        self.pool = [self.cell.reference.generate(self.cell.config, self.batch, gen, self.device, self.cell.dtype)
                     for _ in range(self.cell.traffic["pool"])]

    def bind_program(self):
        import diffopt_tpu_torch as dtt

        make = self.cell.program.make
        self.programs = [make({k: v.requires_grad_(True) for k, v in d.items()}, self.cell.config) for d in self.pool]
        self.entry = getattr(dtt, self.cell.traffic["entry"])
        self.kwargs = dict(self.cell.traffic.get("kwargs", {}))

    def step(self, k: int, marks):
        prog = self.programs[k % len(self.programs)]
        marks[0].record()
        with record_function("pb.forward"):
            out = getattr(self.entry(prog, **self.kwargs), self.cell.config["output"])
        marks[1].record()
        with record_function("pb.backward"):
            grads = torch.autograd.grad((out * out).sum(), prog.tensors())
        marks[2].record()
        return out.detach(), grads

    def warm_up(self):
        for k in range(2 * len(self.programs)):
            self.step(k, [self.event() for _ in range(3)])
        self.sync()

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    # -- the window ----------------------------------------------------------------------------------------
    def window(self):
        depth = self.cell.traffic["depth"]
        self.marks, self.last = [], [None] * len(self.programs)
        self.waits = 0
        t0 = time.perf_counter()
        k = 0
        while True:
            if k >= depth:
                with record_function("pb.wait"):
                    self.marks[k - depth][2].synchronize()
                self.waits += 1
            if k >= 2 and time.perf_counter() - t0 >= self.seconds:  # two steps at least: one interval
                break
            marks = [self.event() for _ in range(3)]
            self.marks.append(marks)
            self.last[k % len(self.programs)] = self.step(k, marks)
            k += 1
        with record_function("pb.sync"):
            self.sync()
        self.steps = k

    def measure(self):
        """Set-up, then the window (under the profiler when traced)."""
        self.make_pool()
        self.bind_program()
        from diffopt_tpu_torch.ops.cuda import _build

        self.warm_up()
        self.build_s = _build.build_seconds
        self.clock_start = card.clocks() if self.on_card else {}
        self.counters_before = launch_counters()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = time.perf_counter() - self.t_process
        prof = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.on_card else [])
            prof = profile(activities=acts)
        with prof:
            self.window()
        self.memory_peak = torch.cuda.max_memory_allocated() if self.on_card else 0
        self.clock_end = card.clocks() if self.on_card else {}
        self.counters = {k: diff(v, self.counters_before[k]) for k, v in launch_counters().items()}
        self.trace = trace.reduce(prof) if self.traced else None

    # -- what the window gives ----------------------------------------------------------------------------
    def step_intervals_ms(self):
        ends = [m[2] for m in self.marks]
        return [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]

    def end_to_end(self) -> dict:
        first, last = self.marks[0][0], self.marks[-1][2]
        window_ms = first.elapsed_time(last)
        steps_ms = self.step_intervals_ms()
        self.lines.append(f"portbench window: {self.steps} steps of {self.batch} instances in {window_ms:.3f} ms"
                          f" (device clock); step interval median {statistics.median(steps_ms):.4f} ms over"
                          f" {len(steps_ms)} intervals")
        values = {}
        for m in self.cell.end_to_end:
            base = m["name"].split(".")[0]
            if base == "solves_per_s":
                values[m["name"]] = self.steps * self.batch / (window_ms * 1e-3)
            elif base == "step_ms_p95":
                values[m["name"]] = quantile(steps_ms, 0.95)
            elif base == "peak_mem_gib":
                values[m["name"]] = self.memory_peak / GIB
            elif base == "setup_s":
                values[m["name"]] = self.setup_s
            else:
                raise SystemExit(f"portbench: no end-to-end metric {m['name']!r}")
        return {k: {"value": v, "unit": next(m["unit"] for m in self.cell.end_to_end if m["name"] == k)}
                for k, v in values.items()}

    def records(self) -> dict:
        """What the per-layer readers read (the traced run)."""
        rec = dict(config=self.cell.config, traffic=self.cell.traffic, batch=self.batch, steps=self.steps,
                   forward_ms=[m[0].elapsed_time(m[1]) for m in self.marks],
                   backward_ms=[m[1].elapsed_time(m[2]) for m in self.marks],
                   clocks=[self.clock_start, self.clock_end], counters=self.counters, harness_waits=self.waits + 1,
                   **(self.trace or {}))
        rec["iterations"] = self.entry_iterations()
        return rec

    def entry_iterations(self):
        """The entry's own iteration counts, ``with_info=True``, in one untimed call on batch 0."""
        with torch.no_grad():
            _, info = self.entry(self.programs[0], with_info=True, **self.kwargs)
        return info.iterations.double().mean().item()

    def per_layer(self, rec) -> dict:
        out = {}
        for m in self.cell.per_layer:
            value = reader(m["name"])(rec)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


def launch_counters() -> dict:
    """The port's own launch counters of its hand-written kernels, by shape: each ``roofline/<kernel>.py``
    reads its kernel's."""
    return {k: kernel_work(k).launches() for k in kernels()}


def diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}


def quantile(values, q):
    """The ``q`` quantile by linear interpolation between order statistics."""
    v = sorted(values)
    x = q * (len(v) - 1)
    lo = math.floor(x)
    return v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (x - lo)


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    return {"device_ops": [[name, t] for name, (_, t) in ops], "idle_gaps": tr["idle_gaps"]}


def emit(lines, result, check_lines):
    for line in lines:
        print(line)
    for line in check_lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def reference_history(cell: Cell, sample: dict, size: int = 1024):
    """The plain reference's interior-point criterion by iteration on a fixed sample (the first ``size``
    instances of the check's sample of batch 0): the iterations these inputs need, for the rooflines."""
    with torch.no_grad():
        return cell.reference.ipm({k: v[:size] for k, v in sample.items()})[-1].cpu()


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: str, t_process: float,
        batch: int | None = None) -> int:
    r = Run(cell, seed, seconds, traced, device, t_process, batch)
    r.measure()
    metrics = None if traced else r.end_to_end()
    if r.on_card:
        r.lines.append("portbench clocks: start " + "; ".join(f"{k}={v}" for k, v in r.clock_start.items())
                       + " | end " + "; ".join(f"{k}={v}" for k, v in r.clock_end.items())
                       + f" | device count {torch.cuda.device_count()}")
    r.lines.append(f"portbench setup: {r.setup_s:.3f} s (of it the nvcc build: {r.build_s} s; None: nothing built)")
    rec = r.records() if traced else None
    # the program's state is freed before the reference runs; its outputs are kept for the check
    outputs, data = r.last, r.pool
    r.programs = r.pool = r.last = None
    verdict = checks.judge(cell, data, outputs, seed, r.device)
    del outputs, data
    if traced:
        rec["reference_history"] = reference_history(cell, verdict.samples[0])
        metrics = r.per_layer(rec)
        r.lines.extend(f"portbench roofline {note}" for note in rec.get("notes", []))
        r.lines.append(f"portbench trace: host calls {rec['host_calls']} over {r.steps} steps; the port's launch"
                       f" counters {rec['counters']}; device busy {rec['busy_s']:.6f} s of {rec['window_s']:.6f} s")
        r.lines.append(f"portbench peaks: {kernel_work('peaks').describe()}"
                       + (f"; card {r.clock_start.get('name')}, power limit {r.clock_start.get('power.limit')}"
                          if r.on_card else ""))
    r.lines.extend(verdict.info)
    found = card.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": verdict.correct, "attempted": r.steps * r.batch, "failed": verdict.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if r.on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if r.on_card else "host",
                         "count": cell.workload["chips"], "memory_peak_bytes": r.memory_peak}}
    if traced:
        result["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = breakdown(rec)
    result["check"] = verdict.numbers
    emit(r.lines, result, verdict.lines)
    return 0
