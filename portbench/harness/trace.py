"""The traced run's profiler records reduced to what the per-layer readers read: device time and launches
by kernel name, the device's busy time over the traced window, the host's synchronizations, and the
longest idle gaps named by what the host was doing. The arithmetic of
``diffopt_tpu_torch/tools/profile_step.py`` (device time by kernel, the idle share), taken over the
whole window rather than one synchronized step."""

from __future__ import annotations

import collections

import numpy as np
import torch

# host calls that block until the card has caught up (device-to-host copies block in the runtime too)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
              "cudaMemcpyAsync")
# the harness's own spans (record_function) around the phases of a step
SPANS = ("pb.forward", "pb.backward", "pb.wait", "pb.sync")


def _events(prof):
    on_device = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        row = (name, start, start + e.duration_ns())
        if e.device_type() != on_device:
            host.append(row)
        elif name not in SPANS:  # the profiler mirrors the host's spans onto the device's timeline
            dev.append(row)
    return dev, host


def _union(intervals: np.ndarray) -> list[tuple[int, int]]:
    merged = []
    for s, e in intervals[np.argsort(intervals[:, 0])]:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_at(t, starts, ends, names, spans):
    """(the harness span, the innermost other host op) covering the host time ``t``."""
    cover = np.nonzero((starts <= t) & (ends >= t))[0]
    span = next((names[i] for i in cover[np.argsort(-starts[cover])] if names[i] in SPANS), "outside")
    inner = next((names[i] for i in cover[np.argsort(-starts[cover])] if names[i] not in SPANS), "python")
    return f"{span.removeprefix('pb.')}/{inner}"


def reduce(prof) -> dict:
    dev, host = _events(prof)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for name, s, e in dev:
        kernels[name][0] += 1
        kernels[name][1] += (e - s) * 1e-9
    syncs = collections.Counter(name for name, _, _ in host if name in SYNC_CALLS)
    out = dict(kernels={k: tuple(v) for k, v in kernels.items()}, host_calls=dict(syncs),
               busy_s=0.0, window_s=0.0, idle_gaps=[])
    if not dev:
        return out
    merged = _union(np.array([(s, e) for _, s, e in dev], dtype=np.int64))
    out["busy_s"] = sum(e - s for s, e in merged) * 1e-9
    out["window_s"] = (merged[-1][1] - merged[0][0]) * 1e-9
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1]) for i in range(len(merged) - 1)), reverse=True)
    names = [n for n, _, _ in host if not n.startswith("cuda")]
    starts = np.array([s for n, s, _ in host if not n.startswith("cuda")], dtype=np.int64)
    ends = np.array([e for n, _, e in host if not n.startswith("cuda")], dtype=np.int64)
    by_cause = collections.Counter()
    for length, at in gaps[:200]:
        by_cause[_host_at(at, starts, ends, names, SPANS)] += length * 1e-9
    out["idle_gaps"] = [[k, v] for k, v in by_cause.most_common(10)]
    return out
