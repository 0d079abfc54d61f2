"""What the per-layer readers (``metrics/<name>.py``) share. Each reader takes the traced run's records and
returns a number, or None where the run has nothing to read: the harness then leaves the metric out."""

from __future__ import annotations

import statistics

from .spec import kernel_work

# device names of the port's hand-written kernels K1-K7 (K3 and K5 are one template, tri_solve_kernel,
# told apart by its diagonal policy)
HAND_WRITTEN = ("pdip_kernel", "ldl_factor_", "tri_solve_kernel", "chol_factor_", "conic_kernel", "ns_kernel")


def mean_ms(rec, key):
    values = rec.get(key) or []
    return statistics.fmean(values) if values else None


def device_time_s(rec, pattern):
    return sum(t for name, (_, t) in rec.get("kernels", {}).items() if pattern in name)


def glue_ms(rec):
    if not rec.get("kernels"):
        return None
    other = sum(t for name, (_, t) in rec["kernels"].items() if not any(k in name for k in HAND_WRITTEN))
    return other * 1e3 / rec["steps"]


def launches_per_step(rec):
    if not rec.get("kernels"):
        return None
    return sum(count for count, _ in rec["kernels"].values()) / rec["steps"]


def host_syncs_per_step(rec):
    """Host calls that wait for the card, per step, less the harness's own waits (the end event of the step
    ``depth`` back, once a step, and the synchronize at the window's end)."""
    calls = rec.get("host_calls")
    if calls is None or not rec.get("kernels"):
        return None
    waits = sum(v for k, v in calls.items() if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                                     "cudaEventSynchronize"))
    return max(0, waits - rec["harness_waits"]) / rec["steps"]


def idle_share(rec):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def sm_clock_mhz(rec):
    from .card import sm_mhz

    values = [sm_mhz(r) for r in rec.get("clocks", [])]
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def reference_iterations(rec, tol):
    """Mean over the reference's fixed sample of the iterations its interior-point method needs to bring
    the criterion to ``tol`` (a lane that never does counts every iteration run)."""
    hist = rec["reference_history"]
    reached = hist <= tol
    first = reached.float().argmax(0)
    first[~reached.any(0)] = hist.shape[0] - 1
    return first.double().mean().item()


def roofline(rec, kernel):
    """Share (%) of the kernel's device time in the window that its least time at the published peaks
    takes: None where the window launched it on no shape or the trace holds no device time for it."""
    module = kernel_work(kernel)
    peaks = kernel_work("peaks")
    device_s = device_time_s(rec, module.PATTERN)
    launches = module.work(rec, lambda tol: reference_iterations(rec, tol))
    if not launches or device_s <= 0:
        return None
    bounds = [peaks.bound_s(nbytes, flops) for nbytes, flops in launches]
    least = sum(t for t, _ in bounds)
    by = {w: sum(t for t, x in bounds if x == w) for w in ("bytes", "operations")}
    rec.setdefault("notes", []).append(
        f"{kernel}: {len(launches)} launches, least time {least * 1e3:.4f} ms ({by['bytes'] * 1e3:.4f} ms of it"
        f" bound by bytes, {by['operations'] * 1e3:.4f} ms by operations) of {device_s * 1e3:.4f} ms on the device")
    return 100.0 * least / device_s
