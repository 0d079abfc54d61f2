"""The comparison that decides ``correct``: the outputs of the window's last step on each batch of the pool
(the solution and the gradient of every data tensor), on a sample of instances drawn from the seed,
against the plain reference in float64 on the same inputs.

Per instance, the gap of an output is ``max |program - reference|`` over its entries, over the larger of
the reference's largest entry for that instance and the median of those over the sample (a gradient can be
all but zero on one instance: an inequality row that is not active has none). The gradient's gap is the
largest over the data tensors. The numbers compared are statistics of these gaps over the sample: the
quantiles ``<output>_gap_<stat>`` and ``grad_gap_<stat>``, which hold the bulk of the answers, and the tail
counts ``<output>_tail_pct`` and ``grad_tail_pct``, which hold each answer: the share (%) of the sampled
instances whose gap passes the traffic mix's ``tail`` threshold, among those that the reference finds at
least ``tail.margin`` from degeneracy (where the reference gives no margin, every instance). The traffic
mix's ``limits`` names which are compared and their limits. Besides, ``nonfinite`` counts the sampled
answers with a value that is not finite, and is compared exactly (limit 0).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

STATS = {"max": 1.0, "q99": 0.99, "q95": 0.95, "q90": 0.9, "median": 0.5}
BLOCK = 4096  # instances a reference call takes at a time


@dataclass
class Verdict:
    correct: bool
    failed: int
    numbers: dict  # compared name -> {"value", "limit"}
    readings: dict  # every statistic, compared or not
    lines: list = field(default_factory=list)  # "check <name> <value> limit <limit>", for standard error
    info: list = field(default_factory=list)  # earlier lines of standard output
    samples: list = field(default_factory=list)  # the f64 inputs of the sample of each batch
    gaps: tuple = ()  # the per-instance gaps (output, gradient) over the samples, in order
    margins: torch.Tensor | None = None  # the reference's per-instance margin over the samples, if it gives one


def sample_index(seed: int, slot: int, batch: int, size: int) -> torch.Tensor:
    gen = torch.Generator()
    gen.manual_seed((seed * 2654435761 + 97 * slot + 12345) % 2**63)
    return torch.randperm(batch, generator=gen)[:size]


def instance_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    p, r = prog.flatten(1).double(), ref.flatten(1).double()
    num = (p - r).abs().amax(-1)
    den = r.abs().amax(-1)
    gap = num / torch.maximum(den, den.median()).clamp(min=torch.finfo(torch.float64).tiny)
    return torch.nan_to_num(gap, nan=float("inf"))


def reference_outputs(reference, data: dict, block: int):
    """The reference's solution, gradients, audit and margins on ``data`` (float64), in blocks of ``block``
    instances."""
    outs, grads, audit, margins = [], {k: [] for k in data}, 0, []
    B = next(iter(data.values())).shape[0]
    for i in range(0, B, block):
        out, g, bad, margin = reference.solve_and_grad({k: v[i:i + block] for k, v in data.items()})
        outs.append(out)
        for k in g:
            grads[k].append(g[k])
        audit += bad
        margins.append(margin)
    margins = None if margins[0] is None else torch.cat(margins)
    return torch.cat(outs), {k: torch.cat(v) for k, v in grads.items()}, audit, margins


def gaps_of(cell, reference_fn, data_slots, outputs, seed, device):
    """Per-instance gaps of the output and of the gradient over the sample of every pool slot, with the
    reference's audit, its margins (or None) and the sampled inputs."""
    traffic, names = cell.traffic, cell.reference.NAMES
    out_gaps, grad_gaps, audit, samples, margins = [], [], 0, [], []
    for slot, (data, (out, grads)) in enumerate(zip(data_slots, outputs)):
        B = out.shape[0]
        idx = sample_index(seed, slot, B, min(traffic["check_sample"], B)).to(out.device)
        d64 = {k: data[k].detach()[idx].to(device=device, dtype=torch.float64) for k in names}
        samples.append(d64)
        r_out, r_grads, bad, margin = reference_fn(d64)
        audit += bad
        margins.append(margin)
        out_gaps.append(instance_gaps(out[idx], r_out))
        grad_gaps.append(torch.stack([instance_gaps(g[idx], r_grads[k]) for k, g in zip(names, grads)]).amax(0))
    margins = None if margins[0] is None else torch.cat(margins).double().cpu()
    return torch.cat(out_gaps), torch.cat(grad_gaps), audit, samples, margins


def statistics_of(name: str, gaps: torch.Tensor) -> dict:
    g = gaps.double().cpu()
    return {f"{name}_gap_{s}": (float(g.max()) if q == 1.0 else float(torch.quantile(g, q))) for s, q in STATS.items()}


def tail_pct(gaps: torch.Tensor, threshold: float, margins, min_margin: float) -> float:
    """Share (%) of the instances whose gap is above ``threshold``, among those at least ``min_margin``
    from degeneracy by the reference (every instance where it gives no margins); counted over all."""
    over = gaps.double().cpu() > threshold
    if margins is not None:
        over &= margins >= min_margin
    return 100.0 * float(over.sum()) / over.numel()


def judge(cell, data_slots, outputs, seed, device) -> Verdict:
    fn = lambda d: reference_outputs(cell.reference, d, BLOCK)
    with torch.no_grad():
        out_gaps, grad_gaps, audit, samples, margins = gaps_of(cell, fn, data_slots, outputs, seed, device)
    out_name = cell.config["output"]
    readings = {**statistics_of(out_name, out_gaps), **statistics_of("grad", grad_gaps)}
    tail = cell.traffic.get("tail")
    if tail:
        m = tail.get("margin", 0.0)
        readings[f"{out_name}_tail_pct"] = tail_pct(out_gaps, tail[out_name], margins, m)
        readings["grad_tail_pct"] = tail_pct(grad_gaps, tail["grad"], margins, m)
    limits = cell.traffic.get("limits", {})
    bad = ~torch.isfinite(out_gaps) | ~torch.isfinite(grad_gaps)
    readings["nonfinite"] = int(bad.sum())
    numbers = {k: {"value": readings[k], "limit": v} for k, v in limits.items()}
    numbers["nonfinite"] = {"value": readings["nonfinite"], "limit": 0}
    correct = len(numbers) > 1 and all(n["value"] <= n["limit"] for n in numbers.values())
    info = [f"portbench check: {out_gaps.numel()} instances against the float64 reference; readings "
            + ", ".join(f"{k} {v:.6e}" for k, v in readings.items() if k != "nonfinite")
            + f"; reference lanes whose active set did not hold up: {audit}"]
    lines = [f"check {k} {n['value']:.6e} limit {n['limit']:.6e}" for k, n in numbers.items()]
    return Verdict(correct, readings["nonfinite"], numbers, readings, lines, info, samples, (out_gaps, grad_gaps),
                   margins)
