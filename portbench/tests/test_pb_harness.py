"""The harness end to end on the host: every cell's rehearsal prints a well-formed last line, loads no
module of JAX or of the JAX package, and the check fails the timed path when it is broken underneath."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.harness import card, check, core
from portbench.harness.spec import HERE, ROOT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_prints_a_result_line(workload, trace):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", "2147483649",
                          "--seconds", "0.5", "--trace", str(trace), "--rehearse-on-cpu", "8"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "check" and {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    cell = load_cell(workload)
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= want
    if not trace:
        assert set(result["metrics"]) == want
    assert out.stderr.strip().splitlines()[-1].startswith("check nonfinite")


def test_no_card_no_result():
    # a measured run never rehearses: without a card it fails and prints no result
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode != 0 and not out.stdout.strip()


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import portbench.harness.core, portbench.calibrate, "
            "diffopt_tpu_torch; from portbench.harness import card; print(card.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
    assert set(card.FORBIDDEN) >= {"jax", "diffopt_tpu", "__graft_entry__"}
    assert "diffopt_tpu_torch".split(".")[0] not in card.FORBIDDEN


def broken(fn, fault):
    """``fn`` with its output broken where it is produced."""
    first = []

    def run(prog, **kw):
        sol = fn(prog, **kw)
        out_name = "z" if hasattr(sol, "z") else "x"
        out = getattr(sol, out_name)
        if fault == "answer altered":
            out = out * (1 + 1e-3)
        elif fault.endswith("the batch left out"):  # the rest's answers zeroed where they are produced
            share = {"half": 0.5, "45%": 0.45, "30%": 0.3}[fault.split()[0]]
            keep = torch.arange(out.shape[0], device=out.device) >= int(share * out.shape[0])
            out = torch.where(keep[:, None], out, torch.zeros_like(out))
        elif fault == "state unchanged":  # every step hands back the first step's answers
            first.append(out.detach()) if not first else None
            out = first[0] + 0 * out
        return sol.__class__(**{**{k: getattr(sol, k) for k in sol.__dataclass_fields__}, out_name: out})
    return run


@pytest.mark.parametrize("fault", ["answer altered", "half the batch left out", "45% of the batch left out",
                                   "state unchanged"])
@pytest.mark.parametrize("workload", CELLS)
def test_check_fails_a_broken_step(workload, fault, monkeypatch):
    import diffopt_tpu_torch as dtt

    cell = load_cell(workload)
    monkeypatch.setattr(dtt, cell.traffic["entry"], broken(getattr(dtt, cell.traffic["entry"]), fault))
    r = core.Run(cell, 7, 0.2, False, "cpu", 0.0, batch=8)
    r.measure()
    verdict = check.judge(cell, r.pool, r.last, 7, "cpu")
    assert verdict.correct is False, verdict.readings


@pytest.mark.parametrize("workload", CELLS)
def test_odd_split_passes_the_medians_and_fails_the_tail(workload, monkeypatch):
    """30% of the answers zeroed: the medians fall among the sound answers, so only the tail counts fail it
    (at 45% a batch this small can hold enough near-degenerate answers to move the gradients' median too)."""
    import diffopt_tpu_torch as dtt

    cell = load_cell(workload)
    monkeypatch.setattr(dtt, cell.traffic["entry"], broken(getattr(dtt, cell.traffic["entry"]), "30% of the batch left out"))
    r = core.Run(cell, 7, 0.2, False, "cpu", 0.0, batch=16)
    r.measure()
    verdict = check.judge(cell, r.pool, r.last, 7, "cpu")
    out = cell.config["output"]
    failed = {k for k, n in verdict.numbers.items() if n["value"] > n["limit"]}
    assert failed and failed <= {f"{out}_tail_pct", "grad_tail_pct"}, verdict.numbers


def test_tf32_rounding_keeps_ten_mantissa_bits():
    sys.path.insert(0, str(HERE))
    from portbench import calibrate

    x = torch.randn(4096, dtype=torch.float32) * 100
    r = calibrate.to_tf32(x)
    assert ((r - x).abs() <= x.abs() * 2.0**-11).all()
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


def test_sound_step_passes_the_same_check():
    cell = load_cell(CELLS[0])
    r = core.Run(cell, 7, 0.2, False, "cpu", 0.0, batch=8)
    r.measure()
    assert check.judge(cell, r.pool, r.last, 7, "cpu").correct is True


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_check(workload, card):
    """The reference in the program's place, in float32 with TF32 matmuls, on the card at a batch a test
    run holds: ``correct`` comes out false."""
    sys.path.insert(0, str(HERE))
    from portbench import calibrate

    cell = load_cell(workload)
    readings = calibrate.control_readings(cell, 11, card, 4096)
    limits = cell.traffic["limits"]
    assert any(readings[k] > v for k, v in limits.items()), readings


@pytest.mark.chip
@pytest.mark.parametrize("workload", CELLS)
def test_odd_split_fails_at_the_cells_size(workload, card, monkeypatch):
    """45% of the answers zeroed where they are produced, on the card at the cell's own batch and sample:
    the tail counts turn ``correct`` false."""
    import diffopt_tpu_torch as dtt

    cell = load_cell(workload)
    monkeypatch.setattr(dtt, cell.traffic["entry"], broken(getattr(dtt, cell.traffic["entry"]), "45% of the batch left out"))
    r = core.Run(cell, 13, 0.0, False, card, 0.0)
    r.measure()
    verdict = check.judge(cell, r.pool, r.last, 13, card)
    out = cell.config["output"]
    assert verdict.correct is False
    assert verdict.numbers[f"{out}_tail_pct"]["value"] > verdict.numbers[f"{out}_tail_pct"]["limit"], verdict.numbers
