"""The kernels' work counts against ``chip_smoke.py``'s bounds at the main path's shapes."""

import pytest

from portbench.harness.spec import kernel_work

PEAKS = kernel_work("peaks")


def rec(kernel, shape, B=32768):
    return {"batch": B, "config": {"dtype": "float32"}, "counters": {kernel: {shape: 1}}}


@pytest.mark.parametrize("kernel,shape,ms", [("K2", (112, 0), 0.7428), ("K3", (112, 1), 0.2564),
                                             ("K4", (64, 0), 0.2416), ("K5", (64, 1), 0.0864)])
def test_bound_matches_chip_smoke(kernel, shape, ms):
    (nbytes, flops), = kernel_work(kernel).work(rec(kernel, shape), None)
    t, by = PEAKS.bound_s(nbytes, flops)
    assert by == "bytes" and round(t * 1e3, 4) == ms


def test_k1_and_k6_count_the_reference_iterations():
    cfg = {"n": 64, "m": 32, "p": 16, "dtype": "float32"}
    r = {"batch": 32768, "config": cfg, "counters": {"K1": {(): 2}}}
    one = kernel_work("K1").work(r, lambda tol: 4.0)
    two = kernel_work("K1").work(r, lambda tol: 9.0)
    assert len(one) == 2 and two[0][1] == pytest.approx(one[0][1] * 2) and one[0][0] == two[0][0]
    socp = {"n": 16, "cones": [["soc", 17]], "dtype": "float32"}
    r = {"batch": 32768, "config": socp, "traffic": {"kwargs": {"tol": 1e-5}}, "counters": {"K6": {(): 1}}}
    (nbytes, flops), = kernel_work("K6").work(r, lambda tol: 0.0)
    body, metrics, init = kernel_work("K6").body_metrics_init(16, 0, 0, [17])
    assert flops == 32768 * (init + 3 * metrics)
