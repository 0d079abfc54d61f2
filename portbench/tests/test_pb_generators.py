"""The inputs follow the sources' distributions and are a function of the seed."""

import json

import torch

from portbench.harness.spec import HERE, load_file

QP = load_file(HERE / "configs" / "qp_dense_n64.py", "gen_qp")
SOCP = load_file(HERE / "configs" / "socp_n16.py", "gen_socp")
QP_CFG = json.loads((HERE / "configs" / "qp_dense_n64.json").read_text())
SOCP_CFG = json.loads((HERE / "configs" / "socp_n16.json").read_text())


def test_qp_batch_is_strictly_convex_and_seeded():
    make = lambda seed: QP.generate(QP_CFG, 64, torch.Generator().manual_seed(seed), "cpu", torch.float32)
    d, again, other = make(2147483647), make(2147483647), make(5)
    assert all(torch.equal(d[k], again[k]) for k in d) and not torch.equal(d["q"], other["q"])
    n, m, p = QP_CFG["n"], QP_CFG["m"], QP_CFG["p"]
    assert d["Q"].shape == (64, n, n) and d["G"].shape == (64, m, n) and d["A"].shape == (64, p, n)
    Q = d["Q"].double()
    torch.testing.assert_close(Q, Q.transpose(1, 2))
    assert float(torch.linalg.eigvalsh(Q).min()) >= n * (1 - 1e-5)  # L L' + n I
    assert abs(float(d["h"].mean()) - 2.0) < 0.1 and abs(float(d["q"].std()) - 1.0) < 0.05


def test_socp_batch_is_feasible_bounded_and_clamped():
    gen = torch.Generator().manual_seed(3000000000)
    d = SOCP.generate(SOCP_CFG, 256, gen, "cpu", torch.float32)
    A, b = d["A"].double(), d["b"].double()
    e, F, f, g = -A[:, 0], -A[:, 1:], b[:, 0], -b[:, 1:]
    sv = torch.linalg.svdvals(F)
    assert float(sv.min()) >= 1 - 1e-5 and float(sv.max()) <= 2 + 1e-5
    torch.testing.assert_close(e.norm(dim=-1), torch.full((256,), 0.5, dtype=torch.float64))
    assert bool((f > g.norm(dim=-1)).all())  # x = 0 strictly feasible
    assert d["c"].shape == (256, SOCP_CFG["n"]) and A.shape[1] == SOCP_CFG["cones"][0][1]
