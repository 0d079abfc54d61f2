"""The plain references against closed-form cases and finite differences (float64, on the host)."""

import pytest
import torch

from portbench.harness.spec import HERE, load_file

QP = load_file(HERE / "configs" / "qp_dense_n64.py", "ref_qp")
SOCP = load_file(HERE / "configs" / "socp_n16.py", "ref_socp")
f64 = torch.float64


def small_qp(B=6, n=5, m=4, p=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return QP.generate(dict(n=n, m=m, p=p), B, gen, "cpu", f64)


def test_qp_inactive_constraints_give_the_unconstrained_minimiser():
    d = small_qp(p=0)
    d["h"] = d["h"] + 1e6  # every inequality far from active
    z, grads, audit, _ = QP.solve_and_grad(d)
    want = -torch.linalg.solve(d["Q"], d["q"][..., None])[..., 0]
    assert audit == 0
    torch.testing.assert_close(z, want, rtol=1e-9, atol=1e-9)
    # d sum(z^2) / dq = -2 Q^-1 z, and nothing flows to G, h of inactive rows
    torch.testing.assert_close(grads["q"], -2 * torch.linalg.solve(d["Q"], z[..., None])[..., 0], rtol=1e-8, atol=1e-10)
    assert grads["G"].abs().max() == 0 and grads["h"].abs().max() == 0


def test_qp_projection_onto_a_halfspace():
    # min 1/2 |z - c|^2 s.t. a'z <= 0 with a'c > 0: z = c - (a'c / a'a) a
    B, n = 4, 3
    c = torch.tensor([[1.0, 2.0, 3.0]] * B, dtype=f64)
    a = torch.tensor([[1.0, 1.0, 1.0]] * B, dtype=f64)
    d = dict(Q=torch.eye(n, dtype=f64).expand(B, n, n).clone(), q=-c, A=torch.zeros(B, 0, n, dtype=f64),
             b=torch.zeros(B, 0, dtype=f64), G=a[:, None, :].clone(), h=torch.zeros(B, 1, dtype=f64))
    z, _, audit, _ = QP.solve_and_grad(d)
    assert audit == 0
    torch.testing.assert_close(z, c - ((a * c).sum(-1) / (a * a).sum(-1))[:, None] * a, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name,index", [("Q", (1, 2, 3)), ("q", (0, 1)), ("A", (2, 1, 0)), ("b", (3, 1)),
                                        ("G", (4, 2, 3)), ("h", (5, 0))])
def test_qp_gradient_against_finite_differences(name, index):
    d = small_qp(B=6, n=6, m=5, p=2, seed=3)
    _, grads, _, _ = QP.solve_and_grad(d)
    eps = 1e-6

    def loss(sign):
        e = {k: v.clone() for k, v in d.items()}
        e[name][index] += sign * eps
        if name == "Q":  # keep Q symmetric: the program's objective reads only its symmetric part
            e[name][index[0], index[2], index[1]] += sign * eps
        return (QP.solve_and_grad(e)[0] ** 2).sum()

    fd = (loss(1) - loss(-1)) / (2 * eps)
    got = grads[name][index] + (grads[name][index[0], index[2], index[1]] if name == "Q" else 0)
    assert abs(float(fd) - float(got)) <= 1e-5 * (1 + abs(float(fd)))


def test_socp_closed_form_is_the_interior_point_solution():
    gen = torch.Generator().manual_seed(1)
    d = SOCP.generate(dict(n=6, cones=[["soc", 7]]), 16, gen, "cpu", f64)
    x, _, _, _ = SOCP.solve_and_grad(d)
    x_ipm, history = SOCP.ipm(d, tol=1e-13)
    assert float(history[-1].max()) <= 1e-13
    # the objective agrees to the tolerance; x to about its square root (the boundary is curved)
    obj = lambda v: (d["c"] * v).sum(-1)
    torch.testing.assert_close(obj(x_ipm), obj(x), rtol=1e-10, atol=1e-10)
    assert float((x_ipm - x).abs().max()) <= 1e-5
    s = d["b"] - (d["A"] @ x[..., None])[..., 0]
    assert float((s[:, 1:].norm(dim=-1) - s[:, 0]).abs().max()) <= 1e-10  # on the cone's boundary


@pytest.mark.parametrize("name,index", [("A", (2, 0, 3)), ("A", (1, 4, 2)), ("b", (0, 0)), ("b", (3, 5)), ("c", (5, 1))])
def test_socp_gradient_against_finite_differences(name, index):
    gen = torch.Generator().manual_seed(2)
    d = SOCP.generate(dict(n=6, cones=[["soc", 7]]), 8, gen, "cpu", f64)
    _, grads, _, _ = SOCP.solve_and_grad(d)
    eps = 1e-6

    def loss(sign):
        e = {k: v.clone() for k, v in d.items()}
        e[name][index] += sign * eps
        return (SOCP.solve_and_grad(e)[0] ** 2).sum()

    fd = (loss(1) - loss(-1)) / (2 * eps)
    assert abs(float(fd) - float(grads[name][index])) <= 1e-6 * (1 + abs(float(fd)))


def test_qp_interior_point_history_reaches_its_tolerance():
    d = small_qp(B=8, n=8, m=6, p=3, seed=4)
    _, _, _, history = QP.ipm(d, tol=1e-12)
    assert float(history[-1].max()) <= 1e-12
    assert history.shape[0] <= 40
