"""The port's examples (``examples/*_torch.py``) held to the closed forms that
``tests/test_examples.py`` checks of the JAX package's — ReLU and its
gradient, softmax's Jacobian, Higham's nearest correlation matrix, the
dispatch and unit-commitment prices — on the host, f64, without calling the
JAX examples."""

import pathlib
import sys

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))

torch.set_num_threads(1)

CPU = "cpu"


def test_qp_relu_matches_relu_and_its_gradient():
    from qp_layers_torch import qp_relu

    # exclude exact 0: the fully degenerate point converges at the sqrt(mu) rate
    y = torch.linspace(-2, 2, 9, dtype=torch.float64)
    np.testing.assert_allclose(qp_relu(y).numpy(), np.maximum(y.numpy(), 0), atol=1e-4)

    y2 = torch.tensor([-1.5, -0.3, 0.4, 2.0], dtype=torch.float64)
    mask = (y2 > 0).double().numpy()
    # forward mode: the tangent of y along each unit vector is the active mask's column
    with fwAD.dual_level():
        out = qp_relu(fwAD.make_dual(y2.expand(4, 4).contiguous(), torch.eye(4, dtype=torch.float64)))
        jac = fwAD.unpack_dual(out).tangent
    np.testing.assert_allclose(jac.numpy(), np.diag(mask), atol=1e-5)
    # reverse mode
    yr = y2.clone().requires_grad_()
    qp_relu(yr).sum().backward()
    np.testing.assert_allclose(yr.grad.numpy(), mask, atol=1e-5)


def test_qp_layers_training_converges():
    from qp_layers_torch import learn_polytope, train_qp_relu_mlp

    losses = train_qp_relu_mlp(steps=25, device=CPU)
    assert losses[-1] < 0.5 * losses[0], losses
    losses = learn_polytope(steps=30, device=CPU)
    assert losses[-1] < 0.5 * losses[0], losses


def test_autotuning_ridge_gradient_is_the_closed_form():
    from autotuning_ridge_torch import autotune, ridge_fit

    hist = autotune(steps=30, device=CPU)
    assert hist[-1][1] <= hist[0][1]  # validation loss non-increasing
    # d w / d alpha = -(X'X + alpha I)^-1 w for w = (X'X + alpha I)^-1 X'y
    rng = np.random.default_rng(3)
    X, y = torch.as_tensor(rng.normal(size=(20, 4))), torch.as_tensor(rng.normal(size=20))
    alpha = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    w = ridge_fit(X, y, alpha)
    seed = torch.as_tensor(rng.normal(size=4))
    (g,) = torch.autograd.grad(w @ seed, alpha)
    H = X.T @ X + 0.7 * torch.eye(4, dtype=torch.float64)
    w_ref = torch.linalg.solve(H, X.T @ y)
    np.testing.assert_allclose(w.detach().numpy(), w_ref.numpy(), atol=1e-8)
    np.testing.assert_allclose(float(g), float(-torch.linalg.solve(H, w_ref) @ seed), atol=1e-8)


def test_sensitivity_examples():
    from sensitivity_analysis_torch import (economic_dispatch_prices, matrix_inversion_manual_check,
                                            ridge_data_sensitivity, svm_hyperplane_sensitivity)

    w, dw = svm_hyperplane_sensitivity(device=CPU)
    assert np.all(np.isfinite(w)) and np.all(np.isfinite(dw))
    assert w[0] > 0 and w[1] > 0  # the separating direction of the +2 / -2 clusters points positive

    g, price, dg = economic_dispatch_prices(demand=10.0, device=CPU)
    np.testing.assert_allclose(g, [6.0, 4.0], atol=1e-5)  # cheap unit at its limit, expensive one the rest
    np.testing.assert_allclose(price, 3.0, atol=1e-5)  # the marginal unit's cost
    np.testing.assert_allclose(dg, [0.0, 1.0], atol=1e-4)  # extra demand goes to the marginal unit

    z, manual, port = matrix_inversion_manual_check(device=CPU)
    np.testing.assert_allclose(z, [-0.25, -0.75], atol=1e-6)
    np.testing.assert_allclose(port, manual, atol=1e-7)

    w, b, dw, X = ridge_data_sensitivity(device=CPU)
    assert abs(w - 2.0) < 0.3 and abs(b - 0.5) < 0.3
    # the points far from the mean of x lever the slope most, with the sign of (x_i - xbar)
    assert np.corrcoef(dw, X - X.mean())[0, 1] > 0.99


def test_nearest_correlation_matches_higham():
    from nearest_correlation_torch import higham, nearest_correlation

    A = np.array([[1.0, 0.9, -0.9], [0.9, 1.0, 0.3], [-0.9, 0.3, 1.0]])
    X = nearest_correlation(A, device=CPU).numpy()
    np.testing.assert_allclose(np.diag(X), 1.0, atol=1e-5)
    assert np.linalg.eigvalsh(X).min() > -1e-6
    np.testing.assert_allclose(X, higham(A), atol=2e-3)


def test_unit_commitment_prices():
    from unit_commitment_torch import marginal_prices

    cost, prices = marginal_prices(device=CPU)
    prices = prices.numpy()
    assert np.all(np.isfinite(prices)) and np.isfinite(cost)
    assert np.all(prices > 0.5)  # at least the cheap unit's cost
    assert prices.argmax() == 2  # the peak period has the highest price


def test_entropic_projection_gradient_matches_softmax():
    from entropic_projection_torch import TARGET, entropic_projection, softmax_gradient_check

    target = torch.tensor(TARGET, dtype=torch.float64)
    q = torch.tensor([0.3, -0.2, 0.1, 0.0], dtype=torch.float64)
    np.testing.assert_allclose(entropic_projection(q).numpy(), torch.softmax(q, 0).numpy(), atol=1e-6)
    g_layer, g_analytic = softmax_gradient_check(q, target)
    np.testing.assert_allclose(g_layer.numpy(), g_analytic.numpy(), atol=1e-6)


def test_examples_need_a_device_or_the_card():
    from unit_commitment_torch import make_uc_layer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the examples default to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_uc_layer()
