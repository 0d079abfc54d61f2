"""Hyperparameter gradient descent through an optimization layer, on the
PyTorch / CUDA port.

The port's counterpart of ``examples/autotuning_ridge.py`` (the reference's
``autotuning-ridge.jl``): ridge regression ``min_w |Xw - y|^2 + alpha |w|^2``
is a QP in ``w`` whose solution map is differentiable in ``alpha``; tune
``alpha`` by gradient descent on a validation loss.

Run: ``python examples/autotuning_ridge_torch.py`` (on the card; ``... cpu`` on the host).
"""

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffopt_tpu_torch import QuadProgram, solve_qp  # noqa: E402
from diffopt_tpu_torch.ir import default_device  # noqa: E402


def ridge_fit(X, y, alpha):
    """Solve ridge regression as an unconstrained QP layer (differentiable
    in alpha through the KKT system)."""
    n = X.shape[1]
    empty = X.new_zeros(0, n)
    qp = QuadProgram(Q=2 * (X.T @ X + alpha * torch.eye(n, dtype=X.dtype, device=X.device)), q=-2 * X.T @ y,
                     A=empty, b=X.new_zeros(0), G=empty, h=X.new_zeros(0))
    return solve_qp(qp).z


def autotune(steps=100, lr=5e-2, seed=0, device=None):
    """Gradient descent on log(alpha); returns the (alpha, validation loss) history."""
    device = default_device(device, "autotune")
    rng = np.random.default_rng(seed)
    N, n = 120, 8
    w_true = rng.normal(size=n)
    X = rng.normal(size=(N, n))
    y = X @ w_true + 0.5 * rng.normal(size=N)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    Xtr, ytr, Xva, yva = as_t(X[:80]), as_t(y[:80]), as_t(X[80:]), as_t(y[80:])

    la = torch.zeros((), dtype=torch.float64, device=device, requires_grad=True)
    hist = []
    for _ in range(steps):
        v = ((Xva @ ridge_fit(Xtr, ytr, torch.exp(la)) - yva) ** 2).mean()
        (dv,) = torch.autograd.grad(v, la)
        with torch.no_grad():
            la -= lr * dv
        hist.append((float(torch.exp(la.detach())), float(v.detach())))
    return hist


if __name__ == "__main__":
    hist = autotune(device=sys.argv[1] if len(sys.argv) > 1 else None)
    print(f"alpha: {hist[0][0]:.4f} -> {hist[-1][0]:.4f}; val loss {hist[0][1]:.4f} -> {hist[-1][1]:.4f}")
