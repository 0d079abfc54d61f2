"""Optimization layers in neural networks, on the PyTorch / CUDA port.

The port's counterpart of ``examples/qp_layers.py``: a QP-backed ReLU trained
inside a small network (the reference's ``custom-relu.jl``) and a learnable
polyhedral projection layer (``polyhedral_project.jl``). ``solve_qp`` is a
``torch.autograd.Function`` whose backward solves the KKT system at the
solution, so the layers drop straight into a ``torch.optim`` training loop.

Run: ``python examples/qp_layers_torch.py`` (on the card; ``... cpu`` on the host).
"""

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffopt_tpu_torch import QuadProgram, solve_qp  # noqa: E402
from diffopt_tpu_torch.ir import default_device  # noqa: E402


def _projection_qp(y, G, h):
    """min 1/2 |x - y|^2 s.t. Gx <= h, for a batch ``y (..., n)``."""
    n = y.shape[-1]
    lead = y.shape[:-1]
    eye = torch.eye(n, dtype=y.dtype, device=y.device).expand(*lead, n, n)
    return QuadProgram(Q=eye, q=-y, A=y.new_zeros(*lead, 0, n), b=y.new_zeros(*lead, 0),
                       G=G.expand(*lead, *G.shape[-2:]), h=h.expand(*lead, h.shape[-1]))


def qp_relu(y):
    """ReLU as a QP layer: argmin_x 1/2|x - y|^2 s.t. x >= 0 (custom-relu.jl:25-61),
    for ``y (..., n)``. Differentiable through the KKT system: the gradient is
    the active-set mask, recovered implicitly, not by autodiff through solver
    iterations."""
    n = y.shape[-1]
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    return solve_qp(_projection_qp(y, -eye, y.new_zeros(n))).z


def polyhedral_project(y, G, h):
    """Projection of ``y (..., n)`` onto {x : Gx <= h} as a differentiable layer
    (polyhedral_project.jl). Gradients flow to y AND to the polytope (G, h)."""
    return solve_qp(_projection_qp(y, G, h)).z


def train_qp_relu_mlp(steps=60, seed=0, device=None):
    """Two-layer MLP with the QP-ReLU activation on a synthetic regression
    task; returns the loss trajectory."""
    device = default_device(device, "train_qp_relu_mlp")
    rng = np.random.default_rng(seed)
    n_in, n_hidden, n_out, N = 4, 8, 1, 256
    X = rng.normal(size=(N, n_in))
    w_true = rng.normal(size=(n_in,))
    Y = np.maximum(X @ w_true, 0.0)[:, None]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    params = {
        "W1": as_t(rng.normal(size=(n_in, n_hidden)) * 0.5),
        "b1": as_t(np.zeros(n_hidden)),
        "W2": as_t(rng.normal(size=(n_hidden, n_out)) * 0.5),
        "b2": as_t(np.zeros(n_out)),
    }
    for p in params.values():
        p.requires_grad_()
    Xt, Yt = as_t(X), as_t(Y)
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        hidden = qp_relu(Xt @ params["W1"] + params["b1"])  # one batched QP layer over the N samples
        loss = ((hidden @ params["W2"] + params["b2"] - Yt) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def learn_polytope(steps=80, seed=1, device=None):
    """Learn (G, h) so that projection onto the polytope matches target
    points: gradients w.r.t. constraint data through the QP layer."""
    device = default_device(device, "learn_polytope")
    rng = np.random.default_rng(seed)
    n, m, N = 2, 4, 64
    Y = rng.normal(size=(N, n)) * 2.0
    T = np.clip(Y, -1.0, 1.0)  # target: projection onto the unit box
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    G = as_t(np.vstack([np.eye(n), -np.eye(n)]) + 0.1 * rng.normal(size=(2 * n, n))).requires_grad_()
    h = as_t(np.full(2 * n, 1.5)).requires_grad_()
    Yt, Tt = as_t(Y), as_t(T)
    opt = torch.optim.Adam([G, h], lr=5e-2)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = ((polyhedral_project(Yt, G, h) - Tt) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else None
    losses = train_qp_relu_mlp(device=dev)
    print(f"QP-ReLU MLP: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    losses = learn_polytope(device=dev)
    print(f"Polytope learning: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
