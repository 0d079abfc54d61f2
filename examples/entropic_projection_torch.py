"""Differentiable entropic projection layer (an exp-cone program in the loop),
on the PyTorch / CUDA port.

The port's counterpart of ``examples/entropic_projection.py``: the entropic
projection

    P(q) = argmax_x  q'x + H(x)   s.t.  sum x = 1, x >= 0
         (H(x) = -sum_i x_i log x_i)

is the exact solution of an exponential-cone program (epigraph t_i <=
-x_i log x_i  <=>  (t_i, x_i, 1) in K_exp), solved by the nonsymmetric-cone
interior-point method (``solvers/conic_nsipm.py``) and differentiated
implicitly. Its analytic solution is softmax(q), which makes every gradient
checkable in closed form. Fit logits q so the projection matches a target
distribution, by plain gradient descent.

Run: ``python examples/entropic_projection_torch.py`` (on the card; ``... cpu`` on the host).
"""

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffopt_tpu_torch import ConeProgram, ConeSpec, solve_conic  # noqa: E402
from diffopt_tpu_torch.ir import default_device  # noqa: E402

TARGET = (0.5, 0.25, 0.15, 0.10)


def entropic_projection_program(q):
    """Conic form of max q'x + H(x) over the simplex: vars [x (k), t (k)],
    min -q'x - sum t, rows: zero(1) sum x = 1; per i (t_i, x_i, 1) in K_exp."""
    k = q.shape[0]
    rows = 1 + 3 * k
    A = np.zeros((rows, 2 * k))
    b = np.zeros(rows)
    A[0, :k] = -1.0
    b[0] = -1.0
    for i in range(k):
        r = 1 + 3 * i
        A[r, k + i] = -1.0
        A[r + 1, i] = -1.0
        b[r + 2] = 1.0
    as_t = lambda a: torch.as_tensor(a, dtype=q.dtype, device=q.device)
    c = torch.cat([-q, -torch.ones(k, dtype=q.dtype, device=q.device)])
    return ConeProgram(A=as_t(A), b=as_t(b), c=c, cones=ConeSpec([("zero", 1)] + [("exp", 3)] * k))


def entropic_projection(q):
    """The layer: q -> P(q) (= softmax(q) analytically)."""
    return solve_conic(entropic_projection_program(q)).x[: q.shape[0]]


def softmax_gradient_check(q, target):
    """The layer's implicit gradient of |P(q) - target|^2 and the analytic one,
    (diag(p) - p p') 2 (p - target) with p = softmax(q)."""
    q = q.detach().clone().requires_grad_()
    ((entropic_projection(q) - target) ** 2).sum().backward()
    p0 = torch.softmax(q.detach(), 0)
    g_analytic = (torch.diag(p0) - torch.outer(p0, p0)) @ (2 * (p0 - target))
    return q.grad, g_analytic


def fit(steps=150, lr=2.0, device=None):
    """Gradient descent on the logits from q = 0; returns the final projection and the target."""
    device = default_device(device, "entropic_projection.fit")
    target = torch.tensor(TARGET, dtype=torch.float64, device=device)
    q = torch.zeros(len(TARGET), dtype=torch.float64, device=device, requires_grad=True)
    for _ in range(steps):
        loss = ((entropic_projection(q) - target) ** 2).sum()
        (g,) = torch.autograd.grad(loss, q)
        with torch.no_grad():
            q -= lr * g
    with torch.no_grad():
        return entropic_projection(q), target


def main(device=None, steps=150):
    device = default_device(device, "entropic_projection.main")
    target = torch.tensor(TARGET, dtype=torch.float64, device=device)
    g_layer, g_analytic = softmax_gradient_check(torch.zeros(len(TARGET), dtype=torch.float64, device=device), target)
    err = float((g_layer - g_analytic).abs().max())
    print(f"implicit vs analytic softmax gradient: max err {err:.2e}")
    assert err < 1e-6, err
    p, target = fit(steps, device=device)
    final = float((p - target).abs().max())
    print(f"after {steps} steps: projection {p.cpu().numpy().round(4)} target {target.cpu().numpy().round(4)}"
          f" (max err {final:.2e})")
    assert final < 1e-3, final
    print("OK")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
