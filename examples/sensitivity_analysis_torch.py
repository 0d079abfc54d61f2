"""Sensitivity-analysis examples on the PyTorch / CUDA port.

The port's counterpart of ``examples/sensitivity_analysis.py`` (the
reference's ``sensitivity-analysis-svm.jl``, ``sensitivity-analysis-ridge.jl``,
``matrix-inversion-manual.jl`` and thermal dispatch): solve a program, then
ask "how does the solution move when the data moves?" through the forward
verb and the forward-mode rule of ``solve_qp``.

Run: ``python examples/sensitivity_analysis_torch.py`` (on the card; ``... cpu`` on the host).
"""

import pathlib
import sys

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffopt_tpu_torch import QPTangent, QuadProgram, forward_differentiate, solve_qp  # noqa: E402
from diffopt_tpu_torch.ir import default_device  # noqa: E402
from diffopt_tpu_torch.solvers import qp as qpsolver  # noqa: E402


def _make(device, **data):
    return QuadProgram.make(**data, dtype=torch.float64, device=default_device(device, "sensitivity_analysis"))


def svm_hyperplane_sensitivity(N=30, seed=0, device=None):
    """Soft-margin linear SVM as a QP; returns d(w)/d(eps) for a perturbation
    of every sample along its label direction.

    QP (variables [w (d,), b, xi (N,)]):
        min 1/2 |w|^2 + C sum xi
        s.t. y_i (w'x_i + b) >= 1 - xi_i,   xi >= 0
    """
    rng = np.random.default_rng(seed)
    d = 2
    X = np.vstack([rng.normal(size=(N // 2, d)) + 2.0, rng.normal(size=(N // 2, d)) - 2.0])
    y = np.concatenate([np.ones(N // 2), -np.ones(N // 2)])
    C = 1.0
    nv = d + 1 + N  # w, b, xi
    Q = np.zeros((nv, nv))
    Q[:d, :d] = np.eye(d)
    q = np.concatenate([np.zeros(d + 1), C * np.ones(N)])
    # -y_i(w'x_i + b) - xi_i <= -1 ; -xi <= 0
    G = np.vstack([np.hstack([-y[:, None] * X, -y[:, None], -np.eye(N)]), np.hstack([np.zeros((N, d + 1)), -np.eye(N)])])
    h = np.concatenate([-np.ones(N), np.zeros(N)])
    qp = _make(device, Q=Q, q=q, G=G, h=h)
    sol, info = qpsolver.solve(qp)
    assert bool(info.converged)

    # perturb X_i -> X_i + eps * y_i * u (u fixed direction): the first N rows of G change by -u
    u = np.array([1.0, 0.0])
    dG = torch.zeros_like(qp.G)
    dG[:N, :d] = torch.as_tensor(-y[:, None] * (y[:, None] * u), dtype=dG.dtype, device=dG.device)
    dqp = QPTangent(dQ=torch.zeros_like(qp.Q), dq=torch.zeros_like(qp.q), dA=torch.zeros_like(qp.A),
                    db=torch.zeros_like(qp.b), dG=dG, dh=torch.zeros_like(qp.h))
    fwd = forward_differentiate(qp, sol, dqp, method="lstsq")
    return sol.z[:d].cpu().numpy(), fwd.dz[:d].cpu().numpy()


def economic_dispatch_prices(demand=10.0, device=None):
    """Thermal economic dispatch LP: two generators with costs / limits; the
    equality dual is the marginal price, and d(dispatch)/d(demand) comes from
    the forward-mode rule of ``solve_qp``."""
    device = default_device(device, "economic_dispatch_prices")
    kw = dict(dtype=torch.float64, device=device)
    costs = torch.tensor([1.0, 3.0], **kw)
    gmax = torch.tensor([6.0, 10.0], **kw)

    def build(dem):
        # min c'g  s.t. sum g = dem, 0 <= g <= gmax
        eye = torch.eye(2, **kw)
        return QuadProgram.make(q=costs, A=torch.ones(1, 2, **kw), b=dem.reshape(1),
                                G=torch.cat([eye, -eye]), h=torch.cat([gmax, torch.zeros(2, **kw)]))

    dem = torch.tensor(demand, **kw)
    sol, info = qpsolver.solve(build(dem))
    price = -float(sol.nu[0])  # AK17 nu is the negated MOI dual; the price is the MOI dual
    with fwAD.dual_level():
        z = solve_qp(build(fwAD.make_dual(dem, torch.ones_like(dem))), method="lstsq", mode="jvp").z
        dz = fwAD.unpack_dual(z).tangent
    return sol.z.cpu().numpy(), price, dz.cpu().numpy()


def matrix_inversion_manual_check(device=None):
    """Reference ``matrix-inversion-manual.jl``: QP with Q=[[4,1],[1,2]],
    q=[1,1], G=[1,1], h=-1. x* = (-0.25, -0.75), AK17 lam* = 0.75. Compare
    dx/dh from the port against the hand-built AK17 eq. (6) system."""
    Q = np.array([[4.0, 1.0], [1.0, 2.0]])
    G = np.array([[1.0, 1.0]])
    h = np.array([-1.0])
    qp = _make(device, Q=Q, q=np.array([1.0, 1.0]), G=G, h=h)
    sol, info = qpsolver.solve(qp)
    assert bool(info.converged)

    # hand-built eq (6): [Q G'; lam G, Gz-h][dx; dlam] = [0; lam dh]
    lam = float(sol.lam[0])
    z = sol.z.cpu().numpy()
    Mh = np.block([[Q, G.T], [lam * G, (G @ z - h).reshape(1, 1)]])
    manual = np.linalg.solve(Mh, np.array([0.0, 0.0, lam]))[:2]

    dqp = QPTangent.zeros_like(qp)
    dqp = QPTangent(dQ=dqp.dQ, dq=dqp.dq, dA=dqp.dA, db=dqp.db, dG=dqp.dG, dh=torch.ones_like(qp.h))
    fwd = forward_differentiate(qp, sol, dqp)
    return z, manual, fwd.dz.cpu().numpy()


def ridge_data_sensitivity(N=40, seed=7, device=None):
    """Reference ``sensitivity-analysis-ridge.jl``: fit y ~ w x + b by ridge
    regression (as an equality-constrained QP over (w, b, e)) and compute the
    sensitivity d(w)/d(y_i) of the slope to each data point: one batched
    forward solve over the N tangents."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=N)
    Y = 2.0 * X + 0.5 + 0.3 * rng.normal(size=N)
    alpha = 0.1
    # vars: [w, b, e_1..e_N]; min e'e + alpha(w^2+b^2) s.t. e_i = y_i - w x_i - b
    nv = 2 + N
    Qm = np.zeros((nv, nv))
    Qm[0, 0] = Qm[1, 1] = 2 * alpha
    Qm[2:, 2:] = 2 * np.eye(N)
    A = np.zeros((N, nv))
    A[:, 0] = X
    A[:, 1] = 1.0
    A[:, 2:] = np.eye(N)
    qp = _make(device, Q=Qm, q=np.zeros(nv), A=A, b=Y)
    sol, info = qpsolver.solve(qp)
    assert bool(info.converged)

    # d(w)/d(y_i): forward differentiation with db = e_i, the N tangents as one batch
    batch = lambda t: t.expand(N, *t.shape)
    dqp = QPTangent.zeros_like(qp.map(batch))
    dqp = QPTangent(dQ=dqp.dQ, dq=dqp.dq, dA=dqp.dA, db=torch.eye(N, dtype=qp.b.dtype, device=qp.b.device),
                    dG=dqp.dG, dh=dqp.dh)
    dw = forward_differentiate(qp.map(batch), sol.map(batch), dqp).dz[:, 0]
    return float(sol.z[0]), float(sol.z[1]), dw.cpu().numpy(), X


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else None
    w, dw = svm_hyperplane_sensitivity(device=dev)
    print("SVM w:", w.round(4), " dw/deps:", dw.round(4))
    g, price, dg = economic_dispatch_prices(device=dev)
    print("dispatch:", g.round(4), " price:", price, " dg/ddemand:", dg.round(4))
    z, manual, fw = matrix_inversion_manual_check(device=dev)
    print("manual vs port dz:", manual.round(6), fw.round(6))
    w, b, dw, X = ridge_data_sensitivity(device=dev)
    print(f"ridge fit w={w:.3f} b={b:.3f}; max |dw/dy| = {abs(dw).max():.4f}")
