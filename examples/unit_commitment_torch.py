"""Relaxed unit commitment as a differentiable layer, on the PyTorch / CUDA port.

The port's counterpart of ``examples/unit_commitment.py`` (the reference's
``chainrules_unit.jl``): a multi-period economic unit-commitment LP (binary
activations relaxed to [0, 1]) whose optimal cost is differentiated with
respect to the load profile by ``backward`` — the marginal prices.

Run: ``python examples/unit_commitment_torch.py`` (on the card; ``... cpu`` on the host).
"""

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffopt_tpu_torch import QuadProgram, solve_qp  # noqa: E402
from diffopt_tpu_torch.ir import default_device  # noqa: E402

DEMAND = (4.0, 7.0, 9.0, 5.0)


def make_uc_layer(T=4, n_units=2, device=None):
    """Variables per period t: p_{it} (power), u_{it} in [0,1] (relaxed
    activation). Constraints: demand equality, generation limits tied to u,
    ramping on p. Objective: linear generation + activation costs. Returns
    ``build(demand) -> QuadProgram`` and ``cost(demand)``."""
    device = default_device(device, "make_uc_layer")
    cgen, cact, pmax, ramp = [1.0, 3.0], [2.0, 1.0], [6.0, 8.0], 3.0
    nv = 2 * n_units * T  # [p(0,:), u(0,:), p(1,:), u(1,:), ...]
    pidx = lambda t, i: 2 * n_units * t + i
    uidx = lambda t, i: 2 * n_units * t + n_units + i

    q = np.zeros(nv)
    A = np.zeros((T, nv))
    rows, h = [], []
    # p <= pmax * u ; p >= 0 ; 0 <= u <= 1 ; ramping |p_t - p_{t-1}| <= ramp
    for t in range(T):
        for i in range(n_units):
            q[pidx(t, i)], q[uidx(t, i)] = cgen[i], cact[i]
            A[t, pidx(t, i)] = 1.0
            r = np.zeros(nv)
            r[pidx(t, i)], r[uidx(t, i)] = 1.0, -pmax[i]
            rows.append(r)
            h.append(0.0)
            r = np.zeros(nv)
            r[pidx(t, i)] = -1.0
            rows.append(r)
            h.append(0.0)
            r = np.zeros(nv)
            r[uidx(t, i)] = 1.0
            rows.append(r)
            h.append(1.0)
            r = np.zeros(nv)
            r[uidx(t, i)] = -1.0
            rows.append(r)
            h.append(0.0)
            if t > 0:
                r = np.zeros(nv)
                r[pidx(t, i)], r[pidx(t - 1, i)] = 1.0, -1.0
                rows.extend([r, -r])
                h.extend([ramp, ramp])
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    # tiny quadratic regularization keeps the LP solution map smooth
    data = dict(Q=1e-5 * torch.eye(nv, dtype=torch.float64, device=device), q=as_t(q), A=as_t(A),
                G=as_t(np.stack(rows)), h=as_t(np.array(h)))

    def build(demand):
        return QuadProgram(Q=data["Q"], q=data["q"], A=data["A"], b=demand, G=data["G"], h=data["h"])

    def cost(demand):
        qp = build(demand)
        return qp.q @ solve_qp(qp, max_iters=60).z

    return build, cost


def marginal_prices(demand=DEMAND, device=None):
    """The total cost and its gradient with respect to the demand of each period."""
    device = default_device(device, "marginal_prices")
    _, cost = make_uc_layer(device=device)
    d = torch.tensor(demand, dtype=torch.float64, device=device, requires_grad=True)
    c = cost(d)
    c.backward()
    return float(c.detach()), d.grad


if __name__ == "__main__":
    c, prices = marginal_prices(device=sys.argv[1] if len(sys.argv) > 1 else None)
    print("total cost:", c)
    print("marginal prices:", prices.cpu().numpy().round(3))
