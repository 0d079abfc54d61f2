"""Nearest correlation matrix — an SDP through the conic backend, on the
PyTorch / CUDA port.

The port's counterpart of ``examples/nearest_correlation.py``: find the
closest (Frobenius) correlation matrix to a given symmetric A,

    min_X |X - A|_F   s.t.  X >= 0 (PSD),  diag(X) = 1

as a cone program over variables v = [x (svec), t]:  min t with
(t, x - a) in SOC, x in PSD(svec), and zero-cone rows pinning the diagonal.
Differentiable w.r.t. A through the homogeneous-embedding rule.

Run: ``python examples/nearest_correlation_torch.py`` (on the card; ``... cpu`` on the host).
"""

import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffopt_tpu_torch import ConeProgram, ConeSpec, solve_conic  # noqa: E402
from diffopt_tpu_torch.cones import _tri_order, svec_to_sym, sym_to_svec  # noqa: E402
from diffopt_tpu_torch.ir import default_device  # noqa: E402


def nearest_correlation_program(A: torch.Tensor) -> ConeProgram:
    d = A.shape[-1]
    tri = d * (d + 1) // 2
    a = sym_to_svec(A)
    order = _tri_order(d)
    diag_pos = torch.as_tensor(np.nonzero(order[:, 0] == order[:, 1])[0], device=A.device)
    nv = tri + 1  # [x, t]
    kw = dict(dtype=A.dtype, device=A.device)
    ar_d, ar_t = torch.arange(d, device=A.device), torch.arange(tri, device=A.device)

    # zero rows: x_diag - 1 in {0}  -> A = -coeff, b = const = -1
    Az = torch.zeros(d, nv, **kw)
    Az[ar_d, diag_pos] = -1.0
    bz = -torch.ones(d, **kw)
    # SOC rows: (t, x - a): A = -coeffs, b = (0, -a)
    Asoc = torch.zeros(tri + 1, nv, **kw)
    Asoc[0, tri] = -1.0
    Asoc[1 + ar_t, ar_t] = -1.0
    bsoc = torch.cat([torch.zeros(1, **kw), -a])
    # PSD rows: x in PSD(svec): A = -I over x
    Ap = torch.zeros(tri, nv, **kw)
    Ap[ar_t, ar_t] = -1.0
    bp = torch.zeros(tri, **kw)

    c = torch.zeros(nv, **kw)
    c[tri] = 1.0
    cones = ConeSpec([("zero", d), ("soc", tri + 1), ("psd", tri)])
    return ConeProgram(A=torch.cat([Az, Asoc, Ap]), b=torch.cat([bz, bsoc, bp]), c=c, cones=cones)


def nearest_correlation(A, device=None, **kw):
    A = torch.as_tensor(A, dtype=torch.float64, device=default_device(device, "nearest_correlation"))
    sol = solve_conic(nearest_correlation_program(A), max_iters=kw.pop("max_iters", 40000), **kw)
    tri = A.shape[-1] * (A.shape[-1] + 1) // 2
    return svec_to_sym(sol.x[:tri])


def higham(A, iters=500):
    """Higham's alternating projections with Dykstra's correction (numpy): the closed-form oracle."""
    Y = A.copy()
    dS = np.zeros_like(A)
    for _ in range(iters):
        R = Y - dS
        w, U = np.linalg.eigh(R)
        Xp = (U * np.maximum(w, 0)) @ U.T
        dS = Xp - R
        Y = Xp.copy()
        np.fill_diagonal(Y, 1.0)
    return Y


if __name__ == "__main__":
    A = np.array([[1.0, 0.9, 0.7], [0.9, 1.0, 0.3], [0.7, 0.3, 1.0]])
    A[0, 2] = A[2, 0] = -0.9  # make it indefinite
    X = nearest_correlation(A, device=sys.argv[1] if len(sys.argv) > 1 else None).cpu().numpy()
    w = np.linalg.eigvalsh(X)
    print("nearest correlation:\n", X.round(4))
    print("eigs:", w.round(5), " diag:", np.diag(X).round(6))
    print("max |X - Higham's| =", f"{np.abs(X - higham(A)).max():.2e}")
