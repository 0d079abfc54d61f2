"""Random QP and conic batches for smoke runs, tests and measurements."""

from __future__ import annotations

import torch

from ..ir import QuadProgram


def make_batch(B, n, m, p, dtype=torch.float32, device="cuda", generator=None) -> QuadProgram:
    """Random strictly-convex QP batch made on ``device`` (the card unless the
    caller names another; there is no silent move to the CPU): ``Q = L L' + n I``,
    standard-normal ``q, A, b, G`` and ``h = normal + 2`` (the distribution of
    the JAX package's headline bench). ``generator`` must live on ``device``;
    without one a generator seeded with 0 is made."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, dtype=dtype, device=device, generator=generator)
    L = rnd(B, n, n)
    Q = L @ L.transpose(-1, -2) + n * torch.eye(n, dtype=dtype, device=device)
    return QuadProgram(
        Q=Q,
        q=rnd(B, n),
        A=rnd(B, p, n),
        b=rnd(B, p),
        G=rnd(B, m, n),
        h=rnd(B, m) + 2.0,
    )


def _on_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device available; pass device="cpu" to build on the host')
    return device


def make_socp_batch(B, n=16, seed=0, dtype=torch.float32, device="cuda"):
    """Random SOCP batch ``min c'x s.t. ||F x - g|| <= e'x + f`` — the family
    of the JAX package's conic benchmark (``benchmarks/conic_bench.py``), made
    with numpy from ``seed`` (the same numbers as that benchmark) and placed on
    ``device``: strictly feasible at x = 0 (f = ||g|| + 1), bounded (||e|| =
    0.5 below sigma_min(F)), F's spectrum clamped to [1, 2]. One SOC block of
    dimension n + 1."""
    import numpy as np

    from ..cones import ConeSpec
    from ..ir import ConeProgram

    device = _on_device(device)
    rng = np.random.default_rng(seed)
    k = n
    F = rng.normal(size=(B, k, n)).astype(np.float32)
    U, S, Vt = np.linalg.svd(F, full_matrices=False)
    F = ((U * np.clip(S, 1.0, 2.0)[:, None, :]) @ Vt).astype(np.float32)
    g = rng.normal(size=(B, k)).astype(np.float32)
    e = rng.normal(size=(B, n)).astype(np.float32)
    e *= (0.5 / np.maximum(np.linalg.norm(e, axis=1), 1e-30))[:, None]
    f = np.linalg.norm(g, axis=1, keepdims=True) + 1.0
    c = rng.normal(size=(B, n)).astype(np.float32)
    A = np.concatenate([-e[:, None, :], -F], axis=1)
    b = np.concatenate([f.astype(np.float32), -g], axis=1)
    as_t = lambda x: torch.as_tensor(x).to(device=device, dtype=dtype)
    return ConeProgram(A=as_t(A), b=as_t(b), c=as_t(c), cones=ConeSpec([("soc", k + 1)]))


def make_sdp_batch(B, side=4, n=3, seed=0, dtype=torch.float32, device="cuda"):
    """Random SDP batch ``min c'x s.t. svec(S0 + sum_i x_i G_i) in PSD,
    ||x|| <= 3`` — the family of the JAX package's SDP benchmark
    (``benchmarks/sdp_bench.py``), made with numpy from ``seed`` and placed on
    ``device``: S0 = L L' + side I strictly PD (x = 0 strictly feasible), G_i
    random symmetric, and an SOC(n + 1) block keeping the feasible set
    compact. Rows ``[psd(tri) | soc(n + 1)]``."""
    import numpy as np

    from ..cones import ConeSpec
    from ..ir import ConeProgram

    device = _on_device(device)
    rng = np.random.default_rng(seed)
    tri = side * (side + 1) // 2
    rows_idx, cols_idx, scale = [], [], []
    for c_ in range(side):
        for r_ in range(c_ + 1):
            rows_idx.append(r_)
            cols_idx.append(c_)
            scale.append(1.0 if r_ == c_ else np.sqrt(2.0))
    rows_idx, cols_idx, scale = np.array(rows_idx), np.array(cols_idx), np.array(scale)
    L = rng.normal(size=(B, side, side))
    S0 = L @ np.swapaxes(L, 1, 2) + side * np.eye(side)
    M = rng.normal(size=(B, n, side, side))
    G = (M + np.swapaxes(M, 2, 3)) / 2
    svec = lambda X: X[..., rows_idx, cols_idx] * scale
    b_psd = svec(S0)
    A_psd = -np.moveaxis(svec(G), 1, 2)
    A_soc = np.broadcast_to(np.concatenate([np.zeros((1, n)), -np.eye(n)], axis=0), (B, n + 1, n))
    b_soc = np.broadcast_to(np.concatenate([[3.0], np.zeros(n)]), (B, n + 1))
    as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dtype)
    return ConeProgram(
        A=as_t(np.concatenate([A_psd, A_soc], axis=1)),
        b=as_t(np.concatenate([b_psd, b_soc], axis=1)),
        c=as_t(rng.normal(size=(B, n))),
        cones=ConeSpec([("psd", tri), ("soc", n + 1)]),
    )
