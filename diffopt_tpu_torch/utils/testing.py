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


def make_mixed_batch(B, dtype=torch.float64, device="cuda", generator=None):
    """A batch with every symmetric cone kind: zero(2) + nonneg(3) +
    nonpos(2) + soc(4) + rsoc(3) + psd(side 3), n = 5, drawn on ``device``
    from ``generator``; strictly feasible (b from an interior slack) and
    bounded (c from an interior dual)."""
    from ..cones import ConeSpec
    from ..ir import ConeProgram

    n = 5
    blocks = [("zero", 2), ("nonneg", 3), ("nonpos", 2), ("soc", 4), ("rsoc", 3), ("psd", 6)]
    rnd = lambda *shape: torch.randn(*shape, dtype=dtype, device=device, generator=generator)

    def interior():
        parts = []
        for kind, d in blocks:
            if kind == "nonneg":
                parts.append(rnd(B, d).abs() + 0.5)
            elif kind == "nonpos":
                parts.append(-rnd(B, d).abs() - 0.5)
            elif kind == "soc":
                t = rnd(B, d)
                parts.append(torch.cat([t[:, 1:].norm(dim=1, keepdim=True) + 1.0, t[:, 1:]], 1))
            elif kind == "rsoc":  # 2 t u >= ||x||^2
                t = rnd(B, d)
                parts.append(torch.cat([1.0 + (t[:, 2:] ** 2).sum(1, keepdim=True), torch.ones_like(t[:, :1]),
                                        t[:, 2:]], 1))
            elif kind == "psd":
                M = rnd(B, 3, 3)
                S = M @ M.transpose(1, 2) + 3 * torch.eye(3, dtype=dtype, device=device)
                parts.append(torch.stack([S[:, r, c] * (1.0 if r == c else 2**0.5)
                                          for c in range(3) for r in range(c + 1)], 1))
            else:
                parts.append(None)
        return parts

    m = sum(d for _, d in blocks)
    A = rnd(B, m, n)
    s0 = torch.cat([torch.zeros(B, d, dtype=dtype, device=device) if x is None else x
                    for x, (_, d) in zip(interior(), blocks)], 1)
    y0 = torch.cat([rnd(B, d) if x is None else x for x, (_, d) in zip(interior(), blocks)], 1)
    b = torch.einsum("bij,bj->bi", A, rnd(B, n)) + s0
    return ConeProgram(A, b, -torch.einsum("bij,bi->bj", A, y0), ConeSpec(blocks))


def make_entropy_batch(B, k=3, seed=0, dtype=torch.float32, device="cuda"):
    """Weighted entropy maximisation ``max sum_i w_i t_i s.t. sum x = 1, (t_i, x_i, 1) in K_exp``
    (``t_i <= -x_i log x_i``), weights w uniform in [0.5, 2] per instance — the family of the JAX
    package's exp-cone benchmark (``benchmarks/exp_bench.py``), made with numpy from ``seed`` (the same
    numbers) and placed on ``device``. Rows ``[zero(1) | exp(3) x k]``, variables ``[x | t]``."""
    import numpy as np

    from ..cones import ConeSpec
    from ..ir import ConeProgram

    device = _on_device(device)
    rng = np.random.default_rng(seed)
    A = np.zeros((1 + 3 * k, 2 * k))
    b = np.zeros(1 + 3 * k)
    A[0, :k] = -1.0
    b[0] = -1.0
    for i in range(k):
        r = 1 + 3 * i
        A[r, k + i] = -1.0
        A[r + 1, i] = -1.0
        b[r + 2] = 1.0
    w = rng.uniform(0.5, 2.0, size=(B, k)).astype(np.float32)
    c = np.concatenate([np.zeros((B, k), np.float32), -w], axis=1)
    as_t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dtype)
    return ConeProgram(
        A=as_t(np.broadcast_to(A, (B,) + A.shape)), b=as_t(np.broadcast_to(b, (B,) + b.shape)), c=as_t(c),
        cones=ConeSpec([("zero", 1)] + [("exp", 3)] * k),
    )


def make_pow_batch(B, seed=3, dtype=torch.float64, device="cuda"):
    """Mixed zero(1) + nonneg(2) + soc(3) + pow(0.6) + dual_pow(0.4) programs, n = 4, built from a known
    strictly feasible primal-dual pair (zero duality gap by construction) — the family of the JAX
    package's fused nonsymmetric-kernel tests (``tests/test_ns_fused.py::_pow_batch``), made with numpy
    from ``seed`` (the same numbers) and placed on ``device``."""
    import numpy as np

    from ..cones import ConeSpec
    from ..ir import ConeProgram

    device = _on_device(device)
    rng = np.random.default_rng(seed)
    cones = ConeSpec([("zero", 1), ("nonneg", 2), ("soc", 3), ("pow", 3, 0.6), ("dual_pow", 3, 0.4)])
    m, n = cones.total_dim, 4
    A_b, b_b, c_b = [], [], []
    for _ in range(B):
        A = rng.normal(size=(m, n))
        xs = rng.normal(size=n)

        def spow(al, dual):
            x = rng.uniform(0.8, 1.5)
            y = rng.uniform(0.8, 1.5)
            cap = (x / al) ** al * (y / (1 - al)) ** (1 - al) if dual else x**al * y ** (1 - al)
            return np.array([x, y, rng.uniform(-0.5, 0.5) * cap])

        v = rng.normal(size=2)
        soc_s = np.concatenate([[np.linalg.norm(v) + 0.4], v])
        w2 = rng.normal(size=2) * 0.1
        soc_y = np.concatenate([[np.linalg.norm(w2) + 0.3], w2])
        s_star = np.concatenate([np.zeros(1), np.abs(rng.normal(size=2)) + 0.2, soc_s, spow(0.6, False), spow(0.4, True)])
        # the dual of pow is dual_pow and the other way round
        y_star = np.concatenate([rng.normal(size=1), np.abs(rng.normal(size=2)) + 0.2, soc_y, spow(0.6, True),
                                 spow(0.4, False)])
        A_b.append(A)
        b_b.append(A @ xs + s_star)
        c_b.append(-A.T @ y_star)
    as_t = lambda x: torch.as_tensor(np.stack(x)).to(device=device, dtype=dtype)
    return ConeProgram(A=as_t(A_b), b=as_t(b_b), c=as_t(c_b), cones=cones)


def make_dual_exp_batch(B, dtype=torch.float64, device="cuda", generator=None):
    """min u s.t. (u, beta, gamma) in K_exp* (the dual-exp family of the JAX package's nonsymmetric tests)
    with one zero row fixing a second variable, so that the fused kernel takes it: beta, gamma uniform in
    [0.5, 2], drawn on ``device`` from ``generator``."""
    from ..cones import ConeSpec
    from ..ir import ConeProgram

    A = torch.zeros(B, 4, 2, dtype=dtype, device=device)
    A[:, 0, 1] = 1.0
    A[:, 1, 0] = -1.0
    b = torch.zeros(B, 4, dtype=dtype, device=device)
    b[:, 0] = 1.0
    b[:, 2:] = 0.5 + 1.5 * torch.rand(B, 2, dtype=dtype, device=device, generator=generator)
    c = torch.zeros(B, 2, dtype=dtype, device=device)
    c[:, 0] = 1.0
    return ConeProgram(A, b, c, ConeSpec([("zero", 1), ("dual_exp", 3)]))


def ns_internal_rows(cp):
    """The fused nonsymmetric-cone kernel's inputs for a ConeProgram batch, its rows through the static
    transform R: ``((c, bE, bC, AE, AC), (p, l, soc_dims, ns_blocks))``."""
    from ..solvers import conic_ipm

    R, p, l, socs, _, ns = conic_ipm._row_transform(cp.cones, allow_ns=True)
    R = torch.as_tensor(R, dtype=cp.A.dtype, device=cp.A.device)
    A = torch.einsum("ij,bjk->bik", R, cp.A)
    b = cp.b @ R.T
    return (cp.c, b[:, :p], b[:, p:], A[:, :p], A[:, p:]), (p, l, socs, ns)
