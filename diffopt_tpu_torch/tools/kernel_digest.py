"""SHA-256 digests of the outputs of kernels K1-K7 on fixed batches.

    python3 -m diffopt_tpu_torch.tools.kernel_digest

Two builds whose kernels do the same arithmetic in the same order print the
same digests; so this shows, bit for bit, that an edit to code the kernels
share (``csrc/dense.cuh``, ``csrc/ipm.cuh``) left a kernel's results as they
were. Run it in two checkouts, in one call on one card, and compare the lines
(to run it against a checkout that lacks it but whose ``utils/testing.py``
has the batch makers it imports: ``PYTHONPATH=<checkout> python3 <this
file>``). Every batch is made on the card from a seed: K1 on the QP
main path's shape (n = 64, m = 32, p = 16) and on n = 32, m = 16, p = 8 in f32
and f64, K2 / K3 on quasi-definite matrices of N = 112 (k = 3) and, from
generators of their own, N = 112 and 172 (160 in f64; k = 1 and 3), K4 / K5 on SPD
matrices at every shape the port launches them at (n = 3, 6, 16, 17, 18, 34,
44, 64, 144 and 160; k = 1, 3 and 16 at each), K6 on the SOCP (n = 16, SOC(17)) in f32 and f64 and the SDP of psd side 4,
K7 on the entropy family (k = 3) in f32 and f64, the pow family and the
dual-exp family in f64 at the launch rule's team ("team rule") and at every
team that takes the layout (a checkout whose wrapper has no teams prints the
first line only).
"""

from __future__ import annotations

import hashlib

import torch

DEVICE = "cuda"


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _gen(seed):
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    return g


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_digest: no CUDA device")
    from diffopt_tpu_torch.ops.cuda import chol, conic_pdip, ns_pdip, pdip
    from diffopt_tpu_torch.solvers import conic_ipm
    from diffopt_tpu_torch.utils.testing import (make_batch, make_dual_exp_batch, make_entropy_batch, make_pow_batch,
                                                 make_sdp_batch, make_socp_batch, ns_internal_rows)

    torch.backends.cuda.matmul.allow_tf32 = False
    for dt in (torch.float32, torch.float64):
        tag = "f32" if dt == torch.float32 else "f64"
        for n, m, p in ((64, 32, 16), (32, 16, 8)):
            qp = make_batch(8192 if dt == torch.float32 else 2048, n, m, p, dt, DEVICE, _gen(5))
            sol, it = pdip.solve_batched_fused(qp, max_iters=25, return_iters=True)
            print(f"[digest] K1 pdip_fused {tag} n={n} m={m} p={p}: {digest(sol.z, sol.lam, sol.nu, it)}")
        gen = _gen(1)
        N, B = 112, 4096
        M = torch.randn(B, N, N, dtype=dt, device=DEVICE, generator=gen)
        K = M @ M.transpose(1, 2) / N + torch.eye(N, dtype=dt, device=DEVICE)
        K[:, 80:, 80:] *= -1.0
        K = torch.tril(K) + torch.tril(K, -1).transpose(1, 2)
        L, d = chol.ldl_batched(K)
        rhs = torch.randn(B, N, 3, dtype=dt, device=DEVICE, generator=gen)
        print(f"[digest] K2 ldl_factor {tag} N={N}: {digest(L, d)}")
        print(f"[digest] K3 ldl_solve {tag} N={N} k=3: {digest(chol.ldl_solve_batched(L, d, rhs))}")
        for n in (64, 34, 6, 16, 17, 160, 3, 18, 44, 144):
            Bn = 256 if n > 128 else B
            M = torch.randn(Bn, n, n, dtype=dt, device=DEVICE, generator=gen)
            H = M @ M.transpose(1, 2) / n + torch.eye(n, dtype=dt, device=DEVICE)
            Lc = chol.cholesky_batched(H)
            r = torch.randn(Bn, n, 16, dtype=dt, device=DEVICE, generator=gen)
            print(f"[digest] K4 chol_factor {tag} n={n}: {digest(Lc)}")
            xs = [chol.cholesky_solve_batched(Lc, r[..., :k].contiguous()) for k in (1, 3, 16)]
            print(f"[digest] K5 chol_solve {tag} n={n} k=1, 3, 16: {digest(*xs)}")
        # K2 / K3 at the QP paths' N (112: [main]; 172: [qp100], past the register tiles; 160 in f64, whose
        # envelope ends at 169), from generators of their own
        for N, Bn in ((112, 8192), (172 if dt == torch.float32 else 160, 2048)):
            g = _gen(20 + N)
            M = torch.randn(Bn, N, N, dtype=dt, device=DEVICE, generator=g)
            K = M @ M.transpose(1, 2) / N + torch.eye(N, dtype=dt, device=DEVICE)
            K[:, (N * 58) // 100:, (N * 58) // 100:] *= -1.0
            K = torch.tril(K) + torch.tril(K, -1).transpose(1, 2)
            L, d = chol.ldl_batched(K)
            r = torch.randn(Bn, N, 3, dtype=dt, device=DEVICE, generator=g)
            print(f"[digest] K2 ldl_factor {tag} N={N} B={Bn}: {digest(L, d)}")
            xs = [chol.ldl_solve_batched(L, d, r[..., 0].contiguous()), chol.ldl_solve_batched(L, d, r)]
            print(f"[digest] K3 ldl_solve {tag} N={N} k=1, 3: {digest(*xs)}")
    cases = [
        ("SOCP f32", make_socp_batch(8192, n=16, seed=1, device=DEVICE)),
        ("SOCP f64", make_socp_batch(2048, n=16, seed=2, dtype=torch.float64, device=DEVICE)),
        ("SDP side 4 f32", make_sdp_batch(2048, 4, seed=3, device=DEVICE)),
    ]
    for label, cp in cases:
        data, lay, _ = conic_ipm.internal_rows(cp)
        n, (p, l, socs, psds) = cp.num_vars, lay
        for team in conic_pdip.TEAMS:
            if conic_pdip.team_takes(n, p, l, socs, psds, cp.A.element_size(), team):
                out = conic_pdip.solve_tile_fused(*data, lay, max_iters=50, tol=5e-6, team=team)
                print(f"[digest] K6 conic_pdip {label} team {team}: {digest(*out)}")
    for label, cp in (("entropy f32", make_entropy_batch(16384, k=3, seed=0, device=DEVICE)),
                      ("entropy f64", make_entropy_batch(2048, k=3, seed=1, dtype=torch.float64, device=DEVICE)),
                      ("dual_exp f64", make_dual_exp_batch(1024, device=DEVICE, generator=_gen(11))),
                      ("pow f64", make_pow_batch(1024, seed=3, device=DEVICE))):
        args, lay = ns_internal_rows(cp)
        p, l, socs, ns = lay
        print(f"[digest] K7 ns_pdip {label} team rule: {digest(*ns_pdip.solve_tile_fused_ns(*args, lay))}")
        for team in getattr(ns_pdip, "TEAMS", ()):
            if ns_pdip.team_takes(cp.num_vars, p, l, socs, ns, cp.A.element_size(), team):
                out = ns_pdip.solve_tile_fused_ns(*args, lay, team=team)
                print(f"[digest] K7 ns_pdip {label} team {team}: {digest(*out)}")


if __name__ == "__main__":
    main()
