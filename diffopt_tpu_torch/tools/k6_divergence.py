"""Where the fused conic IPM (K6) and its plain version part, iteration by
iteration, and how far rounding alone moves either.

    python3 -m diffopt_tpu_torch.tools.k6_divergence [--batch 1024] [--iters 14]

On one SDP batch of side 4 (``make_sdp_batch``, the ``[kernels]`` f64 case of
``chip_smoke.py``) and one SOCP batch (n = 16, SOC(17)) it prints:

* ``[trajectory]``: for k = 0 (the init alone), 1, 2, ... the per-instance
  relative difference over x, yE, yC, s between the kernel and the plain
  version, both run with ``max_iters = k`` (each returns the iterate it
  reached, the best one where that is earlier), in f64;
* ``[rounding]``: the same difference between a run on the data and a run on
  the data with every entry moved by one unit in the last place, for the
  plain version and for the kernel, at the full iteration count, beside the
  kernel-against-plain difference, and how many of the instances where the
  kernel and the plain version part by more than 1e-9 also move by more than
  1e-10 under the one-ulp change;
* ``[f32]``: the kernel's and the plain version's f32 iterates after k bodies
  against the plain version's f64 iterate after k bodies on the same data
  (median and mean per-instance relative error), their iteration counts, and
  the residuals each reports for the state it returns against that state's
  residuals evaluated in f64.

It needs a card; the plain version runs on the card too.
"""

from __future__ import annotations

import argparse
import subprocess

import torch


def _internal(cp):
    from diffopt_tpu_torch.solvers import conic_ipm

    R, p, l, socs, psds = conic_ipm._row_transform(cp.cones)
    R = torch.as_tensor(R, dtype=cp.A.dtype, device=cp.A.device)
    A = torch.einsum("ij,bjk->bik", R, cp.A)
    b = cp.b @ R.T
    return [cp.c, b[:, :p], b[:, p:], A[:, :p], A[:, p:]], (p, l, socs, psds)


def _kw(dt, iters, tol=None):
    f64 = dt == torch.float64
    return dict(max_iters=iters, tol=tol or (1e-9 if f64 else 5e-6), reg=1e-11 if f64 else 1e-7,
                eps=1e-14 if f64 else 1e-7)


def _diff(a, b):
    """Per-instance relative difference over x, yE, yC, s (relative to 1 + the largest entry of b)."""
    return torch.stack([(u.double() - v.double()).abs().amax(-1) / (1.0 + v.double().abs().amax(-1))
                        for u, v in zip(a[:4], b[:4]) if u.shape[-1]]).amax(0)


def _q(t):
    t = t.double()
    return f"median {float(t.median()):.3e}, 99% {float(torch.quantile(t, 0.99)):.3e}, max {float(t.max()):.3e}"


def _ulp(t, gen):
    """t with every entry moved by one unit in the last place, up or down at random."""
    up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    return torch.where(up, torch.nextafter(t, torch.full_like(t, float("inf"))),
                       torch.nextafter(t, torch.full_like(t, float("-inf"))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=14, help="the last k of the trajectory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_divergence: no CUDA device")
    from diffopt_tpu_torch.ops.cuda import conic_pdip
    from diffopt_tpu_torch.utils.testing import make_sdp_batch, make_socp_batch

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"[device] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B = args.batch
    cases = [("SDP side 4", make_sdp_batch(B, 4, seed=4, dtype=torch.float64)),
             ("SOCP n=16", make_socp_batch(B, n=16, seed=2, dtype=torch.float64))]
    for label, cp in cases:
        data, lay = _internal(cp)
        full_k = conic_pdip.solve_tile_fused(*data, lay, **_kw(torch.float64, 50))
        full_p = conic_pdip.solve_tile_fused_plain(*data, lay, **_kw(torch.float64, 50))
        gap = _diff(full_k, full_p)
        print(f"[trajectory] {label} f64 B={B}: iterations mean {float(full_k[4].float().mean()):.2f}"
              f" (plain {float(full_p[4].float().mean()):.2f}); at the end {_q(gap)}")
        for k in range(args.iters + 1):
            a = conic_pdip.solve_tile_fused(*data, lay, **_kw(torch.float64, k))
            b = conic_pdip.solve_tile_fused_plain(*data, lay, **_kw(torch.float64, k))
            err = torch.maximum(b[5], b[6])
            print(f"[trajectory] {label} f64 k={k}: kernel vs plain {_q(_diff(a, b))}; plain residual median"
                  f" {float(err.median()):.3e}")
        pert = [_ulp(t, gen) for t in data]
        pk = conic_pdip.solve_tile_fused(*pert, lay, **_kw(torch.float64, 50))
        pp = conic_pdip.solve_tile_fused_plain(*pert, lay, **_kw(torch.float64, 50))
        dk, dp = _diff(pk, full_k), _diff(pp, full_p)
        apart = gap > 1e-9
        print(f"[rounding] {label} f64 B={B}: kernel vs plain {_q(gap)}, {int(apart.sum())} above 1e-9")
        print(f"[rounding] {label} f64: plain vs plain on one-ulp data {_q(dp)}, {int((dp > 1e-9).sum())} above 1e-9;"
              f" kernel vs kernel on one-ulp data {_q(dk)}, {int((dk > 1e-9).sum())} above 1e-9")
        if bool(apart.any()):
            moved = torch.maximum(dk, dp)[apart]
            print(f"[rounding] {label} f64: of the {int(apart.sum())} instances where kernel and plain part by more"
                  f" than 1e-9, {int((moved > 1e-10).sum())} move by more than 1e-10 under the one-ulp change"
                  f" (each: {', '.join(f'{float(v):.2e}' for v in moved[:8])})")

    # f32: which of the two stays closer to the f64 trajectory
    cp = make_sdp_batch(B, 4, seed=3)
    data, lay = _internal(cp)
    data64 = [t.double() for t in data]
    full_k = conic_pdip.solve_tile_fused(*data, lay, **_kw(torch.float32, 50))
    full_p = conic_pdip.solve_tile_fused_plain(*data, lay, **_kw(torch.float32, 50))
    print(f"[f32] SDP side 4 B={B}: iterations mean kernel {float(full_k[4].float().mean()):.3f}, plain"
          f" {float(full_p[4].float().mean()):.3f}; kernel more on {float((full_k[4] > full_p[4]).float().mean()):.2%},"
          f" fewer on {float((full_k[4] < full_p[4]).float().mean()):.2%}")
    # the exit test: the residuals each version reports for the state it returns, against the same
    # state's residuals evaluated in f64
    from diffopt_tpu_torch.ops import jordan

    c, bE, bC, AE, AC = data64
    for name, out in (("kernel", full_k), ("plain", full_p)):
        x, yE, yC, s = (t.double() for t in out[:4])
        pres, dres, _ = jordan.metrics(c, bE, bC, x, yE, yC, s, *jordan.residuals(c, AE, bE, AC, bC, x, yE, yC, s))
        rep = torch.maximum(out[5].double(), out[6].double())
        true = torch.maximum(pres, dres)
        print(f"[f32 exit] {name}: reported max(pres, dres) median {float(rep.median()):.3e}; the same state in f64"
              f" median {float(true.median()):.3e}; reported / f64 median {float((rep / true).median()):.3f}, mean"
              f" {float((rep / true).mean()):.3f}")
    for k in range(min(args.iters, 10) + 1):
        ref = conic_pdip.solve_tile_fused_plain(*data64, lay, **_kw(torch.float64, k, tol=5e-6))
        a = _diff(conic_pdip.solve_tile_fused(*data, lay, **_kw(torch.float32, k)), ref)
        b = _diff(conic_pdip.solve_tile_fused_plain(*data, lay, **_kw(torch.float32, k)), ref)
        print(f"[f32] k={k}: against the f64 iterate, kernel median {float(a.median()):.3e} mean {float(a.mean()):.3e};"
              f" plain median {float(b.median()):.3e} mean {float(b.mean()):.3e}")
    print(card)


if __name__ == "__main__":
    main()
