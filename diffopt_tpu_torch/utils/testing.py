"""Random QP batches for smoke runs and measurements."""

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
