"""Port parity of the fused nonsymmetric-cone IPM's plain version (``ops/cuda/ns_pdip.py``, the
PyTorch twin of kernel K7, which the CPU takes) against the TPU kernel
``ops/pallas/ns_pdip.py::solve_tile_fused_ns`` in interpret mode, f64, on the same numpy inputs; all
eight outputs compared.

On the pow family (zero + nonneg + soc + pow + dual_pow), capped at 8 bodies with tol 0, the two are
the same computation and agree to 1e-10 relative. The entropy family's full run at its default
tolerance is compared through ``solve_conic_batched`` in ``test_torch_solve_conic_ns.py``, whose JAX
reference runs this kernel on it (one interpret-mode compile per file keeps the suite inside its
time limit): there the dual-scaling Hessian conditions like 1/mu^2, rounding differences (XLA's exp
and log against the C library's, another summation order) grow in the last bodies until a grid step
of a line search can flip, and the two runs agree to the solver's tolerance with iteration counts at
most one apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffopt_tpu.ops.pallas import ns_pdip as jk
from diffopt_tpu_torch.ops.cuda import ns_pdip as tk
from diffopt_tpu_torch.utils.testing import make_entropy_batch, make_pow_batch

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

NAMES = ("x", "yE", "yC", "s", "it", "pres", "dres", "gap")


def _internal(cp):
    """The pow batch's rows are already [zero | nonneg | soc | ns...]: R is the identity."""
    p = 1
    A, b, c = (t.numpy() for t in cp.tensors())
    return (c, b[:, :p], b[:, p:], A[:, :p], A[:, p:])


CASES = {
    "pow_capped": (lambda: make_pow_batch(4, seed=3, device="cpu"),
                   (1, 2, (3,), (("pow", 0.6), ("dual_pow", 0.4))), dict(max_iters=8, tol=0.0)),
}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, (make, lay, kw) in CASES.items():
        args = _internal(make())
        kw = dict(kw, reg=1e-11, eps=1e-15)
        ref = jk.solve_tile_fused_ns(*(jnp.asarray(a) for a in args), lay, **kw)
        got = tk.solve_tile_fused_ns(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), lay, **kw)
        out[name] = ([np.asarray(t) for t in ref], [t.numpy() for t in got])
    return out


def _rel(a, b):
    return np.abs(a - b).max(-1) / (1.0 + np.abs(b).max(-1))


def test_capped_bodies_are_the_same_computation(runs):
    ref, got = runs["pow_capped"]
    for name, r, g in zip(NAMES, ref, got):
        if name == "it":
            np.testing.assert_array_equal(g, r.astype(np.int32))
        elif r.ndim == 2:
            assert _rel(g, r).max() <= 1e-10, name
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-14, err_msg=name)


def test_wrapper_checks_and_envelope():
    cp = make_entropy_batch(2, k=2, dtype=torch.float64, device="cpu")
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in _internal(cp)]
    with pytest.raises(ValueError, match="span"):
        tk.solve_tile_fused_ns(*args, (1, 0, (), (("exp", None),)))
    assert tk.in_envelope(6, 1, 0, (), (("exp", None),) * 3, 4)
    assert not tk.in_envelope(100, 1, 0, (), (("exp", None),) * 10, 4)  # N = 131 > 128
    assert tk.smem_bytes(6, 1, 0, (), (("exp", None),) * 3, 8) > tk.smem_bytes(6, 1, 0, (), (("exp", None),) * 3, 4)
    launches = tk.solve_tile_fused_ns.launches
    tk.solve_tile_fused_ns(*args, (1, 0, (), (("exp", None),) * 2), max_iters=3)
    assert tk.solve_tile_fused_ns.launches == launches  # the plain version on the CPU is no launch


def _old_smem_bytes(n, p, l, socs, ns, itemsize):
    """The eight-warp kernel's shared memory before the teams: no ns kinds among the ints, a 256-word
    pivot column."""
    nns, mC = len(ns), l + sum(socs) + 3 * len(ns)
    N, nb = n + p + mC, (1 if l else 0) + len(socs) + nns
    int_bytes = ((4 * nb + 2 * mC) * 4 + 15) // 16 * 16 + (nns * 8 + 15) // 16 * 16
    words = mC * n + p * n + n + p + mC + 7 * n + 7 * p + 17 * mC + 3 * N + N * (N | 1)
    return int_bytes + (words + len(socs) + 18 * nns + 256 + 64) * itemsize


def _ns_layouts(rng, count):
    kinds = (("exp", None), ("dual_exp", None), ("pow", 0.3), ("dual_pow", 0.7))
    out = []
    for _ in range(count):
        n, p, l = int(rng.integers(1, 60)), int(rng.integers(0, 20)), int(rng.integers(0, 30))
        socs = tuple(int(d) for d in rng.integers(1, 12, size=int(rng.integers(0, 4))))
        ns = tuple(kinds[int(k)] for k in rng.integers(0, 4, size=int(rng.integers(0, 16))))
        out.append((n, p, l, socs, ns))
    return out


def test_launch_rule_table():
    """The Python mirror of K7's launch rule: for every layout the eight-warp kernel took, the smallest
    team that takes it, whose tiles hold N and whose working set fits one block's 227 KB with the static
    table; the team grows with N; the entropy layout of [exp] (n = 6, p = 1, three exp blocks: N = 16)
    runs on one warp. No card and no JAX needed."""
    rng = np.random.default_rng(0)
    taken = 0
    for itemsize in (4, 8):
        for lay in _ns_layouts(rng, 2000):
            n, p, l, socs, ns = lay
            mC = l + sum(socs) + 3 * len(ns)
            N = n + p + mC
            old = mC >= 1 and N <= 128 and _old_smem_bytes(*lay, itemsize) <= tk.MAX_SMEM_BYTES - 1024
            assert tk.in_envelope(*lay, itemsize) == old, lay
            team = tk.team_for(*lay, itemsize)
            if not old:
                continue
            taken += 1
            assert team in tk.TEAMS and tk.team_takes(*lay, itemsize, team), (lay, team)
            assert all(not tk.team_takes(*lay, itemsize, t) for t in tk.TEAMS if t < team), (lay, team)
            assert N <= tk.tile_max_n(team) and (team == 1 or N > tk.tile_max_n(tk.TEAMS[tk.TEAMS.index(team) - 1]))
            assert tk.smem_bytes(*lay, itemsize, team) + 1024 <= tk.MAX_SMEM_BYTES
    assert taken > 1000
    # the team grows with N: exp blocks added one by one to n = 6, p = 1
    teams = [tk.team_for(6, 1, 0, (), (("exp", None),) * k, 4) for k in range(1, 41)]
    assert teams == sorted(teams) and set(teams) == set(tk.TEAMS)
    assert [3 * k + 7 for k, t in enumerate(teams, 1) if t == 2][0] == 43  # past 40 rows: two warps
    entropy = (6, 1, 0, (), (("exp", None),) * 3)
    assert tk.team_for(*entropy, 4) == 1 and tk.team_for(*entropy, 8) == 1
    # the entropy layout's working set on one warp: under 4 KB in f32 (the eight-warp kernel's pivot column was
    # 256 words; the three ns kinds take one more 16-byte piece of ints)
    assert tk.smem_bytes(*entropy, 4, 1) == _old_smem_bytes(*entropy, 4) - 4 * (256 - 80) + 16
    assert tk.smem_bytes(*entropy, 4, 1) < 4096
    # a forced team that does not take the layout raises before anything is launched
    assert not tk.team_takes(6, 1, 0, (), (("exp", None),) * 12, 4, 1)  # N = 43 > 40
    assert not tk.team_takes(6, 1, 0, (), (("exp", None),) * 3, 4, 4)  # teams of four warps are not built
