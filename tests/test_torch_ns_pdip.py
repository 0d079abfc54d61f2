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
