"""The port's native instance packer (``diffopt_tpu_torch/native``) against
``np.add.at`` and against the JAX package's packer on the same triplets
(as ``tests/test_native_packer.py``), its numpy fallback, and the tensors it
returns."""

import numpy as np
import pytest
import torch

from diffopt_tpu import native as jnative
from diffopt_tpu_torch import native


def _ref_pack(triplets, mr, mc):
    out = np.zeros((len(triplets), mr, mc))
    for i, (r, c, v) in enumerate(triplets):
        np.add.at(out[i], (np.asarray(r), np.asarray(c)), np.asarray(v))
    return out


def _triplets(seed=0, B=17):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        nnz = rng.integers(0, 40)
        out.append((rng.integers(0, 12, nnz), rng.integers(0, 9, nnz), rng.normal(size=nnz)))
    return out


@pytest.fixture
def fallback(monkeypatch):
    """The packers as on a machine without a C++ compiler."""
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)


def test_native_builds():
    assert native.native_available(), "the C++ packer did not build"
    assert list(native.build_dir().glob("libpacker-*.so"))


def test_pack_coo_matches_numpy_and_jax():
    triplets = _triplets()
    out = native.pack_coo_batch(triplets, 12, 9, n_threads=4, device="cpu")
    assert out.dtype == torch.float64 and out.device.type == "cpu" and out.shape == (17, 12, 9)
    np.testing.assert_allclose(out.numpy(), _ref_pack(triplets, 12, 9), atol=1e-14)
    np.testing.assert_array_equal(out.numpy(), jnative.pack_coo_batch(triplets, 12, 9, n_threads=4))


def test_pack_coo_accumulates_duplicates():
    t = [(np.array([0, 0]), np.array([1, 1]), np.array([2.0, 3.0]))]
    out = native.pack_coo_batch(t, 2, 2, device="cpu")
    assert float(out[0, 0, 1]) == 5.0 and float(out.abs().sum()) == 5.0


def test_pack_vec_batch_matches_jax():
    rng = np.random.default_rng(1)
    vecs = [rng.normal(size=rng.integers(0, 10)) for _ in range(9)]
    out = native.pack_vec_batch(vecs, 10, fill=7.0, device="cpu")
    for i, v in enumerate(vecs):
        np.testing.assert_allclose(out[i, : len(v)].numpy(), v)
        assert bool((out[i, len(v):] == 7.0).all())
    np.testing.assert_array_equal(out.numpy(), jnative.pack_vec_batch(vecs, 10, fill=7.0))


def test_fallback_gives_the_same_batches(fallback):
    assert not native.native_available()
    triplets = _triplets(seed=3, B=5)
    out = native.pack_coo_batch(triplets, 12, 9, device="cpu")
    np.testing.assert_array_equal(out.numpy(), _ref_pack(triplets, 12, 9))
    vecs = [np.arange(3.0), np.zeros(0), np.ones(5)]
    out = native.pack_vec_batch(vecs, 5, fill=-1.0, device="cpu")
    np.testing.assert_array_equal(out.numpy(), [[0, 1, 2, -1, -1], [-1] * 5, [1] * 5])


def test_empty_batches_and_dtype():
    assert native.pack_coo_batch([], 3, 4, device="cpu").shape == (0, 3, 4)
    assert native.pack_vec_batch([], 4, device="cpu").shape == (0, 4)
    out = native.pack_coo_batch(_triplets(B=2), 12, 9, dtype=torch.float32, device="cpu")
    assert out.dtype == torch.float32
