"""ctypes bindings for the native instance packer.

Counterpart of ``diffopt_tpu/native``. ``packer.cpp`` beside this file is
compiled at first use with the JAX package's Makefile flags
(``g++ -O3 -march=native -fPIC -shared -std=c++17 -pthread``) into
``build/diffopt_tpu_torch/libpacker-<hash>.so`` (the hash covers the source,
the flags and the host's compiler, so an edited source is rebuilt); a
machine without ``g++`` gets the numpy fallback, and a build that fails
raises. :func:`native_available` says which of the two the packers run.
The packers return tensors on the device the caller names (the card unless
``device="cpu"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ir import default_device

SOURCE = Path(__file__).resolve().parent / "packer.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "diffopt_tpu_torch"


def _build(cxx: str) -> Path:
    """Compile ``packer.cpp`` unless its library is there; returns the library's path."""
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode() + SOURCE.read_bytes())
    out = build_dir() / f"libpacker-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The packer library, built at first use; None on a machine without ``g++``."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            return None
        lib = ctypes.CDLL(str(_build(cxx)))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.pack_coo_batch.argtypes = [
            i64p, i64p, f64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p, ctypes.c_int,
        ]
        lib.pack_coo_batch.restype = None
        lib.pack_vec_batch.argtypes = [f64p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double, f64p, ctypes.c_int]
        lib.pack_vec_batch.restype = None
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the packers run the compiled library, False when they run the numpy fallback."""
    return _load() is not None


def _cat(parts, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.concatenate([np.asarray(x, dtype) for x in parts]) if parts else np.zeros(0, dtype))


def _offsets(lengths) -> np.ndarray:
    offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    return offs


def pack_coo_batch(
    triplets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    max_rows: int,
    max_cols: int,
    n_threads: int = 8,
    *,
    dtype=torch.float64,
    device=None,
) -> torch.Tensor:
    """Pack per-instance (rows, cols, vals) COO triplets into a dense
    ``(B, max_rows, max_cols)`` batch, duplicates summed, as a tensor of
    ``dtype`` on ``device``. Packs in float64 on the host (the C++ packer
    when built, else numpy), then moves the batch once."""
    device = default_device(device, "pack_coo_batch")
    B = len(triplets)
    lib = _load()
    if lib is None:
        out = np.zeros((B, max_rows, max_cols))
        for i, (r, c, v) in enumerate(triplets):
            np.add.at(out[i], (np.asarray(r), np.asarray(c)), np.asarray(v))
    else:
        rows = _cat([t[0] for t in triplets], np.int64)
        cols = _cat([t[1] for t in triplets], np.int64)
        vals = _cat([t[2] for t in triplets], np.float64)
        offs = _offsets([len(t[0]) for t in triplets])
        out = np.empty((B, max_rows, max_cols))
        lib.pack_coo_batch(rows, cols, vals, offs, B, max_rows, max_cols, out.reshape(-1), n_threads)
    return torch.from_numpy(out).to(device=device, dtype=dtype)


def pack_vec_batch(
    vecs: Sequence[np.ndarray],
    max_len: int,
    fill: float = 0.0,
    n_threads: int = 8,
    *,
    dtype=torch.float64,
    device=None,
) -> torch.Tensor:
    """Pack variable-length vectors into a padded ``(B, max_len)`` batch, the
    tail of each row set to ``fill``, as a tensor of ``dtype`` on ``device``."""
    device = default_device(device, "pack_vec_batch")
    B = len(vecs)
    lib = _load()
    if lib is None:
        out = np.full((B, max_len), fill)
        for i, v in enumerate(vecs):
            out[i, : len(v)] = v
    else:
        vals = _cat(vecs, np.float64)
        offs = _offsets([len(v) for v in vecs])
        out = np.empty((B, max_len))
        lib.pack_vec_batch(vals, offs, B, max_len, fill, out.reshape(-1), n_threads)
    return torch.from_numpy(out).to(device=device, dtype=dtype)
