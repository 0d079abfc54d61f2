"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them with
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers and the stream
as ``void*``, sizes as ``int``; every launcher returns ``cudaGetLastError()``)
and becomes one shared library ``lib<name>-<hash>.so`` in the build directory,
where ``<hash>`` covers the sources and the flags, so an edited source is
rebuilt and a stale library is never loaded. All sources are compiled at first
use, one ``nvcc`` process each, started together. The build directory is
``build/diffopt_tpu_torch`` beside the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Flags of one source on top of NVCC_FLAGS. The nonsymmetric IPM's line searches test candidates against
# thresholds its iterates ride (the proximity neighbourhood): contracting a * b + c into one fused
# multiply-add rounds those tests one way more often than the plain version's separate operations do, and
# shifted the kernel's iteration counts by 0.9 bodies on average on the dual_exp family (f64, one H100);
# without contraction the two part only as far as one ulp of the data moves either.
SOURCE_FLAGS = {"ns_pdip": ("-fmad=false",)}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None  # wall time of the last build (None: nothing built yet)


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "diffopt_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of diffopt_tpu_torch are compiled at "
        "first use and need the CUDA toolkit (looked on PATH, $CUDA_HOME, /usr/local/cuda)"
    )


def _digest() -> str:
    h = hashlib.sha256((" ".join(NVCC_FLAGS) + repr(sorted(SOURCE_FLAGS.items()))).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:12]


def _build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library is missing; returns name -> path."""
    global build_seconds
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    targets = {src.stem: out / f"lib{src.stem}-{tag}.so" for src in sorted(CSRC.glob("*.cu"))}
    todo = {name: path for name, path in targets.items() if not path.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, path,
        )
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.nvcc.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (building all sources
    first if needed)."""
    with _lock:
        if name not in _libs:
            path = _build_all()[name]
            lib = ctypes.CDLL(str(path))
            lib.dk_error_string.argtypes = [ctypes.c_int]
            lib.dk_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.dk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
