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

import contextlib
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
    t0 = time.perf_counter()
    _compile([(name, path, (), out / f"{name}.nvcc.log") for name, path in todo.items()])
    build_seconds = time.perf_counter() - t0
    return targets


def _compile(jobs: list[tuple[str, Path, tuple[str, ...], Path]]) -> None:
    """Compile ``csrc/<name>.cu`` into ``path`` with ``extra`` flags, its
    output into ``log``, for each ``(name, path, extra, log)``: one ``nvcc``
    each, started together. Raise if one fails."""
    if not jobs:
        return
    nvcc = _nvcc()
    procs = []
    for name, path, extra, log in jobs:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), *extra, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, proc, tmp, path, log))
    failed = []
    for name, proc, tmp, path, log_path in procs:
        log, _ = proc.communicate()
        log_path.write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.dk_error_string.argtypes = [ctypes.c_int]
    lib.dk_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (building all sources
    first if needed)."""
    with _lock:
        if name not in _libs:
            _libs[name] = _open(_build_all()[name])
        return _libs[name]


def build_variants(name: str, *flag_sets) -> list[Path]:
    """The libraries of ``csrc/<name>.cu`` built with each set of extra
    ``nvcc`` flags, the missing ones compiled side by side; each one's
    ``nvcc`` output is beside it, as ``.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = [out / f"lib{name}-{_digest()}-{hashlib.sha256(' '.join(f).encode()).hexdigest()[:8]}.so"
             for f in flag_sets]
    with _lock:
        _compile([(name, path, tuple(f), path.with_suffix(".log"))
                  for f, path in zip(flag_sets, paths) if not path.exists()])
    return paths


@contextlib.contextmanager
def variant(name: str, *flags: str):
    """Inside the block, :func:`load` gives ``csrc/<name>.cu`` built with the
    extra ``nvcc`` flags (for example ``-DDK_PROFILE``, the phase probes of
    ``csrc/prof.cuh``) into a library of its own, so the package's wrappers
    launch that build; the package's own build is back after the block."""
    path = build_variants(name, flags)[0]
    with _lock:
        lib, before = _open(path), _libs.get(name)
        _libs[name] = lib
    try:
        yield lib
    finally:
        with _lock:
            if before is None:
                _libs.pop(name, None)
            else:
                _libs[name] = before


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.dk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
