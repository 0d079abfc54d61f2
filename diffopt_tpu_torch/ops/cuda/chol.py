"""Batched small-matrix factorisations: Cholesky factor + solve for symmetric
positive definite matrices and unpivoted LDL' factor + solve for symmetric
quasi-definite ones. CUDA kernels for Hopper, with the plain PyTorch version
beside each.

Replaces ``diffopt_tpu/ops/pallas/chol.py::cholesky_batched`` (kernel body
``_chol_kernel``), ``::cholesky_solve_batched`` (``_solve_kernel``),
``::ldl_batched`` (``_ldl_kernel``) and ``::ldl_solve_batched``
(``_ldl_solve_kernel``). The symmetrised KKT systems are strongly
factorisable (Vanderbei 1995), so the LDL' needs no pivoting.

The Cholesky pair (sources: ``csrc/chol.cu``, ``csrc/dense.cuh``) follows the
LDL' pair's design, described next; its own notes (bytes bound, the NaN
semantics of a matrix that is not positive definite, the envelope) stand at
the head of ``csrc/chol.cu`` and on the wrappers below.

Design on the H100 (sources: ``csrc/ldl.cu``, ``csrc/dense.cuh``): one thread
block per instance; the matrix is read once from its natural ``(B, N, N)``
row-major layout — by the factor into registers (a 16 x 16 thread grid, each
thread owning a cyclic tile; past N = 128 into shared memory), by the solve
into shared memory (odd row stride, so row and column walks are both free of
bank conflicts) — and the result is written once.

What bounds them: device-memory bytes. The factor needs the lower triangle
of K (``N (N + 1) / 2`` words) and writes L in full and d (``N^2 + N`` words)
against ``N^3 / 3`` flops — at N = 112 in f32 that is 75 KB against
0.5 MFLOP per instance, about 0.74 ms for B = 32768 at 3.35 TB/s; the solve
needs the strict lower triangle of L, d and the right-hand side
(``N (N - 1) / 2 + 2 N`` words) and writes N words against ``2 N^2`` flops —
about 0.26 ms at the same sizes. Neither reaches its byte bound yet (the
factor is at about a fifth of it, the solve at about a quarter; the solve also
loads the upper triangle of L, which it never uses): the N sequential
elimination steps of the factor, each closed by a block barrier, and the 2 N
steps of the solve, each one shuffle and one multiply-add on a single warp,
are what the time goes to. Several blocks resident per SM overlap one block's
serial stretch with another's.

Envelope: what 227 KB of shared memory holds — N <= 239 in f32 and N <= 169 in
f64 (:func:`ldl_max_n`). Past it the wrappers raise and the
callers in ``ops/kkt.py`` take the LU route by size.
"""

from __future__ import annotations

import ctypes

import torch

Tensor = torch.Tensor

MAX_SMEM_BYTES = 232448  # shared memory one block can use on an H100


def _odd(n: int) -> int:
    return n | 1


def _factor_smem_bytes(N: int, itemsize: int) -> int:
    if N <= 128:  # matrix in registers: d + the pivot-column buffer
        return (N + 256) * itemsize
    return (N * _odd(N) + N) * itemsize  # matrix + d


def _solve_smem_bytes(N: int, k: int, itemsize: int) -> int:
    return (N * _odd(N) + N + N * k) * itemsize  # L + d + right-hand sides


def ldl_max_n(dtype) -> int:
    """Largest N that both kernels take for ``dtype`` (the solve with one
    right-hand side)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    fits = lambda N: max(_factor_smem_bytes(N, itemsize), _solve_smem_bytes(N, 1, itemsize)) <= MAX_SMEM_BYTES
    N = 1
    while fits(N + 1):
        N += 1
    return N


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _chol_factor_smem_bytes(n: int, itemsize: int) -> int:
    if n <= 128:  # matrix in registers: pivots + flag word + the pivot-column buffer
        return (n + 1 + 256) * itemsize
    return (n * _odd(n) + n + 1) * itemsize  # matrix + pivots + flag word


def _chol_solve_smem_bytes(n: int, k: int, itemsize: int) -> int:
    return (n * _odd(n) + n + n * k) * itemsize  # L + 1 / diagonal + right-hand sides


_CHOL_SOLVE_MAX_ROWS = 256  # the substitution sweep holds 32 lanes x 8 register entries


def cholesky_max_n(dtype) -> int:
    """Largest n that :func:`cholesky_batched` factors in its kernel for
    ``dtype``; past it the library call takes over."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = 1
    while _chol_factor_smem_bytes(n + 1, itemsize) <= MAX_SMEM_BYTES:
        n += 1
    return n


def _chol_lib():
    from . import _build

    lib = _build.load("chol")
    if not getattr(lib, "_chol_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"chol_factor_{sfx}")
            f.argtypes = [vp, vp, ci, ci, vp]
            f.restype = ci
            s = getattr(lib, f"chol_solve_{sfx}")
            s.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            s.restype = ci
        lib._chol_bound = True
    return lib


def _ldl_lib():
    from . import _build

    lib = _build.load("ldl")
    if not getattr(lib, "_ldl_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"ldl_factor_{sfx}")
            f.argtypes = [vp, vp, vp, ci, ci, vp]
            f.restype = ci
            s = getattr(lib, f"ldl_solve_{sfx}")
            s.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
            s.restype = ci
        lib._ldl_bound = True
    return lib


def _require_cuda(t: Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{what}: expected a CPU or CUDA tensor, got device {t.device}")
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{what}: float32 or float64 only, got {t.dtype}")


# --- plain versions ---------------------------------------------------------


def cholesky_batched_plain(H: Tensor) -> Tensor:
    """Plain PyTorch right-looking Cholesky, ``(B, n, n)`` -> lower ``L`` with
    zeros above the diagonal. Same elimination order as the kernel. A pivot
    that is not positive gives NaN from that column on (no exception)."""
    n = H.shape[-1]
    a = H.clone()
    for j in range(n):
        r = 1.0 / torch.sqrt(a[:, j, j])
        col = a[:, j:, j] * r[:, None]
        a[:, j:, j] = col
        if j + 1 < n:
            sub = col[:, 1:]
            a[:, j + 1:, j + 1:] -= sub[:, :, None] * sub[:, None, :]
    return torch.tril(a)


def forward_sub_plain(L: Tensor, rhs: Tensor) -> Tensor:
    """Solve ``L y = rhs``; rhs ``(B, n, k)``."""
    y = rhs.clone()
    for j in range(L.shape[-1]):
        if j > 0:
            y[:, j] -= (L[:, j, :j, None] * y[:, :j]).sum(dim=1)
        y[:, j] /= L[:, j, j, None]
    return y


def backward_sub_plain(L: Tensor, rhs: Tensor) -> Tensor:
    """Solve ``L' x = rhs``; rhs ``(B, n, k)``."""
    n = L.shape[-1]
    x = rhs.clone()
    for j in range(n - 1, -1, -1):
        if j + 1 < n:
            x[:, j] -= (L[:, j + 1:, j, None] * x[:, j + 1:]).sum(dim=1)
        x[:, j] /= L[:, j, j, None]
    return x


def cholesky_solve_batched_plain(L: Tensor, rhs: Tensor) -> Tensor:
    """Plain PyTorch solve of ``L L' x = rhs`` by forward and back
    substitution; rhs ``(B, n)`` or ``(B, n, k)``."""
    vec = rhs.ndim == 2
    if vec:
        rhs = rhs[..., None]
    x = backward_sub_plain(L, forward_sub_plain(L, rhs))
    return x[..., 0] if vec else x


def ldl_batched_plain(K: Tensor):
    """Plain PyTorch right-looking LDL': ``(B, N, N)`` -> unit-lower ``L`` and
    ``d (B, N)``. Same elimination order as the kernel."""
    B, N, _ = K.shape
    a = K.clone()
    d = K.new_empty(B, N)
    for j in range(N):
        dj = a[:, j, j].clone()
        d[:, j] = dj
        col = a[:, j:, j] * (1.0 / dj)[:, None]  # unit diagonal at row j
        a[:, j:, j] = col
        if j + 1 < N:
            sub = col[:, 1:]
            a[:, j + 1:, j + 1:] -= sub[:, :, None] * sub[:, None, :] * dj[:, None, None]
    return torch.tril(a), d


def ldl_solve_batched_plain(L: Tensor, d: Tensor, rhs: Tensor) -> Tensor:
    """Plain PyTorch solve of ``L D L' x = rhs``; rhs ``(B, N)`` or ``(B, N, k)``."""
    vec = rhs.ndim == 2
    if vec:
        rhs = rhs[..., None]
    N = rhs.shape[1]
    y = rhs.clone()
    for j in range(1, N):  # forward, unit diagonal
        y[:, j] -= (L[:, j, :j, None] * y[:, :j]).sum(dim=1)
    x = y / d[..., None]
    for j in range(N - 2, -1, -1):  # backward with L'
        x[:, j] -= (L[:, j + 1:, j, None] * x[:, j + 1:]).sum(dim=1)
    return x[..., 0] if vec else x


# --- wrappers ---------------------------------------------------------------


def _cholesky_library(H: Tensor) -> Tensor:
    """Past the kernel's envelope (where the JAX package calls the library
    too): ``cholesky_ex`` never raises; from its first failing pivot on the
    columns become NaN, as in the kernel."""
    L, info = torch.linalg.cholesky_ex(H)
    n = H.shape[-1]
    col = torch.arange(n, device=H.device)
    bad = (info[:, None] > 0) & (col[None, :] >= info[:, None] - 1)  # (B, n): columns >= first bad pivot
    lower = col[:, None] >= col[None, :]
    return torch.where(bad[:, None, :] & lower, torch.full_like(L, float("nan")), L)


def cholesky_batched(H: Tensor) -> Tensor:
    """Batched Cholesky of symmetric positive definite matrices:
    ``(B, n, n)`` -> lower ``L (B, n, n)`` with zeros above the diagonal. Only
    the lower triangle of ``H`` is read. It never raises on a matrix that is
    not positive definite: from the first pivot that is not > 0 on, the
    columns of ``L`` are NaN, and a solve with that ``L`` is NaN throughout.

    CUDA tensors go to the kernel (registers up to n = 128, shared memory up
    to :func:`cholesky_max_n`; past that, by size, to
    ``torch.linalg.cholesky_ex``); CPU tensors to the plain version."""
    if H.ndim != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"cholesky_batched: expected (B, n, n), got {tuple(H.shape)}")
    if H.device.type == "cpu":
        return cholesky_batched_plain(H)
    _require_cuda(H, "cholesky_batched")
    B, n, _ = H.shape
    if _chol_factor_smem_bytes(n, H.element_size()) > MAX_SMEM_BYTES:
        return _cholesky_library(H)
    H = H.contiguous()
    L = torch.empty_like(H)
    if B == 0 or n == 0:
        return L
    lib = _chol_lib()
    fn = getattr(lib, f"chol_factor_{_SUFFIX[H.dtype]}")
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(H.data_ptr(), L.data_ptr(), B, n, stream)
    from . import _build

    _build.check(lib, code, "cholesky_batched")
    cholesky_batched.launches += 1
    return L


cholesky_batched.launches = 0


def cholesky_solve_batched(L: Tensor, rhs: Tensor) -> Tensor:
    """Solve ``L L' x = rhs``; ``L (B, n, n)`` lower (its lower triangle is
    read), rhs ``(B, n)`` or ``(B, n, k)``.

    CUDA tensors go to the kernel (n <= 256 and L, the right-hand sides in
    227 KB of shared memory; past that, by size, to ``torch.cholesky_solve``);
    CPU tensors to the plain version."""
    if L.ndim != 3 or L.shape[1] != L.shape[2] or rhs.shape[:2] != L.shape[:2] or rhs.ndim not in (2, 3):
        raise ValueError(f"cholesky_solve_batched: shapes L {tuple(L.shape)}, rhs {tuple(rhs.shape)}")
    if L.device.type == "cpu":
        return cholesky_solve_batched_plain(L, rhs)
    _require_cuda(L, "cholesky_solve_batched")
    if rhs.device != L.device or rhs.dtype != L.dtype:
        raise ValueError("cholesky_solve_batched: L and rhs must share device and dtype")
    B, n, _ = L.shape
    k = 1 if rhs.ndim == 2 else rhs.shape[2]
    if n > _CHOL_SOLVE_MAX_ROWS or _chol_solve_smem_bytes(n, k, L.element_size()) > MAX_SMEM_BYTES:
        out = torch.cholesky_solve(rhs[..., None] if rhs.ndim == 2 else rhs, L)
        return out[..., 0] if rhs.ndim == 2 else out
    L, rhs = L.contiguous(), rhs.contiguous()
    out = torch.empty_like(rhs)
    if B == 0 or n == 0 or k == 0:
        return out
    lib = _chol_lib()
    fn = getattr(lib, f"chol_solve_{_SUFFIX[L.dtype]}")
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(L.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, n, k, stream)
    from . import _build

    _build.check(lib, code, "cholesky_solve_batched")
    cholesky_solve_batched.launches += 1
    return out


cholesky_solve_batched.launches = 0


def ldl_batched(K: Tensor):
    """Batched LDL' of symmetric quasi-definite matrices: ``(B, N, N)`` ->
    ``(L unit-lower (B, N, N), d (B, N))``. Only the lower triangle of ``K``
    is read. CUDA tensors go to the kernel; CPU tensors to the plain version."""
    if K.ndim != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"ldl_batched: expected (B, N, N), got {tuple(K.shape)}")
    if K.device.type == "cpu":
        return ldl_batched_plain(K)
    _require_cuda(K, "ldl_batched")
    B, N, _ = K.shape
    if _factor_smem_bytes(N, K.element_size()) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"ldl_batched: N = {N} is past the kernel's shared-memory envelope "
            f"(N <= {ldl_max_n(K.dtype)} for {K.dtype}); take the LU route"
        )
    K = K.contiguous()
    L = torch.empty_like(K)
    d = K.new_empty(B, N)
    if B == 0 or N == 0:
        return L, d
    lib = _ldl_lib()
    fn = getattr(lib, f"ldl_factor_{_SUFFIX[K.dtype]}")
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(K.data_ptr(), L.data_ptr(), d.data_ptr(), B, N, stream)
    from . import _build

    _build.check(lib, code, "ldl_batched")
    ldl_batched.launches += 1
    return L, d


ldl_batched.launches = 0


def ldl_solve_batched(L: Tensor, d: Tensor, rhs: Tensor) -> Tensor:
    """Solve ``L D L' x = rhs``; ``L (B, N, N)`` unit-lower (its strict lower
    triangle is read), ``d (B, N)``, rhs ``(B, N)`` or ``(B, N, k)``."""
    if L.ndim != 3 or d.shape != L.shape[:2] or rhs.shape[:2] != L.shape[:2] or rhs.ndim not in (2, 3):
        raise ValueError(
            f"ldl_solve_batched: shapes L {tuple(L.shape)}, d {tuple(d.shape)}, rhs {tuple(rhs.shape)}"
        )
    if L.device.type == "cpu":
        return ldl_solve_batched_plain(L, d, rhs)
    _require_cuda(L, "ldl_solve_batched")
    if not (d.device == rhs.device == L.device and d.dtype == rhs.dtype == L.dtype):
        raise ValueError("ldl_solve_batched: L, d and rhs must share device and dtype")
    B, N, _ = L.shape
    k = 1 if rhs.ndim == 2 else rhs.shape[2]
    if _solve_smem_bytes(N, k, L.element_size()) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"ldl_solve_batched: N = {N}, k = {k} is past the kernel's shared-memory envelope"
        )
    L, d, rhs = L.contiguous(), d.contiguous(), rhs.contiguous()
    out = torch.empty_like(rhs)
    if B == 0 or N == 0 or k == 0:
        return out
    lib = _ldl_lib()
    fn = getattr(lib, f"ldl_solve_{_SUFFIX[L.dtype]}")
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(L.data_ptr(), d.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, N, k, stream)
    from . import _build

    _build.check(lib, code, "ldl_solve_batched")
    ldl_solve_batched.launches += 1
    return out


ldl_solve_batched.launches = 0
