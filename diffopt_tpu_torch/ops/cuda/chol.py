"""Batched small-matrix factorisations: Cholesky factor + solve for symmetric
positive definite matrices and unpivoted LDL' factor + solve for symmetric
quasi-definite ones. CUDA kernels for Hopper, with the plain PyTorch version
beside each.

Replaces ``diffopt_tpu/ops/pallas/chol.py::cholesky_batched`` (kernel body
``_chol_kernel``), ``::cholesky_solve_batched`` (``_solve_kernel``),
``::ldl_batched`` (``_ldl_kernel``) and ``::ldl_solve_batched``
(``_ldl_solve_kernel``). The symmetrised KKT systems are strongly
factorisable (Vanderbei 1995), so the LDL' needs no pivoting.

The Cholesky pair (sources: ``csrc/chol.cu``, ``csrc/dense.cuh``) is sized by
n: the factor runs one instance per team of 1, 2 or 8 warps (the matrix in the
team's register tiles: one warp to 40 rows, two to 64, eight to 176 in f32 and
128 in f64, :func:`chol_tile_max_n`; one-warp instances packed two to a block
so that an SM holds more than 32; past the tiles one block of eight warps with
the matrix in shared memory), the solve one instance per warp at k = 1 (four to a
block) and, for k > 1, a team of two warps sharing one copy of L, with L
reaching shared memory by asynchronous copies that overlap the forward sweep.
The launch rule (:func:`team_for`, written once in the source as
``chol_team`` and mirrored here; the wrapper checks the two agree before each
launch) picks ``(team, per_block)``; ``team=`` forces a team and one that
does not take the shape raises. The notes on the bytes bound,
the NaN semantics of a matrix that is not positive definite and the envelope
stand at the head of ``csrc/chol.cu`` and on the wrappers below.

The LDL' pair (sources: ``csrc/ldl.cu``, ``csrc/tri_solve.cuh``,
``csrc/dense.cuh``) is sized by N the same way. The factor runs one instance
per team of 1, 2 or 8 warps with the matrix in the team's register tiles (one
warp to 40 rows, two one-warp teams to a block; two warps to 128 rows in f32
and 64 in f64; eight warps to 176 rows in f32 and 128 in f64), and past that
one block of eight warps per instance with the packed lower triangle in
shared memory. The solve is the Cholesky solve's kernel with a unit diagonal
and a division by d between the sweeps: at k = 1 one warp solves and, past
64 rows, other warps of the instance's team help to copy L (four warps to 128
rows, eight past that; up to 64 rows one-warp instances packed four, two or
one to a block, whichever puts the most on an SM); a team of two warps for
k > 1. L's strict lower triangle arrives packed by asynchronous
copies that overlap the forward sweep. The launch rule (:func:`ldl_team_for`,
written once in the source as ``ldl_team`` and mirrored here, checked against
it before a launch configuration's first use) takes the factor's smallest
team whose tiles hold N; ``team=`` forces a team, and one that does not take
the shape raises. Every team and route does the same operations in the same
order, so they give the same bits.

What bounds them: device-memory bytes. The factor needs the lower triangle
of K (``N (N + 1) / 2`` words) and writes L in full and d (``N^2 + N`` words)
against ``N^3 / 3`` flops — at N = 112 in f32 that is 75 KB against
0.5 MFLOP per instance, about 0.74 ms for B = 32768 at 3.35 TB/s; the solve
needs the strict lower triangle of L, d and the right-hand side
(``N (N - 1) / 2 + 2 N`` words) and writes N words against ``2 N^2`` flops —
about 0.26 ms at the same sizes. What stands between them and it is the N
sequential elimination steps of the factor, each closed by a team barrier and
paid for in instructions by every thread of the team, and the 2 N steps of the
solve, each one shuffle and one multiply-add on one warp, behind the copy of L
into shared memory; many instances resident on an SM overlap one instance's
serial stretch with another's (``PERF.md`` gives the times and the share of
the bound).

Envelope: pinned at N <= 239 in f32 and N <= 169 in f64 (:func:`ldl_max_n`),
where the shared-memory layout before the redesign ended, because the callers
in ``ops/kkt.py`` take the LU route by that size; both kernels take every N up
to it.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

Tensor = torch.Tensor

MAX_SMEM_BYTES = 232448  # shared memory one block can use on an H100


def _odd(n: int) -> int:
    return n | 1


# the LDL' envelope, pinned where the shared-memory layout before the redesign of K2 / K3 ended (f32 N * odd(N)
# + 2 N words in 227 KB): ops/kkt.py chooses LDL' against LU by it
_LDL_MAX_N = {4: 239, 8: 169}


def ldl_max_n(dtype) -> int:
    """Largest N that both LDL' kernels take for ``dtype`` (239 in f32, 169 in f64)."""
    return _LDL_MAX_N[torch.empty((), dtype=dtype).element_size()]


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


# --- the Cholesky pair's launch rule (mirrors chol_team / chol_team_takes in csrc/chol.cu) ---------

FACTOR_TEAMS = (1, 2, 8)  # warps per instance of the factor (kTeams in csrc/dense.cuh)
SOLVE_TEAMS = (1, 2)  # warps per instance of the solve
_CHOL_SOLVE_MAX_ROWS = 256  # the substitution sweep holds 32 lanes x 8 register rows


def tile_max_n(team: int) -> int:
    """Rows a team of ``team`` warps factorises in registers (``tile_max_n`` in ``csrc/dense.cuh``)."""
    return 40 if team == 1 else (128 if team == 8 else 64)


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def chol_tile_max_n(team: int, itemsize: int) -> int:
    """Rows a factor team of ``team`` warps holds in its register tiles (``chol_tile_max_n`` in
    ``csrc/chol.cu``): one warp 40, two 64, eight 176 in f32 and 128 in f64 (past that the shared-memory
    route)."""
    return 176 if team == 8 and itemsize == 4 else tile_max_n(team)


def _chol_factor_smem_bytes(n: int, itemsize: int, team: int = 8) -> int:
    """Shared memory of one factor instance (``chol_factor_words``): where the
    eight-warp tiles hold n, the pivots and the team's double-buffered pivot
    column; past them the matrix and the pivots."""
    if n <= chol_tile_max_n(8, itemsize):
        return (n + 2 * chol_tile_max_n(team, itemsize)) * itemsize
    return (n * _odd(n) + n) * itemsize


def _chol_solve_smem_bytes(n: int, k: int, itemsize: int) -> int:
    """Shared memory of one solve instance: L's lower triangle, packed (the
    right-hand sides live in registers, so it does not grow with k)."""
    return _tri(n) * itemsize


def per_block_of(n: int, k: int, itemsize: int, team: int) -> int:
    """Instances per block of a launch on teams of ``team`` warps
    (``chol_per_block``): two one-warp factor instances, four one-warp solve
    instances (two or one where their shared memory does not fit), else one."""
    if team != 1:
        return 1
    if k == 0:
        return 2
    per = 4
    while per > 1 and per * _chol_solve_smem_bytes(n, k, itemsize) > MAX_SMEM_BYTES:
        per //= 2
    return per


def smem_bytes(n: int, k: int, itemsize: int, team: int) -> int:
    """Dynamic shared memory of a block on teams of ``team`` warps (``k = 0``:
    the factor); the wrapper checks it against the source's
    ``chol_smem_bytes`` before a launch configuration's first use."""
    one = _chol_factor_smem_bytes(n, itemsize, team) if k == 0 else _chol_solve_smem_bytes(n, k, itemsize)
    return per_block_of(n, k, itemsize, team) * one


@functools.lru_cache(maxsize=None)
def team_takes(n: int, k: int, itemsize: int, team: int) -> bool:
    """Whether teams of ``team`` warps take the shape (``k = 0``: the factor):
    the factor on a team whose register tiles hold n (eight warps also past
    them, in shared memory); the solve on one warp at k = 1 and two for k > 1,
    n <= 256; the block's shared memory within 227 KB."""
    if n < 1 or k < 0:
        return False
    if k == 0:
        if team not in FACTOR_TEAMS or (n > chol_tile_max_n(team, itemsize) and team != 8):
            return False
    elif team != (1 if k == 1 else 2) or n > _CHOL_SOLVE_MAX_ROWS:
        return False
    return smem_bytes(n, k, itemsize, team) <= MAX_SMEM_BYTES


@functools.lru_cache(maxsize=None)
def team_for(n: int, k: int, itemsize: int) -> tuple[int, int]:
    """The launch rule (``chol_team`` in ``csrc/chol.cu``): ``(team, per_block)``
    for the shape (``k = 0``: the factor), ``(0, 0)`` where no team takes it.
    Factor: one warp to 40 rows, two to 64, eight past that. Solve: one warp
    at k = 1, two for k > 1."""
    team = (1 if n <= 40 else (2 if n <= 64 else 8)) if k == 0 else (1 if k == 1 else 2)
    return (team, per_block_of(n, k, itemsize, team)) if team_takes(n, k, itemsize, team) else (0, 0)


def cholesky_max_n(dtype) -> int:
    """Largest n that :func:`cholesky_batched` factors in its kernel for
    ``dtype``; past it the library call takes over."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    n = 1
    while team_takes(n + 1, 0, itemsize, 8):
        n += 1
    return n


# --- the LDL' pair's launch rule (mirrors ldl_team / ldl_team_takes in csrc/ldl.cu) ----------------------
# (H100 shared memory per SM and per resident block, and its limits on blocks and warps: csrc/dense.cuh)
_SM_SMEM_BYTES, _BLOCK_RESERVED_SMEM, _SM_MAX_BLOCKS, _SM_MAX_WARPS = 233472, 1024, 32, 64
LDL_SOLVE_TEAMS = (1, 2, 4, 8)  # warps per instance of the LDL' solve at k = 1 (one solves, the rest help to copy)


def ldl_tile_max_n(team: int, itemsize: int) -> int:
    """Rows a factor team of ``team`` warps holds in its register tiles (``ldl_tile_max_n`` in
    ``csrc/ldl.cu``): one warp 40; two warps 128 in f32 and 64 in f64; eight warps 176 in f32 and 128 in
    f64 (past that the shared-memory route)."""
    if team == 1:
        return 40
    return (128 if team == 2 else 176) if itemsize == 4 else (64 if team == 2 else 128)


def _ldl_factor_words(N: int, team: int, itemsize: int) -> int:
    """Shared-memory words of one factor instance: the pivots and the team's double-buffered pivot
    column (registers route), or the packed lower triangle and the pivots (shared-memory route)."""
    return N + 2 * ldl_tile_max_n(team, itemsize) if N <= ldl_tile_max_n(8, itemsize) else _tri(N) + N


def ldl_per_block_of(N: int, k: int, itemsize: int, team: int) -> int:
    """Instances per block (``ldl_per_block``): two one-warp factor teams; one-warp solve instances four,
    two or one to a block, whichever puts the most on an SM by shared memory (the larger count on a tie);
    otherwise one."""
    if k == 0:
        return 2 if team == 1 else 1
    if team != 1:
        return 1
    one = (_tri(N) - N) * itemsize
    best, most = 1, 0
    for per in (4, 2, 1):
        if per * one > MAX_SMEM_BYTES:
            continue
        blocks = min(_SM_SMEM_BYTES // (per * one + _BLOCK_RESERVED_SMEM), _SM_MAX_BLOCKS)
        resident = min(blocks * per, _SM_MAX_WARPS)
        if resident > most:
            best, most = per, resident
    return best


def ldl_smem_bytes(N: int, k: int, itemsize: int, team: int) -> int:
    """Dynamic shared memory of an LDL' block on teams of ``team`` warps (``k = 0``: the factor); the
    wrapper checks it against the source's ``ldl_smem_bytes`` before a launch configuration's first use."""
    words = _ldl_factor_words(N, team, itemsize) if k == 0 else _tri(N) - N
    return ldl_per_block_of(N, k, itemsize, team) * words * itemsize


@functools.lru_cache(maxsize=None)
def ldl_team_takes(N: int, k: int, itemsize: int, team: int) -> bool:
    """Whether LDL' teams of ``team`` warps take the shape (``k = 0``: the factor): N within
    :func:`ldl_max_n`; the factor on a team whose register tiles hold N, and on eight warps past them
    (the shared-memory route); the solve on 1, 2 or 4 warps at k = 1 and two for k > 1; the block's
    shared memory within 227 KB."""
    if N < 1 or k < 0 or N > _LDL_MAX_N[itemsize]:
        return False
    reg_rows = ldl_tile_max_n(8, itemsize)
    if k == 0:
        if team not in FACTOR_TEAMS or (N > ldl_tile_max_n(team, itemsize) and not (team == 8 and N > reg_rows)):
            return False
    elif team not in (LDL_SOLVE_TEAMS if k == 1 else (2,)) or N > _CHOL_SOLVE_MAX_ROWS:
        return False
    return ldl_smem_bytes(N, k, itemsize, team) <= MAX_SMEM_BYTES


def ldl_solve_team(N: int) -> int:
    """Warps per instance of the LDL' solve at k = 1 (``ldl_solve_team`` in ``csrc/ldl.cu``): one warp
    solves and the others help to copy L: one warp to 64 rows, four to 128, eight past that."""
    return 1 if N <= 64 else 4 if N <= 128 else 8


@functools.lru_cache(maxsize=None)
def ldl_team_for(N: int, k: int, itemsize: int) -> tuple[int, int]:
    """The LDL' launch rule (``ldl_team`` in ``csrc/ldl.cu``): ``(team, per_block)`` for the shape
    (``k = 0``: the factor), ``(0, 0)`` where no team takes it. Factor: the smallest team that takes N.
    Solve: :func:`ldl_solve_team` at k = 1, two warps for k > 1."""
    teams = FACTOR_TEAMS if k == 0 else ((ldl_solve_team(N),) if k == 1 else (2,))
    for team in teams:
        if ldl_team_takes(N, k, itemsize, team):
            return team, ldl_per_block_of(N, k, itemsize, team)
    return 0, 0


def _chol_lib():
    from . import _build

    lib = _build.load("chol")
    if not getattr(lib, "_chol_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"chol_factor_{sfx}")
            f.argtypes = [vp, vp, ci, ci, ci, vp]  # H, L, B, n, team, stream
            f.restype = ci
            s = getattr(lib, f"chol_solve_{sfx}")
            s.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]  # L, rhs, out, B, n, k, team, stream
            s.restype = ci
        lib.chol_blocks_per_sm.argtypes = [ci] * 4
        lib.chol_blocks_per_sm.restype = ci
        lib.chol_team.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        lib.chol_team.restype = ci
        lib.chol_smem_bytes.argtypes = [ci] * 4
        lib.chol_smem_bytes.restype = ctypes.c_longlong
        lib._chol_bound = True
    return lib


def blocks_per_sm(n: int, k: int, dtype, team: int = 0) -> int:
    """Instances resident on one SM of the current card at the shape (``k = 0``:
    the factor) on teams of ``team`` warps (0: the rule's), as the CUDA
    occupancy calculator counts them with the built kernel's registers and
    shared memory. Needs the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("chol.blocks_per_sm: no CUDA device")
    itemsize = torch.empty((), dtype=dtype).element_size()
    got = _chol_lib().chol_blocks_per_sm(n, k, itemsize, team)
    if got < 0:
        raise RuntimeError(f"chol.blocks_per_sm: CUDA error {-got} at n={n}, k={k}")
    return got


def _ldl_lib():
    from . import _build

    lib = _build.load("ldl")
    if not getattr(lib, "_ldl_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            f = getattr(lib, f"ldl_factor_{sfx}")
            f.argtypes = [vp, vp, vp, ci, ci, ci, vp]  # K, L, d, B, N, team, stream
            f.restype = ci
            s = getattr(lib, f"ldl_solve_{sfx}")
            s.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]  # L, d, rhs, out, B, N, k, team, stream
            s.restype = ci
        lib.ldl_blocks_per_sm.argtypes = [ci] * 4
        lib.ldl_blocks_per_sm.restype = ci
        lib.ldl_team.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
        lib.ldl_team.restype = ci
        lib.ldl_smem_bytes.argtypes = [ci] * 4
        lib.ldl_smem_bytes.restype = ctypes.c_longlong
        lib._ldl_bound = True
    return lib


def ldl_blocks_per_sm(N: int, k: int, dtype, team: int = 0) -> int:
    """LDL' instances resident on one SM of the current card at the shape (``k = 0``: the factor) on
    teams of ``team`` warps (0: the rule's), as the CUDA occupancy calculator counts them with the built
    kernel's registers and shared memory. Needs the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("chol.ldl_blocks_per_sm: no CUDA device")
    itemsize = torch.empty((), dtype=dtype).element_size()
    got = _ldl_lib().ldl_blocks_per_sm(N, k, itemsize, team)
    if got < 0:
        raise RuntimeError(f"chol.ldl_blocks_per_sm: CUDA error {-got} at N={N}, k={k}")
    return got


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


class _Rule:
    """One pair's launch rule in Python and its C twin's names: the rule, whether a team takes a shape,
    instances per block and shared memory, and the library functions ``<prefix>_team`` /
    ``<prefix>_smem_bytes`` that the source exports."""

    def __init__(self, prefix, team_for, team_takes, per_block_of, smem_bytes, factor_teams, solve_teams):
        self.prefix, self.team_for, self.team_takes = prefix, team_for, team_takes
        self.per_block_of, self.smem_bytes = per_block_of, smem_bytes
        self.factor_teams, self.solve_teams = factor_teams, solve_teams
        self.verified: set[tuple[int, int, int, int]] = set()  # launches whose rule and layout were checked

    def forced(self, what: str, n: int, k: int, itemsize: int, team) -> int | None:
        """The forced team, or None for the rule's; raises ``ValueError`` where it does not take the
        shape (another is never tried)."""
        if team is not None and not self.team_takes(n, k, itemsize, team):
            raise ValueError(
                f"{what}: teams of {team} warps do not take n={n}" + (f", k={k}" if k else "")
                + f" (teams {self.factor_teams if k == 0 else self.solve_teams}; see {self.prefix} team_takes)"
            )
        return team

    def launch(self, lib, n: int, k: int, itemsize: int, forced, what: str) -> tuple[int, int]:
        """``(team, per_block)`` of the launch for the shape. Before a launch configuration's first use
        the source's rule and shared-memory count are checked against this module's (a mismatch raises);
        the verdict is kept, since both are functions of the shape alone and a staged step launches the
        same few shapes hundreds of times."""
        rule = self.team_for(n, k, itemsize)
        team = forced or rule[0]
        key = (n, k, itemsize, team)
        if key not in self.verified:
            per = ctypes.c_int(0)
            if getattr(lib, f"{self.prefix}_team")(n, k, itemsize, ctypes.byref(per)) != rule[0] or per.value != rule[1]:
                raise RuntimeError(f"{what}: launch rule of wrapper and kernel differ at n={n}, k={k}")
            if getattr(lib, f"{self.prefix}_smem_bytes")(n, k, itemsize, team) != self.smem_bytes(n, k, itemsize, team):
                raise RuntimeError(f"{what}: shared-memory layout of wrapper and kernel differ")
            self.verified.add(key)
        return team, self.per_block_of(n, k, itemsize, team)


_CHOL = _Rule("chol", team_for, team_takes, per_block_of, smem_bytes, FACTOR_TEAMS, SOLVE_TEAMS)
_LDL = _Rule("ldl", ldl_team_for, ldl_team_takes, ldl_per_block_of, ldl_smem_bytes, FACTOR_TEAMS, LDL_SOLVE_TEAMS)


def cholesky_batched(H: Tensor, *, team: int | None = None) -> Tensor:
    """Batched Cholesky of symmetric positive definite matrices:
    ``(B, n, n)`` -> lower ``L (B, n, n)`` with zeros above the diagonal. Only
    the lower triangle of ``H`` is read. It never raises on a matrix that is
    not positive definite: from the first pivot that is not > 0 on, the
    columns of ``L`` are NaN, and a solve with that ``L`` is NaN throughout.

    CUDA tensors go to the kernel (one instance per team of 1, 2 or 8 warps,
    the matrix in registers up to n = 176 in f32 and 128 in f64
    (:func:`chol_tile_max_n`), in shared memory up to :func:`cholesky_max_n`;
    past that, by size, to
    ``torch.linalg.cholesky_ex``), with ``team`` warps per instance (None:
    the launch rule's :func:`team_for`); a team that does not take the shape
    raises ``ValueError``, a failed build or launch raises. CPU tensors go to
    the plain version."""
    if H.ndim != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"cholesky_batched: expected (B, n, n), got {tuple(H.shape)}")
    B, n, _ = H.shape
    forced = _CHOL.forced("cholesky_batched", n, 0, H.element_size(), team)
    if H.device.type == "cpu":
        return cholesky_batched_plain(H)
    _require_cuda(H, "cholesky_batched")
    if team_for(n, 0, H.element_size())[0] == 0:  # past cholesky_max_n
        return _cholesky_library(H)
    H = H.contiguous()
    L = torch.empty_like(H)
    if B == 0 or n == 0:
        return L
    lib = _chol_lib()
    t, p = _CHOL.launch(lib, n, 0, H.element_size(), forced, "cholesky_batched")
    fn = getattr(lib, f"chol_factor_{_SUFFIX[H.dtype]}")
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(H.data_ptr(), L.data_ptr(), B, n, t, stream)
    from . import _build

    _build.check(lib, code, f"cholesky_batched ({p} per block, teams of {t} warps)")
    cholesky_batched.launches += 1
    cholesky_batched.launches_by_shape[(n, 0)] += 1
    return L


cholesky_batched.launches = 0
cholesky_batched.launches_by_shape = collections.Counter()  # (n, 0) -> launches


def cholesky_solve_batched(L: Tensor, rhs: Tensor, *, team: int | None = None) -> Tensor:
    """Solve ``L L' x = rhs``; ``L (B, n, n)`` lower (its lower triangle is
    read), rhs ``(B, n)`` or ``(B, n, k)``.

    CUDA tensors go to the kernel (n <= 256 and L's packed triangle in 227 KB
    of shared memory; past that, by size, to ``torch.cholesky_solve``), with
    ``team`` warps per instance (None: the launch rule's :func:`team_for`); a
    team that does not take the shape raises ``ValueError``, a failed build or
    launch raises. CPU tensors go to the plain version."""
    if L.ndim != 3 or L.shape[1] != L.shape[2] or rhs.shape[:2] != L.shape[:2] or rhs.ndim not in (2, 3):
        raise ValueError(f"cholesky_solve_batched: shapes L {tuple(L.shape)}, rhs {tuple(rhs.shape)}")
    B, n, _ = L.shape
    k = 1 if rhs.ndim == 2 else rhs.shape[2]
    forced = _CHOL.forced("cholesky_solve_batched", n, max(k, 1), L.element_size(), team)
    if L.device.type == "cpu":
        return cholesky_solve_batched_plain(L, rhs)
    _require_cuda(L, "cholesky_solve_batched")
    if rhs.device != L.device or rhs.dtype != L.dtype:
        raise ValueError("cholesky_solve_batched: L and rhs must share device and dtype")
    if k > 0 and team_for(n, k, L.element_size())[0] == 0:
        out = torch.cholesky_solve(rhs[..., None] if rhs.ndim == 2 else rhs, L)
        return out[..., 0] if rhs.ndim == 2 else out
    L, rhs = L.contiguous(), rhs.contiguous()
    out = torch.empty_like(rhs)
    if B == 0 or n == 0 or k == 0:
        return out
    lib = _chol_lib()
    t, p = _CHOL.launch(lib, n, k, L.element_size(), forced, "cholesky_solve_batched")
    fn = getattr(lib, f"chol_solve_{_SUFFIX[L.dtype]}")
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(L.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, n, k, t, stream)
    from . import _build

    _build.check(lib, code, f"cholesky_solve_batched ({p} per block, teams of {t} warps)")
    cholesky_solve_batched.launches += 1
    cholesky_solve_batched.launches_by_shape[(n, k)] += 1
    return out


cholesky_solve_batched.launches = 0
cholesky_solve_batched.launches_by_shape = collections.Counter()  # (n, k) -> launches


def ldl_batched(K: Tensor, *, team: int | None = None):
    """Batched LDL' of symmetric quasi-definite matrices: ``(B, N, N)`` ->
    ``(L unit-lower (B, N, N) with zeros above the diagonal, d (B, N))``. Only
    the lower triangle of ``K`` is read.

    CUDA tensors go to the kernel (one instance per team of 1, 2 or 8 warps,
    the matrix in registers up to N = 128 and packed in shared memory past it,
    N <= :func:`ldl_max_n`; past that it raises ``NotImplementedError`` and the
    callers take the LU route by size), with ``team`` warps per instance (None:
    the launch rule's :func:`ldl_team_for`); a team that does not take the
    shape raises ``ValueError``, a failed build or launch raises. CPU tensors
    go to the plain version."""
    if K.ndim != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"ldl_batched: expected (B, N, N), got {tuple(K.shape)}")
    B, N, _ = K.shape
    forced = _LDL.forced("ldl_batched", N, 0, K.element_size(), team)
    if K.device.type == "cpu":
        return ldl_batched_plain(K)
    _require_cuda(K, "ldl_batched")
    if N > ldl_max_n(K.dtype):
        raise NotImplementedError(
            f"ldl_batched: N = {N} is past the kernel's envelope (N <= {ldl_max_n(K.dtype)} for {K.dtype});"
            " take the LU route"
        )
    K = K.contiguous()
    L = torch.empty_like(K)
    d = K.new_empty(B, N)
    if B == 0 or N == 0:
        return L, d
    lib = _ldl_lib()
    t, p = _LDL.launch(lib, N, 0, K.element_size(), forced, "ldl_batched")
    fn = getattr(lib, f"ldl_factor_{_SUFFIX[K.dtype]}")
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(K.data_ptr(), L.data_ptr(), d.data_ptr(), B, N, t, stream)
    from . import _build

    _build.check(lib, code, f"ldl_batched ({p} per block, teams of {t} warps)")
    ldl_batched.launches += 1
    ldl_batched.launches_by_shape[(N, 0)] += 1
    return L, d


ldl_batched.launches = 0
ldl_batched.launches_by_shape = collections.Counter()  # (N, 0) -> launches


def ldl_solve_batched(L: Tensor, d: Tensor, rhs: Tensor, *, team: int | None = None) -> Tensor:
    """Solve ``L D L' x = rhs``; ``L (B, N, N)`` unit-lower (its strict lower
    triangle is read), ``d (B, N)``, rhs ``(B, N)`` or ``(B, N, k)``.

    CUDA tensors go to the kernel (N <= :func:`ldl_max_n`, any k; past that it
    raises ``NotImplementedError``), with ``team`` warps per instance (None:
    the launch rule's :func:`ldl_team_for`); a team that does not take the
    shape raises ``ValueError``, a failed build or launch raises. CPU tensors
    go to the plain version."""
    if L.ndim != 3 or d.shape != L.shape[:2] or rhs.shape[:2] != L.shape[:2] or rhs.ndim not in (2, 3):
        raise ValueError(
            f"ldl_solve_batched: shapes L {tuple(L.shape)}, d {tuple(d.shape)}, rhs {tuple(rhs.shape)}"
        )
    B, N, _ = L.shape
    k = 1 if rhs.ndim == 2 else rhs.shape[2]
    forced = _LDL.forced("ldl_solve_batched", N, max(k, 1), L.element_size(), team)
    if L.device.type == "cpu":
        return ldl_solve_batched_plain(L, d, rhs)
    _require_cuda(L, "ldl_solve_batched")
    if not (d.device == rhs.device == L.device and d.dtype == rhs.dtype == L.dtype):
        raise ValueError("ldl_solve_batched: L, d and rhs must share device and dtype")
    if N > ldl_max_n(L.dtype):
        raise NotImplementedError(f"ldl_solve_batched: N = {N} is past the kernel's envelope (N <= {ldl_max_n(L.dtype)})")
    L, d, rhs = L.contiguous(), d.contiguous(), rhs.contiguous()
    out = torch.empty_like(rhs)
    if B == 0 or N == 0 or k == 0:
        return out
    lib = _ldl_lib()
    t, p = _LDL.launch(lib, N, k, L.element_size(), forced, "ldl_solve_batched")
    fn = getattr(lib, f"ldl_solve_{_SUFFIX[L.dtype]}")
    with torch.cuda.device(L.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(L.data_ptr(), d.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, N, k, t, stream)
    from . import _build

    _build.check(lib, code, f"ldl_solve_batched ({p} per block, teams of {t} warps)")
    ldl_solve_batched.launches += 1
    ldl_solve_batched.launches_by_shape[(N, k)] += 1
    return out


ldl_solve_batched.launches = 0
ldl_solve_batched.launches_by_shape = collections.Counter()  # (N, k) -> launches
