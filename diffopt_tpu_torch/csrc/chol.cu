// Batched Cholesky factor (K4) and solve (K5) for small symmetric positive
// definite matrices: one instance per team of warps, or one per warp with
// several warps packed into a block, sized by n.
//
// Replaces diffopt_tpu/ops/pallas/chol.py::cholesky_batched (_chol_kernel) and
// ::cholesky_solve_batched (_solve_kernel). The TPU kernels put the batch along
// the 128 lanes, pad n to a multiple of 8 and stop at n = 128; here the batch
// is the grid, the matrix stays in its natural (B, n, n) row-major layout, n is
// taken as it comes, and the envelope is what 227 KB of shared memory holds.
//
// Bound on an H100: device-memory bytes. The factor needs the lower triangle
// of H, n (n + 1) / 2 words, and writes L in full (zeros above the diagonal,
// as the reference's tril leaves it), n^2 words, per instance for n^3 / 3
// flops (n = 64, f32: 24 KB against 0.09 MFLOP, 280 bytes per kflop -- far on
// the memory side of the card's 67 TFLOP/s : 3.35 TB/s). The solve needs the
// lower triangle of L and the right-hand sides, n (n + 1) / 2 + n k words, and
// writes n k words for 2 n^2 k flops. Both read only the lower triangle.
// What stands between them and that bound is the sequential structure: n
// elimination steps with a team barrier each in the factor, 2 n substitution
// steps in the solve. An instance's chain is short (n = 6 to 160), so the
// design gives each instance the fewest threads that serve it and puts as
// many instances on an SM as it holds, each chain overlapping the others:
//
// Factor. The matrix lives in the registers of a team of 1, 2 or 8 warps
// (dense.cuh: Team, TileGrid, factor_grid, the same register-tiled
// elimination as K1, K2 and K6, whose update order does not depend on the
// team: every team size gives the same bits), one team per instance, one
// instantiation per (type, team, cover) (CholCovers); the smallest team whose
// tiles hold n takes it (one warp to 40 rows, two to 64, eight to 176 in f32
// and 128 in f64: chol_tile_max_n; chol_team). One-warp teams are packed two
// to a block (blockDim = (32, 2)), so that an SM holds more of them than its
// 32 resident blocks. Past the eight-warp tiles one block of eight warps
// factorises in shared memory (factor_lower), the same operations in the
// same order. At n = 144 (the [sdp] gram route) the shared-memory route paid
// a load and a store for every multiply-add, and ran at 6% of its bound. The
// first pivot that is not > 0 is found by warp ballots over the pivots.
//
// Solve (csrc/tri_solve.cuh, shared with the LDL' solve K3). One warp per
// instance at k = 1, four warps packed into a block. For k > 1 one copy of L
// serves all the right-hand sides: a team of two warps of which each holds up
// to four right-hand sides in registers at once. L's lower triangle reaches
// shared memory packed (row i at i (i + 1) / 2) by asynchronous copies
// (cp.async) in eight groups of columns, overlapped with the forward sweep.
// Every launch does the same operations in the same order (the forward sweep
// subtracts column by column, the backward row by row of L, and each pivot is
// multiplied by 1 / L[j][j]).
//
// A matrix that is not positive definite never traps: from the first pivot j
// that is not > 0 on, every column k >= j of L is NaN (rows >= k), which is
// what the reference's rsqrt leaves behind, and the solvers' NaN guards freeze
// that instance.
//
// Envelope: the factor past its register tiles needs (n * odd(n) + n) words
// of shared memory in 227 KB; the solve n <= 256 (32 lanes x 8 register rows) and its
// packed triangle, n (n + 1) / 2 words, in 227 KB.
#include "dense.cuh"
#include "prof.cuh"
#include "tri_solve.cuh"

namespace dk {

template <typename T>
__device__ inline T quiet_nan();
template <>
__device__ inline float quiet_nan<float>() { return __int_as_float(0x7fffffff); }
template <>
__device__ inline double quiet_nan<double>() { return __longlong_as_double(0x7ff8000000000000LL); }

// ---- the launch rule (mirrored by ops/cuda/chol.py) ----------------------------
//
// A launch is a team of `tw` warps per instance; k = 0 is the factor, k >= 1
// the solve with k right-hand sides. One-warp teams are packed into a block,
// two factor or four solve instances (fewer where their shared memory does not
// fit), the counts that were timed fastest, or within a few percent of it, on
// an H100 (PERF.md).

// The row counts each (type, team) factorises in registers (the covers of its
// tile sets, smallest first; the last is the most it takes): the team's
// TileGrid covers, and for eight warps in f32 144 (n = 144, the [sdp] gram
// route: 45 live entries a thread) and 176 (66), as K2's LdlCovers.
template <typename T, int TW> struct CholCovers {
  static constexpr int kNum = TileGrid<TW>::kNumCovers;
  static constexpr const int* kCovers = TileGrid<TW>::kCovers;
};
template <> struct CholCovers<float, 8> { static constexpr int kNum = 5, kCovers[5] = {32, 64, 128, 144, 176}; };

// rows a factor team of tw warps holds in its register tiles; past the
// eight-warp team's, the shared-memory route
__host__ __device__ constexpr int chol_tile_max_n(int tw, int itemsize) {
  return tw == 8 && itemsize == 4 ? 176 : tile_max_n(tw);
}

// shared-memory words of one instance: the factor's pivots and the team's
// double-buffered pivot column (registers route), or the matrix and pivots
// (shared-memory route); the solve's packed triangle
__host__ __device__ inline int chol_factor_words(int n, int tw, int itemsize) {
  return n <= chol_tile_max_n(8, itemsize) ? n + 2 * chol_tile_max_n(tw, itemsize) : n * odd_stride(n) + n;
}
__host__ __device__ inline int chol_solve_words(int n) { return solve_words<CholDiag>(n); }

// instances per block of a launch with teams of tw warps
inline int chol_per_block(int n, int k, int itemsize, int tw) {
  if (tw != 1) return 1;
  if (k == 0) return 2;
  int per = 4;
  while (per > 1 && size_t(per) * chol_solve_words(n) * itemsize > kMaxSmemBytes) per >>= 1;
  return per;
}

inline size_t chol_smem_bytes_of(int n, int k, int itemsize, int tw) {
  const int words = k == 0 ? chol_factor_words(n, tw, itemsize) : chol_solve_words(n);
  return size_t(chol_per_block(n, k, itemsize, tw)) * words * size_t(itemsize);
}

// Whether teams of tw warps take the shape: the factor on a team whose
// register tiles hold n (eight warps also past them, in shared memory); the
// solve on one warp at k = 1 and two for k > 1, n <= 256; everything in one
// block's shared memory. (Solve teams of four and eight warps were slower
// than two at every shape timed on an H100, and are not built.)
inline bool chol_team_takes(int n, int k, int itemsize, int tw) {
  if (n < 1 || k < 0) return false;
  if (k == 0) {
    if (!(tw == 1 || tw == 2 || tw == 8) || (n > chol_tile_max_n(tw, itemsize) && tw != 8)) return false;
  } else if (tw != (k == 1 ? 1 : 2) || n > kSolveMaxRows) {
    return false;
  }
  return chol_smem_bytes_of(n, k, itemsize, tw) <= kMaxSmemBytes;
}

// The launch rule: the factor's smallest team whose tiles hold n (one warp to
// 40 rows, two to 64, eight past that), the solve's one team for its k; 0
// where none takes the shape.
inline int chol_team(int n, int k, int itemsize) {
  const int tw = k == 0 ? (n <= 40 ? 1 : (n <= 64 ? 2 : 8)) : (k == 1 ? 1 : 2);
  return chol_team_takes(n, k, itemsize, tw) ? tw : 0;
}

// ---- factor ------------------------------------------------------------------

// Index of the first pivot that is not > 0 (n if all are), in every lane of
// the calling warp: ballots over the pivots, 32 at a time.
template <typename T, typename P>
__device__ inline int first_bad_pivot(P diag, int n, int lane) {
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    const unsigned bad = __ballot_sync(kFullMask, j < n && !(diag[j] > T(0)));
    if (bad) return j0 + __ffs(int(bad)) - 1;
  }
  return n;
}

// Registers the launch bounds allow a thread of each factor instantiation:
// resident blocks per SM at least (f32 / f64), so that the tiles fit without
// spilling at the sizes each instantiation serves (eight warps past 128 rows
// in f32: two blocks, 128 registers a thread, as K2's at 176).
__host__ __device__ constexpr int chol_factor_min_blocks(int itemsize, int tw, int rx) {
  return tw == 1 ? (rx <= 3 ? (itemsize == 4 ? 24 : 16) : (itemsize == 4 ? 12 : 6))  // blocks of two warps
       : tw == 2 ? (rx <= 4 ? (itemsize == 4 ? 16 : 8) : (itemsize == 4 ? 8 : 4))
                 : (rx <= 2 ? 4 : (rx <= 4 ? 2 : (rx <= 8 ? 1 : 2)));
}

// One instance per team of TW warps (threadIdx.x), two teams per block for
// TW = 1 (threadIdx.y), the matrix in the team's register tiles of RX column
// tiles: global memory -> registers -> global.
template <typename T, int TW, int RX>
__global__ void __launch_bounds__(32 * TW * (TW == 1 ? 2 : 1), chol_factor_min_blocks(sizeof(T), TW, RX))
chol_factor_team_kernel(const T* __restrict__ H, T* __restrict__ Lout, int B, int n) {
  using G = TileGrid<TW>;
  constexpr int kY = G::kY, kX = G::kX, RY = RX * kX / kY;
  const int inst = blockIdx.x * blockDim.y + threadIdx.y;
  if (inst >= B) return;  // a whole team: blocks of several teams hold one-warp teams only
  const int base = threadIdx.y * chol_factor_words(n, TW, sizeof(T));
  const SPtr<T> diag{base}, colbuf{base + n};
  const int tx = threadIdx.x % kX, ty = threadIdx.x / kX, lane = threadIdx.x & 31;
  const T* Hg = H + size_t(inst) * n * n;
  T* Lg = Lout + size_t(inst) * n * n;
  DK_PROF_START();
  // the lower triangle of H only; entries outside it and past n enter as zeros
  T t[RY][RX];
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int i = ty + kY * a, k = tx + kX * b;
      t[a][b] = (tile_live<kY, kX>(a, b) && i < n && k <= i) ? Hg[size_t(i) * n + k] : T(0);
    }
  DK_PROF_AT(kProfCopy, Team<TW>::sync(), threadIdx.x == 0);
  factor_grid<T, TW, RY, RX>(t, n, diag, colbuf);
  const int jbad = first_bad_pivot<T>(diag, n, lane);
  DK_PROF_AT(kProfWork, Team<TW>::sync(), threadIdx.x == 0);
  const T nan = quiet_nan<T>();
  // column k of t carries L[i][k] * pivot k of the LDL' form: times
  // rsqrt(pivot k) it is the Cholesky factor, diagonal included
  T rk[RX];
#pragma unroll
  for (int b = 0; b < RX; ++b) {
    const int k = tx + kX * b;
    rk[b] = k < n ? (k < jbad ? rsqrt(diag[k]) : nan) : T(0);
  }
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int i = ty + kY * a, k = tx + kX * b;
      if (i < n && k < n) {
        T v = T(0);
        if (tile_live<kY, kX>(a, b) && k <= i) v = k < jbad ? t[a][b] * rk[b] : nan;
        Lg[size_t(i) * n + k] = v;
      }
    }
  DK_PROF_AT(kProfOut, Team<TW>::sync(), threadIdx.x == 0);
  if (threadIdx.x == 0) DK_PROF_ADD(kProfInstances, 1);
}

// Past the register tiles (f32 n > 176, f64 n > 128): one block of eight warps per instance, the matrix in
// shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_factor_smem_kernel(const T* __restrict__ H, T* __restrict__ Lout, int /*B: one block each*/, int n) {
  const SPtr<T> M{0};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Hg = H + size_t(blockIdx.x) * n * n;
  T* Lg = Lout + size_t(blockIdx.x) * n * n;
  const int ld = odd_stride(n);
  T* dvec = reinterpret_cast<T*>(dk_smem) + size_t(n) * ld;
  DK_PROF_START();
  // lower triangle only, one warp per row
  for (int i = warp; i < n; i += kWarps)
    for (int k = lane; k <= i; k += 32) M[i * ld + k] = Hg[size_t(i) * n + k];
  __syncthreads();
  DK_PROF(kProfCopy);
  factor_lower<T>(reinterpret_cast<T*>(dk_smem), ld, n, dvec);
  const int jbad = first_bad_pivot<T>(dvec, n, lane);
  DK_PROF(kProfWork);
  const T nan = quiet_nan<T>();
  for (int i = warp; i < n; i += kWarps)
    for (int k = lane; k < n; k += 32) {
      T v = T(0);
      if (k <= i) v = k < jbad ? M[i * ld + k] * rsqrt(dvec[k]) : nan;
      Lg[size_t(i) * n + k] = v;
    }
  DK_PROF(kProfOut);
  if (tid == 0) DK_PROF_ADD(kProfInstances, 1);
}

// ---- launchers -----------------------------------------------------------------

// f(kernel, block) with the factor's instantiation for (n, tw): the smallest
// of the team's covers that holds n, or the shared-memory kernel past them
template <typename T, int TW, int kIdx = 0, class F>
int with_cover(int n, int per, F&& f) {
  using C = CholCovers<T, TW>;
  if constexpr (kIdx >= C::kNum) {
    return int(cudaErrorInvalidValue);
  } else {
    constexpr int cover = C::kCovers[kIdx];
    static_assert(cover % TileGrid<TW>::kX == 0 && cover % TileGrid<TW>::kY == 0, "whole tiles both ways");
    if (n <= cover) return f(chol_factor_team_kernel<T, TW, cover / TileGrid<TW>::kX>, dim3(32 * TW, per));
    return with_cover<T, TW, kIdx + 1>(n, per, f);
  }
}

template <typename T, class F>
int with_factor_kernel(int n, int tw, int per, F&& f) {
  if (n > chol_tile_max_n(8, sizeof(T))) return f(chol_factor_smem_kernel<T>, dim3(kThreads));
  return with_team(tw, [&](auto tc) { return with_cover<T, decltype(tc)::value>(n, per, f); });
}

template <typename T>
int launch_chol_factor(const void* H, void* L, int B, int n, int team, void* stream) {
  const int item = int(sizeof(T));
  if (team == 0) team = chol_team(n, 0, item);
  if (B <= 0 || !chol_team_takes(n, 0, item, team)) return int(cudaErrorInvalidValue);  // refused
  const int per = chol_per_block(n, 0, item, team);
  const size_t smem = chol_smem_bytes_of(n, 0, item, team);
  return with_factor_kernel<T>(n, team, per, [&](auto kernel, dim3 block) {
    cudaError_t e = smem_attributes(kernel, smem);
    if (e != cudaSuccess) return int(e);
    kernel<<<(B + per - 1) / per, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(H), static_cast<T*>(L), B, n);
    return int(cudaGetLastError());
  });
}

template <typename T>
int launch_chol_solve(const void* L, const void* rhs, void* out, int B, int n, int k, int team, void* stream) {
  const int item = int(sizeof(T));
  if (team == 0) team = chol_team(n, k, item);
  if (B <= 0 || k <= 0 || !chol_team_takes(n, k, item, team)) return int(cudaErrorInvalidValue);  // refused
  const int per = chol_per_block(n, k, item, team);
  const size_t smem = chol_smem_bytes_of(n, k, item, team);
  return with_solve_kernel<T, CholDiag>(n, k, team, per, [&](auto kernel, dim3 block) {
    cudaError_t e = smem_attributes(kernel, smem);
    if (e != cudaSuccess) return int(e);
    kernel<<<(B + per - 1) / per, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(L), nullptr, static_cast<const T*>(rhs), static_cast<T*>(out), B, n, k);
    return int(cudaGetLastError());
  });
}

// instances resident on one SM at the shape with teams of `team` warps (k = 0:
// the factor), by the occupancy calculator; a negative CUDA error code on failure
template <typename T>
int chol_blocks_per_sm_of(int n, int k, int team) {
  const int item = int(sizeof(T));
  if (team == 0) team = chol_team(n, k, item);
  if (!chol_team_takes(n, k, item, team)) return -int(cudaErrorInvalidValue);
  const int per = chol_per_block(n, k, item, team);
  const size_t smem = chol_smem_bytes_of(n, k, item, team);
  auto occupancy = [&](auto kernel, dim3 block) {
    cudaError_t e = smem_attributes(kernel, smem);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block.x * block.y * block.z, smem);
    return e == cudaSuccess ? blocks * per : -int(e);
  };
  return k == 0 ? with_factor_kernel<T>(n, team, per, occupancy) : with_solve_kernel<T, CholDiag>(n, k, team, per, occupancy);
}

}  // namespace dk

extern "C" {

#ifdef DK_PROFILE
int chol_prof_read(unsigned long long* out) { return dk::prof_read(out); }
int chol_prof_zero() { return dk::prof_zero(); }
#endif

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// The launch rule: warps per instance for the shape (k = 0: the factor; 0 where none takes it), and
// instances per block into *per_block.
int chol_team(int n, int k, int itemsize, int* per_block) {
  const int team = dk::chol_team(n, k, itemsize);
  *per_block = team ? dk::chol_per_block(n, k, itemsize, team) : 0;
  return team;
}

// Dynamic shared memory of a block with teams of `team` warps at the shape, in bytes; -1 where that
// team does not take it.
long long chol_smem_bytes(int n, int k, int itemsize, int team) {
  return dk::chol_team_takes(n, k, itemsize, team) ? (long long)dk::chol_smem_bytes_of(n, k, itemsize, team) : -1;
}

// Instances resident per SM at the shape (team 0: the rule's); a negative CUDA error code on failure.
int chol_blocks_per_sm(int n, int k, int itemsize, int team) {
  return itemsize == 4 ? dk::chol_blocks_per_sm_of<float>(n, k, team) : dk::chol_blocks_per_sm_of<double>(n, k, team);
}

// team: warps per instance, 0 for the launch rule's; a team that does not take the shape is refused
// (cudaErrorInvalidValue), never replaced by another.
int chol_factor_f32(const void* H, void* L, int B, int n, int team, void* stream) {
  return dk::launch_chol_factor<float>(H, L, B, n, team, stream);
}
int chol_factor_f64(const void* H, void* L, int B, int n, int team, void* stream) {
  return dk::launch_chol_factor<double>(H, L, B, n, team, stream);
}
int chol_solve_f32(const void* L, const void* rhs, void* out, int B, int n, int k, int team, void* stream) {
  return dk::launch_chol_solve<float>(L, rhs, out, B, n, k, team, stream);
}
int chol_solve_f64(const void* L, const void* rhs, void* out, int B, int n, int k, int team, void* stream) {
  return dk::launch_chol_solve<double>(L, rhs, out, B, n, k, team, stream);
}

}  // extern "C"
