// Dense building blocks shared by the kernels of this package: Cholesky / LDL'
// factorisations and triangular substitutions on a matrix held in shared
// memory, plus warp reductions. One thread block works on one problem
// instance: kThreads threads in K2 / K4 past their register tiles; a team of 1,
// 2 or 8 warps in K1, K2, K4, K6 and K7 (Team below), whose factorisation runs on
// the team's own thread grid (K2 and K4 pack two one-warp teams into a block).
//
// Two scopes: a factorisation has O(n^2) independent updates per step and is
// run by the whole team (one barrier per step), with the matrix in registers
// where it fits and in shared memory otherwise; a substitution on
// ONE right-hand side has O(n) independent updates per step, so it is run by
// one warp, in registers, and several right-hand sides go to several warps
// side by side (or up to four to a warp: csrc/tri_solve.cuh).
//
// Matrices in shared memory use an odd row stride (odd_stride) or are packed
// lower triangles (PackedRows), so that a warp walking down a column and a
// warp walking along a row both touch 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <type_traits>

namespace dk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Shared memory one block can use on sm_90 (227 KB); above 48 KB it must be
// dynamic and the kernel needs cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr size_t kMaxSmemBytes = 232448;
// Shared memory of one SM (228 KB), of which each resident block takes 1 KB for
// the system, and the SM's limits on resident blocks and warps.
constexpr size_t kSmSmemBytes = 233472, kBlockReservedSmem = 1024;
constexpr int kSmMaxBlocks = 32, kSmMaxWarps = 64;

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// The running kernel's dynamic shared memory: every kernel's extern __shared__
// array starts at the same address.
extern __shared__ __align__(16) unsigned char dk_smem[];

// A pointer into the dynamic shared memory held as an index into dk_smem: an
// access through it compiles to LDS / STS with a 32-bit address, where a
// generic pointer to the same word compiles to LD / ST with 64-bit address
// arithmetic -- which, on a chain whose every step waits on such a load, is
// most of the step.
template <typename T>
struct SPtr {
  int off;
  __device__ T& operator[](int i) const { return reinterpret_cast<T*>(dk_smem)[off + i]; }
  __device__ SPtr operator+(int k) const { return SPtr{off + k}; }
};

// Where row i of a matrix in memory starts, in words: rows ld words apart, or a
// packed lower triangle, row i at tri(i) (kDiag = 1: with the diagonal) or at
// tri(i) - i (kDiag = 0: the strict lower triangle). A walk down a column of a
// packed triangle, 32 consecutive rows, touches 32 distinct banks.
struct StridedRows {
  int ld;
  __host__ __device__ int operator()(int i) const { return i * ld; }
};
template <int kDiag>
struct PackedRows {
  __host__ __device__ int operator()(int i) const { return kDiag ? i * (i + 1) / 2 : i * (i - 1) / 2; }
};

// whether a pivot array was given (the substitutions' unit-diagonal case passes nullptr)
template <typename T>
__device__ inline bool given(const T* p) { return p != nullptr; }
template <typename T>
__device__ inline bool given(SPtr<T>) { return true; }

// NaN-propagating max / min (fmax / fmin drop a NaN operand; the reference's
// reductions keep it, and the solver's guards rely on that).
template <typename T>
__device__ inline T nan_max(T a, T b) { return (a > b || a != a) ? a : b; }
template <typename T>
__device__ inline T nan_min(T a, T b) { return (a < b || a != a) ? a : b; }

template <typename T>
__device__ inline T warp_sum(T a) {
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(kFullMask, a, o);
  return a;
}
template <typename T>
__device__ inline T warp_max(T a) {
  for (int o = 16; o > 0; o >>= 1) a = nan_max(a, __shfl_xor_sync(kFullMask, a, o));
  return a;
}
template <typename T>
__device__ inline T warp_min(T a) {
  for (int o = 16; o > 0; o >>= 1) a = nan_min(a, __shfl_xor_sync(kFullMask, a, o));
  return a;
}

// Right-looking unpivoted LDL' factorisation M = L D L' of the n x n matrix M
// (shared memory, row i at M + off(i): StridedRows or PackedRows), in place,
// reading and writing the lower triangle only. Called by every thread of the
// block; ends in __syncthreads. This is the route for any n; where the
// register tiles hold n, factor_grid below is the fast one.
//
// Step j subtracts M[i][j] M[k][j] / M[j][j] from every M[i][k], j < k <= i.
// Column j itself is left as it is (unscaled), so a step reads only what
// earlier steps finished and needs ONE block barrier. On return diag[j] = D[j]
// and the strict lower triangle holds L[i][j] D[j]: the caller divides column
// j by diag[j] where it reads L. A zero pivot gives NaN / inf entries (no
// trap, no hang).
template <typename T, typename Off>
__device__ void factor_lower(T* __restrict__ M, Off off, int n, T* __restrict__ diag) {
  constexpr int kUnroll = 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < n; ++j) {
    const T piv = M[off(j) + j];
    const T inv = T(1) / piv;
    if (tid == 0) diag[j] = piv;
    // one warp per row, lanes along it, kUnroll rows at a time so that their
    // load - multiply-add - store chains overlap (a single chain leaves the
    // warp waiting on shared memory)
    for (int i0 = j + 1 + warp; i0 < n; i0 += kUnroll * kWarps) {
      T ci[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kWarps;
        ci[u] = i < n ? M[off(i) + j] * inv : T(0);
      }
      const int ilast = min(n - 1, i0 + (kUnroll - 1) * kWarps);
      for (int k = j + 1 + lane; k <= ilast; k += 32) {
        const T ck = M[off(k) + j];
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarps;
          v[u] = (i < n && k <= i) ? M[off(i) + k] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarps;
          if (i < n && k <= i) M[off(i) + k] = v[u] - ci[u] * ck;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ void factor_lower(T* __restrict__ M, int ld, int n, T* __restrict__ diag) {
  factor_lower(M, StridedRows{ld}, n, diag);
}

// ---- teams -------------------------------------------------------------------
//
// A team of TW warps that is a whole thread block: its barrier is the block's,
// or for one warp the cheaper __syncwarp (which orders the warp's shared-memory
// accesses as __syncthreads does the block's).
template <int TW>
struct Team {
  static_assert(TW == 1 || TW == 2 || TW == 8, "a team has 1, 2 or 8 warps");
  static constexpr int kWarps = TW, kThreads = 32 * TW;
  __device__ static void sync() {
    if constexpr (TW == 1) __syncwarp();
    else __syncthreads();
  }
  // p of any thread of the team, in every thread; a barrier
  __device__ static bool any(bool p) {
    if constexpr (TW == 1) return __any_sync(kFullMask, p) != 0;
    else return __syncthreads_or(p) != 0;
  }
};

// the team sizes the team kernels (K1, K4, K6, K7) are built for: four warps would hold
// the same 64 rows as two, and were slower than two at every layout of K6 timed
constexpr int kTeams[] = {1, 2, 8};

// f(std::integral_constant<int, TW>) for tw in {1, 2, 8}
template <class F>
int with_team(int tw, F&& f) {
  switch (tw) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return int(cudaErrorInvalidValue);
  }
}

// A kernel's shared-memory attributes: room for smem bytes of dynamic shared
// memory, and the SM's split between L1 and shared memory all to shared
// memory, so that as many blocks are resident as their working sets allow.
template <class K>
cudaError_t smem_attributes(K* kernel, size_t smem) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              int(cudaSharedmemCarveoutMaxShared));
}

// ---- register-tiled factorisation --------------------------------------------
//
// factor_lower spends ten instructions on addresses and predicates for every
// multiply-add, and every operand comes from shared memory. Here the matrix
// lives in REGISTERS for the whole factorisation: the team's threads form a
// kY x kX grid (TileGrid below; 16 x 16 for a team of eight warps),
// thread (ty, tx) = (tid / kX, tid % kX) owns the entries (i, k) with
// i = ty + kY a, k = tx + kX b (a cyclic map, so the trailing matrix stays
// spread over all threads as it shrinks), a < RY, b < RX, kY RY = kX RX, of
// which it keeps the tiles that reach the lower triangle (b <= a on a square
// grid). Step j: the threads that own column j put it (unscaled) into a buffer
// in shared memory, one team barrier, then every thread reads the pivot, its
// RY row entries and its RX column entries and does about RY RX / 2
// multiply-adds without a branch (entries at or above row / column j enter as
// zeros). The buffer is double-buffered, so one barrier per step is enough.

// The thread grid of a team of TW warps, and the row counts its factorisation
// is instantiated for (kCovers: the rows kX RX a tile set holds, smallest
// first; the last is the most the team takes)
template <int TW> struct TileGrid;
template <> struct TileGrid<1> { static constexpr int kY = 4, kX = 8, kNumCovers = 2, kCovers[2] = {24, 40}; };
template <> struct TileGrid<2> { static constexpr int kY = 8, kX = 8, kNumCovers = 2, kCovers[2] = {32, 64}; };
template <> struct TileGrid<8> { static constexpr int kY = 16, kX = 16, kNumCovers = 3, kCovers[3] = {32, 64, 128}; };

// rows of K a team of TW warps factorises in registers, and the words of its
// double-buffered pivot column
__host__ __device__ constexpr int tile_max_n(int tw) { return tw == 1 ? 40 : (tw == 8 ? 128 : 64); }
__host__ __device__ constexpr int colbuf_words(int tw) { return 2 * tile_max_n(tw); }

// Calls f(std::integral_constant<int, RX>) with the smallest of
// TileGrid<TW>::kCovers that holds n rows (RX = cover / kX column tiles, RY =
// RX kX / kY row tiles); returns false (f not called) past the last.
template <int TW, int kIdx = 0, typename F>
__device__ inline bool dispatch_grid(int n, F&& f) {
  using G = TileGrid<TW>;
  if constexpr (kIdx >= G::kNumCovers) {
    return false;
  } else {
    constexpr int cover = G::kCovers[kIdx];
    static_assert(cover % G::kX == 0 && cover % G::kY == 0, "a cover is whole tiles in both directions");
    if (n <= cover) {
      f(std::integral_constant<int, cover / G::kX>{});
      return true;
    }
    return dispatch_grid<TW, kIdx + 1>(n, f);
  }
}

// Whether tile (a, b) of a kY x kX grid holds an entry on or below the diagonal
template <int kY, int kX>
__host__ __device__ constexpr bool tile_live(int a, int b) { return kY * a + kY - 1 >= kX * b; }

// Eliminates the n x n symmetric matrix held in the tiles t of a team of TW
// warps (entries outside n x n must be zero): on return diag[j] = pivot j and
// column j of t holds L[i][j] * pivot j (LDL' with the column scaling left to
// the caller, as in factor_lower; store_chol_grid turns it into a Cholesky
// factor). colbuf: 2 max(tile_max_n(TW), kY RY) words of shared memory
// (colbuf_words(TW) where the tiles hold at most tile_max_n(TW) rows); diag
// and colbuf are plain pointers or SPtr. Called by every thread of the team;
// ends in the team's barrier. The update of entry (i, k) at step j is the
// same operation for every team and tile set, in the same order of j, so
// every team gives the same bits.
//
// A rectangular tile set (kY RY > kX RX) holds rows below the square: rows n
// and on of t are then eliminated by the same n column steps, so that a block
// B stacked under the matrix, [M; B], leaves as B L'^-1 with column j times
// pivot j (the forward substitution of B' against L, its products subtracted
// in the same order of columns).
template <typename T, int TW, int RY, int RX, typename P>
__device__ void factor_grid(T (&t)[RY][RX], int n, P diag, P colbuf) {
  constexpr int kY = TileGrid<TW>::kY, kX = TileGrid<TW>::kX;
  constexpr int kHalf = kY * RY > tile_max_n(TW) ? kY * RY : tile_max_n(TW);
  static_assert(kY * RY >= kX * RX, "the tiles cover at least as many rows as columns");
  const int tx = threadIdx.x % kX, ty = threadIdx.x / kX;
#pragma unroll
  for (int bj = 0; bj < RX; ++bj) {
    const int amin = kX * bj / kY;  // row tiles below it hold rows < kX bj only
    const int jend = min(kX, n - kX * bj);
    for (int jl = 0; jl < jend; ++jl) {
      const int j = kX * bj + jl;
      const P buf = colbuf + (j & 1) * kHalf;
      if (tx == jl) {
#pragma unroll
        for (int a = 0; a < RY; ++a)
          if (a >= amin && tile_live<kY, kX>(a, bj)) buf[ty + kY * a] = t[a][bj];
      }
      Team<TW>::sync();
      const T piv = buf[j];
      const T inv = T(1) / piv;
      if (threadIdx.x == 0) diag[j] = piv;
      // rows and columns at or above j enter as zeros; a tile wholly below (right of) column block bj
      // needs no test
      T ci[RY], ck[RX];
#pragma unroll
      for (int a = 0; a < RY; ++a) {
        const int i = ty + kY * a;
        ci[a] = (a >= amin && (kY * a >= kX * (bj + 1) || i > j)) ? buf[i] * inv : T(0);
      }
#pragma unroll
      for (int b = 0; b < RX; ++b) {
        const int k = tx + kX * b;
        ck[b] = (b > bj || (b == bj && k > j)) ? buf[k] : T(0);
      }
#pragma unroll
      for (int a = 0; a < RY; ++a)
#pragma unroll
        for (int b = 0; b < RX; ++b)
          if (a >= amin && b >= bj && tile_live<kY, kX>(a, b)) t[a][b] -= ci[a] * ck[b];
    }
  }
  Team<TW>::sync();
}

// Writes the Cholesky factor out of factor_grid's result on a team of TW
// warps: rows i < rows of M (shared, row stride ld) get L[i][k] for k < n,
// k <= i (rows past n: the block stacked under the matrix, scaled the same
// way), and diag[j] becomes 1 / L[j][j]. Ends in the team's barrier.
template <typename T, int TW, int RY, int RX, typename P>
__device__ void store_chol_grid(const T (&t)[RY][RX], int n, int rows, P M, int ld, P diag) {
  constexpr int kY = TileGrid<TW>::kY, kX = TileGrid<TW>::kX;
  const int tx = threadIdx.x % kX, ty = threadIdx.x / kX;
  T rk[RX];
#pragma unroll
  for (int b = 0; b < RX; ++b) {
    const int k = tx + kX * b;
    rk[b] = k < n ? rsqrt(diag[k]) : T(0);
  }
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      if (!tile_live<kY, kX>(a, b)) continue;
      const int i = ty + kY * a, k = tx + kX * b;
      if (i < rows && k < n && k <= i) M[i * ld + k] = t[a][b] * rk[b];
    }
  Team<TW>::sync();  // every thread has read the pivots
  for (int j = threadIdx.x; j < n; j += Team<TW>::kThreads) diag[j] = rsqrt(diag[j]);
  Team<TW>::sync();
}

// The substitutions below are called by the 32 lanes of one warp on C
// right-hand sides held in registers (lane l holds entry r * 32 + l of
// column c in x[c][r], kRows register rows: n <= 32 kRows). Row i of L starts
// at word off(i) of L (StridedRows or PackedRows, above). How the pivot entry j is treated when it is read:
//   a pointer or SPtr piv  -- every lane multiplies the shuffled x[j] by
//                             piv[j], and the owning lane keeps the product;
//   LanePivots             -- the owning lane multiplies x[j] by its own
//                             register copy of the pivot before the shuffle;
//   nullptr                -- unit diagonal.
// Either way x[j] becomes x[j] * pivot j by one multiplication, so the forms
// give the same bits.
//
// A step of a substitution is a handful of operations that depend on the step
// before, so what it costs is the latency of that chain. x therefore lives in
// registers for the whole sweep and the pivot entry travels by shuffle: the
// chain is one shuffle and one multiply-add per step, and the loads of L do
// not depend on it. Going through shared memory instead (store, warp barrier,
// load) costs ten times as much per step.
//
// The forward sweep walks L's columns in groups of kGroupCols and calls
// arrive(g) before the first column of group g, so that a caller whose L is
// still arriving (csrc/tri_solve.cuh) waits for each group as it needs it.

template <typename T, int kRows>
struct LanePivots {
  T v[kRows];  // pivot of row 32 r + lane
};
struct NoArrive {
  __device__ void operator()(int) const {}
};

template <typename T, int kRows, typename PP>
__device__ __forceinline__ T pivot_read(T (&xc)[kRows], int rj, int j, int jl, int lane, const PP& piv) {
  if constexpr (std::is_same_v<PP, LanePivots<T, kRows>>) {
    if (lane == jl) xc[rj] *= piv.v[rj];
    return __shfl_sync(kFullMask, xc[rj], jl);
  } else if constexpr (std::is_same_v<PP, std::nullptr_t>) {
    return __shfl_sync(kFullMask, xc[rj], jl);
  } else {
    T y = __shfl_sync(kFullMask, xc[rj], jl);
    if (given(piv)) {
      y *= piv[j];
      if (lane == jl) xc[rj] = y;
    }
    return y;
  }
}

// x <- L^-1 x (column-oriented) on C right-hand sides in registers
template <typename T, int kRows, int C, int kGroupCols, typename PL, typename Off, typename PP, typename Arrive>
__device__ __forceinline__ void warp_forward_sub_regs(PL L, Off off, int n, T (&x)[C][kRows], const PP& piv,
                                                      Arrive&& arrive, int lane) {
  static_assert(32 % kGroupCols == 0, "groups of columns tile a register row");
  constexpr bool kStrided = std::is_same_v<Off, StridedRows>;
  int ro[kRows];  // where this lane's rows start (a packed triangle's offsets, computed once)
#pragma unroll
  for (int r = 0; r < kRows; ++r) ro[r] = kStrided ? 0 : off(r * 32 + lane);
#pragma unroll
  for (int rj = 0; rj < kRows; ++rj) {
#pragma unroll
    for (int q = 0; q < 32 / kGroupCols; ++q) {
      const int j0 = rj * 32 + q * kGroupCols;
      if (j0 >= n) break;
      arrive(j0 / kGroupCols);
      const int jend = min(kGroupCols, n - j0);
#pragma unroll 4
      for (int jj = 0; jj < jend; ++jj) {
        const int jl = q * kGroupCols + jj, j = j0 + jj;
        T y[C];
#pragma unroll
        for (int c = 0; c < C; ++c) y[c] = pivot_read(x[c], rj, j, jl, lane, piv);
#pragma unroll
        for (int r = rj; r < kRows; ++r) {
          const int i = r * 32 + lane;
          if (i > j && i < n) {
            const T l = L[(kStrided ? off(i) : ro[r]) + j];
#pragma unroll
            for (int c = 0; c < C; ++c) x[c][r] -= l * y[c];
          }
        }
      }
    }
  }
}

// x <- L'^-1 x (reading row j of L at step j) on C right-hand sides in registers
template <typename T, int kRows, int C, typename PL, typename Off, typename PP>
__device__ __forceinline__ void warp_backward_sub_regs(PL L, Off off, int n, T (&x)[C][kRows], const PP& piv, int lane) {
#pragma unroll
  for (int rj = kRows - 1; rj >= 0; --rj) {
    const int jend = min(32, n - rj * 32);
#pragma unroll 4
    for (int jl = jend - 1; jl >= 0; --jl) {
      const int j = rj * 32 + jl, rowj = off(j);
      T y[C];
#pragma unroll
      for (int c = 0; c < C; ++c) y[c] = pivot_read(x[c], rj, j, jl, lane, piv);
#pragma unroll
      for (int r = 0; r <= rj; ++r) {
        const int i = r * 32 + lane;
        if (i < j) {
          const T l = L[rowj + i];
#pragma unroll
          for (int c = 0; c < C; ++c) x[c][r] -= l * y[c];
        }
      }
    }
  }
}

// The one-right-hand-side forms on a strided L (K1, K6 and K7): x <- L^-1 x
// and x <- L'^-1 x, lane l holding entry r * 32 + l in xr[r]. L and piv are
// plain pointers, SPtr or (unit diagonal) nullptr.
template <typename T, int kRows, typename PL, typename PP>
__device__ __forceinline__ void warp_forward_sub_regs(PL L, int ld, int n, T (&xr)[kRows], PP piv, int lane) {
  T x[1][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) x[0][r] = xr[r];
  warp_forward_sub_regs<T, kRows, 1, 32>(L, StridedRows{ld}, n, x, piv, NoArrive{}, lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r) xr[r] = x[0][r];
}

template <typename T, int kRows, typename PL, typename PP>
__device__ __forceinline__ void warp_backward_sub_regs(PL L, int ld, int n, T (&xr)[kRows], PP piv, int lane) {
  T x[1][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) x[0][r] = xr[r];
  warp_backward_sub_regs<T, kRows, 1>(L, StridedRows{ld}, n, x, piv, lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r) xr[r] = x[0][r];
}

}  // namespace dk
