// Dense building blocks shared by the kernels of this package: Cholesky / LDL'
// factorisations and triangular substitutions on a matrix held in shared
// memory, plus warp reductions. One thread block (kThreads threads) works on
// one problem instance.
//
// Two scopes: a factorisation has O(n^2) independent updates per step and is
// run by the whole block (one block barrier per step), with the matrix in
// registers where it fits (n <= 128) and in shared memory otherwise; a
// substitution on ONE
// right-hand side has O(n) independent updates per step, so it is run by one
// warp, in registers, and several right-hand sides go to several warps side by
// side.
//
// Matrices in shared memory use an odd row stride (odd_stride), so that a warp
// walking down a column and a warp walking along a row both touch 32 distinct
// banks.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace dk {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Shared memory one block can use on sm_90 (227 KB); above 48 KB it must be
// dynamic and the kernel needs cudaFuncAttributeMaxDynamicSharedMemorySize.
constexpr size_t kMaxSmemBytes = 232448;

__host__ __device__ inline int odd_stride(int n) { return n | 1; }

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

// Dot product of two length-len vectors by one warp; every lane gets the sum.
template <typename T>
__device__ inline T warp_dot(const T* __restrict__ a, const T* __restrict__ b, int len, int lane) {
  T acc = T(0);
  for (int i = lane; i < len; i += 32) acc += a[i] * b[i];
  return warp_sum(acc);
}

// Right-looking unpivoted LDL' factorisation M = L D L' of the n x n matrix M
// (shared memory, row stride ld), in place, reading and writing the lower
// triangle only. Called by every thread of the block; ends in __syncthreads.
// This is the route for any n; up to n = 128 the register-tiled factor_tile
// below is the fast one.
//
// Step j subtracts M[i][j] M[k][j] / M[j][j] from every M[i][k], j < k <= i.
// Column j itself is left as it is (unscaled), so a step reads only what
// earlier steps finished and needs ONE block barrier. On return diag[j] = D[j]
// and the strict lower triangle holds L[i][j] D[j]: the caller divides column
// j by diag[j] where it reads L. A zero pivot gives NaN / inf entries (no
// trap, no hang).
template <typename T>
__device__ void factor_lower(T* __restrict__ M, int ld, int n, T* __restrict__ diag) {
  constexpr int kUnroll = 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < n; ++j) {
    const T piv = M[j * ld + j];
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
        ci[u] = i < n ? M[i * ld + j] * inv : T(0);
      }
      const int ilast = min(n - 1, i0 + (kUnroll - 1) * kWarps);
      for (int k = j + 1 + lane; k <= ilast; k += 32) {
        const T ck = M[k * ld + j];
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarps;
          v[u] = (i < n && k <= i) ? M[i * ld + k] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kWarps;
          if (i < n && k <= i) M[i * ld + k] = v[u] - ci[u] * ck;
        }
      }
    }
    __syncthreads();
  }
}

// ---- register-tiled factorisation --------------------------------------------
//
// factor_lower spends ten instructions on addresses and predicates for every
// multiply-add, and every operand comes from shared memory. Here the matrix
// lives in REGISTERS for the whole factorisation: the block's 256 threads form
// a 16 x 16 grid, thread (ty, tx) owns the entries (i, k) with i = ty + 16 a,
// k = tx + 16 b (a cyclic map, so the trailing matrix stays spread over all
// threads as it shrinks), a, b < kRows, of which it keeps the tiles b <= a.
// Step j: the threads that own column j put it (unscaled) into a buffer in
// shared memory, one block barrier, then every thread reads the pivot, its
// kRows row entries and its kRows column entries and does kRows^2 / 2
// multiply-adds without a branch (entries at or above row / column j enter
// as zeros). The buffer is double-buffered, so one barrier per step is enough.

constexpr int kTileGrid = 16;
static_assert(kTileGrid * kTileGrid == kThreads, "the tile map needs a 16 x 16 thread grid");
constexpr int kMaxTileRows = 8;                                 // n <= 128
constexpr int kColbufWords = 2 * kTileGrid * kMaxTileRows;      // double-buffered pivot column

// Calls f(std::integral_constant<int, kRows>) with the smallest kRows in
// {2, 4, 8} that holds n rows; returns false (f not called) for n > 128.
template <typename F>
__device__ inline bool dispatch_tile(int n, F&& f) {
  if (n <= 2 * kTileGrid) f(std::integral_constant<int, 2>{});
  else if (n <= 4 * kTileGrid) f(std::integral_constant<int, 4>{});
  else if (n <= 8 * kTileGrid) f(std::integral_constant<int, 8>{});
  else return false;
  return true;
}

// Eliminates the n x n symmetric matrix held in the tiles t (entries outside
// n x n must be zero): on return diag[j] = pivot j and column j of t holds
// L[i][j] * pivot j (LDL' with the column scaling left to the caller, as in
// factor_lower; store_chol_tile turns it into a Cholesky factor). colbuf:
// kColbufWords of shared memory. Called by every thread of the block; ends in
// __syncthreads.
template <typename T, int kRows>
__device__ void factor_tile(T (&t)[kRows][kRows], int n, T* __restrict__ diag, T* __restrict__ colbuf) {
  const int tx = threadIdx.x & (kTileGrid - 1), ty = threadIdx.x / kTileGrid;
#pragma unroll
  for (int bj = 0; bj < kRows; ++bj) {
    const int jend = min(kTileGrid, n - kTileGrid * bj);
    for (int jl = 0; jl < jend; ++jl) {
      const int j = kTileGrid * bj + jl;
      T* buf = colbuf + (j & 1) * (kTileGrid * kMaxTileRows);
      if (tx == jl) {
#pragma unroll
        for (int a = bj; a < kRows; ++a) buf[ty + kTileGrid * a] = t[a][bj];
      }
      __syncthreads();
      const T piv = buf[j];
      const T inv = T(1) / piv;
      if (threadIdx.x == 0) diag[j] = piv;
      T ci[kRows], ck[kRows];
#pragma unroll
      for (int a = bj; a < kRows; ++a) {
        const int i = ty + kTileGrid * a;
        ci[a] = i > j ? buf[i] * inv : T(0);
      }
#pragma unroll
      for (int b = bj; b < kRows; ++b) {
        const int k = tx + kTileGrid * b;
        ck[b] = k > j ? buf[k] : T(0);
      }
#pragma unroll
      for (int a = bj; a < kRows; ++a)
#pragma unroll
        for (int b = bj; b <= a; ++b) t[a][b] -= ci[a] * ck[b];
    }
  }
  __syncthreads();
}

// Writes the Cholesky factor out of factor_tile's result: the lower triangle of
// M (shared, row stride ld) gets L, diag[j] becomes 1 / L[j][j]. Ends in
// __syncthreads.
template <typename T, int kRows>
__device__ void store_chol_tile(const T (&t)[kRows][kRows], int n, T* __restrict__ M, int ld,
                                T* __restrict__ diag) {
  const int tx = threadIdx.x & (kTileGrid - 1), ty = threadIdx.x / kTileGrid;
  T rk[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    const int k = tx + kTileGrid * b;
    rk[b] = k < n ? rsqrt(diag[k]) : T(0);
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      if (i < n && k <= i) M[i * ld + k] = t[a][b] * rk[b];
    }
  __syncthreads();  // every thread has read the pivots
  for (int j = threadIdx.x; j < n; j += kThreads) diag[j] = rsqrt(diag[j]);
  __syncthreads();
}

// The substitutions below work on one right-hand side x whose entries lie xs
// words apart (a column of a row-major n x k block: xs = its row stride), and
// are called by the 32 lanes of one warp; they end in __syncwarp. piv[j]
// multiplies entry j when it is read as the pivot (nullptr: unit diagonal).
//
// A step of a substitution is a handful of operations that depend on the step
// before, so what it costs is the latency of that chain. x therefore lives in
// registers for the whole sweep (lane l holds entries l, l + 32, ..., kRows of
// them) and the pivot entry travels by shuffle: the chain is one shuffle and
// one multiply-add per step, and the loads of L do not depend on it. Going
// through shared memory instead (store, warp barrier, load) costs ten times
// as much per step.

// x <- L^-1 x for n <= 32 kRows, column-oriented.
template <typename T, int kRows>
__device__ __noinline__ void warp_forward_sub_rows(const T* __restrict__ L, int ld, int n, T* x, int xs,
                                                   const T* __restrict__ piv, int lane) {
  T xr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * 32 + lane;
    xr[r] = i < n ? x[i * xs] : T(0);
  }
#pragma unroll
  for (int rj = 0; rj < kRows; ++rj) {
    const int jend = min(32, n - rj * 32);
#pragma unroll 4
    for (int jl = 0; jl < jend; ++jl) {
      const int j = rj * 32 + jl;
      T yj = __shfl_sync(kFullMask, xr[rj], jl);
      if (piv) {
        yj *= piv[j];
        if (lane == jl) xr[rj] = yj;
      }
#pragma unroll
      for (int r = rj; r < kRows; ++r) {
        const int i = r * 32 + lane;
        if (i > j && i < n) xr[r] -= L[i * ld + j] * yj;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * 32 + lane;
    if (i < n) x[i * xs] = xr[r];
  }
  __syncwarp();
}

// x <- L'^-1 x for n <= 32 kRows.
template <typename T, int kRows>
__device__ __noinline__ void warp_backward_sub_rows(const T* __restrict__ L, int ld, int n, T* x, int xs,
                                                    const T* __restrict__ piv, int lane) {
  T xr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * 32 + lane;
    xr[r] = i < n ? x[i * xs] : T(0);
  }
#pragma unroll
  for (int rj = kRows - 1; rj >= 0; --rj) {
    const int jend = min(32, n - rj * 32);
#pragma unroll 4
    for (int jl = jend - 1; jl >= 0; --jl) {
      const int j = rj * 32 + jl;
      T xj = __shfl_sync(kFullMask, xr[rj], jl);
      if (piv) {
        xj *= piv[j];
        if (lane == jl) xr[rj] = xj;
      }
#pragma unroll
      for (int r = 0; r <= rj; ++r) {
        const int i = r * 32 + lane;
        if (i < j) xr[r] -= L[j * ld + i] * xj;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * 32 + lane;
    if (i < n) x[i * xs] = xr[r];
  }
  __syncwarp();
}

constexpr int kMaxSubstitutionRows = 256;  // 32 lanes x 8 register entries

template <typename T>
__device__ inline void warp_forward_sub(const T* L, int ld, int n, T* x, int xs, const T* piv, int lane) {
  if (n <= 64) warp_forward_sub_rows<T, 2>(L, ld, n, x, xs, piv, lane);
  else if (n <= 128) warp_forward_sub_rows<T, 4>(L, ld, n, x, xs, piv, lane);
  else warp_forward_sub_rows<T, 8>(L, ld, n, x, xs, piv, lane);
}

template <typename T>
__device__ inline void warp_backward_sub(const T* L, int ld, int n, T* x, int xs, const T* piv, int lane) {
  if (n <= 64) warp_backward_sub_rows<T, 2>(L, ld, n, x, xs, piv, lane);
  else if (n <= 128) warp_backward_sub_rows<T, 4>(L, ld, n, x, xs, piv, lane);
  else warp_backward_sub_rows<T, 8>(L, ld, n, x, xs, piv, lane);
}

// x <- (L L')^-1 x with a Cholesky factor from store_chol_tile (inv_diag = its diag).
template <typename T>
__device__ void warp_chol_solve(const T* L, int ld, int n, T* x, int xs, const T* inv_diag, int lane) {
  warp_forward_sub(L, ld, n, x, xs, inv_diag, lane);
  warp_backward_sub(L, ld, n, x, xs, inv_diag, lane);
}

}  // namespace dk
