// The batched solve with a factor's lower triangle, shared by the Cholesky
// solve (K5, csrc/chol.cu: L L' x = rhs) and the LDL' solve (K3, csrc/ldl.cu:
// L D L' x = rhs). The two differ only in the diagonal (the Diag policies
// below); the sweeps are dense.cuh's warp_forward_sub_regs /
// warp_backward_sub_regs.
//
// One warp per instance at k = 1, several instances packed into a block
// (blockDim = (32, 1, per_block)), or a team of warps of which one solves and
// the others help to copy L (blockDim = (32, tw)). For k > 1 one copy of L
// serves all the right-hand sides: a team of two warps (blockDim = (32, 2)) of
// which each holds up to four right-hand sides in registers at once; a warp
// left without a column only keeps the team's barriers. L's triangle reaches
// shared memory packed (dense.cuh, PackedRows) by asynchronous copies
// (cp.async) in kSolveChunks groups of columns, so the forward sweep, which
// needs columns <= j only, starts on the first group while the rest arrive.
// Both sweeps read L through SPtr (LDS, 32-bit addresses); the right-hand
// sides stay in registers from the load to the store.
#pragma once

#include "dense.cuh"
#include "prof.cuh"

namespace dk {

__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }

// asynchronous copies of one word from device to shared memory, in groups
template <int kBytes>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(kBytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most `pending` of the calling thread's groups are in flight
// (a constant wherever the loop around the call is unrolled)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
#define DK_CP_WAIT(N) \
  case N: asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); break;
    DK_CP_WAIT(0) DK_CP_WAIT(1) DK_CP_WAIT(2) DK_CP_WAIT(3) DK_CP_WAIT(4) DK_CP_WAIT(5) DK_CP_WAIT(6)
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
#undef DK_CP_WAIT
  }
}

constexpr int kSolveChunks = 8;     // groups of columns L arrives in
constexpr int kSolveMaxRows = 256;  // 32 lanes x 8 register rows
constexpr int kSolveMaxCols = 4;    // right-hand sides one warp holds at once

// The two diagonals. Cholesky: L's lower triangle with its diagonal, each
// pivot multiplied by 1 / L[j][j] as it is read. LDL': L's strict lower
// triangle (unit diagonal), and x divided by d between the sweeps.
struct CholDiag {
  static constexpr int kDiag = 1;
};
struct LdlDiag {
  static constexpr int kDiag = 0;
};

// words of one instance's packed triangle
template <class Diag>
__host__ __device__ inline int solve_words(int n) { return PackedRows<Diag::kDiag>{}(n); }

// columns one warp holds at once for k right-hand sides on tw warps: 1, 2 or 4
inline int solve_cols(int k, int tw) {
  const int c = (k + tw - 1) / tw;
  return c <= 1 ? 1 : (c <= 2 ? 2 : kSolveMaxCols);
}

// The team's barrier in the solve: a warp, or the block when the team is more than one warp
__device__ __forceinline__ void solve_sync() {
  if (blockDim.y > 1) __syncthreads();
  else __syncwarp();
}

// Solves L L' x = rhs (CholDiag) or L D L' x = rhs (LdlDiag; d: (B, n)) for
// one instance on a team of blockDim.y warps; each warp holds C right-hand
// sides at once (lane l: rows 32 r + l in x[c][r]), rounds of C blockDim.y
// columns where k is larger. kRows register rows hold n <= 32 kRows. Every
// launch does the same operations in the same order: the forward sweep
// subtracts column by column, the backward row by row of L, each Cholesky
// pivot is multiplied by 1 / L[j][j], and the LDL' solve divides by d[i].
template <typename T, int kRows, int C, class Diag>
__global__ void __launch_bounds__(256)
tri_solve_kernel(const T* __restrict__ Lin, const T* __restrict__ d, const T* __restrict__ rhs, T* __restrict__ out,
                 int B, int n, int k) {
  constexpr int kChunkCols = 4 * kRows;  // kSolveChunks chunks of columns cover 32 kRows
  static_assert(kChunkCols * kSolveChunks == 32 * kRows && 32 % kChunkCols == 0, "chunks tile the register rows");
  constexpr bool kChol = Diag::kDiag == 1;
  const int lane = threadIdx.x, warp = threadIdx.y, warps = blockDim.y;
  const int inst = blockIdx.x * blockDim.z + threadIdx.z;
  if (inst >= B) return;  // a whole warp: blocks of several instances hold one-warp teams only
  const SPtr<T> L{int(threadIdx.z) * solve_words<Diag>(n)};
  const PackedRows<Diag::kDiag> off{};
  const T* Lg = Lin + size_t(inst) * n * n;
  const T* rg = rhs + size_t(inst) * n * k;
  T* og = out + size_t(inst) * n * k;
  DK_PROF_START();

  // L's triangle, packed, by columns [kChunkCols c, kChunkCols (c + 1)) of rows >= that:
  // 32 / kChunkCols rows per warp instruction, the team's warps taking rows in turn
  const unsigned sL = unsigned(__cvta_generic_to_shared(dk_smem)) + unsigned(L.off) * sizeof(T);
  {
    const int dr = lane / kChunkCols, col_in = lane % kChunkCols, rstep = (32 / kChunkCols) * warps;
#pragma unroll
    for (int c = 0; c < kSolveChunks; ++c) {
      const int col = kChunkCols * c + col_in;
      for (int i = kChunkCols * c + dr + (32 / kChunkCols) * warp; i < n; i += rstep)
        if (col < i + Diag::kDiag) cp_async<sizeof(T)>(sL + unsigned(off(i) + col) * sizeof(T), Lg + size_t(i) * n + col);
      cp_async_commit();
    }
  }
  // the lane's pivots: 1 / L[i][i] (Cholesky) or d[i] (LDL')
  LanePivots<T, kRows> piv;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = 32 * r + lane;
    if constexpr (kChol) piv.v[r] = i < n ? T(1) / Lg[size_t(i) * n + i] : T(0);
    else piv.v[r] = i < n ? d[size_t(inst) * n + i] : T(1);
  }
  DK_PROF_AT(kProfCopy, solve_sync(), lane == 0 && warp == 0);

  const int rounds = (k + C * warps - 1) / (C * warps);
  for (int round = 0; round < rounds; ++round) {
    const int c0 = (round * warps + warp) * C;  // this warp's first column
    auto arrive = [&](int chunk) {
      if (round == 0) {
        cp_async_wait(kSolveChunks - 1 - chunk);
        solve_sync();
      }
    };
    if (c0 >= k) {  // no column for this warp this round: it only keeps the team's barriers
      for (int chunk = 0; chunk < (n + kChunkCols - 1) / kChunkCols; ++chunk) arrive(chunk);
      DK_PROF_AT(kProfWork, solve_sync(), false);
      DK_PROF_AT(kProfBack, solve_sync(), false);
      DK_PROF_AT(kProfOut, solve_sync(), false);
      continue;
    }
    T x[C][kRows];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = 32 * r + lane;
        x[c][r] = (i < n && c0 + c < k) ? rg[size_t(i) * k + c0 + c] : T(0);
      }

    // forward: x <- L^-1 x by columns, chunk by chunk as they arrive (waited for in the first round only)
    if constexpr (kChol) {
      warp_forward_sub_regs<T, kRows, C, kChunkCols>(L, off, n, x, piv, arrive, lane);
    } else {
      warp_forward_sub_regs<T, kRows, C, kChunkCols>(L, off, n, x, nullptr, arrive, lane);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int r = 0; r < kRows; ++r) x[c][r] = x[c][r] / piv.v[r];
    }
    DK_PROF_AT(kProfWork, solve_sync(), lane == 0 && warp == 0);

    // backward: x <- L'^-1 x, reading row j of L
    if constexpr (kChol) warp_backward_sub_regs<T, kRows, C>(L, off, n, x, piv, lane);
    else warp_backward_sub_regs<T, kRows, C>(L, off, n, x, nullptr, lane);
    DK_PROF_AT(kProfBack, solve_sync(), lane == 0 && warp == 0);

#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = 32 * r + lane;
        if (i < n && c0 + c < k) og[size_t(i) * k + c0 + c] = x[c][r];
      }
    DK_PROF_AT(kProfOut, solve_sync(), lane == 0 && warp == 0);
  }
  if (lane == 0 && warp == 0) DK_PROF_ADD(kProfInstances, 1);
}

// f(kernel, block) with the solve's instantiation for (n, k) on teams of tw warps, per instances per block
template <typename T, class Diag, class F>
int with_solve_kernel(int n, int k, int tw, int per, F&& f) {
  const dim3 block(32, tw, per);
  auto by_cols = [&](auto rows) {
    constexpr int R = decltype(rows)::value;
    switch (solve_cols(k, tw)) {
      case 1: return f(tri_solve_kernel<T, R, 1, Diag>, block);
      case 2: return f(tri_solve_kernel<T, R, 2, Diag>, block);
      default: return f(tri_solve_kernel<T, R, kSolveMaxCols, Diag>, block);
    }
  };
  if (n <= 32) return by_cols(std::integral_constant<int, 1>{});
  if (n <= 64) return by_cols(std::integral_constant<int, 2>{});
  if (n <= 128) return by_cols(std::integral_constant<int, 4>{});
  return by_cols(std::integral_constant<int, 8>{});
}

}  // namespace dk
