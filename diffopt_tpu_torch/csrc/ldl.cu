// Batched unpivoted LDL' factor (K2) and solve (K3) for symmetric
// quasi-definite matrices: one instance per team of warps, or one per warp
// with several warps packed into a block, sized by N.
//
// Replaces diffopt_tpu/ops/pallas/chol.py::ldl_batched (_ldl_kernel) and
// ::ldl_solve_batched (_ldl_solve_kernel). The TPU kernels put the batch along
// the 128 lanes and walk the matrix in (N, N, B) layout; here the batch is the
// grid and the matrix stays in its natural (B, N, N) row-major layout.
//
// Bound on an H100: device-memory bytes. The factor needs the lower triangle
// of K, N (N + 1) / 2 words, and writes L in full (its upper triangle zeroed)
// and d, N^2 + N words, per instance for N^3 / 3 flops (N = 112, f32: 75 KB
// against 0.47 MFLOP, 160 bytes per kflop -- far on the memory side of the
// card's 67 TFLOP/s : 3.35 TB/s); the solve needs the strict lower triangle of
// L, d and the right-hand sides, N (N - 1) / 2 + N + N k words, and writes
// N k words for 2 N^2 k flops. Both read only what they need. What stands
// between them and that bound is the sequential structure: N elimination
// steps with a team barrier each in the factor, 2 N substitution steps in the
// solve, and in the solve the copy of L into shared memory; so an instance
// gets the threads that serve it best, and an SM holds as many instances as
// fit, each one's chain overlapping the others' (PERF.md has the times):
//
// Factor. The matrix lives in the registers of a team of 1, 2 or 8 warps
// (dense.cuh: Team, TileGrid, factor_grid, the register-tiled elimination of
// K1, K4 and K6), one team per instance, one instantiation per (type, team,
// cover) with its own launch bounds (LdlCovers, ldl_factor_min_blocks); the
// launch rule ldl_team takes the smallest team whose tiles hold N
// (ldl_tile_max_n): one warp to 40 rows (two such teams to a block), two warps
// to 128 rows in f32 and 64 in f64, eight warps to 176 rows in f32 and 128 in
// f64. Fewer threads to an instance means fewer instructions per elimination
// step for the same multiply-adds (the column loads, selects and reciprocal
// of a step are paid by every thread), and the SM's issue rate is what the
// elimination runs into: at N = 112 two-warp teams, six to an SM, beat
// eight-warp teams, three to an SM, by a quarter; at N = 172 eight warps in
// registers beat the packed shared-memory route fourfold. Past the register
// tiles one block of eight warps holds the packed lower triangle in shared
// memory, N (N + 1) / 2 + N words, copied in by cp.async and eliminated by
// factor_lower on PackedRows. L is written out with its upper triangle zeroed.
//
// Solve (csrc/tri_solve.cuh, shared with the Cholesky solve K5): one warp
// solves an instance at k = 1, with L's strict lower triangle arriving packed
// in shared memory by cp.async in eight groups of columns overlapped with the
// forward sweep; the right-hand side stays in registers, and x is divided by
// d between the sweeps. One warp's copies go out slowly (about 150 cycles
// apart), so past 64 rows other warps of the instance's team help to copy
// (ldl_solve_team: four warps to 128 rows, eight past that); up to 64 rows
// one-warp instances are packed four, two or one to a block (ldl_per_block).
// For k > 1 a team of two warps shares one copy of L.
//
// Every launch does the operations of the kernels before this design in
// their order: at step j entry (i, k) becomes K[i][k] - (K[i][j] (1 / K[j][j]))
// K[k][j], one multiply and one fused multiply-add, on every team and both
// routes, and the sweeps subtract in the same order; so every team and route
// gives the same bits.
//
// Envelope: pinned at N <= 239 (f32) / 169 (f64), where the shared-memory
// layout of the kernels before this design ended (ldl_max_n), because
// ops/kkt.py chooses LDL' against LU by it; both kernels take every N up to it.
#include "dense.cuh"
#include "prof.cuh"
#include "tri_solve.cuh"

namespace dk {

// ---- the launch rule (mirrored by ops/cuda/chol.py) ----------------------------

__host__ __device__ constexpr int ldl_max_n(int itemsize) { return itemsize == 4 ? 239 : 169; }

// The row counts each (type, team) factorises in registers (the covers of its
// tile sets, smallest first; the last is the most it takes). Two warps hold
// up to 128 rows in f32 (up to 136 live entries a thread) and 64 in f64;
// eight warps 176 in f32 (66 a thread) and 128 in f64.
template <typename T, int TW> struct LdlCovers;
template <typename T> struct LdlCovers<T, 1> { static constexpr int kNum = 2, kCovers[2] = {24, 40}; };
template <> struct LdlCovers<float, 2> { static constexpr int kNum = 4, kCovers[4] = {32, 64, 112, 128}; };
template <> struct LdlCovers<double, 2> { static constexpr int kNum = 2, kCovers[2] = {32, 64}; };
template <> struct LdlCovers<float, 8> { static constexpr int kNum = 5, kCovers[5] = {32, 64, 112, 128, 176}; };
template <> struct LdlCovers<double, 8> { static constexpr int kNum = 4, kCovers[4] = {32, 64, 112, 128}; };

// rows a team of tw warps factorises in registers
__host__ __device__ constexpr int ldl_tile_max_n(int tw, int itemsize) {
  return tw == 1 ? 40 : (tw == 2 ? (itemsize == 4 ? 128 : 64) : (itemsize == 4 ? 176 : 128));
}
// past this the factor's shared-memory route
__host__ __device__ constexpr int ldl_reg_rows(int itemsize) { return ldl_tile_max_n(8, itemsize); }

// shared-memory words of one instance: the factor's pivots and the team's
// double-buffered pivot column (registers), or the packed lower triangle and
// the pivots (shared-memory route); the solve's packed strict lower triangle
__host__ __device__ inline int ldl_factor_words(int N, int tw, int itemsize) {
  return N <= ldl_reg_rows(itemsize) ? N + 2 * ldl_tile_max_n(tw, itemsize) : tri(N) + N;
}

// instances per block: two one-warp factor teams; one-warp solve instances
// four, two or one to a block, whichever puts the most on an SM by shared
// memory (the larger count on a tie: at N = 172 in f32 one to a block holds
// three on an SM where two to a block hold two); a team of two warps alone
inline int ldl_per_block(int N, int k, int itemsize, int tw) {
  if (k == 0) return tw == 1 ? 2 : 1;
  if (tw != 1) return 1;
  const size_t one = size_t(solve_words<LdlDiag>(N)) * itemsize;
  int best = 1, most = 0;
  for (int per = 4; per >= 1; per >>= 1) {
    if (per * one > kMaxSmemBytes) continue;
    int blocks = int(kSmSmemBytes / (per * one + kBlockReservedSmem));
    blocks = blocks < kSmMaxBlocks ? blocks : kSmMaxBlocks;
    const int resident = blocks * per < kSmMaxWarps ? blocks * per : kSmMaxWarps;
    if (resident > most) best = per, most = resident;
  }
  return best;
}

inline size_t ldl_smem_bytes_of(int N, int k, int itemsize, int tw) {
  const int words = k == 0 ? ldl_factor_words(N, tw, itemsize) : solve_words<LdlDiag>(N);
  return size_t(ldl_per_block(N, k, itemsize, tw)) * words * size_t(itemsize);
}

// Whether teams of tw warps take the shape (k = 0: the factor): N within the
// envelope; the factor on a team whose register tiles hold N, and on eight
// warps past 128 rows; the solve on one warp at k = 1 and two for k > 1;
// everything in one block's shared memory.
inline bool ldl_team_takes(int N, int k, int itemsize, int tw) {
  if (N < 1 || k < 0 || N > ldl_max_n(itemsize)) return false;
  if (k == 0) {
    if (!(tw == 1 || tw == 2 || tw == 8)) return false;
    if (N > ldl_tile_max_n(tw, itemsize) && !(tw == 8 && N > ldl_reg_rows(itemsize))) return false;
  } else if ((k == 1 ? !(tw == 1 || tw == 2 || tw == 4 || tw == 8) : tw != 2) || N > kSolveMaxRows) {
    return false;
  }
  return ldl_smem_bytes_of(N, k, itemsize, tw) <= kMaxSmemBytes;
}

// The solve's team at k = 1: one warp solves, and past 64 rows the others
// help to copy L, whose copy by one warp alone outlasts both sweeps at N = 112
// (the fastest team measured at N = 24, 64, 100, 112 and 172: PERF.md)
__host__ __device__ constexpr int ldl_solve_team(int N) { return N <= 64 ? 1 : (N <= 128 ? 4 : 8); }

// The launch rule: the factor's smallest team that takes N, the solve's team
// for N at k = 1 and two warps for k > 1; 0 where none takes the shape.
inline int ldl_team(int N, int k, int itemsize) {
  if (k == 0) {
    for (int tw : kTeams)
      if (ldl_team_takes(N, 0, itemsize, tw)) return tw;
    return 0;
  }
  const int tw = k > 1 ? 2 : ldl_solve_team(N);
  return ldl_team_takes(N, k, itemsize, tw) ? tw : 0;
}

// ---- factor ------------------------------------------------------------------

// Registers the launch bounds allow a thread of each factor instantiation:
// resident blocks per SM at least (f32 / f64), so that the tiles fit without
// spilling at the sizes each instantiation serves.
__host__ __device__ constexpr int ldl_factor_min_blocks(int itemsize, int tw, int rx) {
  return tw == 1 ? (rx <= 3 ? (itemsize == 4 ? 24 : 16) : (itemsize == 4 ? 12 : 6))  // blocks of two warps
       : tw == 2 ? (rx <= 4 ? (itemsize == 4 ? 16 : 8) : rx <= 8 ? (itemsize == 4 ? 8 : 4) : (rx <= 14 ? 6 : 5))
                 : (rx <= 2 ? 4 : (rx <= 4 ? 2 : (itemsize == 4 ? (rx <= 8 ? 3 : 2) : (rx <= 7 ? 2 : 1))));
}

// One instance per team of TW warps (threadIdx.x), two teams per block for
// TW = 1 (threadIdx.y), the matrix in the team's register tiles of RX column
// tiles: global memory -> registers -> global.
template <typename T, int TW, int RX>
__global__ void __launch_bounds__(32 * TW * (TW == 1 ? 2 : 1), ldl_factor_min_blocks(sizeof(T), TW, RX))
ldl_factor_team_kernel(const T* __restrict__ K, T* __restrict__ Lout, T* __restrict__ dout, int B, int N) {
  using G = TileGrid<TW>;
  constexpr int kY = G::kY, kX = G::kX, RY = RX * kX / kY;
  const int inst = blockIdx.x * blockDim.y + threadIdx.y;
  if (inst >= B) return;  // a whole team: blocks of several teams hold one-warp teams only
  const int base = threadIdx.y * ldl_factor_words(N, TW, sizeof(T));
  const SPtr<T> diag{base}, colbuf{base + N};
  const int tx = threadIdx.x % kX, ty = threadIdx.x / kX;
  const T* Kg = K + size_t(inst) * N * N;
  T* Lg = Lout + size_t(inst) * N * N;
  DK_PROF_START();
  // the lower triangle of K only; entries outside it and past N enter as zeros
  T t[RY][RX];
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int i = ty + kY * a, k = tx + kX * b;
      t[a][b] = (tile_live<kY, kX>(a, b) && i < N && k <= i) ? Kg[size_t(i) * N + k] : T(0);
    }
  DK_PROF_AT(kProfCopy, Team<TW>::sync(), threadIdx.x == 0);
  factor_grid<T, TW, RY, RX>(t, N, diag, colbuf);
  DK_PROF_AT(kProfWork, Team<TW>::sync(), threadIdx.x == 0);
  // unit-lower L (column k of t still carries D[k]) with the upper triangle zeroed, and d
  T dk[RX];
#pragma unroll
  for (int b = 0; b < RX; ++b) {
    const int k = tx + kX * b;
    dk[b] = k < N ? diag[k] : T(1);
  }
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int i = ty + kY * a, k = tx + kX * b;
      if (i < N && k < N) {
        T v = k == i ? T(1) : T(0);
        if (tile_live<kY, kX>(a, b) && k < i) v = t[a][b] / dk[b];
        Lg[size_t(i) * N + k] = v;
      }
    }
  for (int i = threadIdx.x; i < N; i += Team<TW>::kThreads) dout[size_t(inst) * N + i] = diag[i];
  DK_PROF_AT(kProfOut, Team<TW>::sync(), threadIdx.x == 0);
  if (threadIdx.x == 0) DK_PROF_ADD(kProfInstances, 1);
}

// Past 128 rows: one block of eight warps per instance, the packed lower
// triangle in shared memory (row i at tri(i)), then the pivots.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 3 : 1)
ldl_factor_smem_kernel(const T* __restrict__ K, T* __restrict__ Lout, T* __restrict__ dout, int /*B: one block each*/,
                       int N) {
  const PackedRows<1> off{};
  T* M = reinterpret_cast<T*>(dk_smem);
  T* dvec = M + tri(N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Kg = K + size_t(blockIdx.x) * N * N;
  T* Lg = Lout + size_t(blockIdx.x) * N * N;
  DK_PROF_START();
  // lower triangle only, one warp per row, every copy in flight at once
  const unsigned sM = unsigned(__cvta_generic_to_shared(dk_smem));
  for (int i = warp; i < N; i += kWarps)
    for (int k = lane; k <= i; k += 32) cp_async<sizeof(T)>(sM + unsigned(off(i) + k) * sizeof(T), Kg + size_t(i) * N + k);
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  DK_PROF(kProfCopy);
  factor_lower<T>(M, off, N, dvec);
  DK_PROF(kProfWork);
  // unit-lower L (column k still carries D[k]) with the upper triangle zeroed, row by row
  for (int i = warp; i < N; i += kWarps)
    for (int k = lane; k < N; k += 32)
      Lg[size_t(i) * N + k] = k < i ? M[off(i) + k] / dvec[k] : (k == i ? T(1) : T(0));
  for (int i = tid; i < N; i += kThreads) dout[size_t(blockIdx.x) * N + i] = dvec[i];
  DK_PROF(kProfOut);
  if (tid == 0) DK_PROF_ADD(kProfInstances, 1);
}

// ---- launchers -----------------------------------------------------------------

// f(kernel, block) with the factor's instantiation for (N, tw): the smallest
// of the team's covers that holds N, or the shared-memory kernel past 128 rows
template <typename T, int TW, int kIdx = 0, class F>
int with_ldl_cover(int N, int per, F&& f) {
  using C = LdlCovers<T, TW>;
  if constexpr (kIdx >= C::kNum) {
    return int(cudaErrorInvalidValue);
  } else {
    constexpr int cover = C::kCovers[kIdx];
    static_assert(cover % TileGrid<TW>::kX == 0 && cover % TileGrid<TW>::kY == 0, "whole tiles both ways");
    if (N <= cover) return f(ldl_factor_team_kernel<T, TW, cover / TileGrid<TW>::kX>, dim3(32 * TW, per));
    return with_ldl_cover<T, TW, kIdx + 1>(N, per, f);
  }
}

template <typename T, class F>
int with_ldl_factor_kernel(int N, int tw, int per, F&& f) {
  if (N > ldl_reg_rows(sizeof(T))) return f(ldl_factor_smem_kernel<T>, dim3(kThreads));
  return with_team(tw, [&](auto tc) { return with_ldl_cover<T, decltype(tc)::value>(N, per, f); });
}

template <typename T>
int launch_ldl_factor(const void* K, void* L, void* d, int B, int N, int team, void* stream) {
  const int item = int(sizeof(T));
  if (team == 0) team = ldl_team(N, 0, item);
  if (B <= 0 || !ldl_team_takes(N, 0, item, team)) return int(cudaErrorInvalidValue);  // refused
  const int per = ldl_per_block(N, 0, item, team);
  const size_t smem = ldl_smem_bytes_of(N, 0, item, team);
  return with_ldl_factor_kernel<T>(N, team, per, [&](auto kernel, dim3 block) {
    cudaError_t e = smem_attributes(kernel, smem);
    if (e != cudaSuccess) return int(e);
    kernel<<<(B + per - 1) / per, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(K), static_cast<T*>(L), static_cast<T*>(d), B, N);
    return int(cudaGetLastError());
  });
}

template <typename T>
int launch_ldl_solve(const void* L, const void* d, const void* rhs, void* out, int B, int N, int k, int team,
                     void* stream) {
  const int item = int(sizeof(T));
  if (team == 0) team = ldl_team(N, k, item);
  if (B <= 0 || k <= 0 || !ldl_team_takes(N, k, item, team)) return int(cudaErrorInvalidValue);  // refused
  const int per = ldl_per_block(N, k, item, team);
  const size_t smem = ldl_smem_bytes_of(N, k, item, team);
  return with_solve_kernel<T, LdlDiag>(N, k, team, per, [&](auto kernel, dim3 block) {
    cudaError_t e = smem_attributes(kernel, smem);
    if (e != cudaSuccess) return int(e);
    kernel<<<(B + per - 1) / per, block, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(L), static_cast<const T*>(d), static_cast<const T*>(rhs), static_cast<T*>(out), B, N,
        k);
    return int(cudaGetLastError());
  });
}

// instances resident on one SM at the shape with teams of `team` warps (k = 0:
// the factor), by the occupancy calculator; a negative CUDA error code on failure
template <typename T>
int ldl_blocks_per_sm_of(int N, int k, int team) {
  const int item = int(sizeof(T));
  if (team == 0) team = ldl_team(N, k, item);
  if (!ldl_team_takes(N, k, item, team)) return -int(cudaErrorInvalidValue);
  const int per = ldl_per_block(N, k, item, team);
  const size_t smem = ldl_smem_bytes_of(N, k, item, team);
  auto occupancy = [&](auto kernel, dim3 block) {
    cudaError_t e = smem_attributes(kernel, smem);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, block.x * block.y * block.z, smem);
    return e == cudaSuccess ? blocks * per : -int(e);
  };
  return k == 0 ? with_ldl_factor_kernel<T>(N, team, per, occupancy)
                : with_solve_kernel<T, LdlDiag>(N, k, team, per, occupancy);
}

}  // namespace dk

extern "C" {

#ifdef DK_PROFILE
int ldl_prof_read(unsigned long long* out) { return dk::prof_read(out); }
int ldl_prof_zero() { return dk::prof_zero(); }
#endif

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// The launch rule: warps per instance for the shape (k = 0: the factor; 0 where none takes it), and
// instances per block into *per_block.
int ldl_team(int N, int k, int itemsize, int* per_block) {
  const int team = dk::ldl_team(N, k, itemsize);
  *per_block = team ? dk::ldl_per_block(N, k, itemsize, team) : 0;
  return team;
}

// Dynamic shared memory of a block with teams of `team` warps at the shape, in bytes; -1 where that
// team does not take it.
long long ldl_smem_bytes(int N, int k, int itemsize, int team) {
  return dk::ldl_team_takes(N, k, itemsize, team) ? (long long)dk::ldl_smem_bytes_of(N, k, itemsize, team) : -1;
}

// Instances resident per SM at the shape (team 0: the rule's); a negative CUDA error code on failure.
int ldl_blocks_per_sm(int N, int k, int itemsize, int team) {
  return itemsize == 4 ? dk::ldl_blocks_per_sm_of<float>(N, k, team) : dk::ldl_blocks_per_sm_of<double>(N, k, team);
}

// team: warps per instance, 0 for the launch rule's; a team that does not take the shape is refused
// (cudaErrorInvalidValue), never replaced by another.
int ldl_factor_f32(const void* K, void* L, void* d, int B, int N, int team, void* stream) {
  return dk::launch_ldl_factor<float>(K, L, d, B, N, team, stream);
}
int ldl_factor_f64(const void* K, void* L, void* d, int B, int N, int team, void* stream) {
  return dk::launch_ldl_factor<double>(K, L, d, B, N, team, stream);
}
int ldl_solve_f32(const void* L, const void* d, const void* rhs, void* out, int B, int N, int k, int team,
                  void* stream) {
  return dk::launch_ldl_solve<float>(L, d, rhs, out, B, N, k, team, stream);
}
int ldl_solve_f64(const void* L, const void* d, const void* rhs, void* out, int B, int N, int k, int team,
                  void* stream) {
  return dk::launch_ldl_solve<double>(L, d, rhs, out, B, N, k, team, stream);
}

}  // extern "C"
