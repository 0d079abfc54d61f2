// Fused batched primal-dual interior-point QP solver: the whole Mehrotra
// predictor-corrector loop for  min 1/2 z'Qz + q'z  s.t.  Az = b, Gz <= h  in
// one kernel, one instance per team of TW = 1, 2 or 8 warps.
//
// Replaces diffopt_tpu/ops/pallas/pdip.py::solve_batched_fused (_pdip_kernel
// with _chol_value(_loop) and _chol_solve_value(_loop)). The TPU kernel puts
// 128 instances along the vector lanes and freezes finished lanes by select;
// here every per-lane quantity (done, stalled, finite, errb, itdone, alpha) is
// a per-team scalar and a finished instance leaves the loop, which gives what
// freeze-by-select gives. The arithmetic, constants and exit rules are the
// reference's.
//
// Per iteration: H = Q + reg I + G' diag(lam/s) G and its Cholesky L, W =
// L^-1 A', S = A H^-1 A' + reg I = W'W + reg I and its Cholesky, then two
// condensed direction solves (affine, corrector): w = L^-1 rhs, S dnu = W'w +
// rpe, dz = L'^-1 (w - W dnu) -- the reference's z1 = H^-1 rhs, dnu = S^-1 (A
// z1 + rpe), dz = z1 - H^-1 A' dnu with the two halves of each H-solve shared;
// then fraction-to-boundary steps, scale-relative termination, best-iterate
// tracking, a 5-iteration stall exit and a non-finite guard.
//
// Bound on an H100: operations on the f32 (f64) non-tensor units. An instance
// reads n^2 + (m + p)(n + 1) + n words once (n = 64, m = 32, p = 16: 28 KB)
// and then does about n^2 m + n^3 / 3 + n^2 p + p^2 n + 8 n^2 flops per
// iteration (0.4 MFLOP at that size) for five to ten iterations: a hundred
// flops per byte. What the time goes to is the sequential structure: n
// elimination steps with a barrier each, and a chain of substitutions whose
// steps have O(n) independent updates. So the design gives one instance the
// fewest warps that serve it and the SM as many instances as it holds, each
// chain overlapping the others':
//   - Teams. ONE TEAM PER THREAD BLOCK (blockDim = 32 TW; its barrier is the
//     block's, or __syncwarp for one warp), as K6 (csrc/conic_pdip.cu). The
//     launch rule (pdip_team, mirrored by ops/cuda/pdip.py::team_for) picks
//     the smallest team whose register tiles hold max(n, p) rows and whose
//     working set fits: one warp to 32 rows (its tiles hold 40, but two warps
//     were faster at 40), two to 64, eight to 128. Each
//     (type, team) is its own instantiation with its own __launch_bounds__
//     (pdip_reg_blocks). A team that does not take a shape is refused, never
//     replaced by another.
//   - Residency. Q, G and A are staged in shared memory only where that costs
//     no resident team (pdip_stage); otherwise they are read through L1 / L2.
//     At the headline shape a two-warp team needs 27 KB: eight per SM.
//   - W folded into the factorisation. A's p rows are stacked under H in the
//     team's register tiles, rows n .. n + p - 1 of [H; A]; the n column steps
//     of dense.cuh's factor_grid that eliminate H eliminate them as well, so
//     they leave as W' = A L'^-1 with no substitution of their own, and are
//     written beside L (rows n .. n + p - 1 of c.L). S = reg I + W'W is then
//     assembled and factorised on the same grid.
//   - A short chain. A direction's substitutions run on one warp (a step has
//     O(n) independent updates) with the vector in registers from the forward
//     substitution through the S solve to the backward substitution: W'w by
//     shuffle reductions, w - W dnu by shuffle broadcasts of dnu, no trip
//     through shared memory between the stages.
//   - Shared memory by index. The team's arrays are SPtr (dense.cuh), so that
//     every access to them is an LDS / STS; through generic pointers each was
//     an LD / ST with 64-bit address arithmetic, and that cost the headline
//     shape 39% of its time (PERF.md). Q, G and A, where they stay in device
//     memory, are read with several rows in flight per warp (team_matvec) and
//     H's rows of G one ahead of their use.
// Measured on an H100 (PERF.md, tools/k1_variants.py): past eight teams per
// SM the time hardly moves (six: 6% slower), staging Q, G, A at four teams is
// slower than leaving them in device memory at eight, and what an instance
// waits on is its own chain of steps, not the SM's issue rate.
//
// Envelope: 1 <= n, p <= 128, m >= 1 and a working set (unstaged) within a
// block's 227 KB for the team that takes the shape.
#include "dense.cuh"
#include "prof.cuh"

namespace dk {

// counters of the phase probes (prof.cuh; tools/pdip_phase_cycles.py names them in this order)
enum PdipProf {
  kProfFactorHW, kProfFactorS, kProfRhs, kProfChain, kProfDsDlam, kProfResiduals, kProfStep, kProfInit, kProfExit,
  kProfTotal = 14, kProfBodies = 15
};

enum Slot {
  kDscale, kPscale, kGscale, kMu, kMaxRd, kMaxRpe, kMaxRpi, kAp, kAd, kSigMu, kAs, kAl,
  kBadDz, kBadDnu, kBadDlam, kBadDs, kBadZ, kBadLam, kNumSlots = 32
};

// room for the kernel's static shared memory (its pointer table), mirrored by ops/cuda/pdip.py
constexpr size_t kPdipStatic = 512;

// words of the pivot column of [H; A]: the rows of a team's largest tile set, double-buffered
__host__ __device__ constexpr int pdip_colbuf_words(int tw) { return 4 * tile_max_n(tw); }

// words of the working type a team of tw warps needs (mirrored by ops/cuda/pdip.py::smem_bytes)
__host__ __device__ inline size_t pdip_words(int n, int m, int p, int tw, int stage) {
  size_t w = stage ? size_t(n) * n + size_t(m) * n + size_t(p) * n : 0;
  w += size_t(n + p) * odd_stride(n) + size_t(p) * odd_stride(p);
  w += 9 * size_t(n) + 11 * size_t(m) + 7 * size_t(p) + kNumSlots + pdip_colbuf_words(tw);
  return w;
}

// The team's table of its arrays: Q, G, A by generic pointer (staged copies in
// shared memory, or the instance's device memory), the rest as SPtr (indices
// into shared memory, so that every access is an LDS / STS).
template <typename T>
struct Pdip {
  int n, m, p, ld, lds;
  T reg;
  const T *Q, *G, *A;
  SPtr<T> L;  // (n + p) x ld: L_h in rows 0 .. n-1, W' = (L_h^-1 A')' in rows n .. n+p-1
  SPtr<T> S;  // L_s, p x lds
  SPtr<T> q, z, zb, rd, dz, Qz, Gl, An, invH;                // n words each
  SPtr<T> h, lam, s, lamb, sb, rpi, dlam, ds, rc, Gz, ls;  // m words each
  SPtr<T> b, nu, nub, rpe, dnu, Az, invS;                  // p words each
  SPtr<T> sc;                                              // kNumSlots scalars
  SPtr<T> colbuf;                                          // pdip_colbuf_words(TW)
};
static_assert(sizeof(Pdip<double>) <= kPdipStatic, "the pointer table outgrew its room");

// (columns, rows) of [H; A] a team's tile sets hold, smallest first: the
// columns one of TileGrid<TW>::kCovers (n), the rows n + p at most
template <int TW> struct PdipTiles;
template <> struct PdipTiles<1> {
  static constexpr int kNum = 5, kCols[5] = {24, 24, 40, 40, 40}, kRows[5] = {24, 48, 40, 48, 80};
};
template <> struct PdipTiles<2> {
  static constexpr int kNum = 5, kCols[5] = {32, 32, 64, 64, 64}, kRows[5] = {32, 64, 64, 80, 128};
};
template <> struct PdipTiles<8> {
  static constexpr int kNum = 8, kCols[8] = {32, 32, 64, 64, 64, 128, 128, 128},
                       kRows[8] = {32, 160, 64, 96, 192, 128, 160, 256};
};

// f(integral_constant RY, integral_constant RX) for the smallest tile set of
// the team that holds n columns and n + p rows
template <int TW, int kIdx = 0, typename F>
__device__ inline bool dispatch_pdip_tiles(int n, int rows, F&& f) {
  using P = PdipTiles<TW>;
  using G = TileGrid<TW>;
  if constexpr (kIdx >= P::kNum) {
    return false;
  } else {
    constexpr int kC = P::kCols[kIdx], kR = P::kRows[kIdx];
    static_assert(kC % G::kX == 0 && kR % G::kY == 0 && kR >= kC && 2 * kR <= pdip_colbuf_words(TW),
                  "a tile set is whole tiles, at least as many rows as columns, within the pivot column");
    if (n <= kC && rows <= kR) {
      f(std::integral_constant<int, kR / G::kY>{}, std::integral_constant<int, kC / G::kX>{});
      return true;
    }
    return dispatch_pdip_tiles<TW, kIdx + 1>(n, rows, f);
  }
}

// [H; A] with H = Q + reg I + G' diag(ls) G assembled in the team's register
// tiles (RX column tiles; RY row tiles, of which rows n .. n + p - 1 hold A),
// eliminated by factor_grid's n column steps and written out: L_h to rows
// 0 .. n - 1 of c.L, W' = A L_h'^-1 to rows n .. n + p - 1, 1 / L_h[j][j] to
// c.invH.
template <typename T, int TW, int RY, int RX>
__device__ __noinline__ void pdip_factor_HW(const Pdip<T>& c) {
  constexpr int kY = TileGrid<TW>::kY, kX = TileGrid<TW>::kX, RS = RX * kX / kY;  // RS: row tiles of H
  const int tx = threadIdx.x % kX, ty = threadIdx.x / kX;
  const int n = c.n, m = c.m, rows = n + c.p;
  const T* __restrict__ Q = c.Q;
  const T* __restrict__ G = c.G;
  const T* __restrict__ A = c.A;
  T t[RY][RX];
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      if (!tile_live<kY, kX>(a, b)) continue;
      const int i = ty + kY * a, k = tx + kX * b;
      T v = T(0);
      if (k < n) {
        if (i < n) v = Q[i * n + k] + (i == k ? c.reg : T(0));
        else if (i < rows) v = A[(i - n) * n + k];
      }
      t[a][b] = v;
    }
  // the rows of G are loaded one ahead of their use, so that a row's loads
  // (from device memory where G is not staged) overlap the previous row's
  // multiply-adds
  T gi[RS], gk[RX];
  auto load_row = [&](int r, T (&ri)[RS], T (&rk)[RX]) {
    const T* g = G + r * n;
#pragma unroll
    for (int a = 0; a < RS; ++a) {
      const int i = ty + kY * a;
      ri[a] = i < n ? g[i] : T(0);
    }
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int k = tx + kX * b;
      rk[b] = k < n ? g[k] : T(0);
    }
  };
  load_row(0, gi, gk);
  for (int r = 0; r < m; ++r) {
    T ni[RS], nk[RX];
    load_row(r + 1 < m ? r + 1 : r, ni, nk);
    const T lsr = c.ls[r];
#pragma unroll
    for (int a = 0; a < RS; ++a) {
      const T gil = gi[a] * lsr;
#pragma unroll
      for (int b = 0; b < RX; ++b)
        if (tile_live<kY, kX>(a, b)) t[a][b] += gil * gk[b];
    }
#pragma unroll
    for (int a = 0; a < RS; ++a) gi[a] = ni[a];
#pragma unroll
    for (int b = 0; b < RX; ++b) gk[b] = nk[b];
  }
  factor_grid<T, TW, RY, RX>(t, n, c.invH, c.colbuf);
  store_chol_grid<T, TW, RY, RX>(t, n, rows, c.L, c.ld, c.invH);
}

// S = W'W + reg I assembled in the team's register tiles from the rows of W'
// and factorised: L_s to c.S, 1 / L_s[j][j] to c.invS
template <typename T, int TW, int RX>
__device__ __noinline__ void pdip_factor_S(const Pdip<T>& c) {
  constexpr int kY = TileGrid<TW>::kY, kX = TileGrid<TW>::kX, RY = RX * kX / kY;
  const int tx = threadIdx.x % kX, ty = threadIdx.x / kX;
  const int n = c.n, p = c.p, ld = c.ld;
  const SPtr<T> W = c.L + n * ld;  // row a of W' at W + a ld
  T t[RY][RX];
#pragma unroll
  for (int a = 0; a < RY; ++a)
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      if (!tile_live<kY, kX>(a, b)) continue;
      const int i = ty + kY * a, k = tx + kX * b;
      t[a][b] = (i < p && i == k) ? c.reg : T(0);
    }
  for (int r = 0; r < n; ++r) {
    T wi[RY], wk[RX];
#pragma unroll
    for (int a = 0; a < RY; ++a) {
      const int i = ty + kY * a;
      wi[a] = i < p ? W[i * ld + r] : T(0);
    }
#pragma unroll
    for (int b = 0; b < RX; ++b) {
      const int k = tx + kX * b;
      wk[b] = k < p ? W[k * ld + r] : T(0);
    }
#pragma unroll
    for (int a = 0; a < RY; ++a)
#pragma unroll
      for (int b = 0; b < RX; ++b)
        if (tile_live<kY, kX>(a, b)) t[a][b] += wi[a] * wk[b];
  }
  factor_grid<T, TW, RY, RX>(t, p, c.invS, c.colbuf);
  store_chol_grid<T, TW, RY, RX>(t, p, p, c.S, c.lds, c.invS);
}

// Factors for the current ls = lam / s (ready and synchronised): L_h, W' and L_s.
template <typename T, int TW>
__device__ void pdip_factor(const Pdip<T>& c) {
  DK_PROF_START();
  dispatch_pdip_tiles<TW>(c.n, c.n + c.p, [&](auto ry, auto rx) {
    pdip_factor_HW<T, TW, decltype(ry)::value, decltype(rx)::value>(c);
  });
  DK_PROF(kProfFactorHW);
  dispatch_grid<TW>(c.p, [&](auto rx) { pdip_factor_S<T, TW, decltype(rx)::value>(c); });
  DK_PROF(kProfFactorS);
}

// register entries per lane of the chain's vectors (n, p <= tile_max_n(TW) <= 32 of them)
template <int TW>
__host__ __device__ constexpr int chain_rows() { return (tile_max_n(TW) + 31) / 32; }

// The substitution chain of a direction on one warp, from the right-hand side
// in c.dz: w = L_h^-1 rhs, S dnu = W'w + rpe, dz = L_h'^-1 (w - W dnu); dz and
// dnu written. w and dnu stay in registers throughout (lane l holds entry
// 32 r + l in register r).
template <typename T, int R>
__device__ __noinline__ void pdip_chain(const Pdip<T>& c, int lane) {
  const int n = c.n, p = c.p, ld = c.ld;
  const SPtr<T> W = c.L + n * ld;
  T x[R], u[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    x[r] = i < n ? c.dz[i] : T(0);
    u[r] = T(0);
  }
  warp_forward_sub_regs(c.L, ld, n, x, c.invH, lane);
  // u = W'w + rpe: one shuffle reduction per row of W', entry a kept by lane a % 32
#pragma unroll
  for (int ra = 0; ra < R; ++ra) {
    const int aend = min(32, p - ra * 32);
#pragma unroll 4
    for (int al = 0; al < aend; ++al) {
      const SPtr<T> w = W + (ra * 32 + al) * ld;
      T part = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * 32 + lane;
        if (i < n) part += w[i] * x[r];
      }
      const T v = warp_sum(part) + c.rpe[ra * 32 + al];
      if (lane == al) u[ra] = v;
    }
  }
  warp_forward_sub_regs(c.S, c.lds, p, u, c.invS, lane);
  warp_backward_sub_regs(c.S, c.lds, p, u, c.invS, lane);
  // w - W dnu: each dnu_a broadcast from its lane
#pragma unroll
  for (int ra = 0; ra < R; ++ra) {
    const int aend = min(32, p - ra * 32);
#pragma unroll 4
    for (int al = 0; al < aend; ++al) {
      const SPtr<T> w = W + (ra * 32 + al) * ld;
      const T d = __shfl_sync(kFullMask, u[ra], al);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * 32 + lane;
        if (i < n) x[r] -= w[i] * d;
      }
    }
  }
  warp_backward_sub_regs(c.L, ld, n, x, c.invH, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    if (i < n) c.dz[i] = x[r];
    if (i < p) c.dnu[i] = u[r];
  }
}

// put(r, M[r] . x) by lane 0 for the rows r < rows of M (row stride n), one
// warp a row and four rows in flight per warp, so that their loads (from
// device memory where M is not staged) overlap; the team's warps take the
// rows in turn. Each lane sums its entries in order, then the warp's lanes by
// a butterfly.
#ifndef DK_PDIP_MATVEC_ROWS  // 2 and 8 were slower at the headline shape (tools/k1_variants.py)
#define DK_PDIP_MATVEC_ROWS 4
#endif
template <typename T, int TW, typename F>
__device__ inline void team_matvec(const T* __restrict__ M, SPtr<T> x, int rows, int n, F&& put) {
  constexpr int K = DK_PDIP_MATVEC_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp * K; r0 < rows; r0 += TW * K) {
    T acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = T(0);
    for (int i = lane; i < n; i += 32) {
      const T xi = x[i];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (r0 + k < rows) acc[k] += M[(r0 + k) * n + i] * xi;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T v = warp_sum(acc[k]);
      if (lane == 0 && r0 + k < rows) put(r0 + k, v);
    }
  }
}

// Condensed Newton direction for the residuals rd, rpe, rpi and the centring
// term rc (all ready and synchronised) -> dz, dnu, dlam, ds.
template <typename T, int TW>
__device__ void pdip_solve_dir(const Pdip<T>& c) {
  constexpr int kTeamThreads = 32 * TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = c.n, m = c.m;
  const SPtr<T> tm = c.Gz;  // Gz is not read again before the next residuals
  DK_PROF_START();
  for (int r = tid; r < m; r += kTeamThreads) tm[r] = (c.rc[r] - c.lam[r] * c.rpi[r]) / c.s[r];
  Team<TW>::sync();
  for (int j = tid; j < n; j += kTeamThreads) {
    T acc = T(0);
#pragma unroll 8
    for (int r = 0; r < m; ++r) acc += c.G[r * n + j] * tm[r];
    c.dz[j] = -c.rd[j] + acc;
  }
  Team<TW>::sync();
  DK_PROF(kProfRhs);
  if (warp == 0) pdip_chain<T, chain_rows<TW>()>(c, lane);
  Team<TW>::sync();
  DK_PROF(kProfChain);
  team_matvec<T, TW>(c.G, c.dz, m, n, [&](int r, T v) {
    const T dsr = -c.rpi[r] - v;
    c.ds[r] = dsr;
    c.dlam[r] = -(c.rc[r] + c.lam[r] * dsr) / c.s[r];
  });
  Team<TW>::sync();
  DK_PROF(kProfDsDlam);
}

// one of the seven scalars of the scale-relative termination test, by one warp
template <typename T>
__device__ void pdip_metric(const Pdip<T>& c, int group, int lane) {
  const int n = c.n, m = c.m, p = c.p;
  T a = T(0);
  switch (group) {
    case 0:
      for (int j = lane; j < n; j += 32)
        a = nan_max(a, nan_max(nan_max(fabs(c.Qz[j]), fabs(c.q[j])), nan_max(fabs(c.Gl[j]), fabs(c.An[j]))));
      a = warp_max(a);
      if (lane == 0) c.sc[kDscale] = T(1) + a;
      break;
    case 1:
      for (int j = lane; j < p; j += 32) a = nan_max(a, nan_max(fabs(c.Az[j]), fabs(c.b[j])));
      for (int j = lane; j < m; j += 32) a = nan_max(a, nan_max(fabs(c.Gz[j]), fabs(c.h[j])));
      a = warp_max(a);
      if (lane == 0) c.sc[kPscale] = T(1) + a;
      break;
    case 2: {
      T qz = T(0);
      for (int j = lane; j < n; j += 32) { a += c.z[j] * c.Qz[j]; qz += c.q[j] * c.z[j]; }
      a = warp_sum(a);
      qz = warp_sum(qz);
      if (lane == 0) c.sc[kGscale] = T(1) + fabs(T(0.5) * a + qz);
      break;
    }
    case 3:
      for (int r = lane; r < m; r += 32) a += c.s[r] * c.lam[r];
      a = warp_sum(a);
      if (lane == 0) c.sc[kMu] = a / T(m);
      break;
    case 4:
      for (int j = lane; j < n; j += 32) a = nan_max(a, fabs(c.rd[j]));
      a = warp_max(a);
      if (lane == 0) c.sc[kMaxRd] = a;
      break;
    case 5:
      for (int j = lane; j < p; j += 32) a = nan_max(a, fabs(c.rpe[j]));
      a = warp_max(a);
      if (lane == 0) c.sc[kMaxRpe] = a;
      break;
    default:
      for (int j = lane; j < m; j += 32) a = nan_max(a, fabs(c.rpi[j]));
      a = warp_max(a);
      if (lane == 0) c.sc[kMaxRpi] = a;
  }
}

// Residuals of the current iterate and the scalars of the scale-relative
// termination test (kDscale .. kMaxRpi in c.sc).
template <typename T, int TW>
__device__ void pdip_residuals(const Pdip<T>& c) {
  constexpr int kTeamThreads = 32 * TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = c.n, m = c.m, p = c.p;
  DK_PROF_START();
  team_matvec<T, TW>(c.Q, c.z, n, n, [&](int r, T v) { c.Qz[r] = v; });
  team_matvec<T, TW>(c.G, c.z, m, n, [&](int r, T v) { c.Gz[r] = v; });
  team_matvec<T, TW>(c.A, c.z, p, n, [&](int r, T v) { c.Az[r] = v; });
  for (int j = tid; j < n; j += kTeamThreads) {
    T gl = T(0), an = T(0);
#pragma unroll 8
    for (int r = 0; r < m; ++r) gl += c.G[r * n + j] * c.lam[r];
#pragma unroll 8
    for (int a = 0; a < p; ++a) an += c.A[a * n + j] * c.nu[a];
    c.Gl[j] = gl;
    c.An[j] = an;
  }
  Team<TW>::sync();
  for (int j = tid; j < n; j += kTeamThreads) c.rd[j] = ((c.Qz[j] + c.q[j]) + c.Gl[j]) + c.An[j];
  for (int a = tid; a < p; a += kTeamThreads) c.rpe[a] = c.Az[a] - c.b[a];
  for (int r = tid; r < m; r += kTeamThreads) c.rpi[r] = (c.Gz[r] + c.s[r]) - c.h[r];
  Team<TW>::sync();
  for (int group = warp; group < 7; group += TW) pdip_metric(c, group, lane);  // a team of fewer warps takes them in turn
  Team<TW>::sync();
  DK_PROF(kProfResiduals);
}

// min(1, frac * min_{dv < 0} (-v / dv)), by one warp; every lane gets it.
template <typename T>
__device__ inline T warp_step_len(SPtr<T> v, SPtr<T> dv, int len, T frac, int lane) {
  T a = T(INFINITY);
  for (int i = lane; i < len; i += 32) a = nan_min(a, dv[i] < T(0) ? -v[i] / dv[i] : T(INFINITY));
  return nan_min(T(1), frac * warp_min(a));
}

// 1 if any entry is NaN or infinite, by one warp.
template <typename T>
__device__ inline T warp_any_nonfinite(SPtr<T> v, int len, int lane) {
  int bad = 0;
  for (int i = lane; i < len; i += 32) bad |= !isfinite(v[i]);
  return __any_sync(kFullMask, bad) ? T(1) : T(0);
}

// Teams resident per SM that the registers must allow. f32: two-warp teams
// eight per SM (128 registers a thread; shared memory holds eight at the
// headline shape), one-warp teams 24, eight-warp teams three (n = 100 holds
// three by shared memory); f64 half as many, and one eight-warp team.
// DK_PDIP_F32_BLOCKS_<TW> set the f32 counts and DK_PDIP_STAGE (0: never, 1:
// wherever it fits) the staging for an experiment (tools/k1_variants.py); the
// package's build keeps the rule's.
#ifndef DK_PDIP_F32_BLOCKS_1
#define DK_PDIP_F32_BLOCKS_1 24
#endif
#ifndef DK_PDIP_F32_BLOCKS_2
#define DK_PDIP_F32_BLOCKS_2 8
#endif
#ifndef DK_PDIP_F32_BLOCKS_8
#define DK_PDIP_F32_BLOCKS_8 3
#endif
__host__ __device__ constexpr int pdip_reg_blocks(int itemsize, int tw) {
  return itemsize == 4 ? (tw == 1 ? DK_PDIP_F32_BLOCKS_1 : (tw == 2 ? DK_PDIP_F32_BLOCKS_2 : DK_PDIP_F32_BLOCKS_8))
                       : (tw == 1 ? 12 : (tw == 2 ? 4 : 1));
}

template <typename T, int TW>
__global__ void __launch_bounds__(32 * TW, pdip_reg_blocks(sizeof(T), TW))
pdip_kernel(const T* __restrict__ Qg, const T* __restrict__ qg, const T* __restrict__ Ag,
            const T* __restrict__ bg, const T* __restrict__ Gg, const T* __restrict__ hg,
            T* __restrict__ z_out, T* __restrict__ lam_out, T* __restrict__ nu_out,
            T* __restrict__ s_out, int* __restrict__ it_out,
            int n, int m, int p, int iters, T tol, T reg, int stage) {
  constexpr int kTeamThreads = 32 * TW;
  T* const base = reinterpret_cast<T*>(dk_smem);
  int w = 0;  // words of dynamic shared memory taken
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t inst = blockIdx.x;
  DK_PROF_START();
#ifdef DK_PROFILE
  const long long tstart_ = t0_;
#endif
  auto take = [&w](int count) { const SPtr<T> r{w}; w += count; return r; };

  // the team's table of pointers lives in shared memory: held in registers it
  // would cost every thread some fifty of them
  __shared__ Pdip<T> c_shared;
  const T* Qi = Qg + inst * n * n;
  const T* Gi = Gg + inst * m * n;
  const T* Ai = Ag + inst * p * n;
  if (stage) {
    const SPtr<T> sQ = take(n * n), sG = take(m * n), sA = take(p * n);
    for (int i = tid; i < n * n; i += kTeamThreads) sQ[i] = Qi[i];
    for (int i = tid; i < m * n; i += kTeamThreads) sG[i] = Gi[i];
    for (int i = tid; i < p * n; i += kTeamThreads) sA[i] = Ai[i];
    Qi = base;
    Gi = base + n * n;
    Ai = base + n * n + m * n;
  }
  if (tid == 0) {
    Pdip<T>& c = c_shared;
    c.n = n; c.m = m; c.p = p; c.ld = odd_stride(n); c.lds = odd_stride(p);
    c.reg = reg;
    c.Q = Qi; c.G = Gi; c.A = Ai;
    c.L = take((n + p) * c.ld); c.S = take(p * c.lds);
    c.q = take(n); c.z = take(n); c.zb = take(n); c.rd = take(n); c.dz = take(n); c.Qz = take(n);
    c.Gl = take(n); c.An = take(n); c.invH = take(n);
    c.h = take(m); c.lam = take(m); c.s = take(m); c.lamb = take(m); c.sb = take(m); c.rpi = take(m);
    c.dlam = take(m); c.ds = take(m); c.rc = take(m); c.Gz = take(m); c.ls = take(m);
    c.b = take(p); c.nu = take(p); c.nub = take(p); c.rpe = take(p); c.dnu = take(p); c.Az = take(p);
    c.invS = take(p);
    c.sc = take(kNumSlots);
    c.colbuf = take(pdip_colbuf_words(TW));
  }
  Team<TW>::sync();
  const Pdip<T>& c = c_shared;

  // ---- init: one condensed solve at lam = s = 1 from the zero iterate ------
  for (int j = tid; j < n; j += kTeamThreads) { const T v = qg[inst * n + j]; c.q[j] = v; c.rd[j] = v; }
  for (int a = tid; a < p; a += kTeamThreads) { const T v = bg[inst * p + a]; c.b[a] = v; c.rpe[a] = -v; }
  for (int r = tid; r < m; r += kTeamThreads) {
    const T v = hg[inst * m + r];
    c.h[r] = v; c.rpi[r] = -v; c.rc[r] = T(-1); c.lam[r] = T(1); c.s[r] = T(1); c.ls[r] = T(1);
  }
  Team<TW>::sync();
  DK_PROF(kProfInit);
  pdip_factor<T, TW>(c);
  pdip_solve_dir<T, TW>(c);
  DK_PROF_RESTART();
  for (int j = tid; j < n; j += kTeamThreads) c.z[j] = c.dz[j];
  for (int a = tid; a < p; a += kTeamThreads) c.nu[a] = c.dnu[a];
  Team<TW>::sync();
  team_matvec<T, TW>(c.G, c.z, m, n, [&](int r, T v) { c.s[r] = c.h[r] - v; });  // s0 = h - G z
  Team<TW>::sync();
  if (warp == 0) {
    T a = T(INFINITY);
    for (int r = lane; r < m; r += 32) a = nan_min(a, c.s[r]);
    a = warp_min(a);
    if (lane == 0) c.sc[kAp] = nan_max(T(0), -a * T(1.5)) + T(1);
  }
  Team<TW>::sync();
  {
    const T shift = c.sc[kAp];
    for (int r = tid; r < m; r += kTeamThreads) c.s[r] += shift;
  }
  for (int j = tid; j < n; j += kTeamThreads) c.zb[j] = c.z[j];
  for (int a = tid; a < p; a += kTeamThreads) c.nub[a] = c.nu[a];
  Team<TW>::sync();
  for (int r = tid; r < m; r += kTeamThreads) { c.lamb[r] = c.lam[r]; c.sb[r] = c.s[r]; }
  Team<TW>::sync();
  DK_PROF(kProfInit);

  // ---- main loop: every quantity below is uniform across the team ----------
  T errb = T(1e30), mu_prev = T(1e30), err_prev = T(1e30);
  int stall = 0, itdone = -1, it = 0;
  while (it < iters) {
    pdip_residuals<T, TW>(c);
    DK_PROF_RESTART();
    const T mu = c.sc[kMu], dscale = c.sc[kDscale], pscale = c.sc[kPscale], gscale = c.sc[kGscale];
    const T pres = (c.sc[kMaxRpe] + c.sc[kMaxRpi]) / pscale;
    const T dres = c.sc[kMaxRd] / dscale;
    const T gaprel = mu * T(m) / gscale;
    for (int r = tid; r < m; r += kTeamThreads) {
      c.ls[r] = c.lam[r] / c.s[r];
      c.rc[r] = c.s[r] * c.lam[r];
    }
    Team<TW>::sync();
    DK_PROF(kProfStep);
    pdip_factor<T, TW>(c);
    pdip_solve_dir<T, TW>(c);  // affine direction
    DK_PROF_RESTART();
    if (warp == 0) {
      const T ap = warp_step_len(c.s, c.ds, m, T(1), lane);
      const T ad = warp_step_len(c.lam, c.dlam, m, T(1), lane);
      T a = T(0);
      for (int r = lane; r < m; r += 32) a += (c.s[r] + ap * c.ds[r]) * (c.lam[r] + ad * c.dlam[r]);
      const T mu_aff = warp_sum(a) / T(m);
      const T ratio = mu_aff / nan_max(mu, T(1e-30));
      const T sigma = nan_min(nan_max(ratio * ratio * ratio, T(0)), T(1));
      if (lane == 0) c.sc[kSigMu] = sigma * mu;
    }
    Team<TW>::sync();
    {
      const T sigmu = c.sc[kSigMu];
      for (int r = tid; r < m; r += kTeamThreads)
        c.rc[r] = (c.s[r] * c.lam[r] + c.ds[r] * c.dlam[r]) - sigmu;
    }
    Team<TW>::sync();
    DK_PROF(kProfStep);
    pdip_solve_dir<T, TW>(c);  // corrector direction
    DK_PROF_RESTART();
    for (int group = warp; group < 6; group += TW) {
      T v;
      switch (group) {
        case 0: v = warp_step_len(c.s, c.ds, m, T(0.99), lane); break;
        case 1: v = warp_step_len(c.lam, c.dlam, m, T(0.99), lane); break;
        case 2: v = warp_any_nonfinite(c.dz, n, lane); break;
        case 3: v = warp_any_nonfinite(c.dnu, p, lane); break;
        case 4: v = warp_any_nonfinite(c.dlam, m, lane); break;
        default: v = warp_any_nonfinite(c.ds, m, lane);
      }
      if (lane == 0) c.sc[kAs + group] = v;  // kAs, kAl, kBadDz, kBadDnu, kBadDlam, kBadDs
    }
    Team<TW>::sync();
    T alpha = nan_min(c.sc[kAs], c.sc[kAl]);
    const bool finite = c.sc[kBadDz] == T(0) && c.sc[kBadDnu] == T(0) &&
                        c.sc[kBadDlam] == T(0) && c.sc[kBadDs] == T(0);
    const bool done = pres < tol && dres < tol && gaprel < tol;
    // best-iterate tracking: an instance oscillating at the floating-point
    // floor would otherwise export whatever state the last iteration left
    const T err = nan_max(nan_max(pres, dres), gaprel);
    const bool better = err < errb;
    if (better) errb = err;
    // stall exit: five consecutive iterations without >2% progress on BOTH mu
    // and err means the instance sits at its floor
    const bool stalled_now = mu > T(0.98) * mu_prev && err > T(0.98) * err_prev;
    stall = stalled_now ? stall + 1 : 0;
    const bool frozen = done || stall >= 5 || !finite;
    if (frozen && itdone < 0) itdone = it;
    if (!isfinite(alpha)) alpha = T(0);
    // a frozen instance keeps its state (never alpha = 0: 0 * NaN would poison
    // an instance whose direction blew up) and leaves the loop
    for (int j = tid; j < n; j += kTeamThreads) {
      const T v = c.z[j];
      if (better) c.zb[j] = v;
      if (!frozen) c.z[j] = v + alpha * c.dz[j];
    }
    for (int a = tid; a < p; a += kTeamThreads) {
      const T v = c.nu[a];
      if (better) c.nub[a] = v;
      if (!frozen) c.nu[a] = v + alpha * c.dnu[a];
    }
    for (int r = tid; r < m; r += kTeamThreads) {
      const T vl = c.lam[r], vs = c.s[r];
      if (better) { c.lamb[r] = vl; c.sb[r] = vs; }
      if (!frozen) { c.lam[r] = vl + alpha * c.dlam[r]; c.s[r] = vs + alpha * c.ds[r]; }
    }
    ++it;
    mu_prev = mu;
    err_prev = err;
    Team<TW>::sync();
    DK_PROF(kProfStep);
    if (frozen) break;
  }

  // ---- the exit state never got a best-update inside the loop: score it ----
  pdip_residuals<T, TW>(c);
  DK_PROF_RESTART();
  for (int group = warp; group < 2; group += TW) {
    const T v = group == 0 ? warp_any_nonfinite(c.z, n, lane) : warp_any_nonfinite(c.lam, m, lane);
    if (lane == 0) c.sc[kBadZ + group] = v;  // kBadZ, kBadLam
  }
  Team<TW>::sync();
  {
    const T pres = (c.sc[kMaxRpe] + c.sc[kMaxRpi]) / c.sc[kPscale];
    const T dres = c.sc[kMaxRd] / c.sc[kDscale];
    const T err = nan_max(nan_max(pres, dres), c.sc[kMu] * T(m) / c.sc[kGscale]);
    const bool fin = c.sc[kBadZ] == T(0) && c.sc[kBadLam] == T(0);
    const bool last = err < errb && fin;
    for (int j = tid; j < n; j += kTeamThreads) z_out[inst * n + j] = last ? c.z[j] : c.zb[j];
    for (int a = tid; a < p; a += kTeamThreads) nu_out[inst * p + a] = last ? c.nu[a] : c.nub[a];
    for (int r = tid; r < m; r += kTeamThreads) {
      lam_out[inst * m + r] = last ? c.lam[r] : c.lamb[r];
      s_out[inst * m + r] = last ? c.s[r] : c.sb[r];
    }
    if (tid == 0) it_out[inst] = itdone >= 0 ? itdone : it;
  }
  DK_PROF(kProfExit);
#ifdef DK_PROFILE
  if (tid == 0) {
    DK_PROF_ADD(kProfTotal, clock64() - tstart_);
    DK_PROF_ADD(kProfBodies, it + 1);
  }
#endif
}

// ---- the launch rule and the residency model (mirrored by ops/cuda/pdip.py) ----

inline size_t pdip_smem_bytes_of(int n, int m, int p, int itemsize, int tw, int stage) {
  return pdip_words(n, m, p, tw, stage) * size_t(itemsize);
}

// Whether a team of tw warps takes the shape: n and p rows in its register
// tiles, its working set (unstaged) in one block's shared memory
inline bool pdip_team_takes(int n, int m, int p, int itemsize, int tw) {
  return (tw == 1 || tw == 2 || tw == 8) && n >= 1 && m >= 1 && p >= 1 && n <= tile_max_n(tw) &&
         p <= tile_max_n(tw) && pdip_smem_bytes_of(n, m, p, itemsize, tw, 0) + kPdipStatic <= kMaxSmemBytes;
}

// The rows up to which the launch rule gives a shape to a team: one warp's
// tiles hold 40, but at n = 40 two warps were faster and at n = 32 one was
// (PERF.md), so one warp takes shapes to 32 rows
__host__ __device__ constexpr int pdip_rule_rows(int tw) { return tw == 1 ? 32 : tile_max_n(tw); }

// The launch rule: the smallest team that takes the shape within its rule's
// rows, else the smallest that takes it at all; 0 if none does
inline int pdip_team(int n, int m, int p, int itemsize) {
  for (int tw : kTeams)
    if ((n > p ? n : p) <= pdip_rule_rows(tw) && pdip_team_takes(n, m, p, itemsize, tw)) return tw;
  for (int tw : kTeams)
    if (pdip_team_takes(n, m, p, itemsize, tw)) return tw;
  return 0;
}

// Teams of tw warps one SM holds at least: by shared memory (with the room of
// the pointer table and the system's share of each block), by the registers
// the launch bounds promise, and by the SM's block and warp limits
inline int pdip_resident(int n, int m, int p, int itemsize, int tw, int stage) {
  const size_t per_block = pdip_smem_bytes_of(n, m, p, itemsize, tw, stage) + kPdipStatic + kBlockReservedSmem;
  const int regs = pdip_reg_blocks(itemsize, tw);
  int r = int(kSmSmemBytes / per_block);
  r = r < regs ? r : regs;
  r = r < kSmMaxBlocks ? r : kSmMaxBlocks;
  return r < kSmMaxWarps / tw ? r : kSmMaxWarps / tw;
}

// Whether Q, G and A are staged in shared memory: where they fit and cost no resident team
inline int pdip_stage(int n, int m, int p, int itemsize, int tw) {
  const bool fits = pdip_smem_bytes_of(n, m, p, itemsize, tw, 1) + kPdipStatic <= kMaxSmemBytes;
#ifdef DK_PDIP_STAGE
  return DK_PDIP_STAGE && fits;
#endif
  return fits && pdip_resident(n, m, p, itemsize, tw, 1) >= pdip_resident(n, m, p, itemsize, tw, 0);
}

template <typename T>
int launch_pdip(const void* Q, const void* q, const void* A, const void* b, const void* G,
                const void* h, void* z, void* lam, void* nu, void* s, void* it, int B, int n, int m,
                int p, int iters, double tol, double reg, int team, void* stream) {
  const int item = int(sizeof(T));
  const int tw = team ? team : pdip_team(n, m, p, item);
  if (B <= 0 || !pdip_team_takes(n, m, p, item, tw)) return int(cudaErrorInvalidValue);  // refused: no other team
  const int stage = pdip_stage(n, m, p, item, tw);
  return with_team(tw, [&](auto tc) {
    constexpr int TW = decltype(tc)::value;
    const size_t smem = pdip_smem_bytes_of(n, m, p, item, TW, stage);
    cudaError_t e = smem_attributes(pdip_kernel<T, TW>, smem);
    if (e != cudaSuccess) return int(e);
    pdip_kernel<T, TW><<<B, 32 * TW, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(Q), static_cast<const T*>(q), static_cast<const T*>(A),
        static_cast<const T*>(b), static_cast<const T*>(G), static_cast<const T*>(h),
        static_cast<T*>(z), static_cast<T*>(lam), static_cast<T*>(nu), static_cast<T*>(s),
        static_cast<int*>(it), n, m, p, iters, T(tol), T(reg), stage);
    return int(cudaGetLastError());
  });
}

// teams of tw warps resident on one SM at the shape (registers, shared memory
// and the SM's limits together, by the occupancy calculator); a negative CUDA
// error code on failure
template <typename T>
int pdip_blocks_per_sm_of(int n, int m, int p, int tw) {
  const int item = int(sizeof(T));
  if (!pdip_team_takes(n, m, p, item, tw)) return -int(cudaErrorInvalidValue);
  const int stage = pdip_stage(n, m, p, item, tw);
  return with_team(tw, [&](auto tc) {
    constexpr int TW = decltype(tc)::value;
    const size_t smem = pdip_smem_bytes_of(n, m, p, item, TW, stage);
    cudaError_t e = smem_attributes(pdip_kernel<T, TW>, smem);
    int blocks = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pdip_kernel<T, TW>, 32 * TW, smem);
    return e == cudaSuccess ? blocks : -int(e);
  });
}

}  // namespace dk

extern "C" {

#ifdef DK_PROFILE
int pdip_prof_read(unsigned long long* out) { return dk::prof_read(out); }
int pdip_prof_zero() { return dk::prof_zero(); }
#endif

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dynamic shared memory a team of `team` warps needs, in bytes (itemsize 4 or 8).
long long pdip_smem_bytes(int n, int m, int p, int itemsize, int team, int stage) {
  return (long long)dk::pdip_smem_bytes_of(n, m, p, itemsize, team, stage);
}

// The team the launch rule picks for the shape (1, 2 or 8 warps); 0 where none takes it.
int pdip_team(int n, int m, int p, int itemsize) { return dk::pdip_team(n, m, p, itemsize); }

// Whether a team of `team` warps stages Q, G and A at the shape (0 or 1); -1 where it does not take it.
int pdip_stage(int n, int m, int p, int itemsize, int team) {
  return dk::pdip_team_takes(n, m, p, itemsize, team) ? dk::pdip_stage(n, m, p, itemsize, team) : -1;
}

// Teams of `team` warps resident per SM at the shape; a negative CUDA error code where it cannot launch.
int pdip_blocks_per_sm(int n, int m, int p, int itemsize, int team) {
  return itemsize == 4 ? dk::pdip_blocks_per_sm_of<float>(n, m, p, team)
                       : dk::pdip_blocks_per_sm_of<double>(n, m, p, team);
}

// team: 1, 2 or 8 warps per instance, or 0 for the launch rule's choice; a team that does not take the
// shape is refused (cudaErrorInvalidValue), never replaced by another.
int pdip_fused_f32(const void* Q, const void* q, const void* A, const void* b, const void* G,
                   const void* h, void* z, void* lam, void* nu, void* s, void* it, int B, int n,
                   int m, int p, int iters, double tol, double reg, int team, void* stream) {
  return dk::launch_pdip<float>(Q, q, A, b, G, h, z, lam, nu, s, it, B, n, m, p, iters, tol, reg,
                                team, stream);
}
int pdip_fused_f64(const void* Q, const void* q, const void* A, const void* b, const void* G,
                   const void* h, void* z, void* lam, void* nu, void* s, void* it, int B, int n,
                   int m, int p, int iters, double tol, double reg, int team, void* stream) {
  return dk::launch_pdip<double>(Q, q, A, b, G, h, z, lam, nu, s, it, B, n, m, p, iters, tol, reg,
                                 team, stream);
}

}  // extern "C"
