// Fused batched primal-dual interior-point QP solver: the whole Mehrotra
// predictor-corrector loop for  min 1/2 z'Qz + q'z  s.t.  Az = b, Gz <= h  in
// one kernel, one thread block per instance.
//
// Replaces diffopt_tpu/ops/pallas/pdip.py::solve_batched_fused (_pdip_kernel
// with _chol_value(_loop) and _chol_solve_value(_loop)). The TPU kernel puts
// 128 instances along the vector lanes and freezes finished lanes by select;
// here every per-lane quantity (done, stalled, finite, errb, itdone, alpha) is
// a per-block scalar and a finished instance leaves the loop, which gives what
// freeze-by-select gives. The arithmetic, constants and exit rules are the
// reference's.
//
// Per iteration: H = Q + reg I + G' diag(lam/s) G and its Cholesky L, W =
// L^-1 A', S = A H^-1 A' + reg I = W'W + reg I and its Cholesky, then two
// condensed direction solves (affine, corrector), fraction-to-boundary steps,
// scale-relative termination, best-iterate tracking, a 5-iteration stall exit
// and a non-finite guard.
//
// Bound on an H100: operations on the f32 (f64) non-tensor units. An instance
// reads n^2 + (m + p)(n + 1) + n words once (n = 64, m = 32, p = 16: 28 KB)
// and then does about n^2 m + n^3 / 3 + n^2 p + p^2 n + 8 n^2 flops per
// iteration (0.4 MFLOP at that size) for five to ten iterations: a hundred
// flops per byte, past the card's 20 flop/byte ridge for f32. The design keeps
// L, W, S, the iterate and (where they fit) Q, G, A in shared memory so device
// memory is touched once. What it still pays for is the sequential structure,
// and it is laid out to shorten that: H and S are assembled and factorised in
// registers (dense.cuh, factor_tile: one block barrier and a few dozen
// multiply-adds per column); every triangular substitution is run by ONE warp
// with its right-hand side in registers -- the p columns of W side by side on
// the block's warps, the chain of a direction solve on warp 0 -- and each
// H-solve of the reference is split so that its forward half is shared (two
// n-substitutions per direction, not six). Several blocks stay resident per
// SM (55 KB of shared memory each at the size above), so one block's serial
// stretches overlap another's arithmetic.
//
// Envelope: 1 <= n <= 128, 1 <= p <= 128 (H and S are factorised in register
// tiles, which hold 128 rows), m >= 1 and pdip_smem_bytes(n, m, p, stage = 0)
// <= 227 KB. With stage = 1 Q, G and A are staged in shared memory as well
// (the caller asks for it when that fits); with stage = 0 they are read from
// device memory / L2 each time.
#include "dense.cuh"
#include "prof.cuh"

namespace dk {

// Phase probes (prof.cuh) for tools/pdip_phase_cycles.py: counter 8 takes a
// block's whole time, counter 9 its factorisations (the init + the bodies).

enum Slot {
  kDscale, kPscale, kGscale, kMu, kMaxRd, kMaxRpe, kMaxRpi, kAp, kAd, kSigMu, kAs, kAl,
  kBadDz, kBadDnu, kBadDlam, kBadDs, kBadZ, kBadLam, kNumSlots = 32
};

__host__ __device__ inline size_t pdip_words(int n, int m, int p, int stage) {
  size_t w = stage ? size_t(n) * n + size_t(m) * n + size_t(p) * n : 0;
  w += size_t(n) * odd_stride(n) + size_t(n) * odd_stride(p) + size_t(p) * odd_stride(p);
  w += 9 * size_t(n) + 12 * size_t(m) + 7 * size_t(p) + kNumSlots + kColbufWords;
  return w;
}

template <typename T>
struct Pdip {
  int n, m, p, ldh, ldw, lds;
  T reg;
  const T *Q, *G, *A;  // staged copies in shared memory, or the instance's device memory
  T *H, *W, *S;        // H / L_h (n x ldh), W = L_h^-1 A' (n x ldw), S / L_s (p x lds)
  T *q, *z, *zb, *rd, *dz, *Qz, *Gl, *An, *invH;                     // n words each
  T *h, *lam, *s, *lamb, *sb, *rpi, *dlam, *ds, *rc, *tm, *Gz, *ls;  // m words each
  T *b, *nu, *nub, *rpe, *dnu, *Az, *invS;                           // p words each
  T *sc;                                                             // kNumSlots scalars
  T *colbuf;                                                         // kColbufWords, for factor_tile
};

// H = Q + reg I + G' diag(ls) G assembled and factorised in register tiles
// (dense.cuh), L_h written to c.H.
template <typename T, int kRows>
__device__ void pdip_chol_H_tiled(const Pdip<T>& c) {
  const int tx = threadIdx.x & (kTileGrid - 1), ty = threadIdx.x / kTileGrid;
  const int n = c.n, m = c.m;
  const T* __restrict__ Q = c.Q;
  const T* __restrict__ G = c.G;
  const T* __restrict__ ls = c.ls;
  T t[kRows][kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      t[a][b] = (i < n && k < n) ? Q[i * n + k] + (i == k ? c.reg : T(0)) : T(0);
    }
  for (int r = 0; r < m; ++r) {
    const T* g = G + r * n;
    const T lsr = ls[r];
    T gi[kRows], gk[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * a;
      gi[a] = i < n ? g[i] * lsr : T(0);
      gk[a] = k < n ? g[k] : T(0);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b) t[a][b] += gi[a] * gk[b];
  }
  factor_tile<T, kRows>(t, n, c.invH, c.colbuf);
  store_chol_tile<T, kRows>(t, n, c.H, c.ldh, c.invH);
}

// S = W'W + reg I assembled and factorised in register tiles, L_s written to c.S.
template <typename T, int kRows>
__device__ void pdip_chol_S_tiled(const Pdip<T>& c) {
  const int tx = threadIdx.x & (kTileGrid - 1), ty = threadIdx.x / kTileGrid;
  const int n = c.n, p = c.p;
  const T* __restrict__ W = c.W;
  T t[kRows][kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      t[a][b] = (i < p && i == k) ? c.reg : T(0);
    }
  for (int r = 0; r < n; ++r) {
    const T* w = W + r * c.ldw;
    T wi[kRows], wk[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * a;
      wi[a] = i < p ? w[i] : T(0);
      wk[a] = k < p ? w[k] : T(0);
    }
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b) t[a][b] += wi[a] * wk[b];
  }
  factor_tile<T, kRows>(t, p, c.invS, c.colbuf);
  store_chol_tile<T, kRows>(t, p, c.S, c.lds, c.invS);
}

// Factors for the current ls = lam / s (ready and synchronised): L_h = chol(H)
// with H = Q + reg I + G' diag(ls) G, W = L_h^-1 A' and L_s = chol(S) with
// S = A H^-1 A' + reg I = W'W + reg I. Both matrices are assembled and
// factorised in registers (n, p <= 128: the launcher refuses larger ones).
template <typename T>
__device__ void pdip_factor(const Pdip<T>& c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = c.n, p = c.p;
  DK_PROF_START();
  for (int idx = tid; idx < n * p; idx += kThreads) {
    const int a = idx / n, i = idx - a * n;
    c.W[i * c.ldw + a] = c.A[idx];
  }
  dispatch_tile(n, [&](auto rows) { pdip_chol_H_tiled<T, decltype(rows)::value>(c); });
  DK_PROF(0);
  // the p columns of W are independent: one warp each, no block barrier
  for (int a = warp; a < p; a += kWarps)
    warp_forward_sub<T>(c.H, c.ldh, n, c.W + a, c.ldw, c.invH, lane);
  __syncthreads();
  DK_PROF(1);
  dispatch_tile(p, [&](auto rows) { pdip_chol_S_tiled<T, decltype(rows)::value>(c); });
  DK_PROF(2);
}

// Condensed Newton direction for the residuals rd, rpe, rpi and the centring
// term rc (all ready and synchronised) -> dz, dnu, dlam, ds. With H = L L' and
// W = L^-1 A':  w = L^-1 (-rd + G' (rc - lam rpi) / s),  S dnu = W'w + rpe,
// dz = L'^-1 (w - W dnu)  -- the reference's z1 = H^-1 rhs, dnu = S^-1 (A z1 +
// rpe), dz = z1 - H^-1 A' dnu with the two halves of each H-solve shared.
template <typename T>
__device__ void pdip_solve_dir(const Pdip<T>& c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = c.n, m = c.m, p = c.p;
  DK_PROF_START();
  for (int r = tid; r < m; r += kThreads) c.tm[r] = (c.rc[r] - c.lam[r] * c.rpi[r]) / c.s[r];
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) {
    T acc = T(0);
    for (int r = 0; r < m; ++r) acc += c.G[r * n + j] * c.tm[r];
    c.dz[j] = -c.rd[j] + acc;
  }
  __syncthreads();
  DK_PROF(3);
  // a chain of substitutions, each step of which has at most n independent
  // updates: one warp runs it with warp barriers only
  if (warp == 0) {
    warp_forward_sub<T>(c.H, c.ldh, n, c.dz, 1, c.invH, lane);
    for (int a = lane; a < p; a += 32) {
      T acc = c.rpe[a];
      for (int i = 0; i < n; ++i) acc += c.W[i * c.ldw + a] * c.dz[i];
      c.dnu[a] = acc;
    }
    __syncwarp();
    warp_chol_solve<T>(c.S, c.lds, p, c.dnu, 1, c.invS, lane);
    for (int i = lane; i < n; i += 32) {
      T acc = c.dz[i];
      for (int a = 0; a < p; ++a) acc -= c.W[i * c.ldw + a] * c.dnu[a];
      c.dz[i] = acc;
    }
    __syncwarp();
    warp_backward_sub<T>(c.H, c.ldh, n, c.dz, 1, c.invH, lane);
  }
  __syncthreads();
  DK_PROF(4);
  for (int r = warp; r < m; r += kWarps) {
    const T v = warp_dot(c.G + r * n, c.dz, n, lane);
    if (lane == 0) {
      const T dsr = -c.rpi[r] - v;
      c.ds[r] = dsr;
      c.dlam[r] = -(c.rc[r] + c.lam[r] * dsr) / c.s[r];
    }
  }
  __syncthreads();
  DK_PROF(5);
}

// Residuals of the current iterate and the scalars of the scale-relative
// termination test (kDscale .. kMaxRpi in c.sc).
template <typename T>
__device__ void pdip_residuals(const Pdip<T>& c) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = c.n, m = c.m, p = c.p;
  DK_PROF_START();
  for (int row = warp; row < n + m + p; row += kWarps) {
    const T* M;
    T* out;
    if (row < n) { M = c.Q + row * n; out = c.Qz + row; }
    else if (row < n + m) { M = c.G + (row - n) * n; out = c.Gz + (row - n); }
    else { M = c.A + (row - n - m) * n; out = c.Az + (row - n - m); }
    const T v = warp_dot(M, c.z, n, lane);
    if (lane == 0) *out = v;
  }
  for (int j = tid; j < n; j += kThreads) {
    T gl = T(0), an = T(0);
    for (int r = 0; r < m; ++r) gl += c.G[r * n + j] * c.lam[r];
    for (int a = 0; a < p; ++a) an += c.A[a * n + j] * c.nu[a];
    c.Gl[j] = gl;
    c.An[j] = an;
  }
  __syncthreads();
  for (int j = tid; j < n; j += kThreads) c.rd[j] = ((c.Qz[j] + c.q[j]) + c.Gl[j]) + c.An[j];
  for (int a = tid; a < p; a += kThreads) c.rpe[a] = c.Az[a] - c.b[a];
  for (int r = tid; r < m; r += kThreads) c.rpi[r] = (c.Gz[r] + c.s[r]) - c.h[r];
  __syncthreads();
  if (warp == 0) {
    T a = T(0);
    for (int j = lane; j < n; j += 32)
      a = nan_max(a, nan_max(nan_max(fabs(c.Qz[j]), fabs(c.q[j])),
                             nan_max(fabs(c.Gl[j]), fabs(c.An[j]))));
    a = warp_max(a);
    if (lane == 0) c.sc[kDscale] = T(1) + a;
  } else if (warp == 1) {
    T a = T(0);
    for (int j = lane; j < p; j += 32) a = nan_max(a, nan_max(fabs(c.Az[j]), fabs(c.b[j])));
    for (int j = lane; j < m; j += 32) a = nan_max(a, nan_max(fabs(c.Gz[j]), fabs(c.h[j])));
    a = warp_max(a);
    if (lane == 0) c.sc[kPscale] = T(1) + a;
  } else if (warp == 2) {
    T zq = T(0), qz = T(0);
    for (int j = lane; j < n; j += 32) { zq += c.z[j] * c.Qz[j]; qz += c.q[j] * c.z[j]; }
    zq = warp_sum(zq);
    qz = warp_sum(qz);
    if (lane == 0) c.sc[kGscale] = T(1) + fabs(T(0.5) * zq + qz);
  } else if (warp == 3) {
    T a = T(0);
    for (int r = lane; r < m; r += 32) a += c.s[r] * c.lam[r];
    a = warp_sum(a);
    if (lane == 0) c.sc[kMu] = a / T(m);
  } else if (warp == 4) {
    T a = T(0);
    for (int j = lane; j < n; j += 32) a = nan_max(a, fabs(c.rd[j]));
    a = warp_max(a);
    if (lane == 0) c.sc[kMaxRd] = a;
  } else if (warp == 5) {
    T a = T(0);
    for (int j = lane; j < p; j += 32) a = nan_max(a, fabs(c.rpe[j]));
    a = warp_max(a);
    if (lane == 0) c.sc[kMaxRpe] = a;
  } else if (warp == 6) {
    T a = T(0);
    for (int j = lane; j < m; j += 32) a = nan_max(a, fabs(c.rpi[j]));
    a = warp_max(a);
    if (lane == 0) c.sc[kMaxRpi] = a;
  }
  __syncthreads();
  DK_PROF(6);
}

// min(1, frac * min_{dv < 0} (-v / dv)), by one warp; every lane gets it.
template <typename T>
__device__ inline T warp_step_len(const T* v, const T* dv, int len, T frac, int lane) {
  T a = T(INFINITY);
  for (int i = lane; i < len; i += 32) a = nan_min(a, dv[i] < T(0) ? -v[i] / dv[i] : T(INFINITY));
  return nan_min(T(1), frac * warp_min(a));
}

// 1 if any entry is NaN or infinite, by one warp.
template <typename T>
__device__ inline T warp_any_nonfinite(const T* v, int len, int lane) {
  int bad = 0;
  for (int i = lane; i < len; i += 32) bad |= !isfinite(v[i]);
  return __any_sync(kFullMask, bad) ? T(1) : T(0);
}

// Four resident blocks per SM in f32 (64 registers a thread; shared memory
// allows as many at the headline size), two in f64.
template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
pdip_kernel(const T* __restrict__ Qg, const T* __restrict__ qg, const T* __restrict__ Ag,
            const T* __restrict__ bg, const T* __restrict__ Gg, const T* __restrict__ hg,
            T* __restrict__ z_out, T* __restrict__ lam_out, T* __restrict__ nu_out,
            T* __restrict__ s_out, int* __restrict__ it_out,
            int n, int m, int p, int iters, T tol, T reg, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t inst = blockIdx.x;
  DK_PROF_START();
#ifdef DK_PROFILE
  const long long tstart_ = t0_;
#endif
  auto take = [&w](size_t count) { T* r = w; w += count; return r; };

  // the block's table of pointers lives in shared memory: held in registers it
  // would cost every thread some fifty of them and halve the resident blocks
  __shared__ Pdip<T> c_shared;
  const T* Qi = Qg + inst * n * n;
  const T* Gi = Gg + inst * m * n;
  const T* Ai = Ag + inst * p * n;
  T* sQ = nullptr;
  T* sG = nullptr;
  T* sA = nullptr;
  if (stage) {
    sQ = take(size_t(n) * n);
    sG = take(size_t(m) * n);
    sA = take(size_t(p) * n);
    for (int i = tid; i < n * n; i += kThreads) sQ[i] = Qi[i];
    for (int i = tid; i < m * n; i += kThreads) sG[i] = Gi[i];
    for (int i = tid; i < p * n; i += kThreads) sA[i] = Ai[i];
  }
  if (tid == 0) {
    Pdip<T>& c = c_shared;
    c.n = n; c.m = m; c.p = p; c.ldh = odd_stride(n); c.ldw = odd_stride(p); c.lds = odd_stride(p);
    c.reg = reg;
    c.Q = stage ? sQ : Qi; c.G = stage ? sG : Gi; c.A = stage ? sA : Ai;
    c.H = take(size_t(n) * c.ldh); c.W = take(size_t(n) * c.ldw); c.S = take(size_t(p) * c.lds);
    c.q = take(n); c.z = take(n); c.zb = take(n); c.rd = take(n); c.dz = take(n); c.Qz = take(n);
    c.Gl = take(n); c.An = take(n); c.invH = take(n);
    c.h = take(m); c.lam = take(m); c.s = take(m); c.lamb = take(m); c.sb = take(m); c.rpi = take(m);
    c.dlam = take(m); c.ds = take(m); c.rc = take(m); c.tm = take(m); c.Gz = take(m); c.ls = take(m);
    c.b = take(p); c.nu = take(p); c.nub = take(p); c.rpe = take(p); c.dnu = take(p); c.Az = take(p);
    c.invS = take(p);
    c.sc = take(kNumSlots);
    c.colbuf = take(kColbufWords);
  }
  __syncthreads();
  const Pdip<T>& c = c_shared;
  DK_PROF(7);

  // ---- init: one condensed solve at lam = s = 1 from the zero iterate ------
  for (int j = tid; j < n; j += kThreads) { const T v = qg[inst * n + j]; c.q[j] = v; c.rd[j] = v; }
  for (int a = tid; a < p; a += kThreads) { const T v = bg[inst * p + a]; c.b[a] = v; c.rpe[a] = -v; }
  for (int r = tid; r < m; r += kThreads) {
    const T v = hg[inst * m + r];
    c.h[r] = v; c.rpi[r] = -v; c.rc[r] = T(-1); c.lam[r] = T(1); c.s[r] = T(1); c.ls[r] = T(1);
  }
  __syncthreads();
  pdip_factor(c);
  pdip_solve_dir(c);
  for (int j = tid; j < n; j += kThreads) c.z[j] = c.dz[j];
  for (int a = tid; a < p; a += kThreads) c.nu[a] = c.dnu[a];
  __syncthreads();
  for (int r = warp; r < m; r += kWarps) {  // s0 = h - G z
    const T v = warp_dot(c.G + r * n, c.z, n, lane);
    if (lane == 0) c.s[r] = c.h[r] - v;
  }
  __syncthreads();
  if (warp == 0) {
    T a = T(INFINITY);
    for (int r = lane; r < m; r += 32) a = nan_min(a, c.s[r]);
    a = warp_min(a);
    if (lane == 0) c.sc[kAp] = nan_max(T(0), -a * T(1.5)) + T(1);
  }
  __syncthreads();
  {
    const T shift = c.sc[kAp];
    for (int r = tid; r < m; r += kThreads) c.s[r] += shift;
  }
  for (int j = tid; j < n; j += kThreads) c.zb[j] = c.z[j];
  for (int a = tid; a < p; a += kThreads) c.nub[a] = c.nu[a];
  __syncthreads();
  for (int r = tid; r < m; r += kThreads) { c.lamb[r] = c.lam[r]; c.sb[r] = c.s[r]; }
  __syncthreads();

  // ---- main loop: every quantity below is uniform across the block ---------
  T errb = T(1e30), mu_prev = T(1e30), err_prev = T(1e30);
  int stall = 0, itdone = -1, it = 0;
  while (it < iters) {
    pdip_residuals(c);
    const T mu = c.sc[kMu], dscale = c.sc[kDscale], pscale = c.sc[kPscale], gscale = c.sc[kGscale];
    const T pres = (c.sc[kMaxRpe] + c.sc[kMaxRpi]) / pscale;
    const T dres = c.sc[kMaxRd] / dscale;
    const T gaprel = mu * T(m) / gscale;
    for (int r = tid; r < m; r += kThreads) {
      c.ls[r] = c.lam[r] / c.s[r];
      c.rc[r] = c.s[r] * c.lam[r];
    }
    __syncthreads();
    pdip_factor(c);
    pdip_solve_dir(c);  // affine direction
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
    __syncthreads();
    {
      const T sigmu = c.sc[kSigMu];
      for (int r = tid; r < m; r += kThreads)
        c.rc[r] = (c.s[r] * c.lam[r] + c.ds[r] * c.dlam[r]) - sigmu;
    }
    __syncthreads();
    pdip_solve_dir(c);  // corrector direction
    if (warp == 0) { const T v = warp_step_len(c.s, c.ds, m, T(0.99), lane); if (lane == 0) c.sc[kAs] = v; }
    else if (warp == 1) { const T v = warp_step_len(c.lam, c.dlam, m, T(0.99), lane); if (lane == 0) c.sc[kAl] = v; }
    else if (warp == 2) { const T v = warp_any_nonfinite(c.dz, n, lane); if (lane == 0) c.sc[kBadDz] = v; }
    else if (warp == 3) { const T v = warp_any_nonfinite(c.dnu, p, lane); if (lane == 0) c.sc[kBadDnu] = v; }
    else if (warp == 4) { const T v = warp_any_nonfinite(c.dlam, m, lane); if (lane == 0) c.sc[kBadDlam] = v; }
    else if (warp == 5) { const T v = warp_any_nonfinite(c.ds, m, lane); if (lane == 0) c.sc[kBadDs] = v; }
    __syncthreads();
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
    for (int j = tid; j < n; j += kThreads) {
      const T v = c.z[j];
      if (better) c.zb[j] = v;
      if (!frozen) c.z[j] = v + alpha * c.dz[j];
    }
    for (int a = tid; a < p; a += kThreads) {
      const T v = c.nu[a];
      if (better) c.nub[a] = v;
      if (!frozen) c.nu[a] = v + alpha * c.dnu[a];
    }
    for (int r = tid; r < m; r += kThreads) {
      const T vl = c.lam[r], vs = c.s[r];
      if (better) { c.lamb[r] = vl; c.sb[r] = vs; }
      if (!frozen) { c.lam[r] = vl + alpha * c.dlam[r]; c.s[r] = vs + alpha * c.ds[r]; }
    }
    ++it;
    mu_prev = mu;
    err_prev = err;
    __syncthreads();
    if (frozen) break;
  }

  // ---- the exit state never got a best-update inside the loop: score it ----
  pdip_residuals(c);
  if (warp == 0) { const T v = warp_any_nonfinite(c.z, n, lane); if (lane == 0) c.sc[kBadZ] = v; }
  else if (warp == 1) { const T v = warp_any_nonfinite(c.lam, m, lane); if (lane == 0) c.sc[kBadLam] = v; }
  __syncthreads();
  {
    const T pres = (c.sc[kMaxRpe] + c.sc[kMaxRpi]) / c.sc[kPscale];
    const T dres = c.sc[kMaxRd] / c.sc[kDscale];
    const T err = nan_max(nan_max(pres, dres), c.sc[kMu] * T(m) / c.sc[kGscale]);
    const bool fin = c.sc[kBadZ] == T(0) && c.sc[kBadLam] == T(0);
    const bool last = err < errb && fin;
    for (int j = tid; j < n; j += kThreads) z_out[inst * n + j] = last ? c.z[j] : c.zb[j];
    for (int a = tid; a < p; a += kThreads) nu_out[inst * p + a] = last ? c.nu[a] : c.nub[a];
    for (int r = tid; r < m; r += kThreads) {
      lam_out[inst * m + r] = last ? c.lam[r] : c.lamb[r];
      s_out[inst * m + r] = last ? c.s[r] : c.sb[r];
    }
    if (tid == 0) {
      it_out[inst] = itdone >= 0 ? itdone : it;
      DK_PROF_ADD(8, clock64() - tstart_);
      DK_PROF_ADD(9, it + 1);
    }
  }
}

template <typename T>
int launch_pdip(const void* Q, const void* q, const void* A, const void* b, const void* G,
                const void* h, void* z, void* lam, void* nu, void* s, void* it, int B, int n, int m,
                int p, int iters, double tol, double reg, int stage, void* stream) {
  const size_t smem = pdip_words(n, m, p, stage) * sizeof(T);
  constexpr int kMaxRows = kTileGrid * kMaxTileRows;
  if (B <= 0 || n <= 0 || m <= 0 || p <= 0 || n > kMaxRows || p > kMaxRows || smem > kMaxSmemBytes)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(pdip_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem));
  if (e != cudaSuccess) return int(e);
  pdip_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Q), static_cast<const T*>(q), static_cast<const T*>(A),
      static_cast<const T*>(b), static_cast<const T*>(G), static_cast<const T*>(h),
      static_cast<T*>(z), static_cast<T*>(lam), static_cast<T*>(nu), static_cast<T*>(s),
      static_cast<int*>(it), n, m, p, iters, T(tol), T(reg), stage);
  return int(cudaGetLastError());
}

}  // namespace dk

extern "C" {

#ifdef DK_PROFILE
int pdip_prof_read(unsigned long long* out) { return dk::prof_read(out); }
int pdip_prof_zero() { return dk::prof_zero(); }
#endif

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dynamic shared memory the kernel needs, in bytes (elem_size 4 or 8).
long long pdip_smem_bytes(int n, int m, int p, int elem_size, int stage) {
  return (long long)(dk::pdip_words(n, m, p, stage) * size_t(elem_size));
}

int pdip_fused_f32(const void* Q, const void* q, const void* A, const void* b, const void* G,
                   const void* h, void* z, void* lam, void* nu, void* s, void* it, int B, int n,
                   int m, int p, int iters, double tol, double reg, int stage, void* stream) {
  return dk::launch_pdip<float>(Q, q, A, b, G, h, z, lam, nu, s, it, B, n, m, p, iters, tol, reg,
                                stage, stream);
}
int pdip_fused_f64(const void* Q, const void* q, const void* A, const void* b, const void* G,
                   const void* h, void* z, void* lam, void* nu, void* s, void* it, int B, int n,
                   int m, int p, int iters, double tol, double reg, int stage, void* stream) {
  return dk::launch_pdip<double>(Q, q, A, b, G, h, z, lam, nu, s, it, B, n, m, p, iters, tol, reg,
                                 stage, stream);
}

}  // extern "C"
