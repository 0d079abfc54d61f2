// Pieces shared by the fused interior-point kernels (csrc/conic_pdip.cu, K6;
// csrc/ns_pdip.cu, K7), generic over the solver's per-block state C (its
// `Real` type and the fields each piece reads: the data AC, AE, c, bE, bC,
// the iterate x, yE, yC, s, the residuals rd, rpE, rpC, the factor L (row
// stride ld) with D in dvec, the scalar slots sc, nu_deg, and the sizes n, p,
// mC, N): the residuals and the scale-relative metrics, the LDL' of K
// assembled in register tiles from the solver's k_entry(c, i, k), the LDL'
// solve on one warp, and a block-wide non-finite test. Every function is
// called by every thread of the block and ends in __syncthreads.
#pragma once

#include <float.h>

#include "dense.cuh"

namespace dk {

template <typename T> __device__ inline T hyp(T a, T b);
template <> __device__ inline float hyp<float>(float a, float b) { return hypotf(a, b); }
template <> __device__ inline double hyp<double>(double a, double b) { return hypot(a, b); }
template <typename T> __device__ inline T mach_eps();
template <> __device__ inline float mach_eps<float>() { return FLT_EPSILON; }
template <> __device__ inline double mach_eps<double>() { return DBL_EPSILON; }

// scalar slots of the metrics in C::sc (the solvers number their own after them)
enum IpmSlot { sAx2, sB2, sPres2, sNs, sNrdc, sNc, sNrd, sPobj, sDobj, sMu, sMuAff, kIpmSlots };

// K assembled in register tiles, LDL' by factor_tile, unit-lower L (strict
// lower triangle) to c.L and D to c.dvec
template <class C, int kRows>
__device__ __noinline__ void factor_tiled(const C& c) {
  using T = typename C::Real;
  const int tx = threadIdx.x & (kTileGrid - 1), ty = threadIdx.x / kTileGrid;
  const int N = c.N;
  T t[kRows][kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      t[a][b] = (i < N && k < N) ? k_entry(c, i, k) : T(0);
    }
  factor_tile<T, kRows>(t, N, c.dvec, c.colbuf);
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      if (i < N && k < i) c.L[i * c.ld + k] = t[a][b] / c.dvec[k];
    }
  __syncthreads();
}

template <class C>
__device__ void factor(const C& c) {
  dispatch_tile(c.N, [&](auto rows) { factor_tiled<C, decltype(rows)::value>(c); });
}

// x <- (L D L')^-1 x on warp 0
template <class C>
__device__ __noinline__ void ldl_solve_warp0(const C& c, typename C::Real* x) {
  using T = typename C::Real;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    warp_forward_sub<T>(c.L, c.ld, c.N, x, 1, nullptr, lane);
    for (int i = lane; i < c.N; i += 32) x[i] /= c.dvec[i];
    __syncwarp();
    warp_backward_sub<T>(c.L, c.ld, c.N, x, 1, nullptr, lane);
  }
  __syncthreads();
}

// rd = c + AC'yC + AE'yE, rpE = AE x - bE, rpC = AC x + s - bC (one thread per row)
template <class C>
__device__ __noinline__ void residuals(const C& c) {
  using T = typename C::Real;
  const int mC = c.mC, n = c.n, p = c.p;
  for (int r = threadIdx.x; r < c.N; r += kThreads) {
    if (r < n) {
      T a = T(0);
      for (int i = 0; i < mC; ++i) a += c.AC[i * n + r] * c.yC[i];
      T v = c.c[r] + a;
      if (p) {
        T e = T(0);
        for (int k = 0; k < p; ++k) e += c.AE[k * n + r] * c.yE[k];
        v = v + e;
      }
      c.rd[r] = v;
    } else if (r < n + mC) {
      const int i = r - n;
      T a = T(0);
      for (int j = 0; j < n; ++j) a += c.AC[i * n + j] * c.x[j];
      c.rpC[i] = a + c.s[i] - c.bC[i];
    } else {
      const int k = r - n - mC;
      T a = T(0);
      for (int j = 0; j < n; ++j) a += c.AE[k * n + j] * c.x[j];
      c.rpE[k] = a - c.bE[k];
    }
  }
  __syncthreads();
}

// the sums of the scale-relative metrics and mu into the slots
template <class C>
__device__ __noinline__ void metric_sums(const C& c) {
  using T = typename C::Real;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mC = c.mC, n = c.n, p = c.p;
  if (warp == 0) {
    T ax = T(0), b2 = T(0), pr = T(0), ns = T(0);
    for (int i = lane; i < mC; i += 32) {
      const T a = c.rpC[i] - c.s[i] + c.bC[i];
      ax += a * a;
      b2 += c.bC[i] * c.bC[i];
      pr += c.rpC[i] * c.rpC[i];
      ns += c.s[i] * c.s[i];
    }
    T axe = T(0), b2e = T(0), pre = T(0);
    for (int k = lane; k < p; k += 32) {
      const T a = c.rpE[k] + c.bE[k];
      axe += a * a;
      b2e += c.bE[k] * c.bE[k];
      pre += c.rpE[k] * c.rpE[k];
    }
    ax = warp_sum(ax); b2 = warp_sum(b2); pr = warp_sum(pr); ns = warp_sum(ns);
    axe = warp_sum(axe); b2e = warp_sum(b2e); pre = warp_sum(pre);
    if (lane == 0) {
      c.sc[sAx2] = p ? ax + axe : ax;
      c.sc[sB2] = p ? b2 + b2e : b2;
      c.sc[sPres2] = p ? pr + pre : pr;
      c.sc[sNs] = ns;
    }
  } else if (warp == 1) {
    T a = T(0), b = T(0), r = T(0);
    for (int j = lane; j < n; j += 32) {
      const T u = c.rd[j] - c.c[j];
      a += u * u;
      b += c.c[j] * c.c[j];
      r += c.rd[j] * c.rd[j];
    }
    a = warp_sum(a); b = warp_sum(b); r = warp_sum(r);
    if (lane == 0) { c.sc[sNrdc] = a; c.sc[sNc] = b; c.sc[sNrd] = r; }
  } else if (warp == 2) {
    T po = T(0), dc = T(0), de = T(0);
    for (int j = lane; j < n; j += 32) po += c.c[j] * c.x[j];
    for (int i = lane; i < mC; i += 32) dc += c.bC[i] * c.yC[i];
    for (int k = lane; k < p; k += 32) de += c.bE[k] * c.yE[k];
    po = warp_sum(po); dc = warp_sum(dc); de = warp_sum(de);
    if (lane == 0) { c.sc[sPobj] = po; c.sc[sDobj] = p ? -dc - de : -dc; }
  } else if (warp == 3) {
    T a = T(0);
    for (int i = lane; i < mC; i += 32) a += c.s[i] * c.yC[i];
    a = warp_sum(a);
    if (lane == 0) c.sc[sMu] = a / c.nu_deg;
  }
  __syncthreads();
}

template <typename T>
struct Metrics { T pres, dres, gaprel, mu; };

template <class C>
__device__ Metrics<typename C::Real> metrics(const C& c) {
  using T = typename C::Real;
  residuals(c);
  metric_sums(c);
  Metrics<T> m;
  const T psc = T(1) + nan_max(sqrt(c.sc[sAx2]), nan_max(sqrt(c.sc[sNs]), sqrt(c.sc[sB2])));
  m.pres = sqrt(c.sc[sPres2]) / psc;
  m.dres = sqrt(c.sc[sNrd]) / (T(1) + nan_max(sqrt(c.sc[sNrdc]), sqrt(c.sc[sNc])));
  const T po = c.sc[sPobj], dob = c.sc[sDobj];
  m.gaprel = fabs(po - dob) / (T(1) + fabs(po) + fabs(dob));
  m.mu = c.sc[sMu];
  __syncthreads();  // every thread has read the slots
  return m;
}

// 1 in every thread if any entry of the vectors is NaN or infinite
template <typename T>
__device__ inline bool any_nonfinite(const T* a, int na, const T* b, int nb_, const T* d, int nd, const T* e, int ne) {
  int bad = 0;
  for (int i = threadIdx.x; i < na; i += kThreads) bad |= !isfinite(a[i]);
  for (int i = threadIdx.x; i < nb_; i += kThreads) bad |= !isfinite(b[i]);
  for (int i = threadIdx.x; i < nd; i += kThreads) bad |= !isfinite(d[i]);
  for (int i = threadIdx.x; i < ne; i += kThreads) bad |= !isfinite(e[i]);
  return __syncthreads_or(bad) != 0;
}

}  // namespace dk
