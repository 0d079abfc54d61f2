// Fused batched symmetric-cone interior-point solver: the whole NT-scaled
// Mehrotra predictor-corrector loop for
//     min c'x  s.t.  AE x = bE,  AC x + s = bC,  s in K = nonneg(l) x soc(d_1..) x psd(side_1..)
// in one kernel, one instance per team of TW = 1, 2 or 8 warps.
//
// Replaces diffopt_tpu/ops/pallas/conic_pdip.py::solve_tile_fused (kernel body
// _kernel, with _ldl_value / _ldl_solve_value and the lanes-batched Jacobi
// _jacobi_eigh_ll). The TPU kernel puts 128 instances along the vector lanes
// and freezes finished lanes by select; here every per-lane quantity (done,
// stalled, dead, finite, errb, itdone, alpha) is a per-team scalar and a
// frozen instance leaves its loop: a frozen lane keeps its state, so the
// result is the same. The arithmetic, constants and exit rules are the
// reference's: NT scaling per block (eta, v, wb per soc block through the
// factored Jordan determinant with its eps floor; W_nt = S^1/2 (S^1/2 Y
// S^1/2)^-1/2 S^1/2 and its square-root pair per psd block), the Newton matrix
// K = [[-W^2, AC, 0], [AC', reg I, AE'], [0, AE, -reg I]] in [cone | x | eq]
// order factored by unpivoted LDL' with 1 refinement pass (2 with a psd block)
// against K, a Lyapunov jsolve in the eigenbasis of lam shared by the four step
// lengths, scale-relative metrics tested before the step, best-iterate
// tracking, a stall exit after five iterations without 2% progress on mu and
// the error, a mu <= 0 freeze and a non-finite guard. Every team size does
// the same arithmetic in the same order: its outputs are the same.
//
// Bound on an H100: operations. An instance reads (p + mC)(n + 1) + n words
// once and does about N^3 / 3 flops for the factorisation plus eight Jacobi
// eigendecompositions per psd block per iteration. The critical path is
// sequential: N elimination steps (one team barrier each), 2 N substitution
// steps per solve (one warp, right-hand side in registers), the rotation
// chains of the psd blocks. So everything an iteration touches stays in shared
// memory or registers: K is assembled straight into dense.cuh's register
// tiles on the team's thread grid (its -W^2 block computed entry by entry from
// the scaling, never stored), only L is written out, the refinement residual
// is formed from the blocks of K, SOC reductions are warp reductions, and each
// psd block's eigendecompositions and small products run on one warp in
// shared memory while the team's other warps take other blocks.
//
// Teams. At the sizes users send (N = 17 to 43) a phase has a few dozen
// independent updates and then a barrier, and the substitutions and Jacobi
// sweeps run on one warp whatever the team: eight warps per instance leave
// seven waiting, and their registers hold the SM to two instances where
// shared memory holds twenty (9 KB an instance at the SOCP in f32). So one
// instance gets the fewest warps that serve it and the SM gets as many
// instances as it holds, each chain overlapping the others. Layout: ONE TEAM
// PER THREAD BLOCK (blockDim = 32 TW). The block barrier is then the team's,
// and for one warp it is a __syncwarp; the SM's limit of 32 resident blocks
// bounds one-warp teams at 32 per SM, which shared memory and registers reach
// first at the layouts measured (22-24); several teams per block with named
// barriers would buy nothing past that and cost a barrier id per team. The
// team sizes are one, two and eight warps (kTeams): four warps hold the same
// 64 rows as two, so the rule below never picks them, and they were slower
// than two at every layout timed on an H100. Each
// team size is its own instantiation with its own __launch_bounds__
// (conic_min_blocks), and the launch rule (conic_team, mirrored by
// ops/cuda/conic_pdip.py::team_for) picks the smallest team whose tiles hold
// N (one warp to 40 rows, two to 64, eight to 128): measured on an H100 it is
// the fastest at every layout timed (PERF.md; one warp would spill its tiles
// past 40 rows, two were faster at N = 43). A team that does not take a
// layout is refused, never replaced by another.
//
// Envelope: N = n + p + mC <= 128 (register tiles), psd side <= 12, at most
// kMaxSoc soc and kMaxPsd psd blocks, conic_smem_bytes(...) <= 227 KB less
// the static pointer table for the team that takes it.
#include "ipm.cuh"
#include "prof.cuh"

namespace dk {

constexpr int kMaxSoc = 128;
constexpr int kMaxPsd = 64;
constexpr int kMaxSide = 12;
constexpr int kConicSlots = 64;
enum BlockKind { kNonneg = 0, kSoc = 1, kPsd = 2 };
// counters of the phase probes (prof.cuh; tools/k6_phase_cycles.py names them in this order)
enum ConicProf {
  kProfMetrics, kProfNt, kProfFactor, kProfWApply, kProfLamEigs, kProfSolvePred, kProfStepPred, kProfJordan,
  kProfSolveCorr, kProfStepCorr, kProfUpdate, kProfInit, kProfExit, kProfTotal, kProfBodies
};
// scalar slots in shared memory
enum ConicSlot { sStep = 16 };  // the team's per-warp partial minima of a step length, after the metrics' IpmSlot

struct Layout {
  int n, p, l, nsoc, npsd;
  short soc_dim[kMaxSoc];
  short psd_side[kMaxPsd];
};

__host__ __device__ inline int conic_mC(const Layout& L) {
  int m = L.l;
  for (int k = 0; k < L.nsoc; ++k) m += L.soc_dim[k];
  for (int k = 0; k < L.npsd; ++k) m += L.psd_side[k] * (L.psd_side[k] + 1) / 2;
  return m;
}

__host__ __device__ inline int conic_nblocks(const Layout& L) { return (L.l ? 1 : 0) + L.nsoc + L.npsd; }

__host__ __device__ inline int conic_dmax(const Layout& L) {
  int d = 0;
  for (int k = 0; k < L.npsd; ++k) d = L.psd_side[k] > d ? L.psd_side[k] : d;
  return d;
}

__host__ __device__ inline size_t conic_int_bytes(const Layout& L) {
  const size_t ints = 5 * size_t(conic_nblocks(L)) + 2 * size_t(conic_mC(L));
  return (ints * 4 + 15) / 16 * 16;
}

// words of the working type for a team of tw warps (mirrored by
// ops/cuda/conic_pdip.py::smem_bytes): the team's pivot column and one psd
// workspace per warp depend on tw, the rest is the instance's
__host__ __device__ inline size_t conic_words(const Layout& L, int tw) {
  const size_t n = L.n, p = L.p, mC = conic_mC(L), N = n + p + mC, dmax = conic_dmax(L);
  size_t w = mC * n + p * n + n + p + mC;
  w += 4 * n + 4 * p + 20 * mC + 4 * N + N * odd_stride(int(N)) + colbuf_words(tw) + kConicSlots;
  for (int k = 0; k < L.npsd; ++k) {
    const size_t d = L.psd_side[k];
    w += 5 * d * d + d;
  }
  w += size_t(tw) * (5 * dmax * dmax + dmax);
  return w;
}

__host__ __device__ inline size_t conic_smem_bytes(const Layout& L, int itemsize, int tw) {
  return conic_int_bytes(L) + conic_words(L, tw) * size_t(itemsize);
}

template <typename T, int TW>
struct Conic {
  using Real = T;
  using Team = dk::Team<TW>;
  int n, p, mC, N, ld, nb, dmax, passes;
  T reg, eps, nu_deg;
  const int *bkind, *boff, *bdim, *bside, *bdata;  // per cone block: nonneg (if any), socs, psds
  const int *rblk, *rloc;                          // per cone row: its block and its index in it
  T *AC, *AE, *c, *bE, *bC;                        // data
  T *x, *xb, *rd, *dx;                             // n words each
  T *yE, *yEb, *rpE, *dyE;                         // p words each
  T *yC, *s, *yCb, *sb, *rpC, *dyC, *ds, *dsa, *dyCa, *lam, *dsa_s, *dya_s, *comp, *g, *t1, *t2,
      *e, *sw, *swb, *seta;                        // mC words each
  T *rhs, *sol, *res, *dvec;                       // N words each
  T *L;                                            // N x ld, the LDL' factor (strict lower triangle)
  T *colbuf, *sc;
  T *pdata;  // per psd block: P = W_nt, Rb = W_nt^1/2, Rbi = W_nt^-1/2, Q (eigenvectors of lam), lam^-1/2 (d x d each), w (d)
  T *ws;     // per warp of the team: 5 dmax^2 + dmax words of workspace
};

// svec index of (r, c), r <= c: the upper triangle column by column
__device__ inline int tri_index(int r, int c) { return c * (c + 1) / 2 + r; }
__device__ inline void tri_rc(int a, int& r, int& c) {
  c = 0;
  while ((c + 1) * (c + 2) / 2 <= a) ++c;
  r = a - c * (c + 1) / 2;
}

// ---- one warp: small symmetric matrices (d x d, row-major, stride d) ---------

// M <- mat(u): off-diagonal entries times 1/sqrt2
template <typename T>
__device__ __noinline__ void wmat(const T* __restrict__ u, int d, T* __restrict__ M, int lane) {
  const T isq = T(1) / sqrt(T(2));
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, j = e - i * d;
    const T v = u[i <= j ? tri_index(i, j) : tri_index(j, i)];
    M[e] = i == j ? v : v * isq;
  }
  __syncwarp();
}

// u <- svec(M), symmetrising
template <typename T>
__device__ __noinline__ void wsvec(const T* __restrict__ M, int d, T* __restrict__ u, int lane) {
  const T h = T(0.5) * sqrt(T(2));
  for (int a = lane; a < d * (d + 1) / 2; a += 32) {
    int r, c;
    tri_rc(a, r, c);
    u[a] = r == c ? M[r * d + r] : (M[r * d + c] + M[c * d + r]) * h;
  }
  __syncwarp();
}

// C <- op(A) op(B), op = transpose where asked; C distinct from A and B
template <typename T>
__device__ __noinline__ void wmm(const T* __restrict__ A, bool tA, const T* __restrict__ B, bool tB, T* __restrict__ C,
                    int d, int lane) {
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, j = e - i * d;
    T acc = T(0);
    for (int k = 0; k < d; ++k) acc += (tA ? A[k * d + i] : A[i * d + k]) * (tB ? B[j * d + k] : B[k * d + j]);
    C[e] = acc;
  }
  __syncwarp();
}

// C <- (M + M') / 2; C distinct from M
template <typename T>
__device__ __noinline__ void wsym(const T* __restrict__ M, T* __restrict__ C, int d, int lane) {
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, j = e - i * d;
    C[e] = T(0.5) * (M[e] + M[j * d + i]);
  }
  __syncwarp();
}

// cyclic Jacobi (ops/smalleig.py::jacobi_eigh): A is destroyed, w gets the
// eigenvalues (unsorted), V (if given) the eigenvectors as columns
template <typename T>
__device__ __noinline__ void wjacobi(T* __restrict__ A, T* __restrict__ V, T* __restrict__ w, int d, int lane) {
  if (V) {
    for (int e = lane; e < d * d; e += 32) V[e] = (e / d == e % d) ? T(1) : T(0);
  }
  __syncwarp();
  const int sweeps = (d <= 4 ? 6 : (d <= 8 ? 8 : 10)) + (sizeof(T) == 8 ? 2 : 0);
  const T eps = mach_eps<T>();
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int p = 0; p < d - 1; ++p) {
      for (int q = p + 1; q < d; ++q) {
        const T app = A[p * d + p], aqq = A[q * d + q], apq = A[p * d + q];
        const bool small = fabs(apq) <= eps * (fabs(app) + fabs(aqq));
        const T tau = T(0.5) * (aqq - app) / (small ? T(1) : apq);
        const T t = small ? T(0) : (tau >= T(0) ? T(1) : T(-1)) / (fabs(tau) + hyp(T(1), tau));
        const T ct = hyp(T(1), t);
        const T c = T(1) / ct, s = t / ct;
        __syncwarp();
        if (lane < d) {
          const T rp = A[p * d + lane], rq = A[q * d + lane];
          A[p * d + lane] = c * rp - s * rq;
          A[q * d + lane] = s * rp + c * rq;
        }
        __syncwarp();
        if (lane < d) {
          const T cp = A[lane * d + p], cq = A[lane * d + q];
          A[lane * d + p] = c * cp - s * cq;
          A[lane * d + q] = s * cp + c * cq;
          if (V) {
            const T vp = V[lane * d + p], vq = V[lane * d + q];
            V[lane * d + p] = c * vp - s * vq;
            V[lane * d + q] = s * vp + c * vq;
          }
        }
        __syncwarp();
      }
    }
  }
  if (lane < d) w[lane] = A[lane * d + lane];
  __syncwarp();
}

// the reference's relative floor of eigenvalues, in place: max(w, eps max(max w, 0), 1e-30)
template <typename T>
__device__ __noinline__ void wfloor(T* w, int d, T eps, int lane) {
  T mx = lane < d ? w[lane] : T(-INFINITY);
  mx = warp_max(mx);
  __syncwarp();
  if (lane < d) w[lane] = nan_max(nan_max(w[lane], eps * nan_max(mx, T(0))), T(1e-30));
  __syncwarp();
}

// C <- V diag(f) V' with f = w (div = false) or 1 / w (div = true), as (V * f) @ V'
template <typename T>
__device__ __noinline__ void wvdv(const T* __restrict__ V, const T* __restrict__ f, bool div, T* __restrict__ C, int d,
                     int lane) {
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, j = e - i * d;
    T acc = T(0);
    for (int k = 0; k < d; ++k) acc += (div ? V[i * d + k] / f[k] : V[i * d + k] * f[k]) * V[j * d + k];
    C[e] = acc;
  }
  __syncwarp();
}

// (X^1/2, X^-1/2) of a (nearly) PD X (destroyed) with the relative eigenvalue
// floor; either output may be null; V, w: workspace
template <typename T>
__device__ __noinline__ void wsqrt_pair(T* X, T* V, T* w, T* Xh, T* Xih, int d, T eps, int lane) {
  wjacobi(X, V, w, d, lane);
  wfloor(w, d, eps, lane);
  if (lane < d) w[lane] = sqrt(w[lane]);
  __syncwarp();
  if (Xh) wvdv(V, w, false, Xh, d, lane);
  if (Xih) wvdv(V, w, true, Xih, d, lane);
}

// ---- the team's phases (called by every thread; each ends in the team's barrier)

template <typename T, int TW>
__device__ inline T* psd_data(const Conic<T, TW>& c, int b) { return c.pdata + c.bdata[b]; }
template <typename T, int TW>
__device__ inline T* warp_ws(const Conic<T, TW>& c, int warp) {
  return c.ws + warp * (5 * c.dmax * c.dmax + c.dmax);
}

// NT scaling of the pair (s, y): w (nonneg rows, in sw), v (sw) and wb (swb)
// per soc row with eta per soc block (seta), and W_nt with its square-root
// pair per psd block
template <typename T, int TW>
__device__ __noinline__ void nt_scaling(const Conic<T, TW>& c, const T* __restrict__ s, const T* __restrict__ y) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T eps = c.eps;
  for (int b = warp; b < c.nb; b += TW) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      for (int i = lane; i < dim; i += 32) c.sw[off + i] = sqrt(s[off + i] / y[off + i]);
    } else if (c.bkind[b] == kSoc) {
      const T* sb = s + off;
      const T* yb = y + off;
      T a1 = T(0), a2 = T(0);
      for (int i = 1 + lane; i < dim; i += 32) { a1 += sb[i] * sb[i]; a2 += yb[i] * yb[i]; }
      const T ns = sqrt(warp_sum(a1)), ny = sqrt(warp_sum(a2));
      const T s0 = sb[0], y0 = yb[0];
      const T rs = sqrt(nan_max((s0 - ns) * (s0 + ns), eps * (s0 * s0)));
      const T ry = sqrt(nan_max((y0 - ny) * (y0 + ny), eps * (y0 * y0)));
      T a3 = T(0);
      for (int i = lane; i < dim; i += 32) a3 += (sb[i] / rs) * (yb[i] / ry);
      const T gamma = sqrt(nan_max((T(1) + warp_sum(a3)) / T(2), eps));
      const T wb0 = (s0 / rs + y0 / ry) / (T(2) * gamma);
      const T den = sqrt(T(2) * nan_max(wb0 + T(1), eps));
      for (int i = lane; i < dim; i += 32) {
        const T wbi = (sb[i] / rs + (i == 0 ? T(1) : T(-1)) * (yb[i] / ry)) / (T(2) * gamma);
        c.swb[off + i] = wbi;
        c.sw[off + i] = (i == 0 ? wbi + T(1) : wbi) / den;
      }
      if (lane == 0) c.seta[c.bdata[b]] = sqrt(rs / ry);
    } else {
      const int d = c.bside[b];
      T* P = psd_data(c, b);
      T* W = warp_ws(c, warp);
      const int d2 = d * d, dm2 = c.dmax * c.dmax;
      T *M0 = W, *M1 = W + dm2, *M2 = W + 2 * dm2, *M3 = W + 3 * dm2, *wv = W + 5 * dm2;
      wmat(s + off, d, M0, lane);
      wmat(y + off, d, M1, lane);
      wsqrt_pair(M0, M2, wv, M0, (T*)nullptr, d, eps, lane);  // M0 = S^1/2
      wmm(M1, false, M0, false, M3, d, lane);                 // Y S^1/2
      wmm(M0, false, M3, false, M2, d, lane);                 // Z = S^1/2 Y S^1/2
      wsym(M2, M1, d, lane);
      wsqrt_pair(M1, M2, wv, (T*)nullptr, M1, d, eps, lane);  // M1 = sym(Z)^-1/2
      wmm(M1, false, M0, false, M3, d, lane);
      wmm(M0, false, M3, false, M2, d, lane);
      wsym(M2, P, d, lane);                                   // W_nt
      for (int e = lane; e < d2; e += 32) M1[e] = P[e];
      __syncwarp();
      wsqrt_pair(M1, M2, wv, P + d2, P + 2 * d2, d, eps, lane);
    }
  }
  Team<TW>::sync();
}

// out <- W u (inv = false) or W^-1 u (inv = true), blockwise; out distinct from u
template <typename T, int TW>
__device__ __noinline__ void w_apply(const Conic<T, TW>& c, const T* __restrict__ u, T* __restrict__ out, bool inv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < c.nb; b += TW) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      for (int i = lane; i < dim; i += 32) out[off + i] = inv ? u[off + i] / c.sw[off + i] : u[off + i] * c.sw[off + i];
    } else if (c.bkind[b] == kSoc) {
      const T* v = c.sw + off;
      const T* ub = u + off;
      const T eta = c.seta[c.bdata[b]];
      T a = T(0);
      if (inv) {  // W^-1 u = (2 (Jv)(v'Ju) - Ju) / eta
        for (int i = lane; i < dim; i += 32) a += v[i] * (i == 0 ? ub[i] : -ub[i]);
        const T vju = warp_sum(a);
        for (int i = lane; i < dim; i += 32) {
          const T ju = i == 0 ? ub[i] : -ub[i];
          const T jv = i == 0 ? v[i] : -v[i];
          out[off + i] = (T(2) * jv * vju - ju) / eta;
        }
      } else {  // W u = (2 v (v'u) - Ju) eta
        for (int i = lane; i < dim; i += 32) a += v[i] * ub[i];
        const T vu = warp_sum(a);
        for (int i = lane; i < dim; i += 32) {
          const T ju = i == 0 ? ub[i] : -ub[i];
          out[off + i] = (T(2) * v[i] * vu - ju) * eta;
        }
      }
    } else {
      const int d = c.bside[b], dm2 = c.dmax * c.dmax;
      const T* Rm = psd_data(c, b) + (inv ? 2 : 1) * d * d;
      T* W = warp_ws(c, warp);
      T *M0 = W, *M1 = W + dm2, *M2 = W + 2 * dm2;
      wmat(u + off, d, M0, lane);
      wmm(M0, false, Rm, false, M1, d, lane);
      wmm(Rm, false, M1, false, M2, d, lane);
      wsvec(M2, d, out + off, lane);
    }
  }
  Team<TW>::sync();
}

// out <- u o v (Jordan product); out distinct from u and v
template <typename T, int TW>
__device__ __noinline__ void jmul(const Conic<T, TW>& c, const T* __restrict__ u, const T* __restrict__ v, T* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < c.nb; b += TW) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      for (int i = lane; i < dim; i += 32) out[off + i] = u[off + i] * v[off + i];
    } else if (c.bkind[b] == kSoc) {
      const T* ub = u + off;
      const T* vb = v + off;
      T a = T(0);
      for (int i = lane; i < dim; i += 32) a += ub[i] * vb[i];
      const T head = warp_sum(a);
      for (int i = lane; i < dim; i += 32) out[off + i] = i == 0 ? head : ub[0] * vb[i] + vb[0] * ub[i];
    } else {
      const int d = c.bside[b], dm2 = c.dmax * c.dmax;
      T* W = warp_ws(c, warp);
      T *M0 = W, *M1 = W + dm2, *M2 = W + 2 * dm2;
      wmat(u + off, d, M0, lane);
      wmat(v + off, d, M1, lane);
      wmm(M0, false, M1, false, M2, d, lane);
      wsvec(M2, d, out + off, lane);
    }
  }
  Team<TW>::sync();
}

// out <- g with lam o g = dd (arrow inverse per soc block, a Lyapunov solve in
// the stored eigenbasis of lam per psd block)
template <typename T, int TW>
__device__ __noinline__ void jsolve(const Conic<T, TW>& c, const T* __restrict__ lam, const T* __restrict__ dd, T* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T eps = c.eps;
  for (int b = warp; b < c.nb; b += TW) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      for (int i = lane; i < dim; i += 32) out[off + i] = dd[off + i] / lam[off + i];
    } else if (c.bkind[b] == kSoc) {
      const T* lb = lam + off;
      const T* db = dd + off;
      T a1 = T(0), a2 = T(0);
      for (int i = 1 + lane; i < dim; i += 32) { a1 += lb[i] * lb[i]; a2 += lb[i] * db[i]; }
      const T nl1 = sqrt(warp_sum(a1)), ld = warp_sum(a2);
      const T l0 = lb[0];
      T det = (l0 - nl1) * (l0 + nl1);
      const T floor = eps * (l0 * l0);
      det = fabs(det) > floor ? det : floor;
      const T g0 = (l0 * db[0] - ld) / det;
      for (int i = lane; i < dim; i += 32) out[off + i] = i == 0 ? g0 : (db[i] - lb[i] * g0) / l0;
    } else {
      const int d = c.bside[b], dm2 = c.dmax * c.dmax, d2 = d * d;
      const T* Q = psd_data(c, b) + 3 * d2;
      const T* w = psd_data(c, b) + 5 * d2;
      T* W = warp_ws(c, warp);
      T *M0 = W, *M1 = W + dm2, *M2 = W + 2 * dm2;
      wmat(dd + off, d, M0, lane);
      for (int e = lane; e < d2; e += 32) M0[e] = T(2) * M0[e];
      __syncwarp();
      wmm(M0, false, Q, false, M1, d, lane);  // (2 D) Q
      wmm(Q, true, M1, false, M2, d, lane);   // Q' (2 D) Q
      T mx = lane < d ? fabs(w[lane]) : T(0);
      mx = warp_max(mx);
      const T floor = eps * mx;
      for (int e = lane; e < d2; e += 32) {
        const int i = e / d, j = e - i * d;
        T den = w[i] + w[j];
        den = fabs(den) > floor ? den : floor;
        M2[e] = M2[e] / den;
      }
      __syncwarp();
      wmm(M2, false, Q, true, M1, d, lane);  // inner Q'
      wmm(Q, false, M1, false, M0, d, lane);
      wsvec(M0, d, out + off, lane);
    }
  }
  Team<TW>::sync();
}

// largest alpha in (0, 1] keeping lam + alpha du in the cone (the psd blocks
// through the stored lam^-1/2); the same value in every thread
template <typename T, int TW>
__device__ __noinline__ T max_step(const Conic<T, TW>& c, const T* __restrict__ u, const T* __restrict__ du) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T big = T(3.4e38);
  T amax = big;
  for (int b = warp; b < c.nb; b += TW) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      T a = big;
      for (int i = lane; i < dim; i += 32) a = nan_min(a, du[off + i] < T(0) ? -u[off + i] / du[off + i] : big);
      amax = nan_min(amax, warp_min(a));
    } else if (c.bkind[b] == kSoc) {
      const T* ub = u + off;
      const T* db = du + off;
      T a1 = T(0), a2 = T(0), a3 = T(0);
      for (int i = 1 + lane; i < dim; i += 32) { a1 += db[i] * db[i]; a2 += ub[i] * db[i]; a3 += ub[i] * ub[i]; }
      a1 = warp_sum(a1);
      a2 = warp_sum(a2);
      a3 = warp_sum(a3);
      const T u0 = ub[0], d0 = db[0];
      const T qa = d0 * d0 - a1;
      const T qb = T(2) * (u0 * d0 - a2);
      const T nu1 = sqrt(a3);
      const T qc = nan_max((u0 - nu1) * (u0 + nu1), T(0));
      const T disc = qb * qb - T(4) * qa * qc;
      const T sq = sqrt(nan_max(disc, T(0)));
      const bool quadratic = fabs(qa) > T(1e-30);
      const T safe_a = quadratic ? qa : T(1);
      const T r1 = (-qb - sq) / (T(2) * safe_a);
      const T r2 = (-qb + sq) / (T(2) * safe_a);
      const T rlin = qb < T(0) ? -qc / qb : big;
      const T quad = nan_min(r1 > T(0) ? r1 : big, r2 > T(0) ? r2 : big);
      const T root = quadratic ? (disc >= T(0) ? quad : big) : rlin;
      const T cap = d0 < T(0) ? -u0 / d0 : big;
      amax = nan_min(amax, nan_min(root, cap));
    } else {
      const int d = c.bside[b], dm2 = c.dmax * c.dmax, d2 = d * d;
      const T* Uih = psd_data(c, b) + 4 * d2;
      T* W = warp_ws(c, warp);
      T *M0 = W, *M1 = W + dm2, *M2 = W + 2 * dm2, *M3 = W + 3 * dm2, *wv = W + 5 * dm2;
      wmat(du + off, d, M0, lane);
      wmm(M0, false, Uih, false, M1, d, lane);
      wmm(Uih, false, M1, false, M2, d, lane);
      wsym(M2, M3, d, lane);
      wjacobi(M3, (T*)nullptr, wv, d, lane);
      T mn = lane < d ? wv[lane] : T(INFINITY);
      mn = warp_min(mn);
      amax = nan_min(amax, mn < T(0) ? T(-1) / mn : big);
    }
  }
  if (lane == 0) c.sc[sStep + warp] = amax;
  Team<TW>::sync();
  T a = c.sc[sStep];
  for (int k = 1; k < TW; ++k) a = nan_min(a, c.sc[sStep + k]);
  Team<TW>::sync();  // every thread has read the partial minima
  return nan_min(T(1), a);
}

// entry (i, k) of the block-diagonal W^2 (0 across blocks)
template <typename T, int TW>
__device__ T w2_entry(const Conic<T, TW>& c, int i, int k) {
  const int b = c.rblk[i];
  if (c.rblk[k] != b) return T(0);
  if (c.bkind[b] == kNonneg) return i == k ? c.sw[i] * c.sw[i] : T(0);
  if (c.bkind[b] == kSoc) {
    const T eta = c.seta[c.bdata[b]];
    const T J = i == k ? (c.rloc[i] == 0 ? T(1) : T(-1)) : T(0);
    return (T(2) * c.swb[i] * c.swb[k] - J) * (eta * eta);
  }
  // symmetric Kronecker square of P = W_nt: (w_a w_b / 2)(P_ik P_jl + P_il P_jk)
  const int d = c.bside[b];
  const T* P = psd_data(c, b);
  int r1, c1, r2, c2;
  tri_rc(c.rloc[i], r1, c1);
  tri_rc(c.rloc[k], r2, c2);
  const double wa = r1 == c1 ? 1.0 : sqrt(2.0), wb = r2 == c2 ? 1.0 : sqrt(2.0);
  const T coef = T(0.5 * wa * wb);
  return coef * (P[r1 * d + r2] * P[c1 * d + c2] + P[r1 * d + c2] * P[c1 * d + r2]);
}

// entry (i, k) of K = [[-W^2, AC, 0], [AC', reg I, AE'], [0, AE, -reg I]]
template <typename T, int TW>
__device__ T k_entry(const Conic<T, TW>& c, int i, int k) {
  const int mC = c.mC, n = c.n;
  if (i < mC) {
    if (k < mC) return -w2_entry(c, i, k);
    if (k < mC + n) return c.AC[i * n + (k - mC)];
    return T(0);
  }
  if (i < mC + n) {
    const int j = i - mC;
    if (k < mC) return c.AC[k * n + j];
    if (k < mC + n) return k == i ? c.reg : T(0);
    return c.AE[(k - mC - n) * n + j];
  }
  if (k < mC) return T(0);
  if (k < mC + n) return c.AE[(i - mC - n) * n + (k - mC)];
  return k == i ? -c.reg : T(0);
}

// res <- rhs - K sol, one thread per row, from the blocks of K
template <typename T, int TW>
__device__ __noinline__ void k_residual(const Conic<T, TW>& c) {
  const int mC = c.mC, n = c.n, p = c.p;
  for (int i = threadIdx.x; i < c.N; i += 32 * TW) {
    T acc = T(0);
    if (i < mC) {
      const int b = c.rblk[i], off = c.boff[b], dim = c.bdim[b];
      for (int k = off; k < off + dim; ++k) acc += -w2_entry(c, i, k) * c.sol[k];
      for (int j = 0; j < n; ++j) acc += c.AC[i * n + j] * c.sol[mC + j];
    } else if (i < mC + n) {
      const int j = i - mC;
      for (int k = 0; k < mC; ++k) acc += c.AC[k * n + j] * c.sol[k];
      acc += c.reg * c.sol[i];
      for (int e = 0; e < p; ++e) acc += c.AE[e * n + j] * c.sol[mC + n + e];
    } else {
      const int e = i - mC - n;
      for (int j = 0; j < n; ++j) acc += c.AE[e * n + j] * c.sol[mC + j];
      acc += -c.reg * c.sol[i];
    }
    c.res[i] = c.rhs[i] - acc;
  }
  Team<TW>::sync();
}

// Newton direction for the scaled complementarity target g (ready): rhs =
// [-rpC + W g, -rd, -rpE], LDL' solve with c.passes refinement passes against
// K, then ds = -W (g + W dyC)
template <typename T, int TW>
__device__ __noinline__ void solve_dir(const Conic<T, TW>& c, const T* g, T* dx, T* dyE, T* dyC, T* ds) {
  const int mC = c.mC, n = c.n, N = c.N;
  w_apply(c, g, c.t1, false);
  for (int i = threadIdx.x; i < N; i += 32 * TW) {
    const T v = i < mC ? -c.rpC[i] + c.t1[i] : (i < mC + n ? -c.rd[i - mC] : -c.rpE[i - mC - n]);
    c.rhs[i] = v;
    c.sol[i] = v;
  }
  Team<TW>::sync();
  ldl_solve_warp0(c, c.sol);
  for (int pass = 0; pass < c.passes; ++pass) {
    k_residual(c);
    ldl_solve_warp0(c, c.res);
    for (int i = threadIdx.x; i < N; i += 32 * TW) c.sol[i] += c.res[i];
    Team<TW>::sync();
  }
  for (int i = threadIdx.x; i < N; i += 32 * TW) {
    const T v = c.sol[i];
    if (i < mC) dyC[i] = v;
    else if (i < mC + n) dx[i - mC] = v;
    else dyE[i - mC - n] = v;
  }
  Team<TW>::sync();
  w_apply(c, dyC, c.t1, false);
  for (int i = threadIdx.x; i < mC; i += 32 * TW) c.t2[i] = g[i] + c.t1[i];
  Team<TW>::sync();
  w_apply(c, c.t2, c.t1, false);
  for (int i = threadIdx.x; i < mC; i += 32 * TW) ds[i] = -c.t1[i];
  Team<TW>::sync();
}

// one eigendecomposition per psd block of lam: Q, w and lam^-1/2 into the block's data
template <typename T, int TW>
__device__ __noinline__ void lam_eigs(const Conic<T, TW>& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < c.nb; b += TW) {
    if (c.bkind[b] != kPsd) continue;
    const int d = c.bside[b], d2 = d * d, dm2 = c.dmax * c.dmax;
    T* P = psd_data(c, b);
    T *Q = P + 3 * d2, *Lisq = P + 4 * d2, *w = P + 5 * d2;
    T* W = warp_ws(c, warp);
    T *M0 = W, *wv = W + 5 * dm2;
    wmat(c.lam + c.boff[b], d, M0, lane);
    wjacobi(M0, Q, w, d, lane);
    if (lane < d) wv[lane] = w[lane];
    __syncwarp();
    wfloor(wv, d, c.eps, lane);
    if (lane < d) wv[lane] = sqrt(wv[lane]);
    __syncwarp();
    wvdv(Q, wv, true, Lisq, d, lane);
  }
  Team<TW>::sync();
}

// Resident teams per SM that the registers must allow: as many as shared
// memory holds at the SOCP (f32: 9 KB an instance) and SDP layouts for the
// teams of one and two warps (a thread gets at most 80 registers in f32, 168
// in f64); the eight-warp team keeps two blocks per SM (128 registers a
// thread), which its tiled factorisation at 128 rows in f64 needs.
// DK_CONIC_F32_BLOCKS sets the f32 count for an experiment
// (tools/k6_registers.py); the package's build keeps 24.
#ifndef DK_CONIC_F32_BLOCKS
#define DK_CONIC_F32_BLOCKS 24
#endif
template <typename T, int TW>
constexpr int conic_min_blocks() { return TW == 8 ? 2 : (sizeof(T) == 4 ? DK_CONIC_F32_BLOCKS : 12) / TW; }

template <typename T, int TW>
__global__ void __launch_bounds__(32 * TW, conic_min_blocks<T, TW>())
conic_kernel(const T* __restrict__ cg, const T* __restrict__ bEg, const T* __restrict__ bCg,
             const T* __restrict__ AEg, const T* __restrict__ ACg, T* __restrict__ x_out,
             T* __restrict__ yE_out, T* __restrict__ yC_out, T* __restrict__ s_out, int* __restrict__ it_out,
             T* __restrict__ pres_out, T* __restrict__ dres_out, const Layout lay, int iters, T tol, T reg,
             T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Conic<T, TW> cs;
  constexpr int kTeamThreads = 32 * TW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t inst = blockIdx.x;
  const int n = lay.n, p = lay.p, l = lay.l, mC = conic_mC(lay), N = n + p + mC;
  const int nb = conic_nblocks(lay), dmax = conic_dmax(lay);
  int* ints = reinterpret_cast<int*>(smem_raw);
  T* w = reinterpret_cast<T*>(smem_raw + conic_int_bytes(lay));
  auto take = [&w](size_t count) { T* r = w; w += count; return r; };
  DK_PROF_START();
#ifdef DK_PROFILE
  const long long tstart_ = t0_;
#endif

  if (tid == 0) {
    Conic<T, TW>& c = cs;
    c.n = n; c.p = p; c.mC = mC; c.N = N; c.ld = odd_stride(N); c.nb = nb; c.dmax = dmax;
    c.passes = lay.npsd ? 2 : 1;
    c.reg = reg; c.eps = eps;
    int deg = l + lay.nsoc;
    for (int k = 0; k < lay.npsd; ++k) deg += lay.psd_side[k];
    c.nu_deg = T(deg > 1 ? deg : 1);
    int* bk = ints; int* bo = bk + nb; int* bd = bo + nb; int* bs = bd + nb; int* bx = bs + nb;
    int* rb = bx + nb; int* rl = rb + mC;
    c.bkind = bk; c.boff = bo; c.bdim = bd; c.bside = bs; c.bdata = bx; c.rblk = rb; c.rloc = rl;
    int b = 0, off = 0, pdat = 0;
    if (l) { bk[b] = kNonneg; bo[b] = 0; bd[b] = l; bs[b] = 0; bx[b] = 0; ++b; off = l; }
    for (int k = 0; k < lay.nsoc; ++k, ++b) {
      bk[b] = kSoc; bo[b] = off; bd[b] = lay.soc_dim[k]; bs[b] = 0; bx[b] = k; off += lay.soc_dim[k];
    }
    for (int k = 0; k < lay.npsd; ++k, ++b) {
      const int d = lay.psd_side[k];
      bk[b] = kPsd; bo[b] = off; bd[b] = d * (d + 1) / 2; bs[b] = d; bx[b] = pdat;
      off += d * (d + 1) / 2; pdat += 5 * d * d + d;
    }
    for (int bb = 0; bb < nb; ++bb)
      for (int i = 0; i < bd[bb]; ++i) { rb[bo[bb] + i] = bb; rl[bo[bb] + i] = i; }
    c.AC = take(size_t(mC) * n); c.AE = take(size_t(p) * n); c.c = take(n); c.bE = take(p); c.bC = take(mC);
    c.x = take(n); c.xb = take(n); c.rd = take(n); c.dx = take(n);
    c.yE = take(p); c.yEb = take(p); c.rpE = take(p); c.dyE = take(p);
    c.yC = take(mC); c.s = take(mC); c.yCb = take(mC); c.sb = take(mC); c.rpC = take(mC); c.dyC = take(mC);
    c.ds = take(mC); c.dsa = take(mC); c.dyCa = take(mC); c.lam = take(mC); c.dsa_s = take(mC);
    c.dya_s = take(mC); c.comp = take(mC); c.g = take(mC); c.t1 = take(mC); c.t2 = take(mC); c.e = take(mC);
    c.sw = take(mC); c.swb = take(mC); c.seta = take(mC);
    c.rhs = take(N); c.sol = take(N); c.res = take(N); c.dvec = take(N);
    c.L = take(size_t(N) * c.ld);
    c.colbuf = take(colbuf_words(TW)); c.sc = take(kConicSlots);
    c.pdata = take(pdat);
    c.ws = take(size_t(TW) * (5 * dmax * dmax + dmax));
  }
  Team<TW>::sync();
  const Conic<T, TW>& c = cs;

  for (int i = tid; i < mC * n; i += kTeamThreads) c.AC[i] = ACg[inst * mC * n + i];
  for (int i = tid; i < p * n; i += kTeamThreads) c.AE[i] = AEg[inst * p * n + i];
  for (int j = tid; j < n; j += kTeamThreads) c.c[j] = cg[inst * n + j];
  for (int k = tid; k < p; k += kTeamThreads) c.bE[k] = bEg[inst * p + k];
  for (int i = tid; i < mC; i += kTeamThreads) {
    c.bC[i] = bCg[inst * mC + i];
    const int b = c.rblk[i], loc = c.rloc[i];
    T e = T(0);
    if (c.bkind[b] == kNonneg) e = T(1);
    else if (c.bkind[b] == kSoc) e = loc == 0 ? T(1) : T(0);
    else { int r, cc; tri_rc(loc, r, cc); e = r == cc ? T(1) : T(0); }
    c.e[i] = e;
  }
  Team<TW>::sync();

  // ---- init: identity scaling, one solve from the zero iterate, then a
  // per-block shift of s0 = bC - AC x into the interior; yC = e -------------
  nt_scaling(c, c.e, c.e);
  factor(c);
  for (int j = tid; j < n; j += kTeamThreads) c.rd[j] = c.c[j];
  for (int k = tid; k < p; k += kTeamThreads) c.rpE[k] = -c.bE[k];
  for (int i = tid; i < mC; i += kTeamThreads) { c.rpC[i] = -c.bC[i]; c.g[i] = -c.e[i]; }
  Team<TW>::sync();
  solve_dir(c, c.g, c.dx, c.dyE, c.dyC, c.ds);
  for (int j = tid; j < n; j += kTeamThreads) c.x[j] = c.dx[j];
  for (int k = tid; k < p; k += kTeamThreads) c.yE[k] = c.dyE[k];
  Team<TW>::sync();
  for (int i = tid; i < mC; i += kTeamThreads) {
    T a = T(0);
    for (int j = 0; j < n; ++j) a += c.AC[i * n + j] * c.x[j];
    c.s[i] = c.bC[i] - a;
  }
  Team<TW>::sync();
  for (int b = warp; b < nb; b += TW) {
    const int off = c.boff[b], dim = c.bdim[b];
    T* sb = c.s + off;
    if (c.bkind[b] == kNonneg) {
      T mn = T(INFINITY);
      for (int i = lane; i < dim; i += 32) mn = nan_min(mn, sb[i]);
      const T sh = nan_max(T(0), T(-1.5) * warp_min(mn)) + T(1);
      __syncwarp();
      for (int i = lane; i < dim; i += 32) sb[i] = sb[i] + sh;
    } else if (c.bkind[b] == kSoc) {
      T a = T(0);
      for (int i = 1 + lane; i < dim; i += 32) a += sb[i] * sb[i];
      const T excess = sqrt(warp_sum(a)) - sb[0];
      const T sh = nan_max(T(0), T(1.5) * excess) + T(1);
      __syncwarp();
      if (lane == 0) sb[0] = sb[0] + sh;
    } else {
      const int d = c.bside[b], dm2 = c.dmax * c.dmax;
      T* W = warp_ws(c, warp);
      T *M0 = W, *wv = W + 5 * dm2;
      wmat(sb, d, M0, lane);
      wjacobi(M0, (T*)nullptr, wv, d, lane);
      T mn = lane < d ? wv[lane] : T(INFINITY);
      const T sh = nan_max(T(0), T(-1.5) * warp_min(mn)) + T(1);
      for (int i = lane; i < dim; i += 32) sb[i] = sb[i] + sh * c.e[off + i];
    }
    __syncwarp();
  }
  Team<TW>::sync();
  for (int i = tid; i < mC; i += kTeamThreads) { c.yC[i] = c.e[i]; c.yCb[i] = c.e[i]; c.sb[i] = c.s[i]; }
  for (int j = tid; j < n; j += kTeamThreads) c.xb[j] = c.x[j];
  for (int k = tid; k < p; k += kTeamThreads) c.yEb[k] = c.yE[k];
  Team<TW>::sync();
  DK_PROF(kProfInit);

  // ---- main loop: every scalar below is the same in every thread ----------
  T errb = T(1e30), mu_prev = T(1e30), err_prev = T(1e30);
  int stall = 0, itdone = -1, own = iters, it = 0;
  for (; it < iters; ++it) {
    const Metrics<T> m = metrics(c);
    DK_PROF(kProfMetrics);
    const bool done = m.pres < tol && m.dres < tol && m.gaprel < tol;
    const T err = nan_max(nan_max(m.pres, m.dres), m.gaprel);
    if (err < errb) {  // best-iterate tracking
      errb = err;
      for (int j = tid; j < n; j += kTeamThreads) c.xb[j] = c.x[j];
      for (int k = tid; k < p; k += kTeamThreads) c.yEb[k] = c.yE[k];
      for (int i = tid; i < mC; i += kTeamThreads) { c.yCb[i] = c.yC[i]; c.sb[i] = c.s[i]; }
    }
    // stall exit: five consecutive iterations without 2% progress on mu and err
    stall = (m.mu > T(0.98) * mu_prev && err > T(0.98) * err_prev) ? stall + 1 : 0;
    const bool dead = m.mu <= T(0);  // complementarity collapsed: the scaling is meaningless
    if (done || stall >= 5 || dead) {
      if (done) itdone = it;
      own = it + 1;
      break;
    }

    nt_scaling(c, c.s, c.yC);
    DK_PROF(kProfNt);
    factor(c);
    DK_PROF(kProfFactor);
    w_apply(c, c.s, c.lam, true);
    DK_PROF(kProfWApply);
    lam_eigs(c);
    DK_PROF(kProfLamEigs);

    // predictor: g = lam
    solve_dir(c, c.lam, c.dx, c.dyE, c.dyCa, c.dsa);
    DK_PROF(kProfSolvePred);
    w_apply(c, c.dsa, c.dsa_s, true);
    w_apply(c, c.dyCa, c.dya_s, false);
    const T a_p = max_step(c, c.lam, c.dsa_s);
    const T a_d = max_step(c, c.lam, c.dya_s);
    if (warp == 0) {
      T a = T(0);
      for (int i = lane; i < mC; i += 32) a += (c.s[i] + a_p * c.dsa[i]) * (c.yC[i] + a_d * c.dyCa[i]);
      a = warp_sum(a);
      if (lane == 0) c.sc[sMuAff] = a / c.nu_deg;
    }
    Team<TW>::sync();
    const T ratio = c.sc[sMuAff] / nan_max(m.mu, T(1e-30));
    const T sigma = nan_min(nan_max(ratio * ratio * ratio, T(0)), T(1));
    DK_PROF(kProfStepPred);

    // corrector with the Mehrotra second-order term in the scaled variables
    jmul(c, c.lam, c.lam, c.t1);
    jmul(c, c.dsa_s, c.dya_s, c.t2);
    for (int i = tid; i < mC; i += kTeamThreads) c.comp[i] = c.t1[i] + c.t2[i] - (sigma * m.mu) * c.e[i];
    Team<TW>::sync();
    jsolve(c, c.lam, c.comp, c.g);
    DK_PROF(kProfJordan);
    solve_dir(c, c.g, c.dx, c.dyE, c.dyC, c.ds);
    DK_PROF(kProfSolveCorr);
    w_apply(c, c.ds, c.dsa_s, true);
    const T a1 = max_step(c, c.lam, c.dsa_s);
    w_apply(c, c.dyC, c.dya_s, false);
    const T a2 = max_step(c, c.lam, c.dya_s);
    T alpha = nan_min(T(0.99) * nan_min(a1, a2), T(1));
    DK_PROF(kProfStepCorr);

    const bool bad = any_nonfinite<Team<TW>>(c.dx, n, c.dyC, mC, c.ds, mC, c.dyE, p) || !isfinite(alpha);
    if (bad) {
      own = it + 1;
      break;
    }
    alpha = nan_max(alpha, T(0));
    for (int j = tid; j < n; j += kTeamThreads) c.x[j] += alpha * c.dx[j];
    for (int k = tid; k < p; k += kTeamThreads) c.yE[k] += alpha * c.dyE[k];
    for (int i = tid; i < mC; i += kTeamThreads) { c.yC[i] += alpha * c.dyC[i]; c.s[i] += alpha * c.ds[i]; }
    Team<TW>::sync();
    DK_PROF(kProfUpdate);
    mu_prev = m.mu;
    err_prev = err;
  }
  Team<TW>::sync();

  // ---- the exit state never got a best-update inside the loop: score it ----
  {
    const Metrics<T> m = metrics(c);
    const T err = nan_max(nan_max(m.pres, m.dres), m.gaprel);
    const bool fin = !any_nonfinite<Team<TW>>(c.x, n, c.yC, mC, c.x, 0, c.x, 0);
    if (!(err < errb && fin)) {
      for (int j = tid; j < n; j += kTeamThreads) c.x[j] = c.xb[j];
      for (int k = tid; k < p; k += kTeamThreads) c.yE[k] = c.yEb[k];
      for (int i = tid; i < mC; i += kTeamThreads) { c.yC[i] = c.yCb[i]; c.s[i] = c.sb[i]; }
    }
    Team<TW>::sync();
  }
  // the metrics OF THE RETURNED STATE
  const Metrics<T> m = metrics(c);
  for (int j = tid; j < n; j += kTeamThreads) x_out[inst * n + j] = c.x[j];
  for (int k = tid; k < p; k += kTeamThreads) yE_out[inst * p + k] = c.yE[k];
  for (int i = tid; i < mC; i += kTeamThreads) {
    yC_out[inst * mC + i] = c.yC[i];
    s_out[inst * mC + i] = c.s[i];
  }
  if (tid == 0) {
    it_out[inst] = itdone >= 0 ? itdone : own;
    pres_out[inst] = m.pres;
    dres_out[inst] = m.dres;
  }
  DK_PROF(kProfExit);
#ifdef DK_PROFILE
  if (tid == 0) {
    DK_PROF_ADD(kProfTotal, clock64() - tstart_);
    DK_PROF_ADD(kProfBodies, it);
  }
#endif
}

inline bool make_layout(Layout& lay, int n, int p, int l, int nsoc, const int* soc_dims, int npsd,
                        const int* psd_sides) {
  if (nsoc < 0 || nsoc > kMaxSoc || npsd < 0 || npsd > kMaxPsd) return false;
  lay.n = n; lay.p = p; lay.l = l; lay.nsoc = nsoc; lay.npsd = npsd;
  for (int k = 0; k < nsoc; ++k) {
    if (soc_dims[k] < 1) return false;
    lay.soc_dim[k] = short(soc_dims[k]);
  }
  for (int k = 0; k < npsd; ++k) {
    if (psd_sides[k] < 1 || psd_sides[k] > kMaxSide) return false;
    lay.psd_side[k] = short(psd_sides[k]);
  }
  return true;
}

// Room for the kernel's static shared memory (its pointer table Conic<T, TW>),
// mirrored by ops/cuda/conic_pdip.py
constexpr size_t kStaticSmem = 1024;
static_assert(sizeof(Conic<double, 8>) <= kStaticSmem, "the pointer table outgrew its room");

// Whether a team of tw warps takes the layout: K's rows in the team's register
// tiles, its working set in one block's shared memory
inline bool conic_team_takes(const Layout& lay, int itemsize, int tw) {
  const int N = lay.n + lay.p + conic_mC(lay);
  return (tw == 1 || tw == 2 || tw == 8) && N <= tile_max_n(tw) &&
         conic_smem_bytes(lay, itemsize, tw) + kStaticSmem <= kMaxSmemBytes;
}

// The launch rule (mirrored by ops/cuda/conic_pdip.py::team_for): the smallest
// team that takes the layout; 0 if none does
inline int conic_team(const Layout& lay, int itemsize) {
  for (int tw : kTeams)
    if (conic_team_takes(lay, itemsize, tw)) return tw;
  return 0;
}

template <typename T>
int launch_conic(const void* c, const void* bE, const void* bC, const void* AE, const void* AC, void* x,
                 void* yE, void* yC, void* s, void* it, void* pres, void* dres, int B, int n, int p, int l,
                 int nsoc, const int* soc_dims, int npsd, const int* psd_sides, int iters, double tol,
                 double reg, double eps, int team, void* stream) {
  Layout lay;
  if (!make_layout(lay, n, p, l, nsoc, soc_dims, npsd, psd_sides)) return int(cudaErrorInvalidValue);
  if (B <= 0 || n <= 0 || p < 0 || l < 0 || conic_mC(lay) <= 0) return int(cudaErrorInvalidValue);
  const int tw = team ? team : conic_team(lay, int(sizeof(T)));
  if (!conic_team_takes(lay, int(sizeof(T)), tw)) return int(cudaErrorInvalidValue);  // refused: no other team
  return with_team(tw, [&](auto tc) {
    constexpr int TW = decltype(tc)::value;
    const size_t smem = conic_smem_bytes(lay, int(sizeof(T)), TW);
    cudaError_t e = smem_attributes(conic_kernel<T, TW>, smem);
    if (e != cudaSuccess) return int(e);
    conic_kernel<T, TW><<<B, 32 * TW, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(c), static_cast<const T*>(bE), static_cast<const T*>(bC),
        static_cast<const T*>(AE), static_cast<const T*>(AC), static_cast<T*>(x), static_cast<T*>(yE),
        static_cast<T*>(yC), static_cast<T*>(s), static_cast<int*>(it), static_cast<T*>(pres),
        static_cast<T*>(dres), lay, iters, T(tol), T(reg), T(eps));
    return int(cudaGetLastError());
  });
}

// teams of tw warps resident on one SM for the layout (registers, shared memory
// and the SM's block and warp limits together); a negative CUDA error code on failure
template <typename T>
int conic_blocks_per_sm(const Layout& lay, int tw) {
  if (!conic_team_takes(lay, int(sizeof(T)), tw)) return -int(cudaErrorInvalidValue);
  return with_team(tw, [&](auto tc) {
    constexpr int TW = decltype(tc)::value;
    const size_t smem = conic_smem_bytes(lay, int(sizeof(T)), TW);
    cudaError_t e = smem_attributes(conic_kernel<T, TW>, smem);
    int blocks = 0;
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, conic_kernel<T, TW>, 32 * TW, smem);
    return e == cudaSuccess ? blocks : -int(e);
  });
}

}  // namespace dk

extern "C" {

#ifdef DK_PROFILE
int conic_pdip_prof_read(unsigned long long* out) { return dk::prof_read(out); }
int conic_pdip_prof_zero() { return dk::prof_zero(); }
#endif

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dynamic shared memory a team of `team` warps needs, in bytes (itemsize 4 or 8); -1 for a layout it refuses.
long long conic_pdip_smem_bytes(int n, int p, int l, int nsoc, const int* soc_dims, int npsd,
                                const int* psd_sides, int itemsize, int team) {
  dk::Layout lay;
  if (!dk::make_layout(lay, n, p, l, nsoc, soc_dims, npsd, psd_sides)) return -1;
  return (long long)dk::conic_smem_bytes(lay, itemsize, team);
}

// The team the launch rule picks for the layout (1, 2 or 8 warps); 0 where none takes it, -1 for a bad layout.
int conic_pdip_team(int n, int p, int l, int nsoc, const int* soc_dims, int npsd, const int* psd_sides,
                    int itemsize) {
  dk::Layout lay;
  if (!dk::make_layout(lay, n, p, l, nsoc, soc_dims, npsd, psd_sides)) return -1;
  return dk::conic_team(lay, itemsize);
}

// Teams of `team` warps resident per SM for the layout; a negative CUDA error code where it cannot launch.
int conic_pdip_blocks_per_sm(int n, int p, int l, int nsoc, const int* soc_dims, int npsd, const int* psd_sides,
                             int itemsize, int team) {
  dk::Layout lay;
  if (!dk::make_layout(lay, n, p, l, nsoc, soc_dims, npsd, psd_sides)) return -int(cudaErrorInvalidValue);
  return itemsize == 4 ? dk::conic_blocks_per_sm<float>(lay, team) : dk::conic_blocks_per_sm<double>(lay, team);
}

// team: 1, 2 or 8 warps per instance, or 0 for the launch rule's choice; a team that does not take the
// layout is refused (cudaErrorInvalidValue), never replaced by another.
int conic_pdip_f32(const void* c, const void* bE, const void* bC, const void* AE, const void* AC, void* x,
                   void* yE, void* yC, void* s, void* it, void* pres, void* dres, int B, int n, int p, int l,
                   int nsoc, const int* soc_dims, int npsd, const int* psd_sides, int iters, double tol,
                   double reg, double eps, int team, void* stream) {
  return dk::launch_conic<float>(c, bE, bC, AE, AC, x, yE, yC, s, it, pres, dres, B, n, p, l, nsoc, soc_dims,
                                 npsd, psd_sides, iters, tol, reg, eps, team, stream);
}
int conic_pdip_f64(const void* c, const void* bE, const void* bC, const void* AE, const void* AC, void* x,
                   void* yE, void* yC, void* s, void* it, void* pres, void* dres, int B, int n, int p, int l,
                   int nsoc, const int* soc_dims, int npsd, const int* psd_sides, int iters, double tol,
                   double reg, double eps, int team, void* stream) {
  return dk::launch_conic<double>(c, bE, bC, AE, AC, x, yE, yC, s, it, pres, dres, B, n, p, l, nsoc, soc_dims,
                                  npsd, psd_sides, iters, tol, reg, eps, team, stream);
}

}  // extern "C"
