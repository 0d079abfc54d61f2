// Fused batched nonsymmetric-cone interior-point solver: the whole
// dual-scaling Mehrotra predictor-corrector loop for
//     min c'x  s.t.  AE x = bE,  AC x + s = bC,  s in K = nonneg(l) x soc(d_1..) x ns_1 x ...
// with each ns block an exp, dual_exp, pow(alpha) or dual_pow(alpha) cone of
// dimension 3, in one kernel, one thread block per instance.
//
// Replaces diffopt_tpu/ops/pallas/ns_pdip.py::solve_tile_fused_ns (kernel body
// _kernel). The TPU kernel puts 128 instances along the vector lanes and
// freezes finished lanes by select; here every per-lane quantity (done,
// stalled, dead, finite, errb, itdone, the step lengths) is a per-block scalar
// and a frozen instance leaves its loop: a frozen lane keeps its state, so the
// result is the same. The arithmetic, constants and exit rules are the
// reference's: closed-form barrier gradients and Hessians per ns block with a
// relative floor on the margin, Hbar = mu hess F(s) and its inverse (diagonal
// per nonneg row, s s' - (det/2) J per soc block, a floored 3x3 Jacobi
// eigendecomposition per ns block), the Newton matrix
// K = [[-Hbar^-1, AC, 0], [AC', reg I, AE'], [0, AE, -reg I]] in
// [cone | x | eq] order factored by unpivoted LDL', the affine probe (no
// refinement, 9 grid points, feasibility only), the predictor with one
// refinement pass against the unsquared block system and an 18-point search
// under the proximity test prox^2 <= (0.9 mu)^2, a pure-centering step (7
// points, least prox^2 / mu^2) where the predictor's step is below 0.05,
// scale-relative metrics tested before the step, best-iterate tracking, a
// stall exit after five bodies without 2% progress on mu and the error, a
// mu <= 0 freeze and a non-finite guard.
//
// Bound on an H100: operations. An instance reads (p + mC)(n + 1) + n words
// once; a body does the LDL' of N = n + p + mC, four direction solves, three
// Jacobi sweeps' worth of 3x3 rotations per ns block and 34 line-search
// candidates, each a pass over the cone with a log or two per ns block. The
// critical path is sequential (N elimination steps with one block barrier
// each, 2 N substitution steps per solve on one warp), so everything stays in
// shared memory or registers: K is assembled straight into dense.cuh's
// register tiles from the per-block data (the -Hbar^-1 block never stored
// whole), each ns block's Hessian, eigendecomposition and inverse run on one
// thread, and the line-search candidates are evaluated side by side, one per
// lane of warp 0, each over the whole cone with its point s + a ds computed as
// it is read; the step is then chosen in grid order, which gives the
// reference's choice whatever the order of evaluation. No fast-math: a
// __expf-class shortcut would move which candidates pass the interiority
// test near the boundary. And no contraction of a * b + c into fused
// multiply-adds (-fmad=false, ops/cuda/_build.py::SOURCE_FLAGS): the iterates
// ride the proximity neighbourhood's edge, and the fused rounding tipped its
// test one way often enough to cost 0.9 bodies on average on a dual_exp
// family against the plain version's separate operations.
//
// Envelope: N = n + p + mC <= 128 (register tiles), at most kMaxSoc soc and
// kMaxNs ns blocks, ns_smem_bytes(...) <= 227 KB less the static pointer
// table.
#include "ipm.cuh"

namespace dk {

constexpr int kMaxSoc = 128;
constexpr int kMaxNs = 42;
constexpr int kNsSlots = 64;
constexpr int kPredGrid = 18;
constexpr int kCentGrid = 7;
enum NsBlockKind { kNonneg = 0, kSoc = 1, kNs = 2 };
enum NsKind { kExp = 0, kDualExp = 1, kPow = 2, kDualPow = 3 };
// scalar slots in shared memory, after the metrics' IpmSlot: the line-search candidates' results
enum NsSlot { sCand = 32 };

struct NsLayout {
  int n, p, l, nsoc, nns;
  short soc_dim[kMaxSoc];
  int ns_kind[kMaxNs];
  double ns_alpha[kMaxNs];
  double ns_s0[3 * kMaxNs];
  double pred[kPredGrid];
};

__host__ __device__ inline int ns_mC(const NsLayout& L) {
  int m = L.l + 3 * L.nns;
  for (int k = 0; k < L.nsoc; ++k) m += L.soc_dim[k];
  return m;
}

__host__ __device__ inline int ns_nblocks(const NsLayout& L) { return (L.l ? 1 : 0) + L.nsoc + L.nns; }

__host__ __device__ inline size_t ns_int_bytes(const NsLayout& L) {
  const size_t ints = 4 * size_t(ns_nblocks(L)) + 2 * size_t(ns_mC(L));
  return (ints * 4 + 15) / 16 * 16;
}

// words of the working type (mirrored by ops/cuda/ns_pdip.py::smem_bytes)
__host__ __device__ inline size_t ns_words(const NsLayout& L) {
  const size_t n = L.n, p = L.p, mC = ns_mC(L), N = n + p + mC;
  size_t w = mC * n + p * n + n + p + mC + 7 * n + 7 * p + 17 * mC + 3 * N + N * odd_stride(int(N));
  w += size_t(L.nsoc) + 18 * size_t(L.nns) + kColbufWords + kNsSlots;
  return w;
}

// the exponents of the ns blocks sit in doubles after the ints (constants are formed in double, as
// the reference forms them from its Python floats)
__host__ __device__ inline size_t ns_double_bytes(const NsLayout& L) { return (size_t(L.nns) * 8 + 15) / 16 * 16; }

__host__ __device__ inline size_t ns_smem_bytes(const NsLayout& L, int itemsize) {
  return ns_int_bytes(L) + ns_double_bytes(L) + ns_words(L) * size_t(itemsize);
}

template <typename T>
struct NsIpm {
  using Real = T;
  int n, p, mC, N, ld, nb, nsoc, nns, l;
  T reg, eps, nu_deg, beta;
  const int *bkind, *boff, *bdim, *bidx;  // per cone block: nonneg (if any), socs, ns blocks
  const int *rblk, *rloc;                 // per cone row: its block and its index in it
  const int* nskind;                      // per ns block (in the layout)
  const double* nsalpha;
  T *AC, *AE, *c, *bE, *bC;
  T *x, *xb, *rd, *dx, *tdx, *cx, *r1;    // n words each
  T *yE, *yEb, *rpE, *dyE, *tdyE, *cyE, *r2;  // p words each
  T *yC, *s, *yCb, *sb, *rpC, *gradF, *g, *dyC, *ds, *dyCa, *dsa, *cyC, *cs, *r3, *r4, *t1, *t2;  // mC each
  T *rhs, *sol, *dvec;                    // N words each
  T *L;                                   // N x ld, the LDL' factor (strict lower triangle)
  T *sdet;                                // per soc block: its floored Jordan determinant
  T *nsH;                                 // per ns block: mu hess F (9 words), then hess F^-1 / mu (9)
  T *colbuf, *sc;
  T pred[kPredGrid];
  T mu;                                   // of the current body
};

__device__ inline int dual_kind(int k) { return k ^ 1; }  // exp <-> dual_exp, pow <-> dual_pow

// ---- one 3-dim block (one thread) ---------------------------------------------

// relative floor of a margin: max(g, eps (|u0| + |u1| + |u2|))
template <typename T>
__device__ inline T safe_margin(T g, const T* u, T eps) {
  return nan_max(g, eps * ((fabs(u[0]) + fabs(u[1])) + fabs(u[2])));
}

// grad F (gr) and, if H is given, hess F of one ns block at u; the closed forms of ns_pdip.py::_ns_parts
template <typename T>
__device__ void ns_grad_hess(int kind, double a, const T* u, T eps, T* gr, T (*H)[3]) {
  T g, dg[3], d2[3][3] = {{T(0), T(0), T(0)}, {T(0), T(0), T(0)}, {T(0), T(0), T(0)}};
  bool has2[3][3] = {{false, false, false}, {false, false, false}, {false, false, false}};
  T dl[3] = {T(0), T(0), T(0)}, hl[3] = {T(0), T(0), T(0)};
  bool hasl[3] = {false, false, false};
  if (kind == kExp) {
    const T x = u[0], y = u[1], z = u[2];
    const T Lg = log(z / y);
    g = safe_margin(y * Lg - x, u, eps);
    dg[0] = T(-1); dg[1] = Lg - T(1); dg[2] = y / z;
    d2[1][1] = T(-1) / y; d2[1][2] = T(1) / z; d2[2][2] = -y / (z * z);
    has2[1][1] = has2[1][2] = has2[2][2] = true;
    dl[1] = T(-1) / y; dl[2] = T(-1) / z; hl[1] = T(1) / (y * y); hl[2] = T(1) / (z * z);
    hasl[1] = hasl[2] = true;
  } else if (kind == kDualExp) {
    const T t = -u[0], v = u[1], w = u[2];
    const T M = log(w / t);
    g = safe_margin(v + t + t * M, u, eps);
    dg[0] = -M; dg[1] = T(1); dg[2] = t / w;
    d2[0][0] = T(-1) / t; d2[0][2] = T(-1) / w; d2[2][2] = -t / (w * w);
    has2[0][0] = has2[0][2] = has2[2][2] = true;
    dl[0] = T(1) / t; dl[2] = T(-1) / w; hl[0] = T(1) / (t * t); hl[2] = T(1) / (w * w);
    hasl[0] = hasl[2] = true;
  } else {
    const T x = u[0], y = u[1], z = u[2];
    const T P = kind == kPow ? exp(T(2 * a) * log(x) + T(2 * (1 - a)) * log(y))
                             : exp(T(2 * a) * log(x / T(a)) + T(2 * (1 - a)) * log(y / T(1 - a)));
    g = safe_margin(P - z * z, u, eps);
    dg[0] = T(2 * a) * P / x; dg[1] = T(2 * (1 - a)) * P / y; dg[2] = T(-2) * z;
    d2[0][0] = T(2 * a * (2 * a - 1)) * P / (x * x);
    d2[0][1] = T(4 * a * (1 - a)) * P / (x * y);
    d2[1][1] = T(2 * (1 - a) * (1 - 2 * a)) * P / (y * y);
    d2[2][2] = T(-2);
    has2[0][0] = has2[0][1] = has2[1][1] = has2[2][2] = true;
    dl[0] = T(-(1 - a)) / x; dl[1] = T(-a) / y; hl[0] = T(1 - a) / (x * x); hl[1] = T(a) / (y * y);
    hasl[0] = hasl[1] = true;
  }
  for (int i = 0; i < 3; ++i) gr[i] = hasl[i] ? -dg[i] / g + dl[i] : -dg[i] / g;
  if (H) {
    const T gg = g * g;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const int r = i <= j ? i : j, q = i <= j ? j : i;
        T e = dg[i] * dg[j] / gg;
        if (has2[r][q]) e = e - d2[r][q] / g;
        if (i == j && hasl[i]) e = e + hl[i];
        H[i][j] = e;
      }
  }
}

// interiority measure of one block for the cone of kind `kind`: > 0 iff strictly interior; guarded
// logs, so an out-of-domain value reads -1, never NaN
template <typename T>
__device__ T ns_interior(int kind, double a, const T* u) {
  if (kind == kExp) {
    const T x = u[0], y = u[1], z = u[2];
    const bool pos = y > T(0) && z > T(0);
    const T ys = pos ? y : T(1), zs = pos ? z : T(1);
    const T m3 = ys * log(zs / ys) - x;
    return pos ? nan_min(nan_min(y, z), m3) : T(-1);
  }
  if (kind == kDualExp) {
    const T t = -u[0], v = u[1], w = u[2];
    const bool pos = t > T(0) && w > T(0);
    const T ts = pos ? t : T(1), ws = pos ? w : T(1);
    const T m3 = v + ts + ts * log(ws / ts);
    return pos ? nan_min(nan_min(t, w), m3) : T(-1);
  }
  const T x = u[0], y = u[1], z = u[2];
  const bool pos = x > T(0) && y > T(0);
  const T xs = pos ? x : T(1), ys = pos ? y : T(1);
  const T lx = kind == kPow ? log(xs) : log(xs / T(a));
  const T ly = kind == kPow ? log(ys) : log(ys / T(1 - a));
  const T phi = exp(T(a) * lx + T(1 - a) * ly);
  const T m3 = phi - fabs(z);
  return pos ? nan_min(nan_min(x, y), m3) : T(-1);
}

// Cramer solve of the symmetric 3x3 system A x = b (a determinant of magnitude <= tiny divides by 1)
template <typename T>
__device__ void solve3_sym(T (*A)[3], const T* b, T tiny, T* x) {
  const T a00 = A[0][0], a01 = A[0][1], a02 = A[0][2], a11 = A[1][1], a12 = A[1][2], a22 = A[2][2];
  const T c00 = a11 * a22 - a12 * a12;
  const T c01 = a02 * a12 - a01 * a22;
  const T c02 = a01 * a12 - a02 * a11;
  const T c11 = a00 * a22 - a02 * a02;
  const T c12 = a01 * a02 - a00 * a12;
  const T c22 = a00 * a11 - a01 * a01;
  const T det = a00 * c00 + a01 * c01 + a02 * c02;
  const T safe = fabs(det) > tiny ? det : T(1);
  x[0] = (c00 * b[0] + c01 * b[1] + c02 * b[2]) / safe;
  x[1] = (c01 * b[0] + c11 * b[1] + c12 * b[2]) / safe;
  x[2] = (c02 * b[0] + c12 * b[1] + c22 * b[2]) / safe;
}

// cyclic Jacobi of a symmetric 3x3 (ops/smalleig.py::jacobi_eigh, the same sweep rule and rotation):
// A is destroyed, w gets the eigenvalues (unsorted), V the eigenvectors as columns
template <typename T>
__device__ void jacobi3(T (*A)[3], T (*V)[3], T* w) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? T(1) : T(0);
  const int sweeps = 6 + (sizeof(T) == 8 ? 2 : 0);
  const T eps = mach_eps<T>();
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        const T app = A[p][p], aqq = A[q][q], apq = A[p][q];
        const bool small = fabs(apq) <= eps * (fabs(app) + fabs(aqq));
        const T tau = T(0.5) * (aqq - app) / (small ? T(1) : apq);
        const T t = small ? T(0) : (tau >= T(0) ? T(1) : T(-1)) / (fabs(tau) + hyp(T(1), tau));
        const T ct = hyp(T(1), t);
        const T c = T(1) / ct, s = t / ct;
        for (int k = 0; k < 3; ++k) {
          const T rp = A[p][k], rq = A[q][k];
          A[p][k] = c * rp - s * rq;
          A[q][k] = s * rp + c * rq;
        }
        for (int k = 0; k < 3; ++k) {
          const T cp = A[k][p], cq = A[k][q];
          A[k][p] = c * cp - s * cq;
          A[k][q] = s * cp + c * cq;
          const T vp = V[k][p], vq = V[k][q];
          V[k][p] = c * vp - s * vq;
          V[k][q] = s * vp + c * vq;
        }
      }
    }
  }
  for (int i = 0; i < 3; ++i) w[i] = A[i][i];
}

// SOC Jordan determinant (u0 - ||u1||)(u0 + ||u1||) with the relative floor, of a block whose entry i
// is f(i)
template <typename T, typename F>
__device__ inline T soc_det_of(F f, int dim, T eps) {
  T a = T(0);
  for (int i = 1; i < dim; ++i) { const T v = f(i); a += v * v; }
  const T nu1 = sqrt(a), u0 = f(0);
  return nan_max((u0 - nu1) * (u0 + nu1), eps * (u0 * u0));
}


// ---- the block's phases (called by every thread; each ends in __syncthreads) --

// per-block entries of Hbar^-1 (inverse) or Hbar (0 across blocks); the nonneg and soc entries are
// computed from s as the reference forms them, unscaled, then over or times mu
template <typename T>
__device__ T hbar_entry(const NsIpm<T>& c, int i, int k, bool inverse) {
  const int b = c.rblk[i];
  if (c.rblk[k] != b) return T(0);
  const int kind = c.bkind[b];
  if (kind == kNonneg) {
    if (i != k) return T(0);
    const T si = c.s[i];
    return inverse ? (si * si) / c.mu : c.mu * (T(1) / (si * si));
  }
  if (kind == kSoc) {
    const T det = c.sdet[c.bidx[b]];
    const int li = c.rloc[i], lk = c.rloc[k];
    const T J = i == k ? (li == 0 ? T(1) : T(-1)) : T(0);
    if (inverse) return (c.s[i] * c.s[k] - (T(0.5) * det) * J) / c.mu;
    const T jsi = li == 0 ? c.s[i] : -c.s[i], jsk = lk == 0 ? c.s[k] : -c.s[k];
    return c.mu * ((T(4) / (det * det)) * jsi * jsk - (T(2) / det) * J);
  }
  return c.nsH[18 * c.bidx[b] + (inverse ? 9 : 0) + 3 * c.rloc[i] + c.rloc[k]];
}

// out <- Hbar^-1 u (inverse) or Hbar u, one thread per row, over the row's block in order; out distinct
// from u
template <typename T>
__device__ __noinline__ void hbar_apply(const NsIpm<T>& c, const T* __restrict__ u, T* __restrict__ out, bool inverse) {
  for (int i = threadIdx.x; i < c.mC; i += kThreads) {
    const int b = c.rblk[i], off = c.boff[b], dim = c.bdim[b];
    T acc = T(0);
    if (c.bkind[b] == kNonneg) acc = hbar_entry(c, i, i, inverse) * u[i];
    else
      for (int k = off; k < off + dim; ++k) acc += hbar_entry(c, i, k, inverse) * u[k];
    out[i] = acc;
  }
  __syncthreads();
}

// grad F(s) blockwise: -1/s per nonneg row, -2 Js / det per soc block, the closed forms per ns block
template <typename T>
__device__ __noinline__ void grad_barrier(const NsIpm<T>& c, const T* __restrict__ s, T* __restrict__ out) {
  for (int b = threadIdx.x; b < c.nb; b += kThreads) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      for (int i = 0; i < dim; ++i) out[off + i] = T(-1) / s[off + i];
    } else if (c.bkind[b] == kSoc) {
      const T det = soc_det_of<T>([&](int i) { return s[off + i]; }, dim, c.eps);
      for (int i = 0; i < dim; ++i) out[off + i] = (T(-2) * (i == 0 ? s[off] : -s[off + i])) / det;
    } else {
      const int k = c.bidx[b];
      ns_grad_hess<T>(c.nskind[k], c.nsalpha[k], s + off, c.eps, out + off, nullptr);
    }
  }
  __syncthreads();
}

// the per-block data of Hbar at s: the floored soc determinants; per ns block mu hess F and the
// inverse of hess F by floored Jacobi eigendecomposition, over mu (c.mu is set)
template <typename T>
__device__ __noinline__ void hbar_data(const NsIpm<T>& c, T eps_w) {
  for (int b = threadIdx.x; b < c.nb; b += kThreads) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kSoc) {
      c.sdet[c.bidx[b]] = soc_det_of<T>([&](int i) { return c.s[off + i]; }, dim, c.eps);
    } else if (c.bkind[b] == kNs) {
      const int k = c.bidx[b];
      T gr[3], H[3][3], A[3][3], V[3][3], w[3];
      ns_grad_hess<T>(c.nskind[k], c.nsalpha[k], c.s + off, c.eps, gr, H);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) A[i][j] = H[i][j];
      jacobi3(A, V, w);
      const T mx = nan_max(nan_max(w[0], w[1]), w[2]);
      for (int i = 0; i < 3; ++i) w[i] = nan_max(w[i], eps_w * mx);
      T* out = c.nsH + 18 * k;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          T acc = T(0);
          for (int q = 0; q < 3; ++q) acc += (V[i][q] / w[q]) * V[j][q];
          out[3 * i + j] = c.mu * H[i][j];
          out[9 + 3 * i + j] = acc / c.mu;
        }
    }
  }
  __syncthreads();
}

// entry (i, k) of K = [[-Hbar^-1, AC, 0], [AC', reg I, AE'], [0, AE, -reg I]]
template <typename T>
__device__ T k_entry(const NsIpm<T>& c, int i, int k) {
  const int mC = c.mC, n = c.n;
  if (i < mC) {
    if (k < mC) return -hbar_entry(c, i, k, true);
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

// one Newton solve without refinement: rhs = [-rpC + Hbar^-1 g, -rd, -rpE] (a null residual reads as
// zero), then ds = -Hbar^-1 (g + dyC)
template <typename T>
__device__ __noinline__ void solve_once(const NsIpm<T>& c, const T* rd, const T* rpE, const T* rpC, const T* g,
                                        T* dx, T* dyE, T* dyC, T* ds) {
  const int mC = c.mC, n = c.n, N = c.N;
  hbar_apply(c, g, c.t1, true);
  for (int i = threadIdx.x; i < N; i += kThreads) {
    T v;
    if (i < mC) v = (rpC ? -rpC[i] : T(0)) + c.t1[i];
    else if (i < mC + n) v = rd ? -rd[i - mC] : T(0);
    else v = rpE ? -rpE[i - mC - n] : T(0);
    c.sol[i] = v;
  }
  __syncthreads();
  ldl_solve_warp0(c, c.sol);
  for (int i = threadIdx.x; i < N; i += kThreads) {
    const T v = c.sol[i];
    if (i < mC) { dyC[i] = v; c.t2[i] = g[i] + v; }
    else if (i < mC + n) dx[i - mC] = v;
    else dyE[i - mC - n] = v;
  }
  __syncthreads();
  hbar_apply(c, c.t2, c.t1, true);
  for (int i = threadIdx.x; i < mC; i += kThreads) ds[i] = -c.t1[i];
  __syncthreads();
}

// the predictor's direction: one solve, then one refinement pass against the unsquared block system
// r1 = -rd - (AC'dyC + AE'dyE), r2 = -rpE - AE dx, r3 = -rpC - (AC dx + ds), r4 = -g - (dyC + Hbar ds),
// whose correction solves with (-r1, -r2, -r3, -r4) in place of (rd, rpE, rpC, g)
template <typename T>
__device__ __noinline__ void solve_dir(const NsIpm<T>& c, const T* g, T* dx, T* dyE, T* dyC, T* ds) {
  const int mC = c.mC, n = c.n, p = c.p;
  solve_once(c, c.rd, c.rpE, c.rpC, g, dx, dyE, dyC, ds);
  hbar_apply(c, ds, c.t1, false);
  for (int r = threadIdx.x; r < n + p + mC; r += kThreads) {
    if (r < n) {
      T a = T(0);
      for (int i = 0; i < mC; ++i) a += c.AC[i * n + r] * dyC[i];
      T e = T(0);
      for (int k = 0; k < p; ++k) e += c.AE[k * n + r] * dyE[k];
      c.r1[r] = -(-c.rd[r] - (a + e));
    } else if (r < n + p) {
      const int k = r - n;
      T a = T(0);
      for (int j = 0; j < n; ++j) a += c.AE[k * n + j] * dx[j];
      c.r2[k] = -(-c.rpE[k] - a);
    } else {
      const int i = r - n - p;
      T a = T(0);
      for (int j = 0; j < n; ++j) a += c.AC[i * n + j] * dx[j];
      c.r3[i] = -(-c.rpC[i] - (a + ds[i]));
      c.r4[i] = -(-g[i] - (dyC[i] + c.t1[i]));
    }
  }
  __syncthreads();
  solve_once(c, c.r1, c.r2, c.r3, c.r4, c.cx, c.cyE, c.cyC, c.cs);
  for (int j = threadIdx.x; j < n; j += kThreads) dx[j] += c.cx[j];
  for (int k = threadIdx.x; k < p; k += kThreads) dyE[k] += c.cyE[k];
  for (int i = threadIdx.x; i < mC; i += kThreads) { dyC[i] += c.cyC[i]; ds[i] += c.cs[i]; }
  __syncthreads();
}

// one line-search candidate (s0 + a ds, y0 + a dy), evaluated by one thread over the whole cone.
// mode 0: 1 if strictly interior to K x K* and finite, else 0; mode 1: that, mu > 0 and prox^2 <=
// (beta mu)^2; mode 2: prox^2 / max(mu^2, 1e-30) where mode 1's first two hold, else +inf
template <typename T>
__device__ __noinline__ T candidate(const NsIpm<T>& c, const T* __restrict__ s0, const T* __restrict__ y0,
                                    const T* __restrict__ ds, const T* __restrict__ dy, T a, int mode) {
  const int mC = c.mC;
  auto sn = [&](int i) { return s0[i] + a * ds[i]; };
  auto yn = [&](int i) { return y0[i] + a * dy[i]; };
  bool fin = true;
  T mp = T(INFINITY), md = T(INFINITY);
  for (int b = 0; b < c.nb; ++b) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      for (int i = off; i < off + dim; ++i) {
        const T u = sn(i), v = yn(i);
        fin = fin && isfinite(u) && isfinite(v);
        mp = nan_min(mp, u);
        md = nan_min(md, v);
      }
    } else if (c.bkind[b] == kSoc) {
      T a1 = T(0), a2 = T(0);
      for (int i = off; i < off + dim; ++i) {
        const T u = sn(i), v = yn(i);
        fin = fin && isfinite(u) && isfinite(v);
        if (i > off) { a1 += u * u; a2 += v * v; }
      }
      mp = nan_min(mp, sn(off) - sqrt(a1));
      md = nan_min(md, yn(off) - sqrt(a2));
    } else {
      const int k = c.bidx[b];
      T u[3], v[3];
      for (int i = 0; i < 3; ++i) {
        u[i] = sn(off + i); v[i] = yn(off + i);
        fin = fin && isfinite(u[i]) && isfinite(v[i]);
      }
      mp = nan_min(mp, ns_interior<T>(c.nskind[k], c.nsalpha[k], u));
      md = nan_min(md, ns_interior<T>(dual_kind(c.nskind[k]), c.nsalpha[k], v));
    }
  }
  const bool feasible = mp > T(0) && md > T(0) && fin;
  if (mode == 0) return feasible ? T(1) : T(0);
  T dot = T(0);
  for (int i = 0; i < mC; ++i) dot += sn(i) * yn(i);
  const T mu = dot / c.nu_deg;
  // squared proximity ||y + mu grad F(s)||^2 in the norm of hess F(s)^-1
  T q = T(0);
  for (int b = 0; b < c.nb; ++b) {
    const int off = c.boff[b], dim = c.bdim[b];
    if (c.bkind[b] == kNonneg) {
      T acc = T(0);
      for (int i = off; i < off + dim; ++i) {
        const T e = sn(i) * yn(i) - mu;
        acc += e * e;
      }
      q = q + acc;
    } else if (c.bkind[b] == kSoc) {
      const T det = soc_det_of<T>([&](int i) { return sn(off + i); }, dim, c.eps);
      const T f = (T(2) * mu) / det;
      auto z = [&](int i) { return yn(off + i) - f * (i == 0 ? sn(off) : -sn(off + i)); };
      T sz = T(0);
      for (int i = 0; i < dim; ++i) sz += sn(off + i) * z(i);
      T acc = T(0);
      for (int i = 0; i < dim; ++i) {
        const T zi = z(i);
        const T hiz = sz * sn(off + i) - (T(0.5) * det) * (i == 0 ? zi : -zi);
        acc += zi * hiz;
      }
      q = q + acc;
    } else {
      const int k = c.bidx[b];
      T u[3], gr[3], H[3][3], z[3], dj[3], Hs[3][3], zd[3], xs[3];
      for (int i = 0; i < 3; ++i) u[i] = sn(off + i);
      ns_grad_hess<T>(c.nskind[k], c.nsalpha[k], u, c.eps, gr, H);
      for (int i = 0; i < 3; ++i) { z[i] = yn(off + i) + mu * gr[i]; dj[i] = sqrt(H[i][i]); }
      for (int i = 0; i < 3; ++i) {
        zd[i] = z[i] / dj[i];
        for (int j = 0; j < 3; ++j) Hs[i][j] = H[i][j] / dj[i] / dj[j];
      }
      solve3_sym<T>(Hs, zd, T(1e-30), xs);
      T acc = T(0);
      for (int i = 0; i < 3; ++i) acc += z[i] * (xs[i] / dj[i]);
      q = q + acc;
    }
  }
  if (mode == 1) {
    const T bm = c.beta * mu;
    return (feasible && mu > T(0) && q <= bm * bm) ? T(1) : T(0);
  }
  const bool good = feasible && mu > T(0);
  return good ? q / nan_max(mu * mu, T(1e-30)) : T(INFINITY);
}

// a line search over static candidates, one per lane of warp 0: mode 0 (the affine probe: every second
// predictor step) and mode 1 (the predictor: all 18) return the largest step whose candidate passes,
// mode 2 (the centering grid) the step of least value, ties to the earliest, 0 if none is finite. The
// same value in every thread.
template <typename T>
__device__ __noinline__ T line_search(const NsIpm<T>& c, const T* s0, const T* y0, const T* ds, const T* dy, int mode) {
  const T cent[kCentGrid] = {T(1.0), T(0.6), T(0.35), T(0.2), T(0.1), T(0.05), T(0.02)};
  const int count = mode == 0 ? kPredGrid / 2 : (mode == 1 ? kPredGrid : kCentGrid);
  auto step = [&](int k) { return mode == 2 ? cent[k] : c.pred[mode == 0 ? 2 * k : k]; };
  if (threadIdx.x < count) c.sc[sCand + threadIdx.x] = candidate(c, s0, y0, ds, dy, step(threadIdx.x), mode);
  __syncthreads();
  T best = T(0), best_v = T(INFINITY);
  for (int k = 0; k < count; ++k) {
    const T v = c.sc[sCand + k];
    if (mode < 2) {
      best = nan_max(best, v != T(0) ? step(k) : T(0));
    } else if (v < best_v) {
      best = step(k);
      best_v = v;
    }
  }
  __syncthreads();  // every thread has read the candidates
  return best;
}

// four resident blocks' worth of registers is too few for the tiled factorisation at 128 rows in
// f64, so two blocks per SM is the floor
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ns_kernel(const T* __restrict__ cg, const T* __restrict__ bEg, const T* __restrict__ bCg, const T* __restrict__ AEg,
          const T* __restrict__ ACg, T* __restrict__ x_out, T* __restrict__ yE_out, T* __restrict__ yC_out,
          T* __restrict__ s_out, int* __restrict__ it_out, T* __restrict__ pres_out, T* __restrict__ dres_out,
          T* __restrict__ gap_out, const NsLayout lay, int iters, T tol, T reg, T eps, T beta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ NsIpm<T> cs;
  const int tid = threadIdx.x;
  const size_t inst = blockIdx.x;
  const int n = lay.n, p = lay.p, l = lay.l, mC = ns_mC(lay), N = n + p + mC;
  const int nb = ns_nblocks(lay);
  int* ints = reinterpret_cast<int*>(smem_raw);
  double* dbl = reinterpret_cast<double*>(smem_raw + ns_int_bytes(lay));
  T* w = reinterpret_cast<T*>(smem_raw + ns_int_bytes(lay) + ns_double_bytes(lay));
  auto take = [&w](size_t count) { T* r = w; w += count; return r; };

  if (tid == 0) {
    NsIpm<T>& c = cs;
    c.n = n; c.p = p; c.mC = mC; c.N = N; c.ld = odd_stride(N); c.nb = nb; c.nsoc = lay.nsoc; c.nns = lay.nns;
    c.l = l; c.reg = reg; c.eps = eps; c.beta = beta;
    const int deg = l + 2 * lay.nsoc + 3 * lay.nns;
    c.nu_deg = T(deg > 1 ? deg : 1);
    for (int k = 0; k < kPredGrid; ++k) c.pred[k] = T(lay.pred[k]);
    int* bk = ints; int* bo = bk + nb; int* bd = bo + nb; int* bx = bd + nb;
    int* rb = bx + nb; int* rl = rb + mC;
    c.bkind = bk; c.boff = bo; c.bdim = bd; c.bidx = bx; c.rblk = rb; c.rloc = rl;
    int b = 0, off = 0;
    if (l) { bk[b] = kNonneg; bo[b] = 0; bd[b] = l; bx[b] = 0; ++b; off = l; }
    for (int k = 0; k < lay.nsoc; ++k, ++b) {
      bk[b] = kSoc; bo[b] = off; bd[b] = lay.soc_dim[k]; bx[b] = k; off += lay.soc_dim[k];
    }
    for (int k = 0; k < lay.nns; ++k, ++b) {
      bk[b] = kNs; bo[b] = off; bd[b] = 3; bx[b] = k; off += 3;
    }
    for (int bb = 0; bb < nb; ++bb)
      for (int i = 0; i < bd[bb]; ++i) { rb[bo[bb] + i] = bb; rl[bo[bb] + i] = i; }
    c.AC = take(size_t(mC) * n); c.AE = take(size_t(p) * n); c.c = take(n); c.bE = take(p); c.bC = take(mC);
    c.x = take(n); c.xb = take(n); c.rd = take(n); c.dx = take(n); c.tdx = take(n); c.cx = take(n); c.r1 = take(n);
    c.yE = take(p); c.yEb = take(p); c.rpE = take(p); c.dyE = take(p); c.tdyE = take(p); c.cyE = take(p);
    c.r2 = take(p);
    c.yC = take(mC); c.s = take(mC); c.yCb = take(mC); c.sb = take(mC); c.rpC = take(mC); c.gradF = take(mC);
    c.g = take(mC); c.dyC = take(mC); c.ds = take(mC); c.dyCa = take(mC); c.dsa = take(mC); c.cyC = take(mC);
    c.cs = take(mC); c.r3 = take(mC); c.r4 = take(mC); c.t1 = take(mC); c.t2 = take(mC);
    c.rhs = take(N); c.sol = take(N); c.dvec = take(N);
    c.L = take(size_t(N) * c.ld);
    c.sdet = take(lay.nsoc); c.nsH = take(18 * size_t(lay.nns));
    c.colbuf = take(kColbufWords); c.sc = take(kNsSlots);
    c.mu = T(1);
  }
  __syncthreads();
  // the ns blocks' kinds and exponents, copied out of the parameter space
  __shared__ int skind[kMaxNs];
  for (int k = tid; k < lay.nns; k += kThreads) { skind[k] = lay.ns_kind[k]; dbl[k] = lay.ns_alpha[k]; }
  if (tid == 0) { cs.nskind = skind; cs.nsalpha = dbl; }
  __syncthreads();
  const NsIpm<T>& c = cs;

  for (int i = tid; i < mC * n; i += kThreads) c.AC[i] = ACg[inst * mC * n + i];
  for (int i = tid; i < p * n; i += kThreads) c.AE[i] = AEg[inst * p * n + i];
  for (int j = tid; j < n; j += kThreads) { c.c[j] = cg[inst * n + j]; c.x[j] = T(0); c.xb[j] = T(0); }
  for (int k = tid; k < p; k += kThreads) { c.bE[k] = bEg[inst * p + k]; c.yE[k] = T(0); c.yEb[k] = T(0); }
  // ---- init: central s0 (ones, the soc heads, each ns block's central point), yC = -grad F(s0)
  for (int i = tid; i < mC; i += kThreads) {
    c.bC[i] = bCg[inst * mC + i];
    const int b = c.rblk[i], loc = c.rloc[i];
    T v;
    if (c.bkind[b] == kNonneg) v = T(1);
    else if (c.bkind[b] == kSoc) v = loc == 0 ? T(1) : T(0);
    else v = T(lay.ns_s0[3 * c.bidx[b] + loc]);
    c.s[i] = v;
  }
  __syncthreads();
  grad_barrier(c, c.s, c.yC);
  for (int i = tid; i < mC; i += kThreads) { c.yC[i] = -c.yC[i]; c.yCb[i] = c.yC[i]; c.sb[i] = c.s[i]; }
  __syncthreads();

  const T eps_w = sizeof(T) == 8 ? T(1e-14) : T(1e-6);
  // ---- main loop: every scalar below is the same in every thread ----------
  T errb = T(1e30), mu_prev = T(1e30), err_prev = T(1e30);
  int stall = 0, itdone = -1, own = iters, it = 0;
  for (; it < iters; ++it) {
    const Metrics<T> m = metrics(c);
    const bool done = m.pres < tol && m.dres < tol && m.gaprel < tol;
    const T err = nan_max(nan_max(m.pres, m.dres), m.gaprel);
    if (err < errb) {  // best-iterate tracking
      errb = err;
      for (int j = tid; j < n; j += kThreads) c.xb[j] = c.x[j];
      for (int k = tid; k < p; k += kThreads) c.yEb[k] = c.yE[k];
      for (int i = tid; i < mC; i += kThreads) { c.yCb[i] = c.yC[i]; c.sb[i] = c.s[i]; }
    }
    // stall exit: five consecutive bodies without 2% progress on mu and err
    stall = (m.mu > T(0.98) * mu_prev && err > T(0.98) * err_prev) ? stall + 1 : 0;
    const bool dead = m.mu <= T(0);
    if (done || stall >= 5 || dead) {
      if (done) itdone = it;
      own = it + 1;
      break;
    }
    if (tid == 0) cs.mu = m.mu;
    __syncthreads();

    grad_barrier(c, c.s, c.gradF);
    hbar_data(c, eps_w);
    factor(c);

    // Mehrotra affine probe: one solve for g = yC, every second predictor step, feasibility only
    solve_once(c, c.rd, c.rpE, c.rpC, c.yC, c.tdx, c.tdyE, c.dyCa, c.dsa);
    const T a_aff = line_search(c, c.s, c.yC, c.dsa, c.dyCa, 0);
    if (threadIdx.x < 32) {
      T a = T(0);
      for (int i = threadIdx.x; i < mC; i += 32) a += (c.s[i] + a_aff * c.dsa[i]) * (c.yC[i] + a_aff * c.dyCa[i]);
      a = warp_sum(a);
      if (threadIdx.x == 0) c.sc[sMuAff] = a / c.nu_deg;
    }
    __syncthreads();
    const T ratio = c.sc[sMuAff] / nan_max(m.mu, T(1e-30));
    const T sigma = nan_min(nan_max(ratio * ratio * ratio, T(0)), T(1));
    for (int i = tid; i < mC; i += kThreads) c.g[i] = c.yC[i] + (sigma * m.mu) * c.gradF[i];
    __syncthreads();
    solve_dir(c, c.g, c.dx, c.dyE, c.dyC, c.ds);
    T alpha = line_search(c, c.s, c.yC, c.ds, c.dyC, 1);
    if (alpha < T(0.05)) {  // pure centering: zero residual right-hand side, no refinement
      for (int i = tid; i < mC; i += kThreads) c.g[i] = c.yC[i] + m.mu * c.gradF[i];
      __syncthreads();
      solve_once(c, (const T*)nullptr, (const T*)nullptr, (const T*)nullptr, c.g, c.dx, c.dyE, c.dyC, c.ds);
      alpha = line_search(c, c.s, c.yC, c.ds, c.dyC, 2);
    }

    const bool bad = any_nonfinite(c.dx, n, c.dyC, mC, c.ds, mC, c.dyE, p) || !isfinite(alpha);
    if (bad) {
      own = it + 1;
      break;
    }
    alpha = nan_max(alpha, T(0));
    for (int j = tid; j < n; j += kThreads) c.x[j] += alpha * c.dx[j];
    for (int k = tid; k < p; k += kThreads) c.yE[k] += alpha * c.dyE[k];
    for (int i = tid; i < mC; i += kThreads) { c.yC[i] += alpha * c.dyC[i]; c.s[i] += alpha * c.ds[i]; }
    __syncthreads();
    mu_prev = m.mu;
    err_prev = err;
  }
  __syncthreads();

  // ---- the exit state never got a best-update inside the loop: score it ----
  {
    const Metrics<T> m = metrics(c);
    const T err = nan_max(nan_max(m.pres, m.dres), m.gaprel);
    const bool fin = !any_nonfinite(c.x, n, c.yC, mC, c.x, 0, c.x, 0);
    if (!(err < errb && fin)) {
      for (int j = tid; j < n; j += kThreads) c.x[j] = c.xb[j];
      for (int k = tid; k < p; k += kThreads) c.yE[k] = c.yEb[k];
      for (int i = tid; i < mC; i += kThreads) { c.yC[i] = c.yCb[i]; c.s[i] = c.sb[i]; }
    }
    __syncthreads();
  }
  // the metrics OF THE RETURNED STATE
  const Metrics<T> m = metrics(c);
  for (int j = tid; j < n; j += kThreads) x_out[inst * n + j] = c.x[j];
  for (int k = tid; k < p; k += kThreads) yE_out[inst * p + k] = c.yE[k];
  for (int i = tid; i < mC; i += kThreads) {
    yC_out[inst * mC + i] = c.yC[i];
    s_out[inst * mC + i] = c.s[i];
  }
  if (tid == 0) {
    it_out[inst] = itdone >= 0 ? itdone : own;
    pres_out[inst] = m.pres;
    dres_out[inst] = m.dres;
    gap_out[inst] = m.gaprel;
  }
}

inline bool make_layout(NsLayout& lay, int n, int p, int l, int nsoc, const int* soc_dims, int nns,
                        const int* kinds, const double* alphas, const double* central, const double* pred) {
  if (nsoc < 0 || nsoc > kMaxSoc || nns < 0 || nns > kMaxNs) return false;
  lay.n = n; lay.p = p; lay.l = l; lay.nsoc = nsoc; lay.nns = nns;
  for (int k = 0; k < nsoc; ++k) {
    if (soc_dims[k] < 1) return false;
    lay.soc_dim[k] = short(soc_dims[k]);
  }
  for (int k = 0; k < nns; ++k) {
    if (kinds && (kinds[k] < kExp || kinds[k] > kDualPow)) return false;
    lay.ns_kind[k] = kinds ? kinds[k] : 0;
    lay.ns_alpha[k] = alphas ? alphas[k] : 0.0;
    for (int i = 0; i < 3; ++i) lay.ns_s0[3 * k + i] = central ? central[3 * k + i] : 0.0;
  }
  for (int k = 0; k < kPredGrid; ++k) lay.pred[k] = pred ? pred[k] : 0.0;
  return true;
}

template <typename T>
int launch_ns(const void* c, const void* bE, const void* bC, const void* AE, const void* AC, void* x, void* yE,
              void* yC, void* s, void* it, void* pres, void* dres, void* gap, int B, int n, int p, int l, int nsoc,
              const int* soc_dims, int nns, const int* kinds, const double* alphas, const double* central,
              const double* pred, int iters, double tol, double reg, double eps, double beta, void* stream) {
  NsLayout lay;
  if (!make_layout(lay, n, p, l, nsoc, soc_dims, nns, kinds, alphas, central, pred))
    return int(cudaErrorInvalidValue);
  const int mC = ns_mC(lay);
  const size_t smem = ns_smem_bytes(lay, sizeof(T));
  if (B <= 0 || n <= 0 || p < 0 || l < 0 || mC <= 0 || n + p + mC > kTileGrid * kMaxTileRows ||
      smem + sizeof(NsIpm<T>) + kMaxNs * sizeof(int) > kMaxSmemBytes)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ns_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  ns_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(c), static_cast<const T*>(bE), static_cast<const T*>(bC), static_cast<const T*>(AE),
      static_cast<const T*>(AC), static_cast<T*>(x), static_cast<T*>(yE), static_cast<T*>(yC), static_cast<T*>(s),
      static_cast<int*>(it), static_cast<T*>(pres), static_cast<T*>(dres), static_cast<T*>(gap), lay, iters, T(tol),
      T(reg), T(eps), T(beta));
  return int(cudaGetLastError());
}

}  // namespace dk

extern "C" {

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dynamic shared memory the kernel needs, in bytes (itemsize 4 or 8); -1 for a layout it refuses.
long long ns_pdip_smem_bytes(int n, int p, int l, int nsoc, const int* soc_dims, int nns, int itemsize) {
  dk::NsLayout lay;
  if (!dk::make_layout(lay, n, p, l, nsoc, soc_dims, nns, nullptr, nullptr, nullptr, nullptr)) return -1;
  return (long long)dk::ns_smem_bytes(lay, itemsize);
}

int ns_pdip_f32(const void* c, const void* bE, const void* bC, const void* AE, const void* AC, void* x, void* yE,
                void* yC, void* s, void* it, void* pres, void* dres, void* gap, int B, int n, int p, int l, int nsoc,
                const int* soc_dims, int nns, const int* kinds, const double* alphas, const double* central,
                const double* pred, int iters, double tol, double reg, double eps, double beta, void* stream) {
  return dk::launch_ns<float>(c, bE, bC, AE, AC, x, yE, yC, s, it, pres, dres, gap, B, n, p, l, nsoc, soc_dims, nns,
                              kinds, alphas, central, pred, iters, tol, reg, eps, beta, stream);
}
int ns_pdip_f64(const void* c, const void* bE, const void* bC, const void* AE, const void* AC, void* x, void* yE,
                void* yC, void* s, void* it, void* pres, void* dres, void* gap, int B, int n, int p, int l, int nsoc,
                const int* soc_dims, int nns, const int* kinds, const double* alphas, const double* central,
                const double* pred, int iters, double tol, double reg, double eps, double beta, void* stream) {
  return dk::launch_ns<double>(c, bE, bC, AE, AC, x, yE, yC, s, it, pres, dres, gap, B, n, p, l, nsoc, soc_dims, nns,
                               kinds, alphas, central, pred, iters, tol, reg, eps, beta, stream);
}

}  // extern "C"
