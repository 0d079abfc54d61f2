// Batched Cholesky factor and solve for small symmetric positive definite
// matrices, one thread block per instance.
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
// What they still pay for is the sequential structure: n elimination steps
// with a block barrier each in the factor; 2 n substitution steps in the
// solve, run by one warp per right-hand side with the right-hand side in
// registers (k right-hand sides on up to 8 warps side by side, in rounds of
// 8; the block is only as wide as k needs, so that more instances share an SM
// when k = 1). At n = 16 (the Schur complement of the staged QP solver) a
// block of 256 threads has work for one sixteenth of its tile grid; several
// instances per block would be the next step.
//
// A matrix that is not positive definite never traps: from the first pivot j
// that is not > 0 on, every column k >= j of L is NaN (rows >= k), which is
// what the reference's rsqrt leaves behind, and the solvers' NaN guards freeze
// that instance.
//
// The factor keeps the matrix in registers up to n = 128 (dense.cuh,
// factor_tile) and in shared memory past that (factor_lower).
//
// Envelope: (n * odd(n) + n + 1) words for the factor past n = 128 and
// (n * odd(n) + n + n k) words for the solve must fit 227 KB of shared memory,
// and the solve's register sweep holds n <= 256.
#include "dense.cuh"

namespace dk {

// shared memory: the pivots (n words), one flag word (first bad pivot) and,
// up to n = 128, the pivot-column buffer; past that the matrix itself
template <typename T>
__host__ __device__ inline size_t chol_factor_smem(int n) {
  if (n <= kTileGrid * kMaxTileRows) return (size_t(n) + 1 + kColbufWords) * sizeof(T);
  return (size_t(n) * odd_stride(n) + size_t(n) + 1) * sizeof(T);
}
template <typename T>
__host__ __device__ inline size_t chol_solve_smem(int n, int k) {
  return (size_t(n) * odd_stride(n) + size_t(n) + size_t(n) * k) * sizeof(T);
}

template <typename T>
__device__ inline T quiet_nan();
template <>
__device__ inline float quiet_nan<float>() { return __int_as_float(0x7fffffff); }
template <>
__device__ inline double quiet_nan<double>() { return __longlong_as_double(0x7ff8000000000000LL); }

// Index of the first pivot that is not > 0 (n if all are) into *flag. Called
// by every thread of the block; *flag must hold n on entry; ends in
// __syncthreads.
template <typename T>
__device__ inline void first_bad_pivot(const T* __restrict__ diag, int n, int* flag) {
  for (int j = threadIdx.x; j < n; j += kThreads)
    if (!(diag[j] > T(0))) atomicMin(flag, j);
  __syncthreads();
}

// Global memory -> register tiles -> global memory.
template <typename T, int kRows>
__device__ void chol_factor_tiled(const T* __restrict__ Hg, T* __restrict__ Lg, int n, T* smem) {
  const int tx = threadIdx.x & (kTileGrid - 1), ty = threadIdx.x / kTileGrid;
  T* dvec = smem;
  int* flag = reinterpret_cast<int*>(smem + n);
  T* colbuf = smem + n + 1;
  if (threadIdx.x == 0) *flag = n;
  T t[kRows][kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      t[a][b] = (i < n && k < n) ? Hg[size_t(i) * n + k] : T(0);
    }
  factor_tile<T, kRows>(t, n, dvec, colbuf);
  first_bad_pivot<T>(dvec, n, flag);
  const int jbad = *flag;
  const T nan = quiet_nan<T>();
  // column k of t carries L[i][k] * pivot k of the LDL' form: times
  // rsqrt(pivot k) it is the Cholesky factor, diagonal included
  T rk[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    const int k = tx + kTileGrid * b;
    rk[b] = k < n ? (k < jbad ? rsqrt(dvec[k]) : nan) : T(0);
  }
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      if (i < n && k < n) {
        T v = T(0);
        if (b <= a) {
          if (k <= i) v = k < jbad ? t[a][b] * rk[b] : nan;
        }
        Lg[size_t(i) * n + k] = v;
      }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_factor_kernel(const T* __restrict__ H, T* __restrict__ Lout, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Hg = H + size_t(blockIdx.x) * n * n;
  T* Lg = Lout + size_t(blockIdx.x) * n * n;
  if (dispatch_tile(n, [&](auto rows) { chol_factor_tiled<T, decltype(rows)::value>(Hg, Lg, n, M); }))
    return;

  // n > 128: the matrix lives in shared memory
  const int ld = odd_stride(n);
  T* dvec = M + size_t(n) * ld;
  int* flag = reinterpret_cast<int*>(dvec + n);
  if (tid == 0) *flag = n;
  // lower triangle only, one warp per row
  for (int i = warp; i < n; i += kWarps)
    for (int k = lane; k <= i; k += 32) M[i * ld + k] = Hg[size_t(i) * n + k];
  __syncthreads();

  factor_lower<T>(M, ld, n, dvec);
  first_bad_pivot<T>(dvec, n, flag);
  const int jbad = *flag;
  const T nan = quiet_nan<T>();
  for (int i = warp; i < n; i += kWarps)
    for (int k = lane; k < n; k += 32) {
      T v = T(0);
      if (k <= i) v = k < jbad ? M[i * ld + k] * rsqrt(dvec[k]) : nan;
      Lg[size_t(i) * n + k] = v;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chol_solve_kernel(const T* __restrict__ L, const T* __restrict__ rhs, T* __restrict__ out, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int ld = odd_stride(n);
  T* inv_diag = M + size_t(n) * ld;
  T* X = inv_diag + n;
  // the block is as wide as its right-hand sides need (chol_solve_threads), not kThreads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int threads = blockDim.x, warps = threads >> 5;
  const T* Lg = L + size_t(blockIdx.x) * n * n;
  const T* rg = rhs + size_t(blockIdx.x) * n * k;

  // lower triangle only, one warp per row
  for (int i = warp; i < n; i += warps)
    for (int c = lane; c <= i; c += 32) M[i * ld + c] = Lg[size_t(i) * n + c];
  for (int i = tid; i < n; i += threads) inv_diag[i] = T(1) / Lg[size_t(i) * n + i];
  // right-hand sides are held column by column (k x n), one warp per column
  for (int e = tid; e < n * k; e += threads) {
    const int i = e / k, c = e - i * k;
    X[c * n + i] = rg[e];
  }
  __syncthreads();

  // k right-hand sides on the block's warps side by side, in rounds
  for (int c = warp; c < k; c += warps) warp_chol_solve<T>(M, ld, n, X + c * n, 1, inv_diag, lane);
  __syncthreads();

  T* og = out + size_t(blockIdx.x) * n * k;
  for (int e = tid; e < n * k; e += threads) {
    const int i = e / k, c = e - i * k;
    og[e] = X[c * n + i];
  }
}

template <typename T>
int launch_chol_factor(const void* H, void* L, int B, int n, void* stream) {
  const size_t smem = chol_factor_smem<T>(n);
  if (B <= 0 || n <= 0 || smem > kMaxSmemBytes) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(chol_factor_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  chol_factor_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(H), static_cast<T*>(L), n);
  return int(cudaGetLastError());
}

// One warp per right-hand side, at least two (the second helps to load L), at
// most kWarps: a substitution keeps one warp busy, so with one right-hand side
// a narrow block leaves room for more instances on an SM (registers and
// shared memory allow 13 blocks of 64 threads at n = 64 where they allow 4 of
// 256), and what a sweep costs is latency that only other instances can hide.
inline int chol_solve_threads(int k) { return 32 * (k < 2 ? 2 : (k > kWarps ? kWarps : k)); }

template <typename T>
int launch_chol_solve(const void* L, const void* rhs, void* out, int B, int n, int k, void* stream) {
  const size_t smem = chol_solve_smem<T>(n, k);
  if (B <= 0 || n <= 0 || n > kMaxSubstitutionRows || k <= 0 || smem > kMaxSmemBytes)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(chol_solve_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  chol_solve_kernel<T><<<B, chol_solve_threads(k), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(rhs), static_cast<T*>(out), n, k);
  return int(cudaGetLastError());
}

}  // namespace dk

extern "C" {

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int chol_factor_f32(const void* H, void* L, int B, int n, void* stream) {
  return dk::launch_chol_factor<float>(H, L, B, n, stream);
}
int chol_factor_f64(const void* H, void* L, int B, int n, void* stream) {
  return dk::launch_chol_factor<double>(H, L, B, n, stream);
}
int chol_solve_f32(const void* L, const void* rhs, void* out, int B, int n, int k, void* stream) {
  return dk::launch_chol_solve<float>(L, rhs, out, B, n, k, stream);
}
int chol_solve_f64(const void* L, const void* rhs, void* out, int B, int n, int k, void* stream) {
  return dk::launch_chol_solve<double>(L, rhs, out, B, n, k, stream);
}

}  // extern "C"
