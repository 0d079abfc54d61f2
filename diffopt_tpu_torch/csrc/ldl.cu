// Batched unpivoted LDL' factor and solve for symmetric quasi-definite
// matrices, one thread block per instance.
//
// Replaces diffopt_tpu/ops/pallas/chol.py::ldl_batched (_ldl_kernel) and
// ::ldl_solve_batched (_ldl_solve_kernel). The TPU kernels put the batch along
// the 128 lanes and walk the matrix in (N, N, B) layout; here the batch is the
// grid, the matrix stays in its natural (B, N, N) row-major layout, and the
// working copy lives in shared memory.
//
// Bound on an H100: device-memory bytes. The factor needs the lower triangle
// of K, N (N + 1) / 2 words, and writes L in full and d, N^2 + N words, per
// instance for N^3 / 3 flops (N = 112, f32: 75 KB against 0.47 MFLOP, 160
// bytes per kflop -- far on the memory side of the card's 67 TFLOP/s :
// 3.35 TB/s); the solve needs the strict lower triangle of L, d and the
// right-hand sides, N (N - 1) / 2 + N + N k words, and writes N k words for
// 2 N^2 k flops. The factor reads only the lower tiles of K; the solve still
// loads all of L (the upper triangle comes along unused), so it moves about
// twice what it needs. Everything else stays in registers and shared memory.
// What both still pay for is the sequential structure: N elimination steps
// with a block barrier each in the factor; 2 N substitution steps in the
// solve, run by one warp per right-hand side with the right-hand side in
// registers (the other warps of the block only help to load and store).
//
// The factor keeps the matrix in registers up to N = 128 (dense.cuh,
// factor_tile) and in shared memory past that.
//
// Envelope: (N * odd(N) + N) words for the factor past N = 128 and
// (N * odd(N) + N + N k) words for the solve must fit 227 KB of shared memory:
// N <= 239 (f32) / 169 (f64).
#include "dense.cuh"

namespace dk {

// The factor keeps the matrix in registers up to N = 128 and then needs only d
// and the pivot-column buffer in shared memory; past that the matrix itself
// lives there.
template <typename T>
__host__ __device__ inline size_t ldl_factor_smem(int N) {
  if (N <= kTileGrid * kMaxTileRows) return (size_t(N) + kColbufWords) * sizeof(T);
  return (size_t(N) * odd_stride(N) + size_t(N)) * sizeof(T);
}
template <typename T>
__host__ __device__ inline size_t ldl_solve_smem(int N, int k) {
  return (size_t(N) * odd_stride(N) + size_t(N) + size_t(N) * k) * sizeof(T);
}

// Global memory -> register tiles -> global memory; smem = d (N words) and
// the pivot-column buffer.
template <typename T, int kRows>
__device__ void ldl_factor_tiled(const T* __restrict__ Kg, T* __restrict__ Lg, T* __restrict__ dg, int N,
                                 T* smem) {
  const int tx = threadIdx.x & (kTileGrid - 1), ty = threadIdx.x / kTileGrid;
  T* dvec = smem;
  T* colbuf = smem + N;
  T t[kRows][kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      t[a][b] = (i < N && k < N) ? Kg[size_t(i) * N + k] : T(0);
    }
  factor_tile<T, kRows>(t, N, dvec, colbuf);
  // unit-lower L (column k of t still carries D[k]) with the upper triangle zeroed
#pragma unroll
  for (int a = 0; a < kRows; ++a)
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const int i = ty + kTileGrid * a, k = tx + kTileGrid * b;
      if (i < N && k < N) {
        T v = k == i ? T(1) : T(0);
        if (b <= a) {
          if (k < i) v = t[a][b] / dvec[k];
        }
        Lg[size_t(i) * N + k] = v;
      }
    }
  for (int i = threadIdx.x; i < N; i += kThreads) dg[i] = dvec[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ldl_factor_kernel(const T* __restrict__ K, T* __restrict__ Lout, T* __restrict__ dout, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Kg = K + size_t(blockIdx.x) * N * N;
  T* Lg = Lout + size_t(blockIdx.x) * N * N;
  T* dg = dout + size_t(blockIdx.x) * N;
  if (dispatch_tile(N, [&](auto rows) { ldl_factor_tiled<T, decltype(rows)::value>(Kg, Lg, dg, N, M); }))
    return;

  // N > 128: the matrix lives in shared memory
  const int ld = odd_stride(N);
  T* dvec = M + size_t(N) * ld;
  // a flat, unrolled copy keeps several loads of every thread in flight (the
  // upper triangle comes along; it is never read again)
#pragma unroll 8
  for (int e = tid; e < N * N; e += kThreads) {
    const int i = e / N;
    M[i * ld + (e - i * N)] = Kg[e];
  }
  __syncthreads();

  factor_lower<T>(M, ld, N, dvec);

  // unit-lower L (column k of the factored block still carries D[k]) with the
  // upper triangle zeroed
  for (int i = warp; i < N; i += kWarps)
    for (int k = lane; k < N; k += 32)
      Lg[size_t(i) * N + k] = k < i ? M[i * ld + k] / dvec[k] : (k == i ? T(1) : T(0));
  for (int i = tid; i < N; i += kThreads) dg[i] = dvec[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ldl_solve_kernel(const T* __restrict__ L, const T* __restrict__ d, const T* __restrict__ rhs,
                 T* __restrict__ out, int N, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int ld = odd_stride(N);
  T* dvec = M + size_t(N) * ld;
  T* X = dvec + N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* Lg = L + size_t(blockIdx.x) * N * N;
  const T* rg = rhs + size_t(blockIdx.x) * N * k;

#pragma unroll 8
  for (int e = tid; e < N * N; e += kThreads) {
    const int i = e / N;
    M[i * ld + (e - i * N)] = Lg[e];
  }
  for (int i = tid; i < N; i += kThreads) dvec[i] = d[size_t(blockIdx.x) * N + i];
  // right-hand sides are held column by column (k x N), one warp per column
  for (int e = tid; e < N * k; e += kThreads) {
    const int i = e / k, c = e - i * k;
    X[c * N + i] = rg[e];
  }
  __syncthreads();

  for (int c = warp; c < k; c += kWarps) {
    T* x = X + c * N;
    warp_forward_sub<T>(M, ld, N, x, 1, nullptr, lane);
    for (int i = lane; i < N; i += 32) x[i] /= dvec[i];
    __syncwarp();
    warp_backward_sub<T>(M, ld, N, x, 1, nullptr, lane);
  }
  __syncthreads();

  T* og = out + size_t(blockIdx.x) * N * k;
  for (int e = tid; e < N * k; e += kThreads) {
    const int i = e / k, c = e - i * k;
    og[e] = X[c * N + i];
  }
}

template <typename T>
int launch_ldl_factor(const void* K, void* L, void* d, int B, int N, void* stream) {
  const size_t smem = ldl_factor_smem<T>(N);
  if (B <= 0 || N <= 0 || smem > kMaxSmemBytes) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ldl_factor_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  ldl_factor_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(K), static_cast<T*>(L), static_cast<T*>(d), N);
  return int(cudaGetLastError());
}

template <typename T>
int launch_ldl_solve(const void* L, const void* d, const void* rhs, void* out, int B, int N, int k,
                     void* stream) {
  const size_t smem = ldl_solve_smem<T>(N, k);
  if (B <= 0 || N <= 0 || N > kMaxSubstitutionRows || k <= 0 || smem > kMaxSmemBytes)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(ldl_solve_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  ldl_solve_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(d), static_cast<const T*>(rhs),
      static_cast<T*>(out), N, k);
  return int(cudaGetLastError());
}

}  // namespace dk

extern "C" {

const char* dk_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

int ldl_factor_f32(const void* K, void* L, void* d, int B, int N, void* stream) {
  return dk::launch_ldl_factor<float>(K, L, d, B, N, stream);
}
int ldl_factor_f64(const void* K, void* L, void* d, int B, int N, void* stream) {
  return dk::launch_ldl_factor<double>(K, L, d, B, N, stream);
}
int ldl_solve_f32(const void* L, const void* d, const void* rhs, void* out, int B, int N, int k,
                  void* stream) {
  return dk::launch_ldl_solve<float>(L, d, rhs, out, B, N, k, stream);
}
int ldl_solve_f64(const void* L, const void* d, const void* rhs, void* out, int B, int N, int k,
                  void* stream) {
  return dk::launch_ldl_solve<double>(L, d, rhs, out, B, N, k, stream);
}

}  // extern "C"
