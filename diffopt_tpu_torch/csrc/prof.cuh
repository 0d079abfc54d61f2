// Phase probes of the kernels, read by tools/pdip_phase_cycles.py (K1),
// tools/k6_phase_cycles.py (K6), tools/chol_phase_cycles.py (K4, K5) and
// tools/ldl_phase_cycles.py (K2, K3). They are compiled in only with
// -DDK_PROFILE; otherwise every macro vanishes and the package's own build
// carries no trace of them.
//
// DK_PROF_START() opens a block's clock (DK_PROF_RESTART() sets it anew after a
// call whose phases were counted on their own); DK_PROF(k) is a block barrier, then
// thread 0 adds the cycles since the previous probe to counter k in device
// memory; DK_PROF_ADD(k, v) adds v to counter k. The barrier makes a probe a
// phase boundary: it costs a few percent, and the shares are what to read.
#pragma once

#include <cuda_runtime.h>

namespace dk {

constexpr int kProfCounters = 16;
// the counters of the dense kernels' phases (K2-K5): cycles per instance of its copy in, its factorisation
// or forward sweep, its backward sweep and its write out, and the instances counted
enum PhaseProf { kProfCopy, kProfWork, kProfBack, kProfOut, kProfInstances = 15 };

#ifdef DK_PROFILE
__device__ unsigned long long g_prof[kProfCounters];
#define DK_PROF_START() long long t0_ = clock64()
#define DK_PROF_RESTART() t0_ = clock64()
#define DK_PROF(k)                                               \
  do {                                                           \
    __syncthreads();                                             \
    if (threadIdx.x == 0) {                                      \
      const long long t_ = clock64();                            \
      atomicAdd(&g_prof[k], (unsigned long long)(t_ - t0_));     \
      t0_ = t_;                                                  \
    }                                                            \
  } while (0)
#define DK_PROF_ADD(k, v) atomicAdd(&g_prof[k], (unsigned long long)(v))
// DK_PROF(k) for a team that is not the whole block: `sync` its barrier, `leader` the one thread that counts
#define DK_PROF_AT(k, sync, leader)                              \
  do {                                                           \
    sync;                                                        \
    if (leader) {                                                \
      const long long t_ = clock64();                            \
      atomicAdd(&g_prof[k], (unsigned long long)(t_ - t0_));     \
      t0_ = t_;                                                  \
    }                                                            \
  } while (0)

// the counters to the host (out: kProfCounters words) and back to zero
inline int prof_read(unsigned long long* out) {
  return int(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));
}
inline int prof_zero() {
  const unsigned long long zeros[kProfCounters] = {0};
  return int(cudaMemcpyToSymbol(g_prof, zeros, sizeof(zeros)));
}
#else
#define DK_PROF_START() do {} while (0)
#define DK_PROF_RESTART() do {} while (0)
#define DK_PROF(k) do {} while (0)
#define DK_PROF_ADD(k, v) do {} while (0)
#define DK_PROF_AT(k, sync, leader) do {} while (0)
#endif

}  // namespace dk
