// Shared helpers of the fleetflow_tpu_torch kernels (sm_90a, plain C ABI).
//
// Every entry point is `extern "C"`, takes device pointers and ints, launches
// on the caller's stream, never synchronises and returns the cudaError_t of
// cudaGetLastError() after its launches (0 = success).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#define FF_EXPORT extern "C" __attribute__((visibility("default")))

// capacity tolerance of the exact gate: load > cap * (1 + 1e-6), the factor
// rounded to float32 as the reference and the plain versions round it
#define FF_CAP_TOL ((float)(1.0 + 1e-6))

// The lane axis of the tenant multiplexer (solver/multiplex.py): K1-K3 take
// L same-tier lanes stacked on a leading axis. Every stacked plane is a
// contiguous (L, ...) tensor, so a lane's stride is its per-lane size. The
// per-lane scalars travel BY VALUE in this struct, sized for the lane
// ladder's cap: they change every sweep (the temperature), and as device
// arrays they would be a host-to-device copy inside the warm dispatch.
// K1 reads all four fields; K2 and K3 read n_real only. A solo call is L = 1.
#define FF_MAX_LANES 16

struct FFLanes {
  float temp[FF_MAX_LANES];      // K1's Metropolis temperature
  float sticky_w[FF_MAX_LANES];  // stickiness bonus (with sticky_prev)
  int n_real[FF_MAX_LANES];      // rows >= n_real are phantoms
  int active[FF_MAX_LANES];      // 0: K1 leaves the lane untouched
};

FF_EXPORT const char* ff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Compile-time phase stamps (a kernel file defines FF_PHASES when built
// with its -DK1_PHASES / -DK2_PHASES / -DK5_PHASES / -DK6_PHASES /
// -DK7_PHASES; fleetflow_tpu_torch/tools/k12_profile.py, k5_profile.py and
// k67_profile.py build and read them). Thread 0 of each block writes
// FF_PHASE_SLOTS u64 into row blockIdx.y * gridDim.x + blockIdx.x of the
// buffer set by ff_set_phases: the global timer (ns) at the block's start
// and end, the SM cycles between them, four phase cycle counts, two counts
// of the kernel's own, then up to three cycle counts that split the last
// phase (see each kernel). The tool turns cycles into time with the
// ns-per-cycle ratio of the blocks it read.
#define FF_PHASE_SLOTS 12
#ifdef FF_PHASES
__device__ unsigned long long* g_ff_phases = nullptr;

FF_EXPORT int ff_set_phases(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_ff_phases, &buf, sizeof(buf)));
}

__device__ __forceinline__ unsigned long long ff_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// stamp row `row`, or null when no buffer is set or not thread 0
__device__ __forceinline__ unsigned long long* ff_phase_at(size_t row) {
  if (g_ff_phases == nullptr || threadIdx.x != 0) return nullptr;
  return g_ff_phases + row * FF_PHASE_SLOTS;
}

// this block's stamp row, or null when no buffer is set or not thread 0
__device__ __forceinline__ unsigned long long* ff_phase_row() {
  return ff_phase_at((size_t)blockIdx.y * gridDim.x + blockIdx.x);
}
#endif

// eligible[s, n] for either layout: packed int32 words (bit n % 32 of word
// n / 32, `stride` words a row) or dense bytes (`stride` = N)
__device__ __forceinline__ bool ff_elig(const void* elig, int packed,
                                        int stride, int s, int n) {
  if (packed) {
    const int word = static_cast<const int*>(elig)[(size_t)s * stride + (n >> 5)];
    return ((word >> (n & 31)) & 1) != 0;
  }
  return static_cast<const unsigned char*>(elig)[(size_t)s * stride + n] != 0;
}

__device__ __forceinline__ unsigned grid_stride() {
  return gridDim.x * blockDim.x;
}

__device__ __forceinline__ unsigned grid_tid() {
  return blockIdx.x * blockDim.x + threadIdx.x;
}

// block-wide sum of a 64-bit value; every thread gets the total. `sm` holds
// at least 32 entries. Ends with a barrier, so `sm` can be reused after.
__device__ __forceinline__ long long block_sum_ll(long long v, long long* sm) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  long long t = 0;
  for (int w = 0; w < nw; ++w) t += sm[w];
  __syncthreads();
  return t;
}

// (value, index) pair reductions: lower value wins (argmin) or higher value
// wins (argmax); equal values keep the LOWER index, the first occurrence,
// as jnp.argmin / jnp.argmax and torch.argmin / torch.argmax do
__device__ __forceinline__ bool ff_better_min(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool ff_better_max(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool kMin>
__device__ __forceinline__ void block_arg(float& v, int& i, float* sv, int* si) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (kMin ? ff_better_min(ov, oi, v, i) : ff_better_max(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  v = sv[0];
  i = si[0];
  for (int w = 1; w < nw; ++w)
    if (kMin ? ff_better_min(sv[w], si[w], v, i) : ff_better_max(sv[w], si[w], v, i)) {
      v = sv[w];
      i = si[w];
    }
  __syncthreads();
}

static inline int ff_blocks(long long work, int threads, int cap = 132 * 16) {
  long long b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > cap) b = cap;
  return static_cast<int>(b);
}
