// K5: gather and commit of the active-set sub-solve.
//
// Replaces the gather and scatter halves of
// fleetflow_tpu/solver/subsolve.py::_subsolve_fn().subsolve (the mini
// anneal between them runs on K1-K3). Two entry points:
//
//   ff_k5_gather  the mini problem's planes from the resident padded ones.
//                 Slot j < n_sub reads closure row min(rows[j], S - 1):
//                 its demand (3 f32), eligibility row (W packed int32
//                 words, or N dense bytes), preference row (N f32, when
//                 the plane exists) and current node (the seed, also the
//                 mini problem's sticky_prev). Pad slots are inert
//                 phantoms: demand 0, every eligibility bit set, preference
//                 0, seeded on argmax(node_valid), the first valid node.
//   ff_k5_commit  picks the winning chain, the first index of the least
//                 key where key_c = soft_c if viol_c == min(viol) else
//                 +inf (the reference's lexicographic argmin), copies the
//                 resident assignment into a FRESH output and scatters the
//                 winner's rows into it where rows[j] < S (pad slots carry
//                 S and are dropped). The input is never written: a
//                 gate-rejected sub-solve re-runs the full path from it.
//
// Bound: bytes. The gather reads tier rows of demand and eligibility (and
// preference) plus the N validity bytes and writes as many; the commit
// reads and writes the (S,) assignment and tier winner entries. Every
// access is a small contiguous row, so there is nothing to compute. Design:
// the gather runs one block per kRows rows, threads striding over a row's
// words; each block finds the first valid node itself (N bytes from L2).
// The commit is two launches on one stream, a grid-stride copy and then
// one thread per tier slot for the scatter, so every scatter lands after
// the copy of its element; closure rows are unique, so no two slots write
// one element.
#include "common.cuh"

namespace {

constexpr int kRows = 4;        // mini-problem rows per gather block
constexpr int kThreads = 256;

__global__ void k5_gather_kernel(int S, int N, int W, int packed, int tier,
                                 int n_sub, const int* __restrict__ rows,
                                 const int* __restrict__ assignment,
                                 const float* __restrict__ demand,
                                 const void* __restrict__ elig,
                                 const float* __restrict__ pref,
                                 const unsigned char* __restrict__ valid,
                                 float* demand_out, void* elig_out,
                                 float* pref_out, int* seed_out) {
  __shared__ int park;
  if (threadIdx.x == 0) park = INT_MAX;
  __syncthreads();
  int first = INT_MAX;
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    if (valid[n]) {
      first = n;
      break;
    }
  if (first != INT_MAX) atomicMin(&park, first);
  __syncthreads();
  const int node0 = park == INT_MAX ? 0 : park;

  for (int r = 0; r < kRows; ++r) {
    const int j = blockIdx.x * kRows + r;
    if (j >= tier) break;
    const bool real = j < n_sub;
    const int src = min(rows[j], S - 1);
    if (threadIdx.x < 3)
      demand_out[(size_t)j * 3 + threadIdx.x] =
          real ? demand[(size_t)src * 3 + threadIdx.x] : 0.f;
    if (threadIdx.x == 0) seed_out[j] = real ? assignment[src] : node0;
    if (packed) {
      const int* e = static_cast<const int*>(elig);
      int* o = static_cast<int*>(elig_out);
      for (int w = threadIdx.x; w < W; w += blockDim.x)
        o[(size_t)j * W + w] = real ? e[(size_t)src * W + w] : -1;
    } else {
      const unsigned char* e = static_cast<const unsigned char*>(elig);
      unsigned char* o = static_cast<unsigned char*>(elig_out);
      for (int w = threadIdx.x; w < W; w += blockDim.x)
        o[(size_t)j * W + w] = real ? e[(size_t)src * W + w] : 1;
    }
    if (pref != nullptr)
      for (int n = threadIdx.x; n < N; n += blockDim.x)
        pref_out[(size_t)j * N + n] = real ? pref[(size_t)src * N + n] : 0.f;
  }
}

__global__ void k5_copy_kernel(int S, const int* __restrict__ src, int* dst) {
  for (size_t i = grid_tid(); i < (size_t)S; i += grid_stride()) dst[i] = src[i];
}

__global__ void k5_scatter_kernel(int C, int tier, int S,
                                  const int* __restrict__ best_assign,
                                  const float* __restrict__ best_viol,
                                  const float* __restrict__ best_soft,
                                  const int* __restrict__ rows, int* out,
                                  int* best_out) {
  float min_viol = best_viol[0];
  for (int c = 1; c < C; ++c) min_viol = fminf(min_viol, best_viol[c]);
  int best = 0;
  float best_key = best_viol[0] == min_viol ? best_soft[0] : CUDART_INF_F;
  for (int c = 1; c < C; ++c) {
    const float key = best_viol[c] == min_viol ? best_soft[c] : CUDART_INF_F;
    if (key < best_key) {
      best_key = key;
      best = c;
    }
  }
  if (grid_tid() == 0) best_out[0] = best;
  for (size_t j = grid_tid(); j < (size_t)tier; j += grid_stride()) {
    const int r = rows[j];
    if (r >= 0 && r < S) out[r] = best_assign[(size_t)best * tier + j];
  }
}

}  // namespace

FF_EXPORT int ff_k5_gather(int S, int N, int W, int packed, int tier,
                           int n_sub, const int* rows, const int* assignment,
                           const float* demand, const void* elig,
                           const float* pref, const unsigned char* valid,
                           float* demand_out, void* elig_out, float* pref_out,
                           int* seed_out, cudaStream_t stream) {
  const int blocks = (tier + kRows - 1) / kRows;
  k5_gather_kernel<<<blocks, kThreads, 0, stream>>>(
      S, N, W, packed, tier, n_sub, rows, assignment, demand, elig, pref,
      valid, demand_out, elig_out, pref_out, seed_out);
  return static_cast<int>(cudaGetLastError());
}

FF_EXPORT int ff_k5_commit(int C, int tier, int S, const int* best_assign,
                           const float* best_viol, const float* best_soft,
                           const int* rows, const int* assignment, int* out,
                           int* best_out, cudaStream_t stream) {
  k5_copy_kernel<<<ff_blocks(S, kThreads), kThreads, 0, stream>>>(
      S, assignment, out);
  k5_scatter_kernel<<<ff_blocks(tier, kThreads), kThreads, 0, stream>>>(
      C, tier, S, best_assign, best_viol, best_soft, rows, out, best_out);
  return static_cast<int>(cudaGetLastError());
}
