// K6: the per-service first-fit-decreasing scan seed.
//
// Replaces fleetflow_tpu/solver/greedy.py::greedy_place (one lax.scan step
// per service). Services are placed one at a time in `order`; for service s
// every node n is scored against the running (load, used) state:
//   conflict  Σ_k used[n, ids_k] over the valid ids (> 0 is a conflict)
//   fits      load[n, r] + d_r <= cap[n, r] + 1e-6 for r = 0, 1, 2
//   ok        fits & eligible[s, n] & node_valid[n] & !conflict
//   score     -usq (spread), +usq (pack) or -(float)n (fill_lowest), plus
//             preferred[s, n] * 0.5 when the plane is present, where
//             usq = Σ_r (new_r / max(cap_r, 1e-6))², summed r = 0, 1, 2
// The winner is the first argmax of the score over the ok nodes; when no
// node is ok, the first argmax of the best-effort score
//   -(overflow * 1e3 + n_conf * 1e3) + score
// masked with `- 1e15` (not -inf) where the node is not eligible and valid,
// as the reference masks it. The winner's load, occupancy and assignment
// are committed before the next service is scored.
//
// Bound: latency. The S steps are strictly sequential; each reads the K
// conflict columns of the (N, G) occupancy, the (N, 3) load and capacity,
// one eligibility row, node_valid and the preference row (~50 KB at
// N = 1000), a few microseconds of work behind two barriers. The roofline
// of the function is its operation count (~30 f32 operations a node a
// step): its inputs are read once, and the running load and occupancy are
// state small enough to keep on chip, so this design's re-reads of them
// from global memory are its own cost, not the function's. Design: one
// persistent block of 1024 threads runs the whole scan. Thread t owns the
// nodes n ≡ t (mod 1024) and keeps the best (value, index) of both scores
// over them; one block-wide argmax (lowest index on equal values, as
// jnp.argmax) picks the winner, thread 0 commits it, and a barrier makes
// the commit visible to the next step. No wgmma or TMA: this is the simple
// kernel that is right; a faster design (the state in shared memory, more
// than one block) is later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr float kNeg = -1e30f;

__global__ void k6_init(int S, int N, int G, float* load, int* used,
                        int* assignment) {
  const size_t step = grid_stride();
  for (size_t i = grid_tid(); i < (size_t)N * 3; i += step) load[i] = 0.f;
  for (size_t i = grid_tid(); i < (size_t)N * G; i += step) used[i] = 0;
  for (size_t i = grid_tid(); i < (size_t)S; i += step) assignment[i] = -1;
}

__global__ void __launch_bounds__(kThreads) k6_scan(
    int S, int N, int G, const float* __restrict__ demand,
    const float* __restrict__ cap, const int* __restrict__ cids, int K,
    const void* elig, int packed, int stride,
    const unsigned char* __restrict__ valid, const float* __restrict__ pref,
    int strategy, const int* __restrict__ order, int n_order, float* load,
    int* used, int* assignment) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  for (int i = 0; i < n_order; ++i) {
    const int s = order[i];
    const float d0 = demand[(size_t)s * 3 + 0];
    const float d1 = demand[(size_t)s * 3 + 1];
    const float d2 = demand[(size_t)s * 3 + 2];
    const int* ids = cids + (size_t)s * K;
    float ok_v = kNeg, fb_v = -CUDART_INF_F;
    int ok_i = INT_MAX, fb_i = INT_MAX;
    int any_ok = 0;
    for (int n = threadIdx.x; n < N; n += kThreads) {
      int n_conf = 0;
      for (int k = 0; k < K; ++k) {
        const int id = ids[k];
        if (id >= 0) n_conf += used[(size_t)n * G + id];
      }
      const float* l = load + (size_t)n * 3;
      const float* c = cap + (size_t)n * 3;
      const float c0 = c[0], c1 = c[1], c2 = c[2];
      const float n0 = l[0] + d0, n1 = l[1] + d1, n2 = l[2] + d2;
      const bool fits = (n0 <= c0 + 1e-6f) && (n1 <= c1 + 1e-6f) &&
                        (n2 <= c2 + 1e-6f);
      const bool el = ff_elig(elig, packed, stride, s, n) && valid[n];
      const bool ok = fits && el && n_conf == 0;
      const float u0 = n0 / fmaxf(c0, 1e-6f);
      const float u1 = n1 / fmaxf(c1, 1e-6f);
      const float u2 = n2 / fmaxf(c2, 1e-6f);
      const float usq = (u0 * u0 + u1 * u1) + u2 * u2;
      float score = strategy == 0 ? -usq : (strategy == 1 ? usq : -(float)n);
      if (pref != nullptr) score = score + pref[(size_t)s * N + n] * 0.5f;
      // the feasible argmax over every node, infeasible ones at -1e30
      const float v = ok ? score : kNeg;
      if (ff_better_max(v, n, ok_v, ok_i)) {
        ok_v = v;
        ok_i = n;
      }
      any_ok |= ok;
      const float over = (fmaxf(n0 - c0, 0.f) + fmaxf(n1 - c1, 0.f)) +
                         fmaxf(n2 - c2, 0.f);
      float fb = -(over * 1e3f + (float)n_conf * 1e3f) + score;
      if (!el) fb = fb - 1e15f;
      if (ff_better_max(fb, n, fb_v, fb_i)) {
        fb_v = fb;
        fb_i = n;
      }
    }
    // the fallback is taken only when no node at all is ok
    const bool feasible = __syncthreads_or(any_ok) != 0;
    float v = feasible ? ok_v : fb_v;
    int idx = feasible ? ok_i : fb_i;
    block_arg<false>(v, idx, red_v, red_i);
    if (threadIdx.x == 0) {
      float* l = load + (size_t)idx * 3;
      l[0] = l[0] + d0;
      l[1] = l[1] + d1;
      l[2] = l[2] + d2;
      for (int k = 0; k < K; ++k) {
        const int id = ids[k];
        if (id >= 0) used[(size_t)idx * G + id] += 1;
      }
      assignment[s] = idx;
    }
    __syncthreads();
  }
}

}  // namespace

FF_EXPORT int ff_k6_greedy_scan(int S, int N, int G, const float* demand,
                                const float* cap, const int* cids, int K,
                                const void* elig, int packed, int stride,
                                const unsigned char* valid, const float* pref,
                                int strategy, const int* order, int n_order,
                                int* assignment, float* load, int* used,
                                cudaStream_t stream) {
  const long long init_work = (long long)N * (G > 3 ? G : 3);
  k6_init<<<ff_blocks(init_work > S ? init_work : S, 256), 256, 0, stream>>>(
      S, N, G, load, used, assignment);
  k6_scan<<<1, kThreads, 0, stream>>>(S, N, G, demand, cap, cids, K, elig,
                                      packed, stride, valid, pref, strategy,
                                      order, n_order, load, used, assignment);
  return static_cast<int>(cudaGetLastError());
}
