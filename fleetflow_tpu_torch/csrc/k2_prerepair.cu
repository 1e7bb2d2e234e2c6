// K2: fused churn pre-repair of one chain state.
//
// Replaces fleetflow_tpu/solver/anneal.py::prerepair_state_counted. The
// reference's while_loop takes, each iteration, the first stranded (on an
// ineligible or invalid node) service not yet attempted, scores all N nodes
//   clean fit (capacity, conflicts, eligibility) -> max utilization
//   eligible and valid only                      -> max utilization + 1e6
//   otherwise                                    -> inf
// and moves the service to the argmin (first index on ties), if finite.
// A service's stranded bit depends only on its own node, which changes only
// when the loop takes it, so the walk is the initial stranded set in index
// order, cut at max_moves. Returns the number of moves applied.
//
// Lanes (the tenant multiplexer): L same-tier problems stacked on a
// leading axis, one chain each, the state (L, 1, ...). One persistent block
// per lane (grid L) runs the solo loop on its lane's planes, so a lane
// equals a solo pre-repair; the moves come back as (L,).
//
// Bound: latency. Each of at most max_moves (≤256) iterations reads the
// (N, 3) load and capacity and K conflict columns of the (N, G) occupancy
// (~30 KB at N=1000), and the iterations are strictly sequential. Design:
// one persistent block per lane runs the whole loop: a block-wide compaction builds
// the stranded list, then each iteration is a block-wide argmin over the
// nodes followed by a one-thread update of the state and a barrier.
#include "common.cuh"

namespace {

// 1024 threads a block: the register budget must fit 64 a thread
__global__ void __launch_bounds__(1024) k2_kernel(
    int S, int N, int G, int Gc1, int T, const float* __restrict__ demand,
    const float* __restrict__ cap, const int* __restrict__ cids, int K,
    const int* __restrict__ colids, int Kc, const void* elig, int packed,
    int stride, const unsigned char* __restrict__ valid,
    const int* __restrict__ ntopo, FFLanes ls, int* asg, float* ld, int* us,
    int* co, int* tp, int max_moves, int* moves_out, int* list) {
  __shared__ int part[1024];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int n_todo;

  // this block's lane: every stacked plane and the state are contiguous
  // (L, ...), so a lane's stride is its per-lane size
  const size_t l = blockIdx.x;
  demand += l * S * 3;
  cap += l * N * 3;
  cids += l * S * K;
  colids += l * S * Kc;
  elig = static_cast<const char*>(elig) + l * S * stride * (packed ? sizeof(int) : 1);
  valid += l * N;
  ntopo += l * N;
  const int n_real = ls.n_real[l];
  asg += l * S;
  ld += l * N * 3;
  us += l * N * G;
  co += l * N * Gc1;
  tp += l * T;
  list += l * (S + 1);

  // 1. the stranded services, in index order
  const int chunk = (S + blockDim.x - 1) / blockDim.x;
  const int lo = min(S, (int)threadIdx.x * chunk), hi = min(S, lo + chunk);
  int mine = 0;
  for (int s = lo; s < hi; ++s) {
    const int a = asg[s];
    mine += !ff_elig(elig, packed, stride, s, a) || valid[a] == 0;
  }
  part[threadIdx.x] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
    n_todo = run;
  }
  __syncthreads();
  int pos = part[threadIdx.x];
  for (int s = lo; s < hi; ++s) {
    const int a = asg[s];
    if (!ff_elig(elig, packed, stride, s, a) || valid[a] == 0) list[pos++] = s;
  }
  __syncthreads();

  // 2. one relocation per iteration
  const int iters = min(n_todo, max_moves);
  int moves = 0;
  for (int i = 0; i < iters; ++i) {
    const int s = list[i];
    const float d0 = demand[(size_t)s * 3 + 0];
    const float d1 = demand[(size_t)s * 3 + 1];
    const float d2 = demand[(size_t)s * 3 + 2];
    float best = CUDART_INF_F;
    int best_n = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float* l = ld + (size_t)n * 3;
      const float* c = cap + (size_t)n * 3;
      const bool fits = (l[0] + d0 <= c[0] * FF_CAP_TOL) &&
                        (l[1] + d1 <= c[1] * FF_CAP_TOL) &&
                        (l[2] + d2 <= c[2] * FF_CAP_TOL);
      int conf = 0;
      for (int k = 0; k < K; ++k) {
        const int id = cids[(size_t)s * K + k];
        if (id >= 0) conf += us[(size_t)n * G + id];
      }
      const bool el = ff_elig(elig, packed, stride, s, n) && valid[n];
      const float util = fmaxf(fmaxf(l[0] / fmaxf(c[0], 1e-6f),
                                     l[1] / fmaxf(c[1], 1e-6f)),
                               l[2] / fmaxf(c[2], 1e-6f));
      const float score = (fits && conf == 0 && el) ? util
                          : (el ? util + 1e6f : CUDART_INF_F);
      if (ff_better_min(score, n, best, best_n)) {
        best = score;
        best_n = n;
      }
    }
    block_arg<true>(best, best_n, red_v, red_i);
    if (threadIdx.x == 0 && isfinite(best)) {
      const int a = asg[s], b = best_n;
      ld[(size_t)a * 3 + 0] = ld[(size_t)a * 3 + 0] + (-d0);
      ld[(size_t)a * 3 + 1] = ld[(size_t)a * 3 + 1] + (-d1);
      ld[(size_t)a * 3 + 2] = ld[(size_t)a * 3 + 2] + (-d2);
      ld[(size_t)b * 3 + 0] = ld[(size_t)b * 3 + 0] + d0;
      ld[(size_t)b * 3 + 1] = ld[(size_t)b * 3 + 1] + d1;
      ld[(size_t)b * 3 + 2] = ld[(size_t)b * 3 + 2] + d2;
      for (int k = 0; k < K; ++k) {
        const int id = cids[(size_t)s * K + k];
        if (id < 0) continue;
        us[(size_t)a * G + id] -= 1;
        us[(size_t)b * G + id] += 1;
      }
      for (int k = 0; k < Kc; ++k) {
        const int id = colids[(size_t)s * Kc + k];
        if (id < 0) continue;
        co[(size_t)a * Gc1 + id] -= 1;
        co[(size_t)b * Gc1 + id] += 1;
      }
      if (s < n_real) {
        tp[ntopo[a]] -= 1;
        tp[ntopo[b]] += 1;
      }
      asg[s] = b;
      ++moves;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) moves_out[l] = moves;
}

}  // namespace

FF_EXPORT int ff_k2_prerepair(
    int L, int S, int N, int G, int Gc1, int T, const float* demand,
    const float* cap, const int* cids, int K, const int* colids, int Kc,
    const void* elig, int packed, int stride, const unsigned char* valid,
    const int* ntopo, FFLanes lanes, int* assignment, float* load, int* used,
    int* coloc, int* topo, int max_moves, int* moves, int* scratch,
    cudaStream_t stream) {
  // scratch: the stranded list of each lane, (L, S + 1)
  if (L < 1 || L > FF_MAX_LANES) return static_cast<int>(cudaErrorInvalidValue);
  k2_kernel<<<L, 1024, 0, stream>>>(S, N, G, Gc1, T, demand, cap, cids, K,
                                    colids, Kc, elig, packed, stride, valid,
                                    ntopo, lanes, assignment, load, used,
                                    coloc, topo, max_moves, moves, scratch);
  return static_cast<int>(cudaGetLastError());
}
