// K1: one parallel-Metropolis sweep of C annealing chains.
//
// Replaces fleetflow_tpu/solver/anneal.py::_batched_step with
// _proposal_delta and _move_delta_core. The proposals (s_idx, b_idx, u)
// are drawn outside, so the kernel is deterministic given them. Per chain:
//   1. one thread per proposal m computes the annealing-cost delta of
//      moving service s to node b against the PRE-sweep state (capacity
//      overflow mass ×1e3, conflicts ×1e4, eligibility ×1e6, skew ×1e3,
//      the strategy soft term of the two rows, preference/stickiness,
//      colocation), term for term in the reference's order, and accepts
//      when Δ<0 or u<exp(-Δ/T) and a != b;
//   2. winners: the lowest accepted index per service, then the lowest
//      applied index per target node (at most one arrival lands on a node
//      per sweep, which keeps a feasible chain feasible). Both are O(M²)
//      scans over proposals in shared memory, exact and order-free;
//   3. apply: one thread walks the winners in proposal order, departures
//      then arrivals, for the float load (the order of the reference's CPU
//      scatter, so the result is bit-equal); the integer planes and the
//      assignment are updated by all threads with integer atomics.
//
// Lanes (the tenant multiplexer, fleetflow_tpu/solver/multiplex.py's
// vmapped _refine): L same-tier problems stacked on a leading axis, the
// state (L, C, ...) and the proposals (L, C, M). The grid is (C, L); a
// block offsets its problem and state pointers by its lane's strides and
// returns at once when its lane is inactive (a lane whose anneal exited
// stays frozen). Each block runs the solo code, so a lane's result equals
// a solo sweep bit for bit; a solo call is L = 1.
//
// Bound: latency. A sweep moves a few hundred proposals' rows (a few tens
// of KB), far below what the card's bandwidth or ALUs notice; its time is
// the launch plus one block's dependent phases. Design: one block per
// (chain, lane), no global scratch; the serial float apply is M
// iterations. The problem and the move delta live in sweep_delta.cuh,
// shared with K7.
#include "sweep_delta.cuh"

namespace {

// lane `lane`'s problem: every stacked plane is a contiguous (L, ...)
// tensor, so its lane stride is its per-lane size
__device__ __forceinline__ Problem lane_problem(Problem p, int lane,
                                                const FFLanes& ls) {
  const size_t S = p.S, N = p.N, l = lane;
  p.demand += l * S * 3;
  p.cap += l * N * 3;
  p.cids += l * S * p.K;
  p.colids += l * S * p.Kc;
  p.elig = static_cast<const char*>(p.elig) +
           l * S * p.stride * (p.packed ? sizeof(int) : 1);
  p.valid += l * N;
  p.ntopo += l * N;
  if (p.pref != nullptr) p.pref += l * S * N;
  if (p.sticky_prev != nullptr) p.sticky_prev += l * S;
  p.sticky_w = ls.sticky_w[lane];
  p.n_real = ls.n_real[lane];
  return p;
}

__global__ void k1_sweep_kernel(Problem p0, FFLanes ls, int C,
                                int* assignment, float* load, int* used,
                                int* coloc, int* topo,
                                const int* __restrict__ s_idx,
                                const int* __restrict__ b_idx,
                                const float* __restrict__ u, int M,
                                int* applied_out) {
  const int lane = blockIdx.y;
  if (!ls.active[lane]) return;  // the whole block: no barrier is skipped
  const Problem p = lane_problem(p0, lane, ls);
  extern __shared__ int sm[];
  int* s_sm = sm;
  int* a_sm = sm + M;
  int* b_sm = sm + 2 * M;
  int* acc_sm = sm + 3 * M;
  int* win_sm = sm + 4 * M;
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  // the state row of (lane, chain): the state is (L, C, ...)
  const size_t c = (size_t)lane * C + blockIdx.x;
  int* asg = assignment + c * p.S;
  float* ld = load + c * p.N * 3;
  int* us = used + c * p.N * p.G;
  int* co = coloc + c * p.N * p.Gc1;
  int* tp = topo + c * p.T;

  int tmax = 0, tmin = 0;
  if (p.max_skew > 0) block_topo_range(tp, p.T, tmax, tmin, red_v, red_i);

  const float t = fmaxf(ls.temp[lane], 1e-8f);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int s = s_idx[c * M + m];
    const int b = b_idx[c * M + m];
    const int a = asg[s];
    const float delta = move_delta(p, ld, us, co, tp, tmax, tmin, s, a, b);
    const float uu = u[c * M + m];
    const bool accept = ((delta < 0.f) || (uu < expf(-delta / t))) && (a != b);
    s_sm[m] = s;
    a_sm[m] = a;
    b_sm[m] = b;
    acc_sm[m] = accept;
  }
  __syncthreads();
  // winner per service: no earlier accepted proposal for the same service
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    bool w = acc_sm[m];
    for (int q = 0; w && q < m; ++q) w = !(acc_sm[q] && s_sm[q] == s_sm[m]);
    win_sm[m] = w;
  }
  __syncthreads();
  // winner per target node: no earlier applied proposal for the same node
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    bool w = win_sm[m];
    for (int q = 0; w && q < m; ++q) w = !(win_sm[q] && b_sm[q] == b_sm[m]);
    acc_sm[m] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n_applied = 0;
    for (int m = 0; m < M; ++m) {  // departures, in proposal order
      if (!acc_sm[m]) continue;
      const int s = s_sm[m], a = a_sm[m];
      for (int r = 0; r < 3; ++r)
        ld[(size_t)a * 3 + r] = ld[(size_t)a * 3 + r] + (-p.demand[(size_t)s * 3 + r]);
      ++n_applied;
    }
    for (int m = 0; m < M; ++m) {  // arrivals, in proposal order
      if (!acc_sm[m]) continue;
      const int s = s_sm[m], b = b_sm[m];
      for (int r = 0; r < 3; ++r)
        ld[(size_t)b * 3 + r] = ld[(size_t)b * 3 + r] + p.demand[(size_t)s * 3 + r];
    }
    applied_out[c] = n_applied;
  }
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    if (!acc_sm[m]) continue;
    const int s = s_sm[m], a = a_sm[m], b = b_sm[m];
    for (int k = 0; k < p.K; ++k) {
      const int id = p.cids[(size_t)s * p.K + k];
      if (id < 0) continue;
      atomicSub(&us[(size_t)a * p.G + id], 1);
      atomicAdd(&us[(size_t)b * p.G + id], 1);
    }
    for (int k = 0; k < p.Kc; ++k) {
      const int id = p.colids[(size_t)s * p.Kc + k];
      if (id < 0) continue;
      atomicSub(&co[(size_t)a * p.Gc1 + id], 1);
      atomicAdd(&co[(size_t)b * p.Gc1 + id], 1);
    }
    if (s < p.n_real) {
      atomicSub(&tp[p.ntopo[a]], 1);
      atomicAdd(&tp[p.ntopo[b]], 1);
    }
    asg[s] = b;
  }
}

}  // namespace

FF_EXPORT int ff_k1_sweep(
    int L, int C, int S, int N, int G, int Gc1, int T, const float* demand,
    const float* cap, const int* cids, int K, const int* colids, int Kc,
    const void* elig, int packed, int stride, const unsigned char* valid,
    const int* ntopo, const float* pref, const int* sticky_prev,
    int strategy, int max_skew, FFLanes lanes, int* assignment, float* load,
    int* used, int* coloc, int* topo, const int* s_idx, const int* b_idx,
    const float* u, int M, int* applied, cudaStream_t stream) {
  if (L < 1 || L > FF_MAX_LANES) return static_cast<int>(cudaErrorInvalidValue);
  Problem p{S, N, G, Gc1, T, K, Kc, demand, cap, cids, colids, elig, packed,
            stride, valid, ntopo, pref, sticky_prev, 0.f, strategy, max_skew,
            0};
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  const size_t smem = (size_t)5 * M * sizeof(int);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k1_sweep_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  k1_sweep_kernel<<<dim3(C, L), threads, smem, stream>>>(
      p, lanes, C, assignment, load, used, coloc, topo, s_idx, b_idx, u, M,
      applied);
  return static_cast<int>(cudaGetLastError());
}
