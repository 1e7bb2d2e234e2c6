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
// iterations.
#include "common.cuh"

namespace {

struct Problem {
  int S, N, G, Gc1, T, K, Kc;
  const float* demand;
  const float* cap;
  const int* cids;
  const int* colids;
  const void* elig;
  int packed, stride;
  const unsigned char* valid;
  const int* ntopo;
  const float* pref;
  const int* sticky_prev;
  float sticky_w;
  int strategy, max_skew, n_real;
};

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

__device__ __forceinline__ float overflow_mass(const float l[3], const float c[3]) {
  const float x0 = fmaxf(l[0] - c[0], 0.f) / fmaxf(c[0], 1e-6f);
  const float x1 = fmaxf(l[1] - c[1], 0.f) / fmaxf(c[1], 1e-6f);
  const float x2 = fmaxf(l[2] - c[2], 0.f) / fmaxf(c[2], 1e-6f);
  return (x0 + x1) + x2;
}

__device__ __forceinline__ float soft_rows(const Problem& p, const float la[3],
                                           const float lb[3], const float ca[3],
                                           const float cb[3]) {
  if (p.strategy != 0 && p.strategy != 1) return 0.f;
  float usq = 0.f;
  bool first = true;
  for (int r = 0; r < 3; ++r) {
    const float u = la[r] / fmaxf(ca[r], 1e-6f);
    usq = first ? u * u : usq + u * u;
    first = false;
  }
  for (int r = 0; r < 3; ++r) {
    const float u = lb[r] / fmaxf(cb[r], 1e-6f);
    usq = usq + u * u;
  }
  return p.strategy == 0 ? usq / (float)p.N : -usq / (float)p.N;
}

__device__ __forceinline__ float skew_pen(int tmax, int tmin, int max_skew) {
  return fmaxf((float)(tmax - tmin) - (float)max_skew, 0.f) * 1e3f;
}

__device__ float move_delta(const Problem& p, const float* ld, const int* us,
                            const int* co, const int* tp, int tmax, int tmin,
                            int s, int a, int b) {
  const bool ea = ff_elig(p.elig, p.packed, p.stride, s, a) && p.valid[a];
  const bool eb = ff_elig(p.elig, p.packed, p.stride, s, b) && p.valid[b];
  float d_pref = 0.f;
  if (p.pref != nullptr)
    d_pref = (p.pref[(size_t)s * p.N + a] - p.pref[(size_t)s * p.N + b]) / (float)p.S;
  if (p.sticky_prev != nullptr) {
    const int prev = p.sticky_prev[s];
    const bool anch = ff_elig(p.elig, p.packed, p.stride, s, prev) && p.valid[prev];
    d_pref = d_pref + p.sticky_w * ((float)(a == prev && anch) - (float)(b == prev && anch));
  }
  float d[3], ca[3], cb[3], la[3], lb[3], la2[3], lb2[3];
  for (int r = 0; r < 3; ++r) {
    d[r] = p.demand[(size_t)s * 3 + r];
    ca[r] = p.cap[(size_t)a * 3 + r];
    cb[r] = p.cap[(size_t)b * 3 + r];
    la[r] = ld[(size_t)a * 3 + r];
    lb[r] = ld[(size_t)b * 3 + r];
    la2[r] = la[r] - d[r];
    lb2[r] = lb[r] + d[r];
  }
  const float over_before = overflow_mass(la, ca) + overflow_mass(lb, cb);
  const float over_after = overflow_mass(la2, ca) + overflow_mass(lb2, cb);
  const float d_cap = (over_after - over_before) * 1e3f;

  int conf_a = 0, conf_b = 0;
  for (int k = 0; k < p.K; ++k) {
    const int id = p.cids[(size_t)s * p.K + k];
    if (id < 0) continue;
    conf_a += us[(size_t)a * p.G + id] - 1;
    conf_b += us[(size_t)b * p.G + id];
  }
  const float d_conf = (float)(conf_b - conf_a) * 1e4f;
  const float d_elig = ((float)ea - (float)eb) * 1e6f;

  float d_skew = 0.f;
  if (p.max_skew > 0) {
    const int r = s < p.n_real ? 1 : 0;
    const int ta = p.ntopo[a], tb = p.ntopo[b];
    int hi = INT_MIN, lo = INT_MAX;
    for (int t = 0; t < p.T; ++t) {
      const int v = tp[t] - (t == ta ? r : 0) + (t == tb ? r : 0);
      hi = max(hi, v);
      lo = min(lo, v);
    }
    d_skew = skew_pen(hi, lo, p.max_skew) - skew_pen(tmax, tmin, p.max_skew);
  }

  const float soft_before = soft_rows(p, la, lb, ca, cb);
  const float soft_after = soft_rows(p, la2, lb2, ca, cb);
  int col_a = 0, col_b = 0;
  for (int k = 0; k < p.Kc; ++k) {
    const int id = p.colids[(size_t)s * p.Kc + k];
    if (id < 0) continue;
    col_a += co[(size_t)a * p.Gc1 + id] - 1;
    col_b += co[(size_t)b * p.Gc1 + id];
  }
  const float d_coloc = (float)(col_a - col_b) / (float)(p.S > 1 ? p.S : 1);
  return d_cap + d_conf + d_elig + d_skew + (soft_after - soft_before) + d_pref + d_coloc;
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
  if (p.max_skew > 0) {
    float hi = -CUDART_INF_F, lo = CUDART_INF_F;
    int dummy = 0;
    for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
      hi = fmaxf(hi, (float)tp[t]);
      lo = fminf(lo, (float)tp[t]);
    }
    block_arg<false>(hi, dummy, red_v, red_i);
    block_arg<true>(lo, dummy, red_v, red_i);
    tmax = (int)hi;
    tmin = (int)lo;
  }

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
