// K7: one sweep of the service-axis sharded anneal, every (replica, shard)
// position of a mesh whose positions share one card.
//
// Replaces fleetflow_tpu/solver/sharded.py::anneal_sharded's `sweep`
// closure (sharded.py:443-538) with `proposal_delta` (:369-384). There each
// mesh position is a device: it owns S/D services (the shard), holds a
// replicated copy of its replica's node state, and two collectives keep
// the copies equal: a `pmin` that elects one winning move per target node
// across the shards, and `psum`s of the applied state deltas. Here the
// shards are thread blocks and the replicated state is held once per
// replica: the state is (R, ...) like K1's chains, (R, S) assignment,
// (R, N, 3) load, (R, N, G) and (R, N, Gc1) occupancy, (R, T) topology.
// The proposals (s_loc, b_idx, u) are drawn outside, (R, D, M) each, with
// s_loc a shard-local service index, so the kernels are deterministic
// given them.
//
// Three launches a sweep, on the caller's stream (a launch boundary is the
// grid-wide barrier the election needs):
//   1. elect, one block per position (shard, replica): one thread per
//      proposal computes the annealing-cost delta of moving its service
//      (global row d*S/D + s_loc) from a to b against the PRE-sweep state
//      (move_delta, shared with K1: no stickiness, the preference term
//      divided by the padded global S), accepts when Δ<0 or u<exp(-Δ/T)
//      and a != b at the replica's temperature, keeps the lowest accepted
//      proposal per service (an O(M²) scan in shared memory), and posts
//      rank = m + M·d into the replica's per-node array with atomicMin:
//      the reference's pmin. The candidates go to global scratch.
//   2. apply, one block per position: a candidate whose rank won its
//      target node is applied. The integer planes and the assignment take
//      integer atomics (order-free). The float load follows the
//      reference's order: one thread walks the position's applied moves in
//      proposal order, departures then arrivals, into the position's own
//      (N, 3) partial (the reference's zeros.at[a].add(-d).at[b].add(d)).
//   3. reduce, one thread per (replica, node): the partials summed in
//      shard order, ((p0 + p1) + p2) + ..., then added to the load (the
//      reference's psum over the shard axis sums in device order on the
//      CPU, so the load stays bit-equal to it); every partial back to 0
//      and the node's election slot back to INT_MAX for the next sweep.
// The scratch (candidates, election slots, partials) is the caller's: the
// election slots start at INT_MAX and the partials at 0, and launch 3
// leaves them so.
//
// Bound: latency, like K1. A sweep moves 2·D·M proposals' rows (a few
// hundred KB at most) and the dense reduce R·D·N·3 floats; the time is
// three launches and one block's dependent phases. Design: a block per
// position, so D·R blocks; the serial float walk is M iterations a block.
#include "sweep_delta.cuh"

namespace {

struct Scratch {
  int* s;          // (R, D, M) global service row
  int* a;          // (R, D, M) source node
  int* b;          // (R, D, M) target node
  int* cand;       // (R, D, M) lowest accepted proposal of its service
  int* best;       // (R, N) election slot: lowest rank posted, INT_MAX
  float* partial;  // (R, D, N, 3) the positions' load deltas, 0 between sweeps
};

__global__ void k7_elect_kernel(Problem p, FFLanes ls, int D,
                                const int* __restrict__ assignment,
                                const float* __restrict__ load,
                                const int* __restrict__ used,
                                const int* __restrict__ coloc,
                                const int* __restrict__ topo,
                                const int* __restrict__ s_loc,
                                const int* __restrict__ b_idx,
                                const float* __restrict__ u, int M,
                                Scratch sc) {
  const int d = blockIdx.x, r = blockIdx.y;
  const int S_loc = p.S / D;
  extern __shared__ int sm[];
  int* s_sm = sm;
  int* b_sm = sm + M;
  int* acc_sm = sm + 2 * M;
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  const int* asg = assignment + (size_t)r * p.S;
  const float* ld = load + (size_t)r * p.N * 3;
  const int* us = used + (size_t)r * p.N * p.G;
  const int* co = coloc + (size_t)r * p.N * p.Gc1;
  const int* tp = topo + (size_t)r * p.T;
  int tmax = 0, tmin = 0;
  if (p.max_skew > 0) block_topo_range(tp, p.T, tmax, tmin, red_v, red_i);

  const float t = fmaxf(ls.temp[r], 1e-8f);
  const size_t base = ((size_t)r * D + d) * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int s = d * S_loc + s_loc[base + m];
    const int b = b_idx[base + m];
    const int a = asg[s];
    const float delta = move_delta(p, ld, us, co, tp, tmax, tmin, s, a, b);
    const float uu = u[base + m];
    s_sm[m] = s;
    b_sm[m] = b;
    acc_sm[m] = ((delta < 0.f) || (uu < expf(-delta / t))) && (a != b);
    sc.s[base + m] = s;
    sc.a[base + m] = a;
    sc.b[base + m] = b;
  }
  __syncthreads();
  // winner per service: no earlier accepted proposal for the same service;
  // the winners post their rank for their target node (the pmin)
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    bool w = acc_sm[m];
    for (int q = 0; w && q < m; ++q) w = !(acc_sm[q] && s_sm[q] == s_sm[m]);
    sc.cand[base + m] = w;
    if (w) atomicMin(&sc.best[(size_t)r * p.N + b_sm[m]], m + M * d);
  }
}

__global__ void k7_apply_kernel(Problem p, int D, int* assignment,
                                int* used, int* coloc, int* topo, int M,
                                Scratch sc, int* applied_out) {
  const int d = blockIdx.x, r = blockIdx.y;
  extern __shared__ int sm[];
  int* app_sm = sm;
  int* asg = assignment + (size_t)r * p.S;
  int* us = used + (size_t)r * p.N * p.G;
  int* co = coloc + (size_t)r * p.N * p.Gc1;
  int* tp = topo + (size_t)r * p.T;
  const size_t base = ((size_t)r * D + d) * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int s = sc.s[base + m], a = sc.a[base + m], b = sc.b[base + m];
    const bool applied =
        sc.cand[base + m] && sc.best[(size_t)r * p.N + b] == m + M * d;
    app_sm[m] = applied;
    if (!applied) continue;
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
  __syncthreads();
  if (threadIdx.x != 0) return;
  // this position's load delta, departures then arrivals in proposal order
  float* part = sc.partial + ((size_t)r * D + d) * p.N * 3;
  int n_applied = 0;
  for (int m = 0; m < M; ++m) {
    if (!app_sm[m]) continue;
    const int s = sc.s[base + m], a = sc.a[base + m];
    for (int k = 0; k < 3; ++k)
      part[(size_t)a * 3 + k] = part[(size_t)a * 3 + k] + (-p.demand[(size_t)s * 3 + k]);
    ++n_applied;
  }
  for (int m = 0; m < M; ++m) {
    if (!app_sm[m]) continue;
    const int s = sc.s[base + m], b = sc.b[base + m];
    for (int k = 0; k < 3; ++k)
      part[(size_t)b * 3 + k] = part[(size_t)b * 3 + k] + p.demand[(size_t)s * 3 + k];
  }
  applied_out[(size_t)r * D + d] = n_applied;
}

__global__ void k7_reduce_kernel(int N, int D, float* load, Scratch sc) {
  const int r = blockIdx.y;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float* ld = load + ((size_t)r * N + n) * 3;
  for (int k = 0; k < 3; ++k) {
    float* p0 = sc.partial + (((size_t)r * D) * N + n) * 3 + k;
    float sum = *p0;
    *p0 = 0.f;
    for (int d = 1; d < D; ++d) {
      float* pd = sc.partial + (((size_t)r * D + d) * N + n) * 3 + k;
      sum = sum + *pd;
      *pd = 0.f;
    }
    ld[k] = ld[k] + sum;
  }
  sc.best[(size_t)r * N + n] = INT_MAX;
}

}  // namespace

// scratch_i holds 4·R·D·M ints (the candidates) then R·N election slots
// (INT_MAX between sweeps); scratch_f holds R·D·N·3 floats (0 between
// sweeps). lanes.temp[r] is replica r's temperature, lanes.n_real[0] the
// real-row count.
FF_EXPORT int ff_k7_sweep(
    int R, int D, int S, int N, int G, int Gc1, int T, const float* demand,
    const float* cap, const int* cids, int K, const int* colids, int Kc,
    const void* elig, int packed, int stride, const unsigned char* valid,
    const int* ntopo, const float* pref, int strategy, int max_skew,
    FFLanes lanes, int* assignment, float* load, int* used, int* coloc,
    int* topo, const int* s_loc, const int* b_idx, const float* u, int M,
    int* applied, int* scratch_i, float* scratch_f, cudaStream_t stream) {
  if (R < 1 || R > FF_MAX_LANES || D < 1 || S % D != 0 || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{S, N, G, Gc1, T, K, Kc, demand, cap, cids, colids, elig, packed,
            stride, valid, ntopo, pref, nullptr, 0.f, strategy, max_skew,
            lanes.n_real[0]};
  const size_t RDM = (size_t)R * D * M;
  Scratch sc{scratch_i, scratch_i + RDM, scratch_i + 2 * RDM,
             scratch_i + 3 * RDM, scratch_i + 4 * RDM, scratch_f};
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)3 * M * sizeof(int);
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k7_elect_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid(D, R);
  k7_elect_kernel<<<grid, threads, smem, stream>>>(
      p, lanes, D, assignment, load, used, coloc, topo, s_loc, b_idx, u, M,
      sc);
  k7_apply_kernel<<<grid, threads, (size_t)M * sizeof(int), stream>>>(
      p, D, assignment, used, coloc, topo, M, sc, applied);
  const int rt = 256;
  k7_reduce_kernel<<<dim3((N + rt - 1) / rt, R), rt, 0, stream>>>(N, D, load,
                                                                  sc);
  return static_cast<int>(cudaGetLastError());
}
