// K1: one parallel-Metropolis sweep of C annealing chains.
//
// Replaces fleetflow_tpu/solver/anneal.py::_batched_step with
// _proposal_delta and _move_delta_core. The proposals (s_idx, b_idx, u)
// are drawn outside, so the kernel is deterministic given them. Per chain:
//   1. one thread per proposal m computes the annealing-cost delta of
//      moving service s to node b against the PRE-sweep state (capacity
//      overflow mass x1e3, conflicts x1e4, eligibility x1e6, skew x1e3,
//      the strategy soft term of the two rows, preference/stickiness,
//      colocation), term for term in the reference's order, and accepts
//      when delta<0 or u<exp(-delta/T) and a != b;
//   2. winners: the lowest accepted index per service, then the lowest of
//      those per target node (at most one arrival lands on a node per
//      sweep, which keeps a feasible chain feasible);
//   3. apply: departures in proposal order, then arrivals, for the float
//      load (the order of the reference's CPU scatter, so the result is
//      bit-equal to a one-thread walk); the integer planes and the
//      assignment by integer atomics.
//
// Lanes (the tenant multiplexer, fleetflow_tpu/solver/multiplex.py's
// vmapped _refine): L same-tier problems stacked on a leading axis, the
// state (L, C, ...) and the proposals (L, C, M). The grid is (C, L); a
// block offsets its problem and state pointers by its lane's strides; an
// inactive lane's blocks write 0 applied moves and leave its state alone
// (a lane whose anneal exited stays frozen). Each block runs the solo
// code, so a lane's result equals a solo sweep bit for bit; a solo call is
// L = 1.
//
// Bound: latency. A sweep moves a few hundred proposals' rows (a few tens
// of KB), far below what the card's bandwidth or ALUs notice; its time is
// the launch plus one block's dependent phases. Design:
//   - winners in O(M): each proposal takes an atomicMin of its index in a
//     shared-memory table keyed by its service, the service winners one in
//     a table keyed by their target node (open addressing: S reaches 33k).
//     A minimum is order-free, so the winners are exact;
//   - a parallel apply that keeps each node's order: a node gets at most
//     one arrival, so the one-thread walk's order for node n is its
//     departures in proposal order, then its arrival. The lowest applied
//     departure from a node walks that node's departures (reading the
//     proposals' nodes four at a time and their demand, staged in shared
//     memory by the delta phase) and adds its arrival; an arrival at a node
//     nothing leaves is added by its own thread. Every node's load is
//     written by one thread, bit-equal to the walk, without its M-long
//     chain of dependent global read-modify-writes;
//   - the problem, the state and the proposal count stay fixed over an
//     anneal's sweeps: the wrapper binds them once (K1Static) and a sweep
//     passes only its draws, temperatures and active lanes.
// Shared memory: 7M + 10H ints, H the power of two >= 2M, so M <= 2,048
// proposals a chain. The problem and the move delta live in
// sweep_delta.cuh, shared with K7.
#ifdef K1_PHASES
#define FF_PHASES 1
#endif
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

// the slot of `key` in an open-addressing table of mask + 1 slots (a power
// of two, never full), inserting it when absent and `insert`; -1 when
// absent and not inserting. Keys are never removed.
__device__ __forceinline__ int table_slot(int* keys, unsigned mask, int key,
                                          bool insert) {
  unsigned h = static_cast<unsigned>(key) * 0x9E3779B1u;
  h = (h ^ (h >> 15)) & mask;
  volatile int* vk = keys;
  while (true) {
    const int k = vk[h];
    if (k == key) return static_cast<int>(h);
    if (k == -1) {
      if (!insert) return -1;
      const int prev = atomicCAS(&keys[h], -1, key);
      if (prev == -1 || prev == key) return static_cast<int>(h);
    }
    h = (h + 1) & mask;
  }
}

// a proposal's standing after each phase
enum : int { kRejected = 0, kAccepted = 1, kServiceWinner = 2, kApplied = 3 };

__global__ void k1_sweep_kernel(Problem p0, FFLanes ls, int C,
                                int* assignment, float* load, int* used,
                                int* coloc, int* topo,
                                const int* __restrict__ s_idx,
                                const int* __restrict__ b_idx,
                                const float* __restrict__ u, int M, int H,
                                int* applied_out) {
  const int lane = blockIdx.y;
  // the state row of (lane, chain): the state is (L, C, ...)
  const size_t c = (size_t)lane * C + blockIdx.x;
  if (!ls.active[lane]) {  // the whole block: no barrier is skipped
    if (threadIdx.x == 0) applied_out[c] = 0;
    return;
  }
#ifdef FF_PHASES
  unsigned long long* ph = ff_phase_row();
  const long long clk0 = clock64();
  long long c_delta = 0, c_scan1 = 0, c_scan2 = 0;
  if (ph) ph[0] = ff_globaltimer();
#endif
  const Problem p = lane_problem(p0, lane, ls);
  extern __shared__ int sm[];
  int* s_sm = sm;                // M: the proposal's service
  int* a_sm = sm + M;            // M: its node before the sweep
  int* b_sm = sm + 2 * M;        // M: its target
  int* st_sm = sm + 3 * M;       // M: its standing
  int* skey = sm + 4 * M;        // H: service table keys
  int* sval = skey + H;          // H: lowest accepted index of the service
  int* nkey = sval + H;          // 2H: node table keys
  int* ntgt = nkey + 2 * H;      // 2H: lowest service winner arriving
  int* ndep = ntgt + 2 * H;      // 2H: lowest applied proposal departing
  int* ncnt = ndep + 2 * H;      // 2H: applied proposals departing
  float* d_sm = reinterpret_cast<float*>(ncnt + 2 * H);  // 3M: its demand
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int n_applied;
  const unsigned smask = H - 1, nmask = 2 * H - 1;

  int* asg = assignment + c * p.S;
  float* ld = load + c * p.N * 3;
  int* us = used + c * p.N * p.G;
  int* co = coloc + c * p.N * p.Gc1;
  int* tp = topo + c * p.T;

  for (int x = threadIdx.x; x < H; x += blockDim.x) {
    skey[x] = -1;
    sval[x] = M;
  }
  for (int x = threadIdx.x; x < 2 * H; x += blockDim.x) {
    nkey[x] = -1;
    ntgt[x] = M;
    ndep[x] = M;
    ncnt[x] = 0;
  }
  if (threadIdx.x == 0) n_applied = 0;

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
    for (int r = 0; r < 3; ++r) d_sm[m * 3 + r] = p.demand[(size_t)s * 3 + r];
    b_sm[m] = b;
    st_sm[m] = accept ? kAccepted : kRejected;
  }
  __syncthreads();
#ifdef FF_PHASES
  c_delta = clock64();
#endif
  // winner per service: the lowest accepted index
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    if (st_sm[m] == kAccepted)
      atomicMin(&sval[table_slot(skey, smask, s_sm[m], true)], m);
  __syncthreads();
#ifdef FF_PHASES
  c_scan1 = clock64();
#endif
  // winner per target node: the lowest service winner arriving
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    if (st_sm[m] == kAccepted &&
        sval[table_slot(skey, smask, s_sm[m], false)] == m) {
      st_sm[m] = kServiceWinner;
      atomicMin(&ntgt[table_slot(nkey, nmask, b_sm[m], true)], m);
    }
  __syncthreads();
#ifdef FF_PHASES
  c_scan2 = clock64();
#endif
  // the applied moves; each departure is listed under its node, and a
  // proposal not applied leaves no node in a_sm
  int mine = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    if (st_sm[m] == kServiceWinner &&
        ntgt[table_slot(nkey, nmask, b_sm[m], false)] == m) {
      st_sm[m] = kApplied;
      const int h = table_slot(nkey, nmask, a_sm[m], true);
      atomicMin(&ndep[h], m);
      atomicAdd(&ncnt[h], 1);
      ++mine;
    } else {
      a_sm[m] = -1;
    }
  }
  if (mine) atomicAdd(&n_applied, mine);
  __syncthreads();
#ifdef FF_PHASES
  const long long c_tables = clock64();
#endif
  // apply: the float load node by node in the walk's order
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    if (st_sm[m] != kApplied) continue;
    const int s = s_sm[m], a = a_sm[m], b = b_sm[m];
    const int ha = table_slot(nkey, nmask, a, false);
    if (ndep[ha] == m) {  // node a: its departures, then its arrival
      float l[3] = {ld[(size_t)a * 3 + 0], ld[(size_t)a * 3 + 1],
                    ld[(size_t)a * 3 + 2]};
      // the walk reads four proposals at a time, adds in proposal order
      for (int q0 = m, left = ncnt[ha]; left > 0; q0 += 4) {
        int an[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) an[v] = q0 + v < M ? a_sm[q0 + v] : -1;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (an[v] != a) continue;
          for (int r = 0; r < 3; ++r) l[r] = l[r] + (-d_sm[(q0 + v) * 3 + r]);
          --left;
        }
      }
      if (ntgt[ha] < M)
        for (int r = 0; r < 3; ++r) l[r] = l[r] + d_sm[ntgt[ha] * 3 + r];
      for (int r = 0; r < 3; ++r) ld[(size_t)a * 3 + r] = l[r];
    }
    const int hb = table_slot(nkey, nmask, b, false);
    if (ndep[hb] == M)  // an arrival where nothing leaves
      for (int r = 0; r < 3; ++r)
        ld[(size_t)b * 3 + r] = ld[(size_t)b * 3 + r] + d_sm[m * 3 + r];
  }
#ifdef FF_PHASES
  __syncthreads();
  const long long c_float = clock64();
#endif
  // ... the integer planes and the assignment, proposal by proposal
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    if (st_sm[m] != kApplied) continue;
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
  if (threadIdx.x == 0) applied_out[c] = n_applied;
#ifdef FF_PHASES
  __syncthreads();
  if (ph) {
    const long long clk1 = clock64();
    ph[1] = ff_globaltimer();
    ph[2] = clk1 - clk0;
    ph[3] = c_delta - clk0;
    ph[4] = c_scan1 - c_delta;
    ph[5] = c_scan2 - c_scan1;
    ph[6] = clk1 - c_scan2;
    ph[7] = n_applied;
    ph[8] = M;
    ph[9] = c_tables - c_scan2;   // apply's parts: the applied moves,
    ph[10] = c_float - c_tables;  // the float load, the integer planes
    ph[11] = clk1 - c_float;
  }
#endif
}

// the arguments that stay fixed over an anneal call's sweeps
struct K1Static {
  Problem p;
  int L, C, M;
  int* assignment;
  float* load;
  int* used;
  int* coloc;
  int* topo;
};

}  // namespace

// sizeof(K1Static): the wrapper's ctypes mirror must match it
FF_EXPORT int ff_k1_static_size() { return static_cast<int>(sizeof(K1Static)); }

// `args` is a K1Static (the wrapper's _ext.SweepArgs)
FF_EXPORT int ff_k1_sweep(const void* args, FFLanes lanes, const int* s_idx,
                          const int* b_idx, const float* u, int* applied,
                          cudaStream_t stream) {
  const K1Static* a = static_cast<const K1Static*>(args);
  const int M = a->M;
  if (a->L < 1 || a->L > FF_MAX_LANES || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int H = 1;  // service table: a power of two >= 2M (node table: 2H)
  while (H < 2 * M) H <<= 1;
  int threads = ((M + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = ((size_t)7 * M + (size_t)10 * H) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k1_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  k1_sweep_kernel<<<dim3(a->C, a->L), threads, smem, stream>>>(
      a->p, lanes, a->C, a->assignment, a->load, a->used, a->coloc, a->topo,
      s_idx, b_idx, u, M, H, applied);
  return static_cast<int>(cudaGetLastError());
}
