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
// s_loc a shard-local service index, so the kernel is deterministic given
// them.
//
// One cooperative launch a sweep; a persistent grid of min(R·D, resident
// blocks) blocks, block b taking positions b, b + grid, ..., runs three
// phases with a grid barrier between them:
//   1. elect: one thread per proposal computes the annealing-cost delta of
//      moving its service (global row d·S/D + s_loc) from a to b against
//      the PRE-sweep state (move_delta, shared with K1: no stickiness, the
//      preference term divided by the padded global S) and accepts when
//      Δ < 0 or u < exp(-Δ/T) and a != b at the replica's temperature. A
//      service's candidate is its lowest accepted proposal: an atomicMin
//      of the index into a shared-memory table keyed by the service (open
//      addressing, as K1's), O(M) where a scan of the earlier proposals
//      was O(M²). Each candidate posts rank = m + M·d into its replica's
//      per-node slot with atomicMin: the reference's pmin.
//   2. apply: a candidate whose rank won its target node is applied. The
//      integer planes and the assignment take integer atomics
//      (order-free). The float load follows the reference's order: a
//      position's partial for node n is its departures from n in proposal
//      order, then its arrival at n (a node receives at most one arrival
//      per replica a sweep, the election's point), starting from 0.0 (the
//      reference's zeros.at[a].add(-d).at[b].add(d)). The lowest applied
//      departure from a node walks the position's applied departures
//      (compacted in proposal order by a block scan) from its own on, adds
//      its node's, then the arrival; an arrival where nothing leaves is
//      added by its own thread: no thread walks the M proposals. Each
//      touched node's partial goes to the position's row of the (R, D, N,
//      3) partial plane and into the position's list of touched nodes,
//      and the node's mark takes the lowest shard that touched it
//      (atomicMin, which needs no reply).
//   3. reduce: each position walks its own list; the lowest shard that
//      touched a node sums its partials in shard order, ((p0 + p1) + p2)
//      + ..., and adds the sum to the load (the reference's psum over the
//      shard axis sums in device order on the CPU, so the load stays
//      bit-equal to it); a node nothing touched has a sum of +0.0, which
//      would leave its load as it is, so it is skipped. The touched
//      nodes' partials, election slots and marks go back to their resting
//      values. No thread waits on a global counter.
// The scratch is the caller's (sharded.py's _scratch): the candidates and
// the positions' lists (overwritten every sweep), the marks and the
// election slots (INT_MAX at rest, the slots last), the partials (0 at
// rest); each sweep leaves them so.
// The problem, the state and the proposal count stay fixed over an
// anneal's sweeps: the wrapper binds them once (K7Static, ff_k7_bind) and
// a sweep passes only its draws and temperatures.
//
// Bound: latency, like K1. A sweep moves 2·D·M proposals' rows (a few
// hundred KB at most); its time is one launch and three dependent phases
// of a block, with two grid barriers. Shared memory: 9M + 10H ints, H the
// power of two >= 2M, so M <= 1,536 proposals a position. A card that
// cannot co-schedule one block makes the call fail; there is no launch
// loop to fall back on.
//
// Built with -DK7_PHASES (fleetflow_tpu_torch/tools/k67_profile.py), thread
// 0 of each block stamps its cycles into row blockIdx.x: 3 the delta, 4 the
// winner scan, 5 the election (the posts and the wait at the first
// barrier), 9 the integer apply, 10 the float walk (to the block's
// barrier), 6 its longest thread's walk, 11 the reduce after the second
// barrier; 7 the applied moves, 8 M.
#ifdef K7_PHASES
#define FF_PHASES 1
#endif
#include <cooperative_groups.h>

#include "sweep_delta.cuh"

namespace cg = cooperative_groups;

namespace {

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
enum : int { kRejected = 0, kAccepted = 1, kCandidate = 2, kApplied = 3 };

constexpr int kThreads = 256;  // the block's threads (at most)

// The applied proposals in proposal order, compacted: dep_m[j] is the
// j-th applied proposal, dep_a[j] its source node, pos[m] = j. Thread t
// takes a contiguous chunk of the M proposals; a warp scan and the warps'
// totals (`warp_tot`, 32 ints) give each chunk its offset. Returns the
// count to every thread; ends with a barrier.
__device__ int compact_applied(const int* st_sm, const int* a_sm, int M,
                               int* dep_m, int* dep_a, int* pos,
                               int* warp_tot) {
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31;
  const int c = (M + T - 1) / T, lo = min(t * c, M), hi = min(lo + c, M);
  int n = 0;
  for (int m = lo; m < hi; ++m) n += st_sm[m] == kApplied;
  int incl = n;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[t >> 5] = incl;
  __syncthreads();
  int j = incl - n, total = 0;
  for (int w = 0; w < (T >> 5); ++w) {
    const int v = warp_tot[w];
    if (w < (t >> 5)) j += v;
    total += v;
  }
  for (int m = lo; m < hi; ++m)
    if (st_sm[m] == kApplied) {
      dep_m[j] = m;
      dep_a[j] = a_sm[m];
      pos[m] = j++;
    }
  __syncthreads();
  return total;
}

// the arguments fixed over an anneal call's sweeps; ff_k7_bind fills the
// launch shape
struct K7Static {
  Problem p;
  int R, D, M;
  int* assignment;
  float* load;
  int* used;
  int* coloc;
  int* topo;
  int* scratch;     // 4·R·D·M candidates | R·D·2M lists | R·D lengths |
                    // R·N marks | R·N election slots
  float* partial;   // (R, D, N, 3)
  int grid, threads, H;
  long long smem;
};

__global__ void __launch_bounds__(kThreads) k7_sweep_kernel(
    K7Static a, FFLanes ls, const int* __restrict__ s_loc,
    const int* __restrict__ b_idx, const float* __restrict__ u,
    int* applied_out) {
  cg::grid_group grid = cg::this_grid();
  const Problem& p = a.p;
  const int D = a.D, M = a.M, H = a.H, N = p.N;
  const int P = a.R * D, S_loc = p.S / D;
  const size_t PM = (size_t)P * M, RN = (size_t)a.R * N;
  int* c_s = a.scratch;        // the proposals' services, sources,
  int* c_a = c_s + PM;         // targets and standing, for a block that
  int* c_b = c_a + PM;         // takes more than one position
  int* c_st = c_b + PM;
  int* c_list = c_st + PM;     // (R·D, 2M) the positions' touched nodes
  int* c_list_n = c_list + 2 * PM;
  int* mark = c_list_n + P;    // (R, N): the lowest shard touching it
  int* best = mark + RN;       // (R, N) election slots
  extern __shared__ int sm[];
  int* s_sm = sm;              // M: the proposal's service
  int* a_sm = sm + M;          // M: its node before the sweep
  int* b_sm = sm + 2 * M;      // M: its target
  int* st_sm = sm + 3 * M;     // M: its standing
  int* skey = sm + 4 * M;      // H: service table keys
  int* sval = skey + H;        // H: lowest accepted index of the service
  int* nkey = sval + H;        // 2H: node table keys
  int* ntgt = nkey + 2 * H;    // 2H: the applied arrival
  int* ndep = ntgt + 2 * H;    // 2H: lowest applied proposal departing
  int* ncnt = ndep + 2 * H;    // 2H: applied proposals departing
  float* d_sm = reinterpret_cast<float*>(ncnt + 2 * H);  // 3M: its demand
  int* list_sm = reinterpret_cast<int*>(d_sm + 3 * M);  // 2M: touched
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int n_applied, n_listed;
  const unsigned smask = H - 1, nmask = 2 * H - 1;
  // one position a block: its shared arrays live across the barrier
  const bool resident = P <= (int)gridDim.x;
#ifdef FF_PHASES
  unsigned long long* ph = ff_phase_at(blockIdx.x);
  const long long clk0 = clock64();
  long long c_delta = 0, c_scan = 0, c_post = 0, c_int = 0, c_float = 0;
  long long applied_sum = 0;
  __shared__ unsigned long long walk_max;  // the longest thread's walk
  if (threadIdx.x == 0) walk_max = 0;
  if (ph) ph[0] = ff_globaltimer();
#endif

  // -- 1. elect ---------------------------------------------------------------
  for (int pos = blockIdx.x; pos < P; pos += gridDim.x) {
#ifdef FF_PHASES
    const long long t_a = clock64();
#endif
    const int r = pos / D, d = pos - r * D;
    const int* asg = a.assignment + (size_t)r * p.S;
    const float* ld = a.load + (size_t)r * N * 3;
    const int* us = a.used + (size_t)r * N * p.G;
    const int* co = a.coloc + (size_t)r * N * p.Gc1;
    const int* tp = a.topo + (size_t)r * p.T;
    __syncthreads();  // the previous position's tables are read
    for (int x = threadIdx.x; x < H; x += blockDim.x) {
      skey[x] = -1;
      sval[x] = M;
    }
    int tmax = 0, tmin = 0;
    if (p.max_skew > 0) block_topo_range(tp, p.T, tmax, tmin, red_v, red_i);
    const float t = fmaxf(ls.temp[r], 1e-8f);
    const size_t base = (size_t)pos * M;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      const int s = d * S_loc + s_loc[base + m];
      const int b = b_idx[base + m];
      const int src = asg[s];
      const float delta = move_delta(p, ld, us, co, tp, tmax, tmin, s, src, b);
      const float uu = u[base + m];
      const bool accept =
          ((delta < 0.f) || (uu < expf(-delta / t))) && (src != b);
      s_sm[m] = s;
      a_sm[m] = src;
      b_sm[m] = b;
      st_sm[m] = accept ? kAccepted : kRejected;
      for (int k = 0; k < 3; ++k) d_sm[m * 3 + k] = p.demand[(size_t)s * 3 + k];
    }
    __syncthreads();
#ifdef FF_PHASES
    const long long t_b = clock64();
    c_delta += t_b - t_a;
#endif
    // a service's candidate: its lowest accepted index
    for (int m = threadIdx.x; m < M; m += blockDim.x)
      if (st_sm[m] == kAccepted)
        atomicMin(&sval[table_slot(skey, smask, s_sm[m], true)], m);
    __syncthreads();
#ifdef FF_PHASES
    const long long t_c = clock64();
    c_scan += t_c - t_b;
#endif
    // the candidates post their rank for their target node (the pmin)
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      if (st_sm[m] == kAccepted &&
          sval[table_slot(skey, smask, s_sm[m], false)] == m) {
        st_sm[m] = kCandidate;
        atomicMin(&best[(size_t)r * N + b_sm[m]], m + M * d);
      }
      if (!resident) {
        c_s[base + m] = s_sm[m];
        c_a[base + m] = a_sm[m];
        c_b[base + m] = b_sm[m];
        c_st[base + m] = st_sm[m];
      }
    }
#ifdef FF_PHASES
    c_post += clock64() - t_c;
#endif
  }
#ifdef FF_PHASES
  const long long t_p1 = clock64();
#endif
  grid.sync();
#ifdef FF_PHASES
  const long long t_e = clock64();
#endif

  // -- 2. apply ---------------------------------------------------------------
  for (int pos = blockIdx.x; pos < P; pos += gridDim.x) {
#ifdef FF_PHASES
    const long long t_a = clock64();
#endif
    const int r = pos / D, d = pos - r * D;
    const size_t base = (size_t)pos * M;
    __syncthreads();  // the previous position's tables are read
    if (!resident) {
      for (int m = threadIdx.x; m < M; m += blockDim.x) {
        const int s = c_s[base + m];
        s_sm[m] = s;
        a_sm[m] = c_a[base + m];
        b_sm[m] = c_b[base + m];
        st_sm[m] = c_st[base + m];
        for (int k = 0; k < 3; ++k)
          d_sm[m * 3 + k] = p.demand[(size_t)s * 3 + k];
      }
    }
    for (int x = threadIdx.x; x < 2 * H; x += blockDim.x) {
      nkey[x] = -1;
      ntgt[x] = M;
      ndep[x] = M;
      ncnt[x] = 0;
    }
    if (threadIdx.x == 0) {
      n_applied = 0;
      n_listed = 0;
    }
    __syncthreads();
    // the applied moves; each departure is listed under its node and each
    // arrival (one a node) under its target, and a proposal not applied
    // leaves no node in a_sm
    int mine = 0;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      if (st_sm[m] == kCandidate &&
          __ldcg(&best[(size_t)r * N + b_sm[m]]) == m + M * d) {
        st_sm[m] = kApplied;
        const int h = table_slot(nkey, nmask, a_sm[m], true);
        atomicMin(&ndep[h], m);
        atomicAdd(&ncnt[h], 1);
        ntgt[table_slot(nkey, nmask, b_sm[m], true)] = m;
        ++mine;
      } else {
        a_sm[m] = -1;
      }
    }
    if (mine) atomicAdd(&n_applied, mine);
    __syncthreads();
    // the applied departures in proposal order, in the service table's
    // room (2H >= 4M ints, free after the election)
    int* dep_m = skey;
    int* dep_a = skey + M;
    int* dep_pos = skey + 2 * M;
    const int n_dep = compact_applied(st_sm, a_sm, M, dep_m, dep_a, dep_pos,
                                      red_i);
    // the integer planes and the assignment, proposal by proposal
    int* asg = a.assignment + (size_t)r * p.S;
    int* us = a.used + (size_t)r * N * p.G;
    int* co = a.coloc + (size_t)r * N * p.Gc1;
    int* tp = a.topo + (size_t)r * p.T;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      if (st_sm[m] != kApplied) continue;
      const int s = s_sm[m], src = a_sm[m], b = b_sm[m];
      for (int k = 0; k < p.K; ++k) {
        const int id = p.cids[(size_t)s * p.K + k];
        if (id < 0) continue;
        atomicSub(&us[(size_t)src * p.G + id], 1);
        atomicAdd(&us[(size_t)b * p.G + id], 1);
      }
      for (int k = 0; k < p.Kc; ++k) {
        const int id = p.colids[(size_t)s * p.Kc + k];
        if (id < 0) continue;
        atomicSub(&co[(size_t)src * p.Gc1 + id], 1);
        atomicAdd(&co[(size_t)b * p.Gc1 + id], 1);
      }
      if (s < p.n_real) {
        atomicSub(&tp[p.ntopo[src]], 1);
        atomicAdd(&tp[p.ntopo[b]], 1);
      }
      asg[s] = b;
    }
#ifdef FF_PHASES
    const long long t_b = clock64();
    c_int += t_b - t_a;
#endif
    // the position's partial of each touched node, in the walk's order
    float* part = a.partial + (size_t)pos * N * 3;
#ifdef FF_PHASES
    const long long t_w = clock64();
#endif
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      if (st_sm[m] != kApplied) continue;
      const int src = a_sm[m], b = b_sm[m];
      const int ha = table_slot(nkey, nmask, src, false);
      int touched[2] = {-1, -1};
      if (ndep[ha] == m) {  // node src: its departures, then its arrival
        float l[3] = {0.f, 0.f, 0.f};
        // the walk over the applied departures from this one on, four
        // sources read at a time, adding the node's own in proposal order
        for (int j = dep_pos[m], left = ncnt[ha]; left > 0; j += 4) {
          int an[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) an[v] = j + v < n_dep ? dep_a[j + v] : -1;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (an[v] != src) continue;
            const float* dd = d_sm + dep_m[j + v] * 3;
            for (int k = 0; k < 3; ++k) l[k] = l[k] + (-dd[k]);
            --left;
          }
        }
        if (ntgt[ha] < M)
          for (int k = 0; k < 3; ++k) l[k] = l[k] + d_sm[ntgt[ha] * 3 + k];
        for (int k = 0; k < 3; ++k) part[(size_t)src * 3 + k] = l[k];
        touched[0] = src;
      }
      const int hb = table_slot(nkey, nmask, b, false);
      if (ndep[hb] == M) {  // an arrival where nothing leaves
        for (int k = 0; k < 3; ++k)
          part[(size_t)b * 3 + k] = 0.f + d_sm[m * 3 + k];
        touched[1] = b;
      }
      for (int v = 0; v < 2; ++v) {
        if (touched[v] < 0) continue;
        atomicMin(&mark[(size_t)r * N + touched[v]], d);
        list_sm[atomicAdd(&n_listed, 1)] = touched[v];
      }
    }
#ifdef FF_PHASES
    atomicMax(&walk_max, (unsigned long long)(clock64() - t_w));
#endif
    __syncthreads();
    if (!resident)
      for (int x = threadIdx.x; x < n_listed; x += blockDim.x)
        c_list[2 * base + x] = list_sm[x];
    if (threadIdx.x == 0) {
      applied_out[pos] = n_applied;
      if (!resident) c_list_n[pos] = n_listed;
    }
#ifdef FF_PHASES
    c_float += clock64() - t_b;
    applied_sum += n_applied;
#endif
  }
  grid.sync();
#ifdef FF_PHASES
  const long long t_r = clock64();
#endif

  // -- 3. reduce --------------------------------------------------------------
  // each position's touched nodes; the lowest shard touching a node sums
  for (int pos = blockIdx.x; pos < P; pos += gridDim.x) {
    const int r = pos / D, d = pos - r * D;
    const int listed = resident ? n_listed : __ldcg(&c_list_n[pos]);
    for (int x = threadIdx.x; x < listed; x += blockDim.x) {
      const int n = resident ? list_sm[x]
                             : __ldcg(&c_list[2 * (size_t)pos * M + x]);
      const size_t rn = (size_t)r * N + n;
      if (__ldcg(&mark[rn]) != d) continue;
      // the shards' partials, loaded before any is cleared (a store
      // between them would order the loads one after another)
      float* p0 = a.partial + ((size_t)r * D * N + n) * 3;
      const size_t stride = (size_t)N * 3;
      float s0 = __ldcg(p0), s1 = __ldcg(p0 + 1), s2 = __ldcg(p0 + 2);
#pragma unroll 4
      for (int q = 1; q < D; ++q) {
        const float* pq = p0 + q * stride;
        s0 = s0 + __ldcg(pq);
        s1 = s1 + __ldcg(pq + 1);
        s2 = s2 + __ldcg(pq + 2);
      }
      for (int q = 0; q < D; ++q) {
        float* pq = p0 + q * stride;
        pq[0] = pq[1] = pq[2] = 0.f;
      }
      float* ld = a.load + rn * 3;
      ld[0] = ld[0] + s0;
      ld[1] = ld[1] + s1;
      ld[2] = ld[2] + s2;
      best[rn] = INT_MAX;
      mark[rn] = INT_MAX;
    }
  }
#ifdef FF_PHASES
  __syncthreads();
  if (ph) {
    const long long clk1 = clock64();
    ph[1] = ff_globaltimer();
    ph[2] = clk1 - clk0;
    ph[3] = c_delta;
    ph[4] = c_scan;
    ph[5] = c_post + (t_e - t_p1);
    ph[6] = walk_max;
    ph[7] = applied_sum;
    ph[8] = M;
    ph[9] = c_int;
    ph[10] = c_float;
    ph[11] = clk1 - t_r;
  }
#endif
}


// -- the cross-rank form: one position a rank, three launches a sweep --------
//
// On a mesh of ranks (fleetflow_tpu_torch/parallel.py, one process a
// position, each on its own device or several sharing one card) a rank
// holds its shard's (S/D, ·) rows, its replica's node state once, and the
// two grid barriers of the cooperative kernel above become collectives
// between three launches (solver/sharded_ranks.py drives them):
//   elect  the position's proposals against the pre-sweep state, each
//          service's lowest accepted proposal its candidate (the hashed
//          service table), each candidate's rank m + M·d posted into the
//          (N,) election slots with atomicMin;
//          -> all_reduce(MIN) of the slots over the replica's ranks;
//   apply  the candidates whose rank won their target node: the shard's
//          assignment, the integer deltas of the occupancy and topology
//          planes and the touched-node counts (N·G | N·Gc1 | T | N, integer
//          atomics, order-free), and the position's (N, 3) load partial in
//          the cooperative kernel's order (the compacted departure walk:
//          a node's departures in proposal order, then its arrival, from
//          0.0);
//          -> all_gather of the partials and all_reduce(SUM) of the integer
//          deltas over the replica's ranks;
//   reduce the gathered partials summed in shard order into the load of
//          every node some shard touched, the integer deltas added to the
//          planes, and the slots, the partial and the deltas reset to
//          their resting values (INT_MAX, 0, 0).
// The composition equals sharded_step_plain (sharded.py) bit for bit: the
// same move delta, winner rules, rank encoding and float order. In the
// shard's Problem the planes are indexed by shard-local row, p.S is the
// GLOBAL padded S (the move delta divides the preference and colocation
// terms by it) and p.n_real the shard's real rows (phantoms are a suffix
// of the global rows, so a prefix of each shard's real). elect and apply
// are one block (the position is one cooperative block above); reduce is
// a grid over the node planes. Latency-bound, like the cooperative form.

struct K7RankStatic {
  Problem p;
  int D, d, M;       // shards, this rank's shard, proposals a sweep
  int* assignment;   // (S/D,)
  float* load;       // (N, 3) the replica's node state
  int* used;         // (N, G)
  int* coloc;        // (N, Gc1)
  int* topo;         // (T,)
  int* slots;        // (N,) election slots, INT_MAX at rest
  int* cand;         // (4, M) service, source, target, standing
  float* partial;    // (N, 3) this position's load delta, 0 at rest
  int* deltas;       // N·G | N·Gc1 | T | N touched, 0 at rest
  int threads, H, reduce_grid;
  long long smem_elect, smem_apply;
};

__global__ void __launch_bounds__(kThreads) k7r_elect_kernel(
    K7RankStatic a, float temp, const int* __restrict__ s_loc,
    const int* __restrict__ b_idx, const float* __restrict__ u) {
  const Problem& p = a.p;
  const int M = a.M, H = a.H;
  extern __shared__ int sm[];
  int* skey = sm;        // H: service table keys
  int* sval = sm + H;    // H: lowest accepted index of the service
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const unsigned smask = H - 1;
  int* c_s = a.cand;
  int* c_a = c_s + M;
  int* c_b = c_a + M;
  int* c_st = c_b + M;
  for (int x = threadIdx.x; x < H; x += blockDim.x) {
    skey[x] = -1;
    sval[x] = M;
  }
  int tmax = 0, tmin = 0;
  if (p.max_skew > 0) block_topo_range(a.topo, p.T, tmax, tmin, red_v, red_i);
  const float t = fmaxf(temp, 1e-8f);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int s = s_loc[m], b = b_idx[m];
    const int src = a.assignment[s];
    const float delta = move_delta(p, a.load, a.used, a.coloc, a.topo, tmax,
                                   tmin, s, src, b);
    const bool accept =
        ((delta < 0.f) || (u[m] < expf(-delta / t))) && (src != b);
    c_s[m] = s;
    c_a[m] = src;
    c_b[m] = b;
    c_st[m] = accept ? kAccepted : kRejected;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    if (c_st[m] == kAccepted)
      atomicMin(&sval[table_slot(skey, smask, c_s[m], true)], m);
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x)
    if (c_st[m] == kAccepted &&
        sval[table_slot(skey, smask, c_s[m], false)] == m) {
      c_st[m] = kCandidate;
      atomicMin(&a.slots[c_b[m]], m + M * a.d);
    }
}

__global__ void __launch_bounds__(kThreads) k7r_apply_kernel(K7RankStatic a,
                                                             int* applied_out) {
  const Problem& p = a.p;
  const int M = a.M, H = a.H, N = p.N;
  extern __shared__ int sm[];
  int* s_sm = sm;              // M: the proposal's service
  int* a_sm = sm + M;          // M: its node before the sweep
  int* b_sm = sm + 2 * M;      // M: its target
  int* st_sm = sm + 3 * M;     // M: its standing
  int* nkey = sm + 4 * M;      // 2H: node table keys
  int* ntgt = nkey + 2 * H;    // 2H: the applied arrival
  int* ndep = ntgt + 2 * H;    // 2H: lowest applied proposal departing
  int* ncnt = ndep + 2 * H;    // 2H: applied proposals departing
  int* dep_m = ncnt + 2 * H;   // M: the applied departures, compacted
  int* dep_a = dep_m + M;      // M: their sources
  int* dep_pos = dep_a + M;    // M: a proposal's place among them
  float* d_sm = reinterpret_cast<float*>(dep_pos + M);  // 3M: demand
  __shared__ int red_i[32];
  __shared__ int n_applied;
  const unsigned nmask = 2 * H - 1;
  int* dused = a.deltas;
  int* dcoloc = dused + (size_t)N * p.G;
  int* dtopo = dcoloc + (size_t)N * p.Gc1;
  int* touched = dtopo + p.T;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int s = a.cand[m];
    s_sm[m] = s;
    a_sm[m] = a.cand[M + m];
    b_sm[m] = a.cand[2 * M + m];
    st_sm[m] = a.cand[3 * M + m];
    for (int k = 0; k < 3; ++k) d_sm[m * 3 + k] = p.demand[(size_t)s * 3 + k];
  }
  for (int x = threadIdx.x; x < 2 * H; x += blockDim.x) {
    nkey[x] = -1;
    ntgt[x] = M;
    ndep[x] = M;
    ncnt[x] = 0;
  }
  if (threadIdx.x == 0) n_applied = 0;
  __syncthreads();
  int mine = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    if (st_sm[m] == kCandidate && a.slots[b_sm[m]] == m + M * a.d) {
      st_sm[m] = kApplied;
      const int h = table_slot(nkey, nmask, a_sm[m], true);
      atomicMin(&ndep[h], m);
      atomicAdd(&ncnt[h], 1);
      ntgt[table_slot(nkey, nmask, b_sm[m], true)] = m;
      ++mine;
    } else {
      a_sm[m] = -1;
    }
  }
  if (mine) atomicAdd(&n_applied, mine);
  __syncthreads();
  const int n_dep = compact_applied(st_sm, a_sm, M, dep_m, dep_a, dep_pos,
                                    red_i);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    if (st_sm[m] != kApplied) continue;
    const int s = s_sm[m], src = a_sm[m], b = b_sm[m];
    for (int k = 0; k < p.K; ++k) {
      const int id = p.cids[(size_t)s * p.K + k];
      if (id < 0) continue;
      atomicSub(&dused[(size_t)src * p.G + id], 1);
      atomicAdd(&dused[(size_t)b * p.G + id], 1);
    }
    for (int k = 0; k < p.Kc; ++k) {
      const int id = p.colids[(size_t)s * p.Kc + k];
      if (id < 0) continue;
      atomicSub(&dcoloc[(size_t)src * p.Gc1 + id], 1);
      atomicAdd(&dcoloc[(size_t)b * p.Gc1 + id], 1);
    }
    if (s < p.n_real) {
      atomicSub(&dtopo[p.ntopo[src]], 1);
      atomicAdd(&dtopo[p.ntopo[b]], 1);
    }
    a.assignment[s] = b;
    touched[src] = 1;
    touched[b] = 1;
    // the position's partial of the touched nodes, as the cooperative
    // kernel's walk: the lowest applied departure from a node walks the
    // applied departures from its own on, then adds the arrival
    const int ha = table_slot(nkey, nmask, src, false);
    if (ndep[ha] == m) {
      float l[3] = {0.f, 0.f, 0.f};
      for (int j = dep_pos[m], left = ncnt[ha]; left > 0; ++j) {
        if (dep_a[j] != src) continue;
        const float* dd = d_sm + dep_m[j] * 3;
        for (int k = 0; k < 3; ++k) l[k] = l[k] + (-dd[k]);
        --left;
      }
      if (ntgt[ha] < M)
        for (int k = 0; k < 3; ++k) l[k] = l[k] + d_sm[ntgt[ha] * 3 + k];
      for (int k = 0; k < 3; ++k) a.partial[(size_t)src * 3 + k] = l[k];
    }
    const int hb = table_slot(nkey, nmask, b, false);
    if (ndep[hb] == M)  // an arrival where nothing leaves
      for (int k = 0; k < 3; ++k)
        a.partial[(size_t)b * 3 + k] = 0.f + d_sm[m * 3 + k];
  }
  __syncthreads();
  if (threadIdx.x == 0) applied_out[0] = n_applied;
  (void)n_dep;
}

__global__ void k7r_reduce_kernel(K7RankStatic a,
                                  const float* __restrict__ gathered) {
  const Problem& p = a.p;
  const int N = p.N, D = a.D;
  int* dused = a.deltas;
  int* dcoloc = dused + (size_t)N * p.G;
  int* dtopo = dcoloc + (size_t)N * p.Gc1;
  int* touched = dtopo + p.T;
  const size_t stride = (size_t)N * 3;
  for (size_t n = grid_tid(); n < (size_t)N; n += grid_stride()) {
    if (touched[n] > 0) {
      const float* p0 = gathered + n * 3;
      float s0 = p0[0], s1 = p0[1], s2 = p0[2];
      for (int q = 1; q < D; ++q) {
        const float* pq = p0 + q * stride;
        s0 = s0 + pq[0];
        s1 = s1 + pq[1];
        s2 = s2 + pq[2];
      }
      float* ld = a.load + n * 3;
      ld[0] = ld[0] + s0;
      ld[1] = ld[1] + s1;
      ld[2] = ld[2] + s2;
      touched[n] = 0;
    }
    a.slots[n] = INT_MAX;
    a.partial[n * 3] = a.partial[n * 3 + 1] = a.partial[n * 3 + 2] = 0.f;
  }
  const size_t nu = (size_t)N * p.G, nc = (size_t)N * p.Gc1;
  for (size_t i = grid_tid(); i < nu; i += grid_stride())
    if (dused[i]) {
      a.used[i] += dused[i];
      dused[i] = 0;
    }
  for (size_t i = grid_tid(); i < nc; i += grid_stride())
    if (dcoloc[i]) {
      a.coloc[i] += dcoloc[i];
      dcoloc[i] = 0;
    }
  for (size_t i = grid_tid(); i < (size_t)p.T; i += grid_stride())
    if (dtopo[i]) {
      a.topo[i] += dtopo[i];
      dtopo[i] = 0;
    }
}

}  // namespace

// sizeof(K7Static): the wrapper's ctypes mirror must match it
FF_EXPORT int ff_k7_static_size() { return static_cast<int>(sizeof(K7Static)); }

// Check a K7Static (the wrapper's _ext.K7Args) and fill its launch shape:
// the grid (the positions, at most what the card co-schedules), the block
// (a thread per proposal, at most 1,024), the service table size H and the
// dynamic shared memory. Called once per bound launcher.
FF_EXPORT int ff_k7_bind(void* args) {
  K7Static* a = static_cast<K7Static*>(args);
  if (a->R < 1 || a->R > FF_MAX_LANES || a->D < 1 || a->p.S % a->D != 0 ||
      a->M < 1 || a->p.N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int H = 1;  // service table: a power of two >= 2M (node table: 2H)
  while (H < 2 * a->M) H <<= 1;
  int threads = ((a->M + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  const size_t smem = ((size_t)9 * a->M + (size_t)10 * H) * sizeof(int);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k7_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k7_sweep_kernel,
                                                    threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const long long P = (long long)a->R * a->D;
  const long long cap = (long long)per_sm * sms;
  a->grid = static_cast<int>(P < cap ? P : cap);
  a->threads = threads;
  a->H = H;
  a->smem = static_cast<long long>(smem);
  return 0;
}

// One sweep. `args` is a K7Static that ff_k7_bind filled; lanes.temp[r] is
// replica r's temperature; the proposals are (R, D, M); applied gets the
// (R, D) applied moves.
FF_EXPORT int ff_k7_sweep(const void* args, FFLanes lanes, const int* s_loc,
                          const int* b_idx, const float* u, int* applied,
                          cudaStream_t stream) {
  K7Static a = *static_cast<const K7Static*>(args);
  if (a.grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* kargs[] = {&a, &lanes, &s_loc, &b_idx, &u, &applied};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)k7_sweep_kernel, dim3(a.grid), dim3(a.threads), kargs,
      (size_t)a.smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(K7RankStatic): the wrapper's ctypes mirror must match it
FF_EXPORT int ff_k7r_static_size() {
  return static_cast<int>(sizeof(K7RankStatic));
}

// Check a K7RankStatic (the wrapper's _ext.K7RankArgs) and fill its launch
// shape: a block of a thread a proposal (at most 256), the service table
// size H, the reduce's grid and the two blocks' dynamic shared memory
// (elect 2H ints, apply 10M + 8H). Called once per bound launcher.
FF_EXPORT int ff_k7r_bind(void* args) {
  K7RankStatic* a = static_cast<K7RankStatic*>(args);
  if (a->D < 1 || a->d < 0 || a->d >= a->D || a->M < 1 || a->p.N < 1 ||
      a->p.S % a->D != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int H = 1;
  while (H < 2 * a->M) H <<= 1;
  int threads = ((a->M + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  const size_t elect = (size_t)2 * H * sizeof(int);
  const size_t apply = ((size_t)10 * a->M + (size_t)8 * H) * sizeof(int);
  cudaError_t e = cudaSuccess;
  if (elect > 48 * 1024)
    e = cudaFuncSetAttribute(k7r_elect_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)elect);
  if (e == cudaSuccess && apply > 48 * 1024)
    e = cudaFuncSetAttribute(k7r_apply_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)apply);
  if (e != cudaSuccess) return static_cast<int>(e);
  long long work = (long long)a->p.N * (a->p.G > a->p.Gc1 ? a->p.G : a->p.Gc1);
  if (work < a->p.T) work = a->p.T;
  a->threads = threads;
  a->H = H;
  a->reduce_grid = ff_blocks(work, 256);
  a->smem_elect = static_cast<long long>(elect);
  a->smem_apply = static_cast<long long>(apply);
  return 0;
}

// elect: the (M,) shard-local services, targets and uniforms of this
// position at temperature `temp`; posts the candidates into the slots.
FF_EXPORT int ff_k7r_elect(const void* args, float temp, const int* s_loc,
                           const int* b_idx, const float* u,
                           cudaStream_t stream) {
  const K7RankStatic a = *static_cast<const K7RankStatic*>(args);
  if (a.threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  k7r_elect_kernel<<<1, a.threads, (size_t)a.smem_elect, stream>>>(
      a, temp, s_loc, b_idx, u);
  return static_cast<int>(cudaGetLastError());
}

// apply: the candidates that won their node, against the reduced slots;
// `applied` gets the position's applied moves (one int).
FF_EXPORT int ff_k7r_apply(const void* args, int* applied,
                           cudaStream_t stream) {
  const K7RankStatic a = *static_cast<const K7RankStatic*>(args);
  if (a.threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  k7r_apply_kernel<<<1, a.threads, (size_t)a.smem_apply, stream>>>(a,
                                                                   applied);
  return static_cast<int>(cudaGetLastError());
}

// reduce: `gathered` is the (D, N, 3) partials of the replica's shards in
// shard order; the deltas hold the summed integer deltas.
FF_EXPORT int ff_k7r_reduce(const void* args, const float* gathered,
                            cudaStream_t stream) {
  const K7RankStatic a = *static_cast<const K7RankStatic*>(args);
  if (a.reduce_grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  k7r_reduce_kernel<<<a.reduce_grid, 256, 0, stream>>>(a, gathered);
  return static_cast<int>(cudaGetLastError());
}
