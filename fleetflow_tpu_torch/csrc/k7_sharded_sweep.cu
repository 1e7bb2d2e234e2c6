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
#if defined(K7_PHASES) || defined(K7R_PHASES)
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
//          service's lowest accepted proposal its candidate, each
//          candidate's rank m + M·d posted into the (N,) election slots
//          with atomicMin;
//          -> all_reduce(MIN) of the slots over the replica's ranks;
//   apply  the candidates whose rank won their target node move (the
//          shard's assignment) and are written, in proposal order, into
//          the position's records: a buffer of cap = min(M, N) moves (an
//          applied move's target is its own across the replica, so no
//          position applies more) of rec_words int32 words,
//            [count, 0, 0, 0]     the header;
//            2·cap node entries   (node, the 3 float bits of its partial):
//                                 entry 2x move x's source when x is its
//                                 first departure (the source's
//                                 departures in proposal order, then its
//                                 arrival, from 0.0: the cooperative
//                                 kernel's order), entry 2x + 1 its target
//                                 when nothing leaves the target (0.0 +
//                                 its demand), else (-1, 0, 0, 0);
//            cap move rows        source, target, real row (0/1), the K
//                                 conflict ids, the Kc coloc ids, of
//                                 3 + K + Kc ints; -1 past the count;
//            -1 up to a multiple of 4 words;
//          every word written every sweep, so the buffer never depends on
//          an earlier sweep (the plain version builds it bit for bit);
//          -> all_gather of the records over the replica's ranks (about
//          16 KB a position at M 256, K 4, Kc 1);
//   reduce the gathered (D, rec_words) records into the replica's state:
//          every position's integer deltas by atomics straight into the
//          occupancy and topology planes (integer sums: any order), the
//          slots of their targets back to INT_MAX (every slot the MIN left
//          below INT_MAX is the target of one applied move), and the
//          loads: a node's entry in the lowest position that has one owns
//          it and adds the later positions' partials to its own in shard
//          order, ((p0 + p1) + ...) + p_{D-1} (absent partials are +0.0,
//          and no partial is -0.0, so skipping them changes no bit; a node
//          has at most one entry a position), then the sum to the load.
// The composition equals sharded_step_plain (sharded.py) bit for bit: the
// same move delta, winner rules, rank encoding and float order. In the
// shard's Problem the planes are indexed by shard-local row, p.S is the
// GLOBAL padded S (the move delta divides the preference and colocation
// terms by it) and p.n_real the shard's real rows (phantoms are a suffix
// of the global rows, so a prefix of each shard's real).
//
// Bound: latency. A position's M proposals move a few tens of KB; the
// time of elect and apply is their chains of dependent loads and their
// barriers. As one block (the first design) elect spent 6.9 of its 8.4 µs
// in one thread's move delta, a chain of ~14 dependent loads (the id and
// skew loops one id at a time), and apply 4.0 of its 7.0 µs in its
// integer atomics and departure walk (tools/k7r_profile.py's stamps, M
// 256, H100). So both are now one thread-block cluster of C CTAs (2 to 8,
// one launch, cudaLaunchKernelEx; grid = cluster), each CTA a contiguous
// chunk of the M proposals, a team of g lanes (a power of two >= the id
// and skew widths, at most 32) a proposal:
//   elect  the team's lanes split the K conflict ids, the Kc coloc ids and
//          the T-long skew loop (order-free integer sums, combined with
//          shuffles), its reads go out in two waves, and every lane then
//          computes the float terms in the plain version's order
//          (move_delta_team): the chain is ~3 loads deep where one
//          thread's move_delta was ~14. An accepted proposal posts m
//          into the shard's (S/D,) `first` array (atomicMin, INT_MAX at
//          rest); after ONE cluster barrier the proposal that reads its
//          own m there is its service's candidate, posts its rank and
//          puts `first` back at rest (a later proposal of the service
//          then reads m or INT_MAX, never its own index). No service
//          table to clear.
//   apply  a thread reads its candidate, the slot of its target and, beside
//          it, the demand its move would carry, so the won check is ~2
//          loads deep (a won move's id rows are prefetched into L1 for its
//          record); the chunk's applied moves are compacted in proposal
//          order (a block scan) and pushed, with their sources, targets and
//          demand, into every CTA's copy of the cluster's list (chunk q at
//          rows [q·Mc, q·Mc + count[q]), distributed shared memory). After
//          ONE cluster barrier each CTA holds the whole list (a few tens
//          of moves, at most one arrival a node); its last threads write
//          its chunk's move rows at their place in proposal order (the
//          counts of the chunks before it) and its share of the empty rows
//          while each of its chunk's rows, on its first threads, makes one
//          branch-free pass over the list
//          (broadcast reads of shared memory): its source's departures
//          before and after it, the source's arrival, whether anything
//          leaves its target. A row with no earlier departure from its
//          source walks the source's departures from its own on, in list
//          order, four rows read at a time, then adds the source's
//          arrival, from 0.0: the first design's float order (a node's
//          departures in proposal order, then its arrival); only a node
//          left by several moves walks past its own row. A row whose
//          target nothing leaves adds its arrival alone. Both go to the
//          row's two node entries. No hash table (shared-memory CAS
//          serialises: the first design's node tables and walk were 3.5
//          of its 7.0 µs, a one-warp pass over such a table 10.8 µs
//          here); nothing is read from another CTA after the barrier, so
//          no CTA waits for the others to exit. No global atomics: the
//          integer deltas travel as the moves' id rows.
// A card or a width the cluster cannot take (its shared memory, a card
// without cluster launch) makes ff_k7r_bind fail; there is no single-block
// path to fall back on.
//   reduce one CTA of kReduceThreads, its work in proportion to the moves
//          the records hold: it reads the D counts into a list of the
//          positions' moves in shard order; half the CTA then makes D
//          passes over the node entries in shard order, a thread an entry
//          adding its partial to its node's row of an (N, 4) accumulator
//          in global memory (at rest between sweeps: nothing is filled a
//          launch, and no node count is refused), the first entry of a
//          node claiming the row (the first pass writes without a read;
//          in the last a node's only entry adds to its load itself);
//          after the last pass each claimed row's owner adds the sums to
//          its node's load and puts the row back at rest.
//          The other half applies the integer deltas, a thread a move,
//          meanwhile (a barrier after the atomics would wait for them: 0.4
//          µs at M 256). (A (D, N) map of the entries in shared memory in
//          place of the accumulator bounds D·N by the shared memory and
//          sets D·N ints a launch; a scan of the list's entries in shared
//          memory by every owner, O(entries) a thread, took 8.0 µs at M
//          256: chip_smoke's [ranks], H100.) The first design read all
//          N·G + N·Gc1 + T + N cells of a dense delta plane (3.3 MB at
//          [ranks]' shard) to find the few a sweep moved, after an
//          all_reduce(SUM) of that plane across the ranks.
//
// Built with -DK7R_PHASES (fleetflow_tpu_torch/tools/k7r_profile.py),
// thread 0 of each CTA stamps its cycles into row blockIdx.x; the slots
// are named in solver/sharded_ranks.py's PHASE_SLOTS.

constexpr int kRankThreads = 512;   // a CTA's threads (at most)
constexpr int kRankCluster = 8;     // CTAs a cluster (at most; portable)
constexpr int kRankTarget = 256;    // lanes a CTA the bind aims for

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
  int* first;        // (S/D,) a service's lowest accepted proposal,
                     // INT_MAX at rest
  int* acc;          // (N, 4) reduce's node accumulator: owner, 3 float
                     // sums; {-1, +0, +0, +0} at rest
  int* records;      // (rec_words,) this position's applied moves, written
                     // whole by apply (the layout above)
  int cap, rec_words;  // min(M, N) moves; the records' words (the caller's,
                       // checked by the bind)
  // the launch shape ff_k7r_bind fills: C CTAs of `threads`, teams of
  // `team` lanes, chunks of `chunk` proposals; each kernel's dynamic
  // shared memory
  int cluster, threads, team, chunk;
  long long smem_elect, smem_apply, smem_reduce;
};

// the lanes of this thread's team (a power of two <= 32 within a warp)
__device__ __forceinline__ unsigned team_mask(int g) {
  const int lane = threadIdx.x & 31;
  return g == 32 ? 0xffffffffu : (((1u << g) - 1u) << (lane & ~(g - 1)));
}

// the cluster barrier split in two: a relaxed arrive at a CTA's start and
// the wait before its first access to another CTA's shared memory, which
// then has started (a CTA's shared memory is there only once it runs)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// a prefetch of the line holding `ptr` into L1
__device__ __forceinline__ void prefetch_l1(const void* ptr) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(ptr));
}

// (max, min) of the topology counts, every lane of the warp; the whole
// warp calls it
__device__ __forceinline__ void warp_topo_range(const int* tp, int T,
                                                int& tmax, int& tmin) {
  int hi = INT_MIN, lo = INT_MAX;
  for (int t = threadIdx.x & 31; t < T; t += 32) {
    hi = max(hi, tp[t]);
    lo = min(lo, tp[t]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
  }
  tmax = hi;
  tmin = lo;
}

__global__ void __launch_bounds__(kRankThreads) k7r_elect_kernel(
    K7RankStatic a, float temp, const int* __restrict__ s_loc,
    const int* __restrict__ b_idx, const float* __restrict__ u) {
  cg::cluster_group cluster = cg::this_cluster();
  const Problem& p = a.p;
  const int M = a.M, g = a.team, Mc = a.chunk;
  const int c = (int)cluster.block_rank();
  const int lo = min(c * Mc, M), hi = min(lo + Mc, M);
  const int tl = threadIdx.x & (g - 1), teams = blockDim.x / g;
  const unsigned tmask = team_mask(g);
  extern __shared__ int sm[];
  int* acc_sm = sm;             // Mc: the chunk's proposal accepted
  int* svc_sm = sm + Mc;        // Mc: its service
  int* tgt_sm = sm + 2 * Mc;    // Mc: its target
  int* c_s = a.cand;
  int* c_a = c_s + M;
  int* c_b = c_a + M;
  int* c_st = c_b + M;
#ifdef K7R_PHASES
  unsigned long long* ph = ff_phase_row();
  __shared__ unsigned long long longest;
  __shared__ int n_acc;
  if (threadIdx.x == 0) longest = 0, n_acc = 0;
  if (ph) ph[0] = ff_globaltimer();
  __syncthreads();
  const long long c0 = clock64();
#endif
  int tmax = 0, tmin = 0;
  if (p.max_skew > 0) warp_topo_range(a.topo, p.T, tmax, tmin);
  const float t = fmaxf(temp, 1e-8f);
#ifdef K7R_PHASES
  const long long c1 = clock64();
#endif
  for (int m = lo + (int)threadIdx.x / g; m < hi; m += teams) {
    const int s = s_loc[m], b = b_idx[m];
    const float uu = u[m];
    const int src = a.assignment[s];
    const float delta = move_delta_team(p, a.load, a.used, a.coloc, a.topo,
                                        tmax, tmin, s, src, b, tl, g, tmask);
    if (tl == 0) {
      const bool accept =
          ((delta < 0.f) || (uu < expf(-delta / t))) && (src != b);
      c_s[m] = s;
      c_a[m] = src;
      c_b[m] = b;
      acc_sm[m - lo] = accept;
      svc_sm[m - lo] = s;
      tgt_sm[m - lo] = b;
      if (accept) atomicMin(&a.first[s], m);
#ifdef K7R_PHASES
      if (accept) atomicAdd(&n_acc, 1);
#endif
    }
  }
#ifdef K7R_PHASES
  atomicMax(&longest, (unsigned long long)(clock64() - c1));
  const long long c2 = clock64();
#endif
  cluster.sync();  // every accepted proposal has posted into `first`
#ifdef K7R_PHASES
  const long long c3 = clock64();
#endif
  for (int i = threadIdx.x; i < hi - lo; i += blockDim.x) {
    const int m = lo + i;
    int standing = kRejected;
    if (acc_sm[i]) {
      const int s = svc_sm[i];
      standing = kAccepted;
      if (__ldcg(&a.first[s]) == m) {
        standing = kCandidate;
        a.first[s] = INT_MAX;
        atomicMin(&a.slots[tgt_sm[i]], m + M * a.d);
      }
    }
    c_st[m] = standing;
  }
#ifdef K7R_PHASES
  __syncthreads();
  if (ph) {
    const long long c4 = clock64();
    ph[1] = ff_globaltimer();
    ph[2] = c4 - c0;
    ph[3] = c1 - c0;
    ph[4] = c2 - c1;
    ph[5] = c3 - c2;
    ph[6] = c4 - c3;
    ph[7] = n_acc;
    ph[8] = M;
    ph[9] = longest;
  }
#endif
}

// The chunk's applied moves (flags `app_sm` over n entries) in order: each
// thread takes a contiguous run, a warp scan and the warps' totals
// (`warp_tot`, 32 ints) give each run its offset. `emit(i, j)` is called
// for the applied entry i with its rank j. Returns the count to every
// thread; ends with a barrier.
template <class Emit>
__device__ int scan_applied(const int* app_sm, int n, int* warp_tot,
                            Emit emit) {
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31;
  const int per = (n + T - 1) / T, i0 = min(t * per, n), i1 = min(i0 + per, n);
  int k = 0;
  for (int i = i0; i < i1; ++i) k += app_sm[i];
  int incl = k;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[t >> 5] = incl;
  __syncthreads();
  int j = incl - k, total = 0;
  for (int w = 0; w < (T >> 5); ++w) {
    const int v = warp_tot[w];
    if (w < (t >> 5)) j += v;
    total += v;
  }
  for (int i = i0; i < i1; ++i)
    if (app_sm[i]) emit(i, j++);
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kRankThreads) k7r_apply_kernel(
    K7RankStatic a) {
  cg::cluster_group cluster = cg::this_cluster();
  const Problem& p = a.p;
  const int M = a.M, Mc = a.chunk;
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int lo = min(c * Mc, M), hi = min(lo + Mc, M);
  extern __shared__ int sm[];
  int* app_sm = sm;                  // Mc: the chunk's move applied
  int* src_sm = sm + Mc;             // Mc: its source
  int* tgt_sm = sm + 2 * Mc;         // Mc: its target
  float* dem_sm = reinterpret_cast<float*>(sm + 3 * Mc);  // 3Mc: demand
  int* l_src = sm + 6 * Mc;          // C·Mc: the cluster's applied moves,
  int* l_tgt = l_src + C * Mc;       // chunk q at rows [q·Mc, q·Mc +
  float* l_dem = reinterpret_cast<float*>(l_tgt + C * Mc);  // count[q])
  int* count = reinterpret_cast<int*>(l_dem + 3 * C * Mc);  // kRankCluster
  __shared__ int warp_tot[32];
  cluster_arrive_relaxed();
#ifdef K7R_PHASES
  unsigned long long* ph = ff_phase_row();
  if (ph) ph[0] = ff_globaltimer();
  const long long c0 = clock64();
#endif
  // the won check, a thread a proposal; the move's demand is read beside
  // its slot, before the check
  for (int m = lo + (int)threadIdx.x; m < hi; m += blockDim.x) {
    int app = 0;
    if (a.cand[3 * M + m] == kCandidate) {
      const int s = a.cand[m], src = a.cand[M + m], b = a.cand[2 * M + m];
      const int won = a.slots[b];
      float dm[3];
      for (int k = 0; k < 3; ++k) dm[k] = p.demand[(size_t)s * 3 + k];
      app = won == m + M * a.d;
      if (app) {
        // its id rows, into L1 for the record written after the barrier
        if (p.K > 0) prefetch_l1(p.cids + (size_t)s * p.K);
        if (p.Kc > 0) prefetch_l1(p.colids + (size_t)s * p.Kc);
        a.assignment[s] = b;
        src_sm[m - lo] = src;
        tgt_sm[m - lo] = b;
        for (int k = 0; k < 3; ++k) dem_sm[(m - lo) * 3 + k] = dm[k];
      }
    }
    app_sm[m - lo] = app;
  }
  __syncthreads();
#ifdef K7R_PHASES
  const long long c1 = clock64();
#endif
  // the chunk's applied moves in proposal order, as rows of this CTA's
  // list, then pushed into every other CTA's
  const int n_c = scan_applied(app_sm, hi - lo, warp_tot, [&](int i, int j) {
    const int row = c * Mc + j;
    l_src[row] = src_sm[i];
    l_tgt[row] = tgt_sm[i];
    for (int k = 0; k < 3; ++k) l_dem[row * 3 + k] = dem_sm[i * 3 + k];
  });
  cluster_wait();  // every CTA of the cluster runs
  for (int x = threadIdx.x; x < n_c * C; x += blockDim.x) {
    const int r = x % C, row = c * Mc + x / C;
    if (r == c) continue;
    cluster.map_shared_rank(l_src, r)[row] = l_src[row];
    cluster.map_shared_rank(l_tgt, r)[row] = l_tgt[row];
    float* rd = cluster.map_shared_rank(l_dem, r);
    for (int k = 0; k < 3; ++k) rd[row * 3 + k] = l_dem[row * 3 + k];
  }
  if (threadIdx.x < C) cluster.map_shared_rank(count, threadIdx.x)[c] = n_c;
#ifdef K7R_PHASES
  const long long c2 = clock64();
#endif
  cluster.sync();  // every CTA holds the cluster's list and counts
#ifdef K7R_PHASES
  const long long c3 = clock64();
  long long walk = 0;
#endif
  int pre = 0, total = 0;  // the moves of the chunks before this one; all
  for (int q = 0; q < C; ++q) {
    pre += q < c ? count[q] : 0;
    total += count[q];
  }
  const int cap = a.cap, K = p.K, Wm = 3 + K + p.Kc;
  int* rec = a.records;
  int4* ent = reinterpret_cast<int4*>(rec + 4);
  int* mv = rec + 4 + 8 * (size_t)cap;
  const int4 empty = make_int4(-1, 0, 0, 0);
  if (c == 0 && threadIdx.x < 4) rec[threadIdx.x] = threadIdx.x ? 0 : total;
  // this chunk's move rows (source, target, real row, its ids), then the
  // rows past the position's moves and the padding, by the CTA's last
  // threads first: its first n_c threads walk the list below meanwhile. A
  // row's service is its proposal's, whose rank its target's slot holds
  // (L1 hits: the won check read both)
  const int back = (int)blockDim.x - 1 - (int)threadIdx.x;
  for (int i = back; i < n_c * Wm; i += blockDim.x) {
    const int j = i / Wm, w = i - j * Wm, b = l_tgt[c * Mc + j];
    const int s = w < 2 ? 0 : a.cand[a.slots[b] - M * a.d];
    int v;
    if (w == 0)
      v = l_src[c * Mc + j];
    else if (w == 1)
      v = b;
    else if (w == 2)
      v = s < p.n_real;
    else if (w < 3 + K)
      v = p.cids[(size_t)s * K + (w - 3)];
    else
      v = p.colids[(size_t)s * p.Kc + (w - 3 - K)];
    mv[(size_t)(pre + j) * Wm + w] = v;
  }
  {
    const int t = c * (int)blockDim.x + back;
    const int nt = C * (int)blockDim.x;
    for (int e = 2 * total + t; e < 2 * cap; e += nt) ent[e] = empty;
    for (size_t w = 4 + 8 * (size_t)cap + (size_t)total * Wm + t;
         w < (size_t)a.rec_words; w += nt)
      rec[w] = -1;
  }
  // each of this chunk's rows x: one branch-free pass over the list
  // counts its source's departures before and after it, finds the
  // source's arrival and whether anything leaves its target; x then walks
  // its source's departures if none comes before it (its own, then the
  // `after` later ones in list order, four rows read at a time, then the
  // arrival; most nodes have one departure and walk nothing past their
  // own row), and its target's entry is its arrival alone if nothing
  // leaves the target
  for (int j = threadIdx.x; j < n_c; j += blockDim.x) {
    const int x = c * Mc + j, src = l_src[x], b = l_tgt[x];
    int before = 0, after = 0, arrival = -1;
    bool lone = true;
    for (int q = 0; q < C; ++q) {
      const int y0 = q * Mc, y1 = y0 + count[q];
#pragma unroll 4
      for (int y = y0; y < y1; ++y) {
        const int sy = l_src[y], ty = l_tgt[y];
        before += (sy == src) & (y < x);
        after += (sy == src) & (y > x);
        lone &= sy != b;
        arrival = ty == src ? y : arrival;
      }
    }
#ifdef K7R_PHASES
    const long long w0 = clock64();
#endif
    int4 es = empty, et = empty;
    if (before == 0) {
      float l[3];
      for (int r = 0; r < 3; ++r) l[r] = 0.f + (-l_dem[x * 3 + r]);
      for (int q = c, y = x + 1; after > 0 && q < C; y = ++q * Mc) {
        for (const int y1 = q * Mc + count[q]; after > 0 && y < y1; y += 4) {
          int sy[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) sy[v] = y + v < y1 ? l_src[y + v] : -1;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (sy[v] != src || after == 0) continue;
            for (int r = 0; r < 3; ++r)
              l[r] = l[r] + (-l_dem[(y + v) * 3 + r]);
            --after;
          }
        }
      }
      if (arrival >= 0)
        for (int r = 0; r < 3; ++r) l[r] = l[r] + l_dem[arrival * 3 + r];
      es = make_int4(src, __float_as_int(l[0]), __float_as_int(l[1]),
                     __float_as_int(l[2]));
    }
    if (lone)
      et = make_int4(b, __float_as_int(0.f + l_dem[x * 3]),
                     __float_as_int(0.f + l_dem[x * 3 + 1]),
                     __float_as_int(0.f + l_dem[x * 3 + 2]));
    ent[2 * (pre + j)] = es;
    ent[2 * (pre + j) + 1] = et;
#ifdef K7R_PHASES
    walk = max(walk, clock64() - w0);
#endif
  }
#ifdef K7R_PHASES
  __shared__ unsigned long long walk_max;
  if (threadIdx.x == 0) walk_max = 0;
  __syncthreads();
  atomicMax(&walk_max, (unsigned long long)walk);
  __syncthreads();
  if (ph) {
    const long long c5 = clock64();
    ph[1] = ff_globaltimer();
    ph[2] = c5 - c0;
    ph[3] = c1 - c0;
    ph[4] = c2 - c1;
    ph[5] = c3 - c2;
    ph[6] = c5 - c3;
    ph[7] = n_c;
    ph[8] = M;
    ph[9] = walk_max;
  }
#endif
}

constexpr int kReduceThreads = 1024;  // reduce's one CTA

// position q of move g of the D positions' list, whose first moves are
// off[0..D] (off[D] the total)
__device__ __forceinline__ int position_of(const int* off, int D, int g) {
  int q = 0;
  while (q + 1 < D && off[q + 1] <= g) ++q;
  return q;
}

__global__ void __launch_bounds__(kReduceThreads) k7r_reduce_kernel(
    K7RankStatic a, const int* __restrict__ gathered) {
  const Problem& p = a.p;
  const int D = a.D, W = a.rec_words, cap = a.cap;
  const int ids = p.K + p.Kc, Wm = 3 + ids;
  extern __shared__ int off[];  // D + 1: the list's positions
  int4* acc = reinterpret_cast<int4*>(a.acc);
#ifdef K7R_PHASES
  unsigned long long* ph = ff_phase_row();
  if (ph) ph[0] = ff_globaltimer();
  const long long c0 = clock64();
#endif
  // the positions' moves in shard order as one list (the counts)
  for (int q = threadIdx.x; q < D; q += blockDim.x)
    off[q + 1] = __ldg(gathered + (size_t)q * W);
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int q = 0; q < D; ++q) off[q + 1] += off[q];
  }
  __syncthreads();
  const int moves = off[D];
#ifdef K7R_PHASES
  const long long c1 = clock64();
  long long c2 = c1;
#endif
  // two teams of half the CTA each, which do not wait for each other. The
  // first makes D passes in shard order, a barrier of its own between
  // them: position q's node entries (a node has at most one a position)
  // each add their partial to their node's row of the accumulator
  // ({owner, 3 float sums}, {-1, +0, +0, +0} at rest), the first to reach
  // a row claiming it. In the first pass every row is at rest (no read);
  // in the last an entry that finds its row at rest is its node's only
  // one and adds its partial to the load itself (the row stays at rest).
  // Then each claimed row's owner adds the sums to its node's load and
  // puts the row back at rest. The second team applies the moves' integer
  // deltas straight into the replica's planes (a barrier after them would
  // wait for their atomics).
  const int team = blockDim.x / 2;
  if ((int)threadIdx.x < team) {
    for (int q = 0; q < D; ++q) {
      const int4* ent =
          reinterpret_cast<const int4*>(gathered + (size_t)q * W + 4);
      const int e0 = 2 * off[q], n_e = 2 * off[q + 1] - e0;
      for (int i = threadIdx.x; i < n_e; i += team) {
        const int4 v = __ldg(ent + i);
        if (v.x < 0) continue;
        const int4 r = q == 0 ? make_int4(-1, 0, 0, 0) : acc[v.x];
        const float s0 = __int_as_float(r.y) + __int_as_float(v.y);
        const float s1 = __int_as_float(r.z) + __int_as_float(v.z);
        const float s2 = __int_as_float(r.w) + __int_as_float(v.w);
        if (q == D - 1 && r.x < 0) {
          float* ld = a.load + (size_t)v.x * 3;
          ld[0] = ld[0] + s0;
          ld[1] = ld[1] + s1;
          ld[2] = ld[2] + s2;
        } else {
          acc[v.x] = make_int4(r.x < 0 ? e0 + i : r.x, __float_as_int(s0),
                               __float_as_int(s1), __float_as_int(s2));
        }
      }
      if (D > 1) asm volatile("bar.sync 1, %0;" ::"r"(team) : "memory");
    }
#ifdef K7R_PHASES
    c2 = clock64();
#endif
    // the owners: entries of every position but the last
    for (int q = 0; q + 1 < D; ++q) {
      const int4* ent =
          reinterpret_cast<const int4*>(gathered + (size_t)q * W + 4);
      const int e0 = 2 * off[q], n_e = 2 * off[q + 1] - e0;
      for (int i = threadIdx.x; i < n_e; i += team) {
        const int n = __ldg(ent + i).x;
        if (n < 0) continue;
        float* ld = a.load + (size_t)n * 3;
        const int4 r = acc[n];  // read beside the load, before the check
        const float l0 = ld[0], l1 = ld[1], l2 = ld[2];
        if (r.x != e0 + i) continue;
        ld[0] = l0 + __int_as_float(r.y);
        ld[1] = l1 + __int_as_float(r.z);
        ld[2] = l2 + __int_as_float(r.w);
        acc[n] = make_int4(-1, 0, 0, 0);
      }
    }
  } else {
    // a move: its row's source, target, real flag and first 8 ids read in
    // one wave; the slot of its target back at rest
    for (int g = threadIdx.x - team; g < moves; g += team) {
      const int q = position_of(off, D, g);
      const int* row = gathered + (size_t)q * W + 4 + 8 * (size_t)cap +
                       (size_t)(g - off[q]) * Wm;
      const int src = __ldg(row), b = __ldg(row + 1), real = __ldg(row + 2);
      int id[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) id[v] = v < ids ? __ldg(row + 3 + v) : -1;
      a.slots[b] = INT_MAX;
      if (real) {
        atomicSub(&a.topo[p.ntopo[src]], 1);
        atomicAdd(&a.topo[p.ntopo[b]], 1);
      }
      for (int k0 = 0; k0 < ids; k0 += 8) {
        if (k0 > 0)
          for (int v = 0; v < 8; ++v)
            id[v] = k0 + v < ids ? __ldg(row + 3 + k0 + v) : -1;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          if (id[v] < 0) continue;
          const bool occ = k0 + v < p.K;
          int* plane = occ ? a.used : a.coloc;
          const size_t width = occ ? p.G : p.Gc1;
          atomicSub(&plane[(size_t)src * width + id[v]], 1);
          atomicAdd(&plane[(size_t)b * width + id[v]], 1);
        }
      }
    }
  }
#ifdef K7R_PHASES
  if (ph) {
    const long long c3 = clock64();
    ph[1] = ff_globaltimer();
    ph[2] = c3 - c0;
    ph[3] = c1 - c0;
    ph[4] = c2 - c1;
    ph[5] = c3 - c2;
    ph[7] = moves;
    ph[8] = a.M;
  }
#endif
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

// a cluster launch of `a.cluster` CTAs (the grid is one cluster)
static cudaLaunchConfig_t rank_config(const K7RankStatic& a, size_t smem,
                                      cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster);
  cfg.blockDim = dim3(a.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// a failed runtime call of the bind: its error is returned and cleared
// from the runtime's last-error state, so no later launch check reads it
static int bind_failed(cudaError_t e) {
  (void)cudaGetLastError();
  return static_cast<int>(e);
}

// the records' words for cap moves of 3 + K + Kc ints (the layout above;
// sharded_ranks.record_layout computes the same)
static long long record_words(long long cap, int K, int Kc) {
  const long long moves = cap * (3 + K + Kc);
  return 4 + 8 * cap + (moves + 3) / 4 * 4;
}

// Check a K7RankStatic (the wrapper's _ext.K7RankArgs) and fill its launch
// shape: the team g (a power of two >= the conflict-id, coloc-id and, with
// a spread constraint, topology widths; at most 32), the cluster (M·g
// lanes at ~kRankTarget a CTA, 2 to 8 CTAs of at most kRankThreads), the
// chunk and the kernels' dynamic shared memory (elect 3·chunk ints, apply
// 6·chunk + 5·C·chunk + 8, reduce D + 1). The
// records must have the layout's size for cap = min(M, N). Fails, and
// nothing is launched, on a card without cluster launch or when a cluster
// of that shape cannot be scheduled (apply's list past the shared memory:
// M above 10,096 on an H100); a runtime call that fails there leaves no
// error behind for a later launch's check. Called once per bound launcher.
FF_EXPORT int ff_k7r_bind(void* args) {
  K7RankStatic* a = static_cast<K7RankStatic*>(args);
  const Problem& p = a->p;
  if (a->D < 1 || a->d < 0 || a->d >= a->D || a->M < 1 || p.N < 1 ||
      p.S % a->D != 0 || p.K < 0 || p.Kc < 0 || p.T < 1 ||
      a->first == nullptr || a->records == nullptr || a->acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = a->M < p.N ? a->M : p.N;
  if (a->cap != cap || a->rec_words != record_words(cap, p.K, p.Kc))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, cluster_ok = 0, max_smem = 0;
  cudaFuncAttributes fe = {}, fa = {};
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&cluster_ok, cudaDevAttrClusterLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fe, k7r_elect_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, k7r_apply_kernel);
  if (e != cudaSuccess) return bind_failed(e);
  if (!cluster_ok) return static_cast<int>(cudaErrorNotSupported);
  int need = p.K > p.Kc ? p.K : p.Kc;
  if (p.max_skew > 0 && p.T > need) need = p.T;
  int g = 1;
  while (g < need && g < 32) g <<= 1;
  const long long lanes = (long long)a->M * g;
  long long C = (lanes + kRankTarget - 1) / kRankTarget;
  if (C < 2) C = 2;
  if (C > kRankCluster) C = kRankCluster;
  long long threads = (lanes + C - 1) / C;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kRankThreads) threads = kRankThreads;
  const int chunk = static_cast<int>((a->M + C - 1) / C);
  const size_t elect = (size_t)3 * chunk * sizeof(int);
  const size_t apply = ((size_t)6 * chunk + (size_t)5 * C * chunk +
                        kRankCluster) * sizeof(int);
  // the dynamic shared memory beside each kernel's static
  if (apply + fa.sharedSizeBytes > (size_t)max_smem ||
      elect + fe.sharedSizeBytes > (size_t)max_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (elect > 48 * 1024)
    e = cudaFuncSetAttribute(k7r_elect_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)elect);
  if (e == cudaSuccess && apply > 48 * 1024)
    e = cudaFuncSetAttribute(k7r_apply_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)apply);
  if (e != cudaSuccess) return bind_failed(e);
  a->cluster = static_cast<int>(C);
  a->threads = static_cast<int>(threads);
  a->team = g;
  a->chunk = chunk;
  // reduce's one CTA: the positions' counts
  const size_t reduce = ((size_t)a->D + 1) * sizeof(int);
  if (reduce > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  a->smem_reduce = static_cast<long long>(reduce);
  // one cluster of this shape must fit on the card, for each kernel
  cudaLaunchAttribute attr[1];
  int fits = 0;
  cudaLaunchConfig_t cfg = rank_config(*a, elect, 0, attr);
  e = cudaOccupancyMaxActiveClusters(&fits, k7r_elect_kernel, &cfg);
  if (e == cudaSuccess && fits >= 1) {
    cfg = rank_config(*a, apply, 0, attr);
    e = cudaOccupancyMaxActiveClusters(&fits, k7r_apply_kernel, &cfg);
  }
  if (e != cudaSuccess) return bind_failed(e);
  if (fits < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  a->smem_elect = static_cast<long long>(elect);
  a->smem_apply = static_cast<long long>(apply);
  return 0;
}

// elect: the (M,) shard-local services, targets and uniforms of this
// position at temperature `temp`; posts the candidates into the slots.
FF_EXPORT int ff_k7r_elect(const void* args, float temp, const int* s_loc,
                           const int* b_idx, const float* u,
                           cudaStream_t stream) {
  const K7RankStatic& a = *static_cast<const K7RankStatic*>(args);
  if (a.cluster < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      rank_config(a, (size_t)a.smem_elect, stream, attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, k7r_elect_kernel, a, temp, s_loc, b_idx, u);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// apply: the candidates that won their node, against the reduced slots,
// into the position's records (their header holds the applied count).
FF_EXPORT int ff_k7r_apply(const void* args, cudaStream_t stream) {
  const K7RankStatic& a = *static_cast<const K7RankStatic*>(args);
  if (a.cluster < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      rank_config(a, (size_t)a.smem_apply, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k7r_apply_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// reduce: `gathered` is the (D, rec_words) records of the replica's
// shards in shard order.
FF_EXPORT int ff_k7r_reduce(const void* args, const int* gathered,
                            cudaStream_t stream) {
  const K7RankStatic& a = *static_cast<const K7RankStatic*>(args);
  if (a.smem_reduce < 1) return static_cast<int>(cudaErrorInvalidValue);
  k7r_reduce_kernel<<<1, kReduceThreads, (size_t)a.smem_reduce, stream>>>(
      a, gathered);
  return static_cast<int>(cudaGetLastError());
}
