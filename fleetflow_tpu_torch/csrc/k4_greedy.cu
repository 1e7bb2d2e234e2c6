// K4: batched greedy seed.
//
// Replaces fleetflow_tpu/solver/greedy.py::greedy_place_batched with
// _node_scores, _conflict_rows, _pairwise_ok and _commit. Services are
// placed in `order`, M at a time; for each batch and round:
//   choose  each batch service scores all N nodes against the shared
//           (load, used) state: fit, util² by strategy, preference,
//           overflow and conflict rows. Among the hard-feasible nodes it
//           takes rank r_eff of the stable descending order (the
//           reference's lax.top_k, lower index first on equal scores), with
//           the anti-herding rank of the strategy; with no feasible node it
//           takes the first argmax of the best-effort score (ineligible
//           nodes masked by -1e15);
//   commit  service m commits when the demand of the EARLIER live
//           same-node batch-mates (summed in index order) still fits and
//           none of them shares a conflict id; each node adds its winners'
//           demand in batch order and, after the last round, its
//           best-effort rest in batch order. Round 2 re-chooses for the
//           losers.
//
// Bound: operations. Each round scores M×N pairs (~30 float32 operations,
// a conflict bit and an eligibility bit each) over ceil(S/M) sequential
// batches; the rest is latency: the batches and rounds are a chain of
// dependent steps.
//
// Design: ONE cooperative launch per seed. A persistent grid (occupancy ×
// SMs, at most M blocks of 512 threads) walks the batches and rounds
// itself, with a grid barrier between choose and commit and between
// commit and the next choose (~1 µs each on the H100):
//   - the prologue zeroes the state and, for strategies 1 and 2, takes the
//     capacity column medians (blocks 0-2, by radix select) and every
//     batch's mean demand (one value per batch, summed in index order as
//     before, not once per block);
//   - the seed needs of the occupancy only whether a node already holds
//     one of a service's conflict ids, so it keeps a bitmap (a bit a node
//     for each id, set by atomicOr at commit) in place of the (N, G)
//     counts: a service's conflict row is the OR of K coalesced rows of
//     N/32 words, where the counts cost N×K scattered L2 sectors a block
//     (the L2 throughput that bound choose);
//   - choose: block b takes services b, b + grid, ... Its scoring pass
//     writes one 32-bit ordered key per node to shared memory (descending
//     score = ascending key; an infeasible node holds the largest key) and
//     counts the feasible nodes, so r_eff is known before the selection.
//     The node of rank r_eff is found by a block-wide radix select, not a
//     sort: four 8-bit digit passes, each a shared-memory histogram (a
//     warp whose candidates share a digit, as tied scores do, adds once)
//     and one warp's scan of its 256 bins, leave the key K* and the rank t
//     of the wanted node among the nodes of key K*; a block prefix count
//     in index order then finds that node (ties by index, as a stable
//     sort);
//   - commit: block 0 stages the batch's demand, ids and chosen nodes'
//     load and capacity in shared memory once (one round of parallel
//     loads, where reading them inside the walks below was a chain of L2
//     latencies), and sorts the batch's live (choice, m) pairs (warp runs
//     of 32, merged by binary search), so each service walks only its own
//     node's group, in m order, for its earlier mates' demand and pairwise
//     conflicts; then one thread per touched node adds its winners, then
//     its best-effort rest, in batch order (every node's float order is
//     the old serial loop's), and the conflict bits by atomics. (A
//     broadcast scan of the whole batch for each service's mates, with no
//     sort, measured 3.7× slower: 255 dependent steps.) A round with no
//     live service left is skipped by every block (nothing would change).
// State shared across blocks (load, the bitmap, the choices) is read at L2
// (ld.global.cg) after each barrier; the seed's running load is padded to
// one 16-byte word a node, so a node's load is one L2 access. The node count is limited by the keys
// in shared memory (K4_MAX_NODES); capacity and load are read from L2
// rather than staged, which would cut that limit to ~9k nodes. A card that
// cannot co-schedule the grid makes the call fail; there is no launch
// loop to fall back on.
//
// Built with -DK4_PHASES (fleetflow_tpu_torch/tools/k4_phases.py), the
// kernel also writes the device timer at five points of each batch-round
// (choose starts, the last block leaves choose, commit starts, commit
// ends, the next round may start) into a buffer set by ff_k4_set_phases.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#ifdef K4_PHASES
__device__ unsigned long long* g_phases = nullptr;  // (batch-rounds, 8)

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// block 0's thread 0 stamps point i of batch-round jr; K4_PHASE_LAST takes
// the latest stamp of any block
#define K4_PHASE(jr, i)                                               \
  if (g_phases && blockIdx.x == 0 && threadIdx.x == 0)                \
    g_phases[(size_t)(jr) * 8 + (i)] = global_timer()
#define K4_PHASE_LAST(jr, i)                                          \
  if (g_phases && threadIdx.x == 0)                                   \
    atomicMax(&g_phases[(size_t)(jr) * 8 + (i)], global_timer())
#else
#define K4_PHASE(jr, i)
#define K4_PHASE_LAST(jr, i)
#endif

#define K4_THREADS 512
// keys of N nodes in shared memory (4 bytes each) plus the static arrays
#define K4_MAX_NODES 49152
#define K4_MAX_BATCH 1024

namespace {

struct Problem {
  int S, N, G, K;
  const float* demand;
  const float* cap;
  const int* cids;
  const void* elig;
  int packed, stride;
  const unsigned char* valid;
  const float* pref;
  int strategy;
};

struct Work {
  const int* order;
  int M, rounds;
  int* assignment;
  float4* load;     // (N,): a node's load, padded to one 16-byte word
  unsigned* taken;  // (G, words): bit n of row id = node n holds that id
  int words;        // ceil(N / 32)
  int* live;     // (M,)
  int* choice;   // (M,)
  int* hasok;    // (M,)
  int* any_live; // (1,)
  float* med;    // (3,)
  float* mean;   // (batches, 3)
};

__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// ascending key of a feasible node's score: the stable descending order
__device__ __forceinline__ unsigned node_key(float score) {
  if (score == 0.f) score = 0.f;  // -0 and +0 rank as equal, as in a compare
  return ~ordered_bits(score);
}

struct Select {
  unsigned hist[2][256];  // double-buffered: one pass builds, one is zeroed
  unsigned digit, rank, count;
  int found;
  unsigned cand_key[32];
  int cand_idx[32];
};

// Block-wide: the index of the t-th element (index order) of keys[0..n)
// equal to `key`; such an element exists.
__device__ int nth_equal(const unsigned* keys, int n, unsigned key,
                         unsigned t, unsigned* warp_cnt, Select& sel) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned base = 0;
  if (threadIdx.x == 0) sel.found = -1;
  __syncthreads();
  for (int c = 0; c < n; c += blockDim.x) {
    const int i = c + threadIdx.x;
    const bool flag = i < n && keys[i] == key;
    const unsigned bal = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    unsigned before = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) before += warp_cnt[w];
      total += warp_cnt[w];
    }
    before += __popc(bal & ((1u << lane) - 1u));
    if (flag && before == t) sel.found = i;
    __syncthreads();
    if (sel.found >= 0) break;
    base += total;
  }
  return sel.found;
}

// Block-wide, for at most 32 keys of keys[0..n) matching `prefix` under
// `mask`: the index of the one of rank r in (key, index) order. The
// candidates are compacted in index order, then one warp ranks them.
__device__ int select_small(const unsigned* keys, int n, unsigned prefix,
                            unsigned mask, unsigned r, unsigned* warp_cnt,
                            Select& sel) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  unsigned base = 0;
  for (int c = 0; c < n; c += blockDim.x) {
    const int i = c + threadIdx.x;
    const bool flag = i < n && (keys[i] & mask) == prefix;
    const unsigned bal = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) warp_cnt[warp] = __popc(bal);
    __syncthreads();
    unsigned before = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) before += warp_cnt[w];
      total += warp_cnt[w];
    }
    before += __popc(bal & ((1u << lane) - 1u));
    if (flag) {
      sel.cand_key[before] = keys[i];
      sel.cand_idx[before] = i;
    }
    base += total;
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    const unsigned l = threadIdx.x;
    const unsigned kl = l < base ? sel.cand_key[l] : 0xffffffffu;
    unsigned rank = 0;
    for (unsigned j = 0; j < base; ++j) {
      const unsigned kj = sel.cand_key[j];
      rank += kj < kl || (kj == kl && j < l);
    }
    if (l < base && rank == r) sel.found = sel.cand_idx[l];
  }
  __syncthreads();
  return sel.found;
}

// Block-wide: the index of the element of ascending rank r (r < n) of
// keys[0..n) in (key, index) order: 8-bit radix passes from the top until
// the wanted bin holds at most 32 keys (select_small), or all four passes
// leave a run of equal keys (nth_equal).
__device__ int select_rank(const unsigned* keys, int n, unsigned r,
                           unsigned* warp_cnt, Select& sel) {
  unsigned prefix = 0, mask = 0;
  int b = 0;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) sel.hist[0][i] = 0;
  __syncthreads();
  for (int shift = 24; shift >= 0; shift -= 8) {
    unsigned* hist = sel.hist[b];
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sel.hist[b ^ 1][i] = 0;
    // a warp whose candidates share one digit (tied scores do) adds once
    for (int i0 = threadIdx.x & ~31; i0 < n; i0 += blockDim.x) {
      const int i = i0 + (threadIdx.x & 31);
      const unsigned k = i < n ? keys[i] : 0u;
      const bool in = i < n && (k & mask) == prefix;
      const unsigned d = (k >> shift) & 255u;
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (act == 0u) continue;
      const int leader = __ffs(act) - 1;
      const unsigned dl = __shfl_sync(0xffffffffu, d, leader);
      if (__all_sync(0xffffffffu, !in || d == dl)) {
        if ((int)(threadIdx.x & 31) == leader) atomicAdd(&hist[dl], __popc(act));
      } else if (in) {
        atomicAdd(&hist[d], 1u);
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      unsigned own = 0;
      for (int q = 0; q < 8; ++q) own += hist[lane * 8 + q];
      unsigned incl = own;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const unsigned excl = incl - own;
      const unsigned hit = __ballot_sync(0xffffffffu, excl <= r && r < incl);
      if (lane == __ffs(hit) - 1) {
        unsigned run = excl;
        for (int q = 0; q < 8; ++q) {
          const unsigned h = hist[lane * 8 + q];
          if (r < run + h) {
            sel.digit = lane * 8 + q;
            sel.rank = r - run;
            sel.count = h;
            break;
          }
          run += h;
        }
      }
    }
    __syncthreads();
    prefix |= sel.digit << shift;
    mask |= 255u << shift;
    r = sel.rank;
    b ^= 1;
    if (sel.count <= 32u)
      return select_small(keys, n, prefix, mask, r, warp_cnt, sel);
  }
  return nth_equal(keys, n, prefix, r, warp_cnt, sel);
}

struct Reduce {
  long long c[32];
  float v[32];
  int i[32];
  long long c_out;
  float v_out;
  int i_out;
};

// Block-wide, in one pass: the sum of `count` and the first argmax of
// (v, i) (higher v, then lower i); every thread gets both
__device__ void count_and_argmax(long long& count, float& v, int& i,
                                 Reduce& red) {
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, o);
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (ff_better_max(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red.c[warp] = count;
    red.v[warp] = v;
    red.i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    long long c = lane < nw ? red.c[lane] : 0;
    float bv = lane < nw ? red.v[lane] : -CUDART_INF_F;
    int bi = lane < nw ? red.i[lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
      c += __shfl_down_sync(0xffffffffu, c, o);
      const float ov = __shfl_down_sync(0xffffffffu, bv, o);
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      if (ff_better_max(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      red.c_out = c;
      red.v_out = bv;
      red.i_out = bi;
    }
  }
  __syncthreads();
  count = red.c_out;
  v = red.v_out;
  i = red.i_out;
}

// choose for batch service m (one block): writes choice[m], hasok[m]
__device__ void choose(const Problem& p, const Work& w, int base, int m,
                       int est, unsigned* keys, unsigned* warp_cnt,
                       Select& sel) {
  __shared__ Reduce red;
  const int s = w.order[base + m];
  const float d0 = p.demand[(size_t)s * 3 + 0];
  const float d1 = p.demand[(size_t)s * 3 + 1];
  const float d2 = p.demand[(size_t)s * 3 + 2];

  // the service's conflict row: a node holds one of its ids
  unsigned* conf = keys + p.N;
  for (int wd = threadIdx.x; wd < w.words; wd += blockDim.x) {
    unsigned bits = 0u;
    for (int k = 0; k < p.K; ++k) {
      const int id = __ldg(&p.cids[(size_t)s * p.K + k]);
      if (id >= 0) bits |= __ldcg(&w.taken[(size_t)id * w.words + wd]);
    }
    conf[wd] = bits;
  }
  __syncthreads();
  long long count = 0;
  float fb_best = -CUDART_INF_F;
  int fb_idx = 0;
  for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
    const float4 l = __ldcg(w.load + n);
    const float* c = p.cap + (size_t)n * 3;
    const float c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
    const float n0 = l.x + d0, n1 = l.y + d1, n2 = l.z + d2;
    const bool fits = (n0 <= c0 + 1e-6f) && (n1 <= c1 + 1e-6f) &&
                      (n2 <= c2 + 1e-6f);
    const float u0 = n0 / fmaxf(c0, 1e-6f);
    const float u1 = n1 / fmaxf(c1, 1e-6f);
    const float u2 = n2 / fmaxf(c2, 1e-6f);
    const float usq = (u0 * u0 + u1 * u1) + u2 * u2;
    float score = p.strategy == 0 ? -usq : (p.strategy == 1 ? usq : -(float)n);
    if (p.pref != nullptr) score = score + p.pref[(size_t)s * p.N + n] * 0.5f;
    const float overflow = (fmaxf(n0 - c0, 0.f) + fmaxf(n1 - c1, 0.f)) +
                           fmaxf(n2 - c2, 0.f);
    const bool conflict = (conf[n >> 5] >> (n & 31)) & 1u;
    const bool el = ff_elig(p.elig, p.packed, p.stride, s, n) && p.valid[n];
    const bool ok = fits && el && !conflict;
    count += ok;
    keys[n] = ok ? node_key(score) : 0xffffffffu;
    float fb = (score - overflow * 1e3f) - (float)conflict * 1e3f;
    if (!el) fb = fb - 1e15f;
    if (ff_better_max(fb, n, fb_best, fb_idx)) {
      fb_best = fb;
      fb_idx = n;
    }
  }
  count_and_argmax(count, fb_best, fb_idx, red);
  if (count == 0) {
    if (threadIdx.x == 0) {
      w.choice[m] = fb_idx;
      w.hasok[m] = 0;
    }
    return;
  }
  const int W = w.M < p.N ? w.M : p.N;
  const int count_ok = count < W ? (int)count : W;
  const int floor_ok = count_ok - 1 > 0 ? count_ok - 1 : 0;
  const int r_eff = p.strategy == 0
                        ? min(((m % W) * count_ok) / W, floor_ok)
                        : min(m / est, floor_ok);
  const int node = select_rank(keys, p.N, (unsigned)r_eff, warp_cnt, sel);
  if (threadIdx.x == 0) {
    w.choice[m] = node;
    w.hasok[m] = 1;
  }
}

// Block-wide ascending sort of n (a multiple of 32) 32-bit keys from `in`
// to `out`: each warp sorts runs of 32 in registers (a bitonic network of
// shuffles), then every key finds its place by binary searches in the
// other runs (a stable merge: an equal key of an earlier run goes first).
// Two barriers, where a shared-memory bitonic sort of 256 keys takes 36;
// on the H100 it timed faster than that sort and than ranking each key
// against all the others.
__device__ void sort_u32(unsigned* in, unsigned* out, int n) {
  const int lane = threadIdx.x & 31;
  for (int run = threadIdx.x >> 5; run < n / 32; run += blockDim.x >> 5) {
    unsigned v = in[run * 32 + lane];
    for (int k = 2; k <= 32; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        const unsigned o = __shfl_xor_sync(0xffffffffu, v, j);
        const bool up = (lane & k) == 0 || k == 32;
        const bool low = (lane & j) == 0;
        v = (low == up) ? min(v, o) : max(v, o);
      }
    in[run * 32 + lane] = v;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int run = x >> 5;
    const unsigned v = in[x];
    int pos = x & 31;
    for (int o = 0; o < n / 32; ++o) {
      if (o == run) continue;
      const unsigned* r = in + o * 32;
      int lo = 0, hi = 32;  // count of r below v (or not above it)
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (o < run ? r[mid] <= v : r[mid] < v) lo = mid + 1; else hi = mid;
      }
      pos += lo;
    }
    out[pos] = v;
  }
  __syncthreads();
}

// commit of one batch and round (block 0 alone): the batch's demand, ids
// and chosen nodes' load and capacity are staged in shared memory once,
// and its live (choice, m) pairs sorted, so each service walks only its
// own node's group, in m order
__device__ void commit(const Problem& p, const Work& w, int base, int round,
                       bool last, unsigned* sm) {
  const int M = w.M, K = p.K;
  int P = 32;
  while (P < M) P <<= 1;
  unsigned* sorted = sm;                           // (P,)
  unsigned* keys = sm + P;                         // (P,)
  int* live_sm = reinterpret_cast<int*>(sm + 2 * P);  // (M,) each
  int* ch_sm = live_sm + M;
  int* s_sm = ch_sm + M;
  int* ok_sm = s_sm + M;
  int* pos_sm = ok_sm + M;
  float* d_sm = reinterpret_cast<float*>(pos_sm + M);  // (M, 3)
  float* l_sm = d_sm + 3 * M;                          // (M, 3)
  float* c_sm = l_sm + 3 * M;                          // (M, 3)
  int* ids_sm = reinterpret_cast<int*>(c_sm + 3 * M);  // (M, K)
  __shared__ int any;
  if (threadIdx.x == 0) any = 0;
  for (int m = threadIdx.x; m < P; m += blockDim.x) {
    unsigned key = 0xffffffffu;
    if (m < M) {
      const bool live = round == 1 ? base + m < p.S : __ldcg(&w.live[m]) != 0;
      const int c = live ? __ldcg(&w.choice[m]) : 0;
      const int s = base + m < p.S ? w.order[base + m] : 0;
      live_sm[m] = live;
      ch_sm[m] = c;
      s_sm[m] = s;
      const float4 l = __ldcg(w.load + c);
      l_sm[m * 3 + 0] = l.x;
      l_sm[m * 3 + 1] = l.y;
      l_sm[m * 3 + 2] = l.z;
      for (int r = 0; r < 3; ++r) {
        d_sm[m * 3 + r] = p.demand[(size_t)s * 3 + r];
        c_sm[m * 3 + r] = __ldg(&p.cap[(size_t)c * 3 + r]);
      }
      for (int k = 0; k < K; ++k)
        ids_sm[m * K + k] = __ldg(&p.cids[(size_t)s * K + k]);
      if (live) key = ((unsigned)c << 10) | (unsigned)m;
    }
    keys[m] = key;
  }
  __syncthreads();
  sort_u32(keys, sorted, P);
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    if (sorted[i] != 0xffffffffu) pos_sm[sorted[i] & 1023u] = i;
  __syncthreads();
  // each live service with a feasible choice against its earlier mates
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    bool ok = false;
    if (live_sm[m] && __ldcg(&w.hasok[m])) {
      const int c = ch_sm[m];
      const int pos = pos_sm[m];
      int lo = pos;
      while (lo > 0 && (sorted[lo - 1] >> 10) == (unsigned)c) --lo;
      float pre0 = 0.f, pre1 = 0.f, pre2 = 0.f;
      bool conf_ok = true;
      for (int i = lo; i < pos; ++i) {
        const int q = (int)(sorted[i] & 1023u);
        pre0 = pre0 + d_sm[q * 3 + 0];
        pre1 = pre1 + d_sm[q * 3 + 1];
        pre2 = pre2 + d_sm[q * 3 + 2];
        for (int k = 0; conf_ok && k < K; ++k) {
          const int id = ids_sm[m * K + k];
          if (id < 0) continue;
          for (int k2 = 0; k2 < K; ++k2)
            if (ids_sm[q * K + k2] == id) conf_ok = false;
        }
      }
      const float* cp = c_sm + m * 3;
      const bool cap_ok =
          ((l_sm[m * 3 + 0] + pre0) + d_sm[m * 3 + 0] <= cp[0] + 1e-6f) &&
          ((l_sm[m * 3 + 1] + pre1) + d_sm[m * 3 + 1] <= cp[1] + 1e-6f) &&
          ((l_sm[m * 3 + 2] + pre2) + d_sm[m * 3 + 2] <= cp[2] + 1e-6f);
      ok = cap_ok && conf_ok;
    }
    ok_sm[m] = ok;
  }
  __syncthreads();
  // one thread per touched node: winners in batch order, then (last round)
  // the best-effort rest in batch order
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const unsigned key = sorted[i];
    if (key == 0xffffffffu) continue;
    if (i > 0 && (sorted[i - 1] >> 10) == (key >> 10)) continue;
    const int c = (int)(key >> 10);
    const int m0 = (int)(key & 1023u);
    float l0 = l_sm[m0 * 3 + 0], l1 = l_sm[m0 * 3 + 1], l2 = l_sm[m0 * 3 + 2];
    for (int pass = 0; pass < (last ? 2 : 1); ++pass)
      for (int j = i; j < M && sorted[j] != 0xffffffffu &&
                      (sorted[j] >> 10) == (unsigned)c; ++j) {
        const int m = (int)(sorted[j] & 1023u);
        if ((ok_sm[m] != 0) != (pass == 0)) continue;
        l0 = l0 + d_sm[m * 3 + 0];
        l1 = l1 + d_sm[m * 3 + 1];
        l2 = l2 + d_sm[m * 3 + 2];
      }
    w.load[c] = make_float4(l0, l1, l2, 0.f);
  }
  // the committed services' ids mark their node in the conflict bitmap
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const bool take = ok_sm[m] || (last && live_sm[m]);
    if (take) {
      const int c = ch_sm[m];
      for (int k = 0; k < K; ++k) {
        const int id = ids_sm[m * K + k];
        if (id >= 0)
          atomicOr(&w.taken[(size_t)id * w.words + (c >> 5)], 1u << (c & 31));
      }
      w.assignment[s_sm[m]] = c;
    }
    const int still = live_sm[m] && !ok_sm[m] && !last;
    w.live[m] = still;
    if (still) any = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) *w.any_live = any;
}

__global__ void __launch_bounds__(K4_THREADS)
k4_seed(Problem p, Work w) {
  extern __shared__ unsigned dyn[];
  __shared__ Select sel;
  __shared__ unsigned warp_cnt[32];
  cg::grid_group grid = cg::this_grid();
  const size_t step = grid_stride();
  for (size_t i = grid_tid(); i < (size_t)p.N; i += step)
    w.load[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = grid_tid(); i < (size_t)p.G * w.words; i += step)
    w.taken[i] = 0u;
  const int M = w.M;
  const int n_batches = (p.S + M - 1) / M;
  if (p.strategy != 0) {
    // capacity column medians, (lo + hi) * 0.5 as jnp.median
    for (int r = blockIdx.x; r < 3; r += gridDim.x) {
      for (int n = threadIdx.x; n < p.N; n += blockDim.x)
        dyn[n] = ordered_bits(p.cap[(size_t)n * 3 + r]);
      __syncthreads();
      const float lo = from_ordered(
          dyn[select_rank(dyn, p.N, (unsigned)((p.N - 1) / 2), warp_cnt, sel)]);
      const float hi = from_ordered(
          dyn[select_rank(dyn, p.N, (unsigned)(p.N / 2), warp_cnt, sel)]);
      if (threadIdx.x == 0) w.med[r] = (lo + hi) * 0.5f;
      __syncthreads();
    }
    // each batch's mean demand over ALL M rows, padded rows reading
    // service 0, summed in index order
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_batches * 3;
         j += gridDim.x * blockDim.x) {
      const int b = j / 3, r = j % 3;
      float sum = 0.f;
      for (int q = 0; q < M; ++q) {
        const int sq = b * M + q < p.S ? w.order[b * M + q] : 0;
        sum = sum + p.demand[(size_t)sq * 3 + r];
      }
      w.mean[j] = fmaxf(sum / (float)M, 1e-6f);
    }
  }
  grid.sync();
  for (int j = 0; j < n_batches; ++j) {
    const int base = j * M;
    int est = 1;
    if (p.strategy != 0) {
      float ratio = CUDART_INF_F;
      for (int r = 0; r < 3; ++r)
        ratio = fminf(ratio, __ldcg(&w.med[r]) / __ldcg(&w.mean[j * 3 + r]));
      est = ratio >= (float)M ? M : (int)ratio;
      if (est < 1) est = 1;
    }
    for (int round = 1; round <= w.rounds; ++round) {
      if (round > 1 && __ldcg(w.any_live) == 0) break;  // uniform
      K4_PHASE(j * 2 + round - 1, 0);
      for (int m = blockIdx.x; m < M; m += gridDim.x) {
        const bool live =
            round == 1 ? base + m < p.S : __ldcg(&w.live[m]) != 0;
        if (live) choose(p, w, base, m, est, dyn, warp_cnt, sel);
        __syncthreads();
      }
      K4_PHASE_LAST(j * 2 + round - 1, 1);
      grid.sync();
      K4_PHASE(j * 2 + round - 1, 2);
      if (blockIdx.x == 0) commit(p, w, base, round, round == w.rounds, dyn);
      K4_PHASE(j * 2 + round - 1, 3);
      grid.sync();
      K4_PHASE(j * 2 + round - 1, 4);
    }
  }
}

}  // namespace

// The dynamic shared memory of k4_seed: the node keys of one service, or
// its conflict row (a bit a node), or block 0's commit arrays (the sort
// keys twice; 5 ints, 9 floats and K ids a batch service), whichever is
// larger.
static size_t k4_smem(int N, int M, int K) {
  int P = 32;
  while (P < M) P <<= 1;
  const size_t keys = ((size_t)N + (N + 31) / 32) * sizeof(unsigned);
  const size_t commit = (2 * (size_t)P + (size_t)M * (14 + K)) * 4;
  return keys > commit ? keys : commit;
}

FF_EXPORT int ff_k4_greedy(int S, int N, int G, const float* demand,
                           const float* cap, const int* cids, int K,
                           const void* elig, int packed, int stride,
                           const unsigned char* valid, const float* pref,
                           int strategy, const int* order, int M, int rounds,
                           int* assignment, float* load, int* taken,
                           int* scratch, cudaStream_t stream) {
  if (M < 1 || M > K4_MAX_BATCH || N < 1 || N > K4_MAX_NODES || S < 1 ||
      (rounds != 1 && rounds != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Problem p{S, N, G, K, demand, cap, cids, elig, packed, stride, valid, pref,
            strategy};
  // scratch: live, choice, has_ok (M each) | any_live | med (3) | mean
  // (batches × 3)
  Work w{order, M, rounds, assignment, reinterpret_cast<float4*>(load),
         reinterpret_cast<unsigned*>(taken), (N + 31) / 32, scratch,
         scratch + M,
         scratch + 2 * M, scratch + 3 * M,
         reinterpret_cast<float*>(scratch + 3 * M + 1),
         reinterpret_cast<float*>(scratch + 3 * M + 4)};
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const size_t smem = k4_smem(N, M, K);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k4_seed,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k4_seed,
                                                    K4_THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = per_sm * sms < M ? per_sm * sms : M;
  void* args[] = {&p, &w};
  e = cudaLaunchCooperativeKernel((const void*)k4_seed, dim3(grid),
                                  dim3(K4_THREADS), args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#ifdef K4_PHASES
// the (batch-rounds, 8) u64 buffer the phase stamps go to (null: none)
FF_EXPORT int ff_k4_set_phases(void* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_phases, &buf, sizeof(buf)));
}
#endif
