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
// as the reference masks it. With best_effort 0 (the reference's
// greedy_place(best_effort=False)) a service with no ok node goes to node
// 0, the first argmax of an all -1e30 row, with no second pass. The
// winner's load, occupancy and assignment are committed before the next
// service is scored.
//
// Bound: latency. The S steps are strictly sequential, each a few
// operations a node; the function's roofline is its operation count (~30
// f32 operations a node a step), its inputs read once. A step's time is
// the chain of latencies between one commit and the next, and, with a
// thread a node, the instructions every warp issues in it (the three IEEE
// divisions of the utilisation are most of them), so the design takes
// every load and every barrier it can off that chain. One persistent
// block runs the whole scan:
//   - owned nodes: thread t owns the nodes n ≡ t (mod blockDim) and alone
//     reads and writes their state. With N ≤ 1,024 a node's load, capacity
//     and validity live in its owner's registers; with more nodes (one
//     block of 1,024 threads owning several each) the load sits in a
//     global (N, 4) array that only its owner touches (L1-resident);
//   - owner-only occupancy: the scan needs of the occupancy only whether a
//     node holds one of the service's ids, so it keeps a bitmap of
//     "count > 0" in the transposed layout (G/32 words, N): a warp's 32
//     nodes read 32 neighbouring words. It sits in shared memory when
//     G·N/8 bytes fit (104 KB at 10k×1k), else in global memory. The exact
//     counts that only the best-effort score reads stay in a global (G, N)
//     plane, valid where the node's bit is set (set to 1 with the bit, so
//     the plane needs no clearing); they are read only in a step with no
//     ok node. No thread reads another node's state, so a commit needs no
//     atomic and no barrier to be seen;
//   - rows staged ahead: warp 0 loads each service's demand and conflict
//     ids into its registers one step before it stores them into a ring
//     of shared-memory rows, four steps ahead of their step, with each
//     id's bitmap word offset and bit worked out once, and `order` eight
//     steps ahead, so the order -> service -> row chain is off the
//     critical path; each thread loads its node's eligibility word and
//     preference of the next step one step ahead, into registers;
//   - one barrier a step: each warp reduces its (score key, node) pairs
//     with redux.sync and a ballot (the larger key, then the lower node:
//     the first argmax) into a double-buffered shared slot, with a bit
//     saying whether any of its nodes was ok; one __syncthreads publishes
//     them, and every warp then reduces the 32 slots itself, so all
//     threads know the winner and its owner commits it. A step with no ok
//     node takes a second pass and barrier for the best-effort argmax
//     (none in strict mode: every node's key is then that of -1e30, and
//     the first argmax is already node 0). The
//     score keys order the floats as a float compare does (-0 equals +0),
//     so ties go to the lower node whatever the order of the reduction.
//
// Built with -DK6_PHASES (fleetflow_tpu_torch/tools/k67_profile.py), thread
// 0 stamps its cycles a step: the row fetch, the score, the reduce and the
// commit, summed over the steps (common.cuh's slots 3-6; 7 the steps, 8 N),
// and the fetch's parts: the row's read, the wait for the eligibility word
// and preference, warp 0's staging (slots 9-11).
#ifdef K6_PHASES
#define FF_PHASES 1
#endif
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kAhead = 4;         // service rows staged this many steps ahead
constexpr int kRing = 8;          // row slots (>= kAhead + 2, a power of two)
constexpr int kOrderAhead = 8;    // order entries staged this far ahead
constexpr int kOrderRing = 16;
constexpr int kPend = 4;          // raw row elements a lane of warp 0 keeps
                                  // in flight (rows of 3 + K <= 128)
constexpr int kFastK = 4;         // conflict ids tested with their loads
                                  // issued together
constexpr float kNeg = -1e30f;
// the dynamic shared memory a block may take (227 KB on the H100)
constexpr size_t kMaxShared = 232448 - 2048;

struct Scan {
  int S, N, G, K, Gw;
  const float* demand;
  const float* cap;
  const int* cids;
  const void* elig;
  int packed, stride;
  const unsigned char* valid;
  const float* pref;
  int strategy;
  int best_effort;   // 0: a service with no ok node goes to node 0
  const int* order;
  int n_order;
  int* assignment;
  int* counts;       // (G, N) exact occupancy where the node's bit is set
  unsigned* gbits;   // (Gw, N) bitmap when it does not fit on chip
  float4* gload;     // (N,) running load when a thread owns several nodes
};

// element e of service s's raw row: its demand (e < 3), then its K
// conflict ids
__device__ __forceinline__ int row_raw(const Scan& p, int s, int e) {
  return e < 3 ? __float_as_int(p.demand[(size_t)s * 3 + e])
               : p.cids[(size_t)s * p.K + e - 3];
}

// put raw element e into a ring row (3 + 3K ints: the demand, the ids,
// each id's bitmap word offset (id / 32)·N and its bit; 0 and 0 for an
// invalid id, which then tests word n against an empty mask)
__device__ __forceinline__ void row_put(const Scan& p, int* row, int e,
                                        int v) {
  row[e] = v;
  if (e >= 3) {
    const int k = e - 3;
    row[3 + p.K + k] = v >= 0 ? (v >> 5) * p.N : 0;
    row[3 + 2 * p.K + k] = v >= 0 ? static_cast<int>(1u << (v & 31)) : 0;
  }
}

// an unsigned key that orders the floats as a float compare does: a larger
// float, a larger key; -0 and +0 one key; NaN below every number (it never
// wins). Key 0 is below every float: a thread without a node.
__device__ __forceinline__ unsigned score_key(float v) {
  if (v != v) return 1u;
  if (v == 0.f) v = 0.f;
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The warp's best (key, node), on every lane: the largest key, the lowest
// node among its equals. kOrdered: lane l holds the warp's l-th node (one
// node a thread), so the lowest lane holding the largest key has the
// lowest node; else a second reduction finds it.
template <bool kOrdered>
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& node) {
  const unsigned m = __reduce_max_sync(0xffffffffu, key);
  if (kOrdered) {
    const int src = __ffs(__ballot_sync(0xffffffffu, key == m)) - 1;
    node = __shfl_sync(0xffffffffu, node, src);
  } else {
    node = __reduce_min_sync(0xffffffffu, key == m ? node : 0xffffffffu);
  }
  key = m;
}

// A warp's slot: its best key, and its best node with bit 31 set when one
// of its nodes was ok.
__device__ __forceinline__ uint2 warp_slot(unsigned key, unsigned node,
                                           bool any_ok) {
  const unsigned ok_bit = __any_sync(0xffffffffu, any_ok) ? 0x80000000u : 0u;
  return make_uint2(key, (node & 0x7fffffffu) | ok_bit);
}

// The block's best node from the warps' slots, known to every thread;
// `any` says whether any warp had an ok node. With one node a thread the
// warps hold ascending node ranges, so the slots are ordered too.
template <bool kOrdered>
__device__ __forceinline__ unsigned block_best(const uint2* slot, bool& any) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const uint2 v = lane < nw ? slot[lane] : make_uint2(0u, 0xffffffffu);
  any = __any_sync(0xffffffffu, lane < nw && (v.y >> 31) != 0u);
  unsigned key = v.x, node = lane < nw ? (v.y & 0x7fffffffu) : 0xffffffffu;
  warp_best<kOrdered>(key, node);
  return node;
}

__device__ __forceinline__ int elig_word(const Scan& p, int s, int n) {
  if (p.packed)
    return static_cast<const int*>(p.elig)[(size_t)s * p.stride + (n >> 5)];
  return static_cast<const unsigned char*>(p.elig)[(size_t)s * p.stride + n];
}

__device__ __forceinline__ bool elig_bit(const Scan& p, int word, int n) {
  return p.packed ? ((word >> (n & 31)) & 1) != 0 : word != 0;
}

// whether node n holds one of the valid ids of `row`
__device__ __forceinline__ bool conflicted(const Scan& p, const unsigned* bits,
                                           const int* row, int n) {
  const int* offs = row + 3 + p.K;
  const int* masks = offs + p.K;
  unsigned hit = 0u;
#pragma unroll
  for (int k = 0; k < kFastK; ++k)
    if (k < p.K) hit |= bits[offs[k] + n] & static_cast<unsigned>(masks[k]);
  for (int k = kFastK; k < p.K; ++k)
    hit |= bits[offs[k] + n] & static_cast<unsigned>(masks[k]);
  return hit != 0u;
}

// Σ_k used[n, ids_k] over the valid ids (a count is valid where its bit is)
__device__ __forceinline__ int conflict_count(const Scan& p,
                                              const unsigned* bits,
                                              const int* row, int n) {
  const int* ids = row + 3;
  const int* offs = ids + p.K;
  const int* masks = offs + p.K;
  int c = 0;
  for (int k = 0; k < p.K; ++k)
    if (bits[offs[k] + n] & static_cast<unsigned>(masks[k]))
      c += __ldcg(&p.counts[(size_t)ids[k] * p.N + n]);
  return c;
}

// the score and ok of one node, in the reference's float32 expressions
struct NodeEval {
  float n0, n1, n2, score;
  bool el, fits;
};

__device__ __forceinline__ NodeEval eval_node(const Scan& p, int n, float l0,
                                              float l1, float l2, float c0,
                                              float c1, float c2, bool el,
                                              float pf, float d0, float d1,
                                              float d2) {
  NodeEval e;
  e.n0 = l0 + d0;
  e.n1 = l1 + d1;
  e.n2 = l2 + d2;
  e.fits = (e.n0 <= c0 + 1e-6f) && (e.n1 <= c1 + 1e-6f) &&
           (e.n2 <= c2 + 1e-6f);
  e.el = el;
  const float u0 = e.n0 / fmaxf(c0, 1e-6f);
  const float u1 = e.n1 / fmaxf(c1, 1e-6f);
  const float u2 = e.n2 / fmaxf(c2, 1e-6f);
  const float usq = (u0 * u0 + u1 * u1) + u2 * u2;
  float score = p.strategy == 0 ? -usq : (p.strategy == 1 ? usq : -(float)n);
  if (p.pref != nullptr) score = score + pf * 0.5f;
  e.score = score;
  return e;
}

// the best-effort score of an evaluated node with n_conf conflicts
__device__ __forceinline__ float fallback_score(const NodeEval& e, float c0,
                                                float c1, float c2,
                                                int n_conf) {
  const float over = (fmaxf(e.n0 - c0, 0.f) + fmaxf(e.n1 - c1, 0.f)) +
                     fmaxf(e.n2 - c2, 0.f);
  float fb = -(over * 1e3f + (float)n_conf * 1e3f) + e.score;
  if (!e.el) fb = fb - 1e15f;
  return fb;
}

// the owner's commit of the row's ids on node w: the bit set and the
// count at 1 the first time, the count raised after
__device__ __forceinline__ void commit_ids(const Scan& p, unsigned* bits,
                                           const int* row, int w) {
  const int* ids = row + 3;
  for (int k = 0; k < p.K; ++k) {
    const int id = ids[k];
    if (id < 0) continue;
    unsigned* word = bits + ids[p.K + k] + w;
    const unsigned bit = static_cast<unsigned>(ids[2 * p.K + k]);
    int* count = p.counts + (size_t)id * p.N + w;
    const unsigned cur = *word;
    if (cur & bit) {
      atomicAdd(count, 1);  // no return value: the owner does not wait
    } else {
      *word = cur | bit;
      *count = 1;
    }
  }
}

// kOne: N <= blockDim, thread t owns node t, its load, capacity and
// validity in registers; else thread t walks its nodes n = t, t +
// blockDim, ... with the load in p.gload. kSharedBits: the occupancy
// bitmap in shared memory, else in p.gbits.
template <bool kOne, bool kSharedBits>
__global__ void __launch_bounds__(kThreads, 1) k6_scan(Scan p) {
  extern __shared__ int dyn[];
  __shared__ uint2 slots[2][32];   // the warps' best, double-buffered
  __shared__ uint2 fb_slots[32];   // the warps' best-effort best
  __shared__ int oring[kOrderRing];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // a ring row: the demand (3 floats), the K ids, their word offsets and
  // bits (row_put); the raw part (3 + K) is what warp 0 loads
  const int B = blockDim.x, N = p.N, K = p.K, RS = 3 + 3 * K, RR = 3 + K;
  int* ring = dyn;
  unsigned* bits = kSharedBits
                       ? reinterpret_cast<unsigned*>(dyn + kRing * RS)
                       : p.gbits;

  // every service not in `order` stays unplaced; owned state at zero
  for (int x = t; x < p.S; x += B) p.assignment[x] = -1;
  for (int n = t; n < N; n += B) {
    for (int w = 0; w < p.Gw; ++w) bits[(size_t)w * N + n] = 0u;
    if (!kOne) p.gload[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the first rows before the pipeline takes over, and the loads of the
  // next row and order entry in flight (warp 0's registers)
  int pend[kPend], ord_pend = 0;
  if (warp == 0) {
    for (int j = lane; j < kOrderAhead && j < p.n_order; j += 32)
      oring[j] = p.order[j];
    for (int j = 0; j < kAhead && j < p.n_order; ++j) {
      const int s = p.order[j];
      for (int e = lane; e < RR; e += 32) row_put(p, ring + j * RS, e, row_raw(p, s, e));
    }
#pragma unroll
    for (int q = 0; q < kPend; ++q)
      pend[q] = kAhead < p.n_order && lane + 32 * q < RR
                    ? row_raw(p, p.order[kAhead], lane + 32 * q)
                    : 0;
    if (kOrderAhead < p.n_order) ord_pend = p.order[kOrderAhead];
  }
  const bool mine = kOne && t < N;
  float l0 = 0.f, l1 = 0.f, l2 = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  bool vld = false;
  if (mine) {
    c0 = p.cap[(size_t)t * 3 + 0];
    c1 = p.cap[(size_t)t * 3 + 1];
    c2 = p.cap[(size_t)t * 3 + 2];
    vld = p.valid[t] != 0;
  }
  __syncthreads();
  // the next step's eligibility word and preference (kOne), in flight
  int el_next = 0;
  float pf_next = 0.f;
  if (mine && p.n_order > 0) {
    el_next = elig_word(p, oring[0], t);
    if (p.pref != nullptr) pf_next = p.pref[(size_t)oring[0] * N + t];
  }
#ifdef FF_PHASES
  unsigned long long* ph = ff_phase_row();
  const long long clk0 = clock64();
  long long c_fetch = 0, c_score = 0, c_reduce = 0, c_commit = 0;
  long long c_rows = 0, c_elig = 0, c_stage = 0;
  if (ph) ph[0] = ff_globaltimer();
#endif

  for (int i = 0; i < p.n_order; ++i) {
#ifdef FF_PHASES
    const long long t_a = clock64();
#endif
    const int s = oring[i & (kOrderRing - 1)];
    const int* row = ring + (i & (kRing - 1)) * RS;
    const float d0 = __int_as_float(row[0]);
    const float d1 = __int_as_float(row[1]);
    const float d2 = __int_as_float(row[2]);
#ifdef FF_PHASES
    asm volatile("" ::"f"(d0), "f"(d1), "f"(d2));
    const long long t_r = clock64();
    c_rows += t_r - t_a;
#endif
    const int el_word = el_next;
    const float pf = pf_next;
#ifdef FF_PHASES
    asm volatile("" ::"r"(el_word), "f"(pf));
    const long long t_e = clock64();
    c_elig += t_e - t_r;
#endif
    if (mine && i + 1 < p.n_order) {
      const int s1 = oring[(i + 1) & (kOrderRing - 1)];
      el_next = elig_word(p, s1, t);
      if (p.pref != nullptr) pf_next = p.pref[(size_t)s1 * N + t];
    }
    // warp 0 stores step i + kAhead's row and order entry i + kOrderAhead,
    // loaded one step ago, and loads the next ones: a load has a whole
    // step to land, and a row is stored four steps before its step
    if (warp == 0) {
      const int js = i + kAhead, jl = js + 1, jo = i + kOrderAhead;
      if (RR <= 32) {  // one element a lane: the rows of up to 29 ids
        if (js < p.n_order && lane < RR)
          row_put(p, ring + (js & (kRing - 1)) * RS, lane, pend[0]);
        if (jl < p.n_order && lane < RR)
          pend[0] = row_raw(p, oring[jl & (kOrderRing - 1)], lane);
      } else {
        if (js < p.n_order) {
          int* dst = ring + (js & (kRing - 1)) * RS;
#pragma unroll
          for (int q = 0; q < kPend; ++q)
            if (lane + 32 * q < RR) row_put(p, dst, lane + 32 * q, pend[q]);
          for (int e = lane + 32 * kPend; e < RR; e += 32)
            row_put(p, dst, e, row_raw(p, oring[js & (kOrderRing - 1)], e));
        }
        if (jl < p.n_order) {
          const int sl = oring[jl & (kOrderRing - 1)];
#pragma unroll
          for (int q = 0; q < kPend; ++q)
            if (lane + 32 * q < RR) pend[q] = row_raw(p, sl, lane + 32 * q);
        }
      }
      if (lane == 0) {
        if (jo < p.n_order) oring[jo & (kOrderRing - 1)] = ord_pend;
        if (jo + 1 < p.n_order) ord_pend = p.order[jo + 1];
      }
    }
#ifdef FF_PHASES
    const long long t_b = clock64();
    c_stage += t_b - t_e;
    c_fetch += t_b - t_a;
#endif

    // the thread's best (key, node); n rises, so an equal key keeps the
    // lower node
    unsigned key = 0u, node = 0xffffffffu;
    bool any_ok = false;
    if (kOne) {
      if (mine) {
        const NodeEval e = eval_node(p, t, l0, l1, l2, c0, c1, c2,
                                     elig_bit(p, el_word, t) && vld, pf, d0,
                                     d1, d2);
        any_ok = e.fits & e.el & !conflicted(p, bits, row, t);
        key = score_key(any_ok ? e.score : kNeg);
        node = t;
      }
    } else {
      for (int n = t; n < N; n += B) {
        const float4 L = p.gload[n];
        const bool el = elig_bit(p, elig_word(p, s, n), n) && p.valid[n];
        const float pfn = p.pref != nullptr ? p.pref[(size_t)s * N + n] : 0.f;
        const NodeEval e = eval_node(
            p, n, L.x, L.y, L.z, p.cap[(size_t)n * 3], p.cap[(size_t)n * 3 + 1],
            p.cap[(size_t)n * 3 + 2], el, pfn, d0, d1, d2);
        const bool ok = e.fits & e.el & !conflicted(p, bits, row, n);
        const unsigned k = score_key(ok ? e.score : kNeg);
        if (k > key) {
          key = k;
          node = n;
        }
        any_ok |= ok;
      }
    }
#ifdef FF_PHASES
    asm volatile("" ::"r"(key), "r"(node));
    const long long t_c = clock64();
    c_score += t_c - t_b;
#endif
    warp_best<kOne>(key, node);
    const uint2 mine_slot = warp_slot(key, node, any_ok);
    if (lane == 0) slots[i & 1][warp] = mine_slot;
    __syncthreads();
    bool feasible;
    int w = static_cast<int>(block_best<kOne>(slots[i & 1], feasible));
    // the flag and `feasible` are the same in every thread: the barrier
    // below is taken by all or by none
    if (!feasible && p.best_effort) {
      // no ok node anywhere: the first argmax of the best-effort score
      key = 0u;
      node = 0xffffffffu;
      if (kOne) {
        if (mine) {
          const NodeEval e = eval_node(p, t, l0, l1, l2, c0, c1, c2,
                                       elig_bit(p, el_word, t) && vld, pf, d0,
                                       d1, d2);
          key = score_key(fallback_score(e, c0, c1, c2,
                                         conflict_count(p, bits, row, t)));
          node = t;
        }
      } else {
        for (int n = t; n < N; n += B) {
          const float4 L = p.gload[n];
          const float cn0 = p.cap[(size_t)n * 3], cn1 = p.cap[(size_t)n * 3 + 1],
                      cn2 = p.cap[(size_t)n * 3 + 2];
          const bool el = elig_bit(p, elig_word(p, s, n), n) && p.valid[n];
          const float pfn =
              p.pref != nullptr ? p.pref[(size_t)s * N + n] : 0.f;
          const NodeEval e = eval_node(p, n, L.x, L.y, L.z, cn0, cn1, cn2, el,
                                       pfn, d0, d1, d2);
          const unsigned k = score_key(fallback_score(
              e, cn0, cn1, cn2, conflict_count(p, bits, row, n)));
          if (k > key) {
            key = k;
            node = n;
          }
        }
      }
      warp_best<kOne>(key, node);
      const uint2 fb_slot = warp_slot(key, node, false);
      if (lane == 0) fb_slots[warp] = fb_slot;
      __syncthreads();
      bool unused;
      w = static_cast<int>(block_best<kOne>(fb_slots, unused));
    }
#ifdef FF_PHASES
    asm volatile("" ::"r"(w));
    const long long t_d = clock64();
    c_reduce += t_d - t_c;
#endif
    // the owner commits: its registers (or its load row), its bits and
    // counts, the assignment
    if (kOne ? w == t : w - (w / B) * B == t) {
      if (kOne) {
        l0 = l0 + d0;
        l1 = l1 + d1;
        l2 = l2 + d2;
      } else {
        float4 L = p.gload[w];
        L.x = L.x + d0;
        L.y = L.y + d1;
        L.z = L.z + d2;
        p.gload[w] = L;
      }
      commit_ids(p, bits, row, w);
      p.assignment[s] = w;
    }
#ifdef FF_PHASES
    c_commit += clock64() - t_d;
#endif
  }
#ifdef FF_PHASES
  if (ph) {
    const long long clk1 = clock64();
    ph[1] = ff_globaltimer();
    ph[2] = clk1 - clk0;
    ph[3] = c_fetch;
    ph[4] = c_score;
    ph[5] = c_reduce;
    ph[6] = c_commit;
    ph[7] = p.n_order;
    ph[8] = N;
    ph[9] = c_rows;
    ph[10] = c_elig;
    ph[11] = c_stage;
  }
#endif
}

struct Layout {
  bool one, shared_bits;
  int threads, Gw;
  size_t smem, counts_ints, bits_ints, scratch_ints;
};

// a region of the scratch, rounded up to 16 bytes (the load is float4)
size_t ints16(size_t n) { return (n + 3) / 4 * 4; }

Layout layout_of(int N, int G, int K) {
  Layout l;
  l.one = N <= kThreads;
  l.threads = l.one ? ((N + 31) / 32) * 32 : kThreads;
  l.Gw = (G + 31) / 32;
  const size_t ring = (size_t)kRing * (3 + 3 * (size_t)K) * sizeof(int);
  const size_t bits = (size_t)l.Gw * N * sizeof(unsigned);
  l.shared_bits = ring + bits <= kMaxShared;
  l.smem = ring + (l.shared_bits ? bits : 0);
  // counts (G, N), then the bitmap (Gw, N) when it is not on chip, then
  // the load (N, 4) when it is not in registers
  l.counts_ints = ints16((size_t)G * N);
  l.bits_ints = l.shared_bits ? 0 : ints16((size_t)l.Gw * N);
  l.scratch_ints = l.counts_ints + l.bits_ints + (l.one ? 0 : (size_t)4 * N);
  return l;
}

template <bool kOne, bool kSharedBits>
cudaError_t launch_scan(const Scan& p, const Layout& l, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(&k6_scan<kOne, kSharedBits>);
  if (l.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (e != cudaSuccess) return e;
  }
  k6_scan<kOne, kSharedBits><<<1, l.threads, l.smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// the int32 scratch K6 needs at (N, G, K): the wrapper allocates it
FF_EXPORT long long ff_k6_scratch_ints(int N, int G, int K) {
  return static_cast<long long>(layout_of(N, G, K).scratch_ints);
}

// `scratch` holds ff_k6_scratch_ints(N, G, K) ints; nothing in it needs
// clearing
FF_EXPORT int ff_k6_greedy_scan(int S, int N, int G, const float* demand,
                                const float* cap, const int* cids, int K,
                                const void* elig, int packed, int stride,
                                const unsigned char* valid, const float* pref,
                                int strategy, int best_effort,
                                const int* order, int n_order,
                                int* assignment, int* scratch,
                                cudaStream_t stream) {
  if (N < 1 || G < 0 || K < 0 || n_order < 0 || n_order > S)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout_of(N, G, K);
  int* bits = scratch + l.counts_ints;
  Scan p{S, N, G, K, l.Gw, demand, cap, cids, elig, packed, stride, valid,
         pref, strategy, best_effort, order, n_order, assignment, scratch,
         l.shared_bits ? nullptr : reinterpret_cast<unsigned*>(bits),
         l.one ? nullptr : reinterpret_cast<float4*>(bits + l.bits_ints)};
  cudaError_t e;
  if (l.one)
    e = l.shared_bits ? launch_scan<true, true>(p, l, stream)
                      : launch_scan<true, false>(p, l, stream);
  else
    e = l.shared_bits ? launch_scan<false, true>(p, l, stream)
                      : launch_scan<false, false>(p, l, stream);
  return static_cast<int>(e);
}
