// K5: stage and commit of the active-set sub-solve.
//
// Replaces the host planner's frozen base and the gather and scatter halves
// of fleetflow_tpu/solver/subsolve.py::_subsolve_fn().subsolve (the mini
// anneal between them runs on K1-K3). Two entry points:
//
//   ff_k5_stage   the whole mini problem in one launch, from the resident
//                 padded planes and one small staged plan buffer: the
//                 closure rows (tier, ascending, pad slots carry S), then
//                 the sorted compact conflict ids and coloc ids of the
//                 closure (the staging's ids each compact id stands for).
//                 Slot j < n_sub is closure row min(rows[j], S - 1): its
//                 demand (3 f32), eligibility row (W packed int32 words or
//                 N dense bytes), preference row (N f32, when the plane
//                 exists), current node (the seed, also the mini problem's
//                 sticky_prev) and its conflict/coloc ids remapped into the
//                 compact lists (-1 where absent). Pad slots are inert
//                 phantoms: demand 0, every eligibility bit set,
//                 preference 0, ids -1, seeded on the first valid node.
//                 The frozen base: every real row j < n_real outside the
//                 closure, at its node in the resident assignment, adds to
//                 load0 (N, 3) f32, used0 (N, G_sub) and coloc0 (N, Gc1)
//                 i32 (the compact ids it carries) and topo0 (T,) i32.
//   ff_k5_commit  picks the winning chain, the first index of the least
//                 key where key_c = soft_c if viol_c == min(viol) else
//                 +inf (the reference's lexicographic argmin), and writes
//                 a FRESH output: element i is the winner's slot value
//                 where i is a closure row (rows[j] == i < S), else
//                 assignment[i]. The input is never written: a
//                 gate-rejected sub-solve re-runs the full path from it.
//
// Exactness: load0 adds each node's frozen rows one at a time in ascending
// row order from 0.0, the order of the host planner's np.add.at, so it is
// bit-equal to it; the integer planes are counts, exact in any order.
//
// Bound: bytes. The stage reads the (n_real,) assignment, the slots' rows
// of demand, eligibility, preference and ids, the frozen rows' demand and
// ids, and writes the slot planes and the (N, G_sub) base, which dominates
// (4 MB at N = 1000, tier 1024). The commit reads and writes the (S,)
// assignment. Nothing is computed.
//
// Design: one grid of three roles, 256 threads a block.
//   block 0     finds the first valid node once, seeds the pad slots on
//               it, and counts topo0: the real rows' domains, from the
//               assignment staged in tiles (csrc/node_rows.cuh) and the
//               domains staged in shared memory, minus the closure rows'
//               (gathered 8 a thread at once), with shared-memory atomics
//               (a warp-aggregated add by __match_any_sync measured ~0.3
//               µs a call with every lane's domain distinct).
//   slot blocks a warp a slot: its rows copied with 128-bit accesses where
//               they align; its ids remapped by binary search in the
//               compact lists, staged in shared memory.
//   node blocks a warp a node (8 a block): the warp zeroes its node's rows
//               of used0 and coloc0 and is their only writer, so the
//               counts need neither atomics nor a zeroing launch. The
//               block stages the assignment in 2048-row tiles
//               (node_rows.cuh) and scans each tile ONCE, branch-free, for
//               rows on its 8 nodes that are frozen (real and not in the
//               closure: a bit of the closure's bitmap over the real rows,
//               which each block builds in its own shared memory before
//               the scan), listing them in row order in one block list.
//               Only when the list is full, and at the end, each warp
//               lists its node's rows from it by ballot and gathers them
//               32 at a time, demand and first ids in one round of loads
//               (a node's ~10 rows: one round in all, where adding tile by
//               tile would wait on a round a tile), adds the demand in row
//               order (node_rows.cuh) and counts the compact ids, lanes
//               with the same id merged by __match_any_sync so one lane
//               writes each count.
//
// Built with -DK5_PHASES (fleetflow_tpu_torch/tools/k5_profile.py), thread
// 0 of each stage block stamps its row (csrc/common.cuh): the global timer
// at its start and end, its cycles, its role (0: block 0, 1: slot, 2:
// node) and the cycles at the end of its setup, of its tile scan and of
// its last step (block 0: the closure rows; node blocks: the last flush),
// the cycles it spent staging and waiting for assignment tiles, and those
// of its scan work in them (block 0: the domain counts; node blocks: the
// ballots).
#ifdef K5_PHASES
#define FF_PHASES 1
#endif
#include "common.cuh"
#include "node_rows.cuh"

#ifdef FF_PHASES
#define K5_STAMP_BEGIN                           \
  unsigned long long* ph = ff_phase_row();       \
  const long long clk0 = clock64();              \
  long long waited_cycles = 0, part_cycles = 0;  \
  long long* waited = ph ? &waited_cycles : nullptr; \
  if (ph) ph[0] = ff_globaltimer()
#define K5_MARK(slot) \
  if (ph) ph[slot] = (unsigned long long)(clock64() - clk0)
#define K5_STAMP_END(role)                                    \
  if (ph) {                                                   \
    ph[1] = ff_globaltimer();                                 \
    ph[2] = (unsigned long long)(clock64() - clk0);           \
    ph[3] = role;                                             \
    ph[7] = (unsigned long long)waited_cycles;                \
    ph[8] = (unsigned long long)part_cycles;                  \
  }
#define K5_PART_BEGIN const long long p0 = clock64()
#define K5_PART_END part_cycles += clock64() - p0
#else
#define K5_STAMP_BEGIN long long* waited = nullptr
#define K5_PART_BEGIN
#define K5_PART_END
#define K5_MARK(slot)
#define K5_STAMP_END(role)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // slots or nodes a block
constexpr int kCommitElems = 1024;     // output elements a commit block
constexpr int kTile = 2048;            // assignments a staged tile
constexpr int kStages = 2;             // tiles in flight
constexpr int kBlockList = kTile;      // frozen rows a node block lists
constexpr int kWarpList = 1024;        // a flush lists a warp's rows from
                                       // this many of them at a time
constexpr int kMaxDynSmem = 160 * 1024;

}  // namespace

// the stage's sizes, planes and outputs; filled by the caller, passed by
// pointer to ff_k5_stage (fleetflow_tpu_torch/solver/subsolve.py mirrors it)
struct K5Stage {
  int S, N, W, packed, T, K, C;  // the resident staging: rows (padded),
                                 // nodes, eligibility row width (words or
                                 // bytes), layout, domains, id widths
  int tier, n_sub, n_real, n_conf, n_coloc, G_sub, Gc1, Kc, Cc;
  const int* plan;  // rows (tier) | conflict ids (n_conf) | coloc ids
  const int* assignment;
  const float* demand;
  const void* elig;
  const float* pref;  // null: no preference plane
  const unsigned char* valid;
  const int* cids;
  const int* colids;
  const int* ntopo;
  float* demand_out;
  void* elig_out;
  float* pref_out;
  int* seed_out;
  int* sub_conflict;
  int* sub_coloc;
  float* load0;
  int* used0;
  int* coloc0;
  int* topo0;
};

namespace {

// first index in sorted a[0, n) whose value is >= key (n when none)
__device__ __forceinline__ int lower_bound(const int* a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// the same search by a whole warp (every lane gets the answer): 32 probes
// a round narrow the range 32-fold, so a 4096-entry array takes 3 rounds of
// one load a lane instead of 12 dependent loads
__device__ __forceinline__ int warp_lower_bound(const int* a, int n, int key) {
  const int wl = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (wl + 1) * step - 1;
    const bool less = p < hi && a[p] < key;  // a prefix of the probes
    const int c = __popc(__ballot_sync(0xffffffffu, less));
    hi = min(hi, lo + (c + 1) * step - 1);
    lo = lo + c * step;
  }
  return lo;
}

// copy `bytes` bytes of row `src` to `dst` (or fill with the 32-bit
// pattern `fill` when src is null) by the 32 lanes of a warp: 16-byte
// accesses when both rows align, else 4-byte, else bytes
__device__ __forceinline__ void warp_row(void* dst, const void* src,
                                         size_t bytes, unsigned fill) {
  const int wl = threadIdx.x & 31;
  const uintptr_t al = reinterpret_cast<uintptr_t>(dst) |
                       reinterpret_cast<uintptr_t>(src) | bytes;
  if ((al & 15) == 0) {
    const uint4 f = make_uint4(fill, fill, fill, fill);
    uint4* d = static_cast<uint4*>(dst);
    const uint4* s = static_cast<const uint4*>(src);
    for (size_t i = wl; i < bytes / 16; i += 32) d[i] = s ? s[i] : f;
  } else if ((al & 3) == 0) {
    unsigned* d = static_cast<unsigned*>(dst);
    const unsigned* s = static_cast<const unsigned*>(src);
    for (size_t i = wl; i < bytes / 4; i += 32) d[i] = s ? s[i] : fill;
  } else {
    unsigned char* d = static_cast<unsigned char*>(dst);
    const unsigned char* s = static_cast<const unsigned char*>(src);
    for (size_t i = wl; i < bytes; i += 32)
      d[i] = s ? s[i] : static_cast<unsigned char>(fill);
  }
}

// slot j's ids remapped into the sorted compact list `lst` (n entries):
// the `width` output columns of row j, -1 where absent or padded
__device__ __forceinline__ void remap_ids(const int* ids, int K, int src,
                                          bool real, const int* lst, int n,
                                          int* out, int width) {
  for (int k = threadIdx.x & 31; k < width; k += 32) {
    const int id = real && k < K ? ids[(size_t)src * K + k] : -1;
    out[k] = id >= 0 ? lower_bound(lst, n, id) : -1;
  }
}

// the position of `id` in the sorted list `lst` (n entries), -1 if absent
__device__ __forceinline__ int find_id(const int* lst, int n, int id) {
  if (id < 0) return -1;
  const int p = lower_bound(lst, n, id);
  return p < n && lst[p] == id ? p : -1;
}

// out[g] += the lanes holding g (g < 0: none), merged by
// __match_any_sync so one lane writes each count. Called by all 32 lanes.
__device__ __forceinline__ void count_one(int g, int* out) {
  const unsigned grp = __match_any_sync(0xffffffffu, g);
  if (g >= 0 && (int)(threadIdx.x & 31) == __ffs(grp) - 1)
    out[g] += __popc(grp);
  __syncwarp();
}

// the lanes' rows (row < 0: none) add the compact ids of their K-wide id
// row to `out`, a node's row of a count plane; `pre` holds each lane's
// first 4 ids, loaded with its demand. The warp is the row's only writer,
// so no atomics. Called by all 32 lanes.
__device__ __forceinline__ void count_ids(const int* ids, int K, int row,
                                          const int (&pre)[4],
                                          const int* lst, int n, int* out) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k < K) count_one(find_id(lst, n, pre[k]), out);
  for (int k = 4; k < K; ++k)
    count_one(find_id(lst, n, row >= 0 ? ids[(size_t)row * K + k] : -1),
              out);
}

// the first 4 of row `row`'s K ids (-1 past K, or for row < 0)
__device__ __forceinline__ void first_ids(const int* ids, int K, int row,
                                          int (&pre)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    pre[k] = row >= 0 && k < K ? ids[(size_t)row * K + k] : -1;
}

// a node warp's part of a flush: its rows among the block's listed frozen
// rows (blist, `cnt_b` entries of row * 8 + node offset, in row order),
// listed by ballot kWarpList entries at a time, then gathered 32 at a
// time: each lane's demand and first ids in one round of loads, the demand
// added in row order (csrc/node_rows.cuh), the ids counted into the node's
// rows
__device__ __forceinline__ void flush_node(const K5Stage& a, const int* blist,
                                           int cnt_b, short* list,
                                           const int* sconf,
                                           const int* scol, int* used_row,
                                           int* coloc_row, float& l0,
                                           float& l1, float& l2) {
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w0 = 0; w0 < cnt_b; w0 += kWarpList) {  // windows, in order
    const int w1 = min(cnt_b, w0 + kWarpList);
    int cnt = 0;
    for (int k0 = w0; k0 < w1; k0 += 32) {
      const int k = k0 + wl;
      cnt = ff_list_append(k < w1 && (blist[k] & 7) == warp,
                           (short)(k - w0), list, cnt);
    }
    __syncwarp();
    for (int k0 = 0; k0 < cnt; k0 += 32) {
      int row = -1;
      float e0 = 0.f, e1 = 0.f, e2 = 0.f;
      if (k0 + wl < cnt) {
        row = blist[w0 + list[k0 + wl]] >> 3;
        const float* d = a.demand + (size_t)row * 3;
        e0 = d[0];
        e1 = d[1];
        e2 = d[2];
      }
      int pc[4], pl[4];
      first_ids(a.cids, a.n_conf > 0 ? a.K : 0, row, pc);
      first_ids(a.colids, a.n_coloc > 0 ? a.C : 0, row, pl);
      ff_add_chunk(e0, e1, e2, min(32, cnt - k0), l0, l1, l2);
      if (a.n_conf > 0)
        count_ids(a.cids, a.K, row, pc, sconf, a.n_conf, used_row);
      if (a.n_coloc > 0)
        count_ids(a.colids, a.C, row, pl, scol, a.n_coloc, coloc_row);
    }
    __syncwarp();  // the list is rebuilt for the next window
  }
}

// hist[t] += d (t < 0: none); lanes of one domain meet in the atomics
__device__ __forceinline__ void hist_add(int* hist, int t, int d) {
  if (t >= 0) atomicAdd(&hist[t], d);
}

__global__ void __launch_bounds__(kThreads)
k5_stage_kernel(const K5Stage a, int n_slot_blocks) {
  // slot blocks: conflict ids | coloc ids; node blocks: the closure rows'
  // bitmap over the real rows | conflict ids | coloc ids
  extern __shared__ int dyn[];
  __shared__ int tile[kStages][kTile];
  __shared__ int blist[kBlockList];
  __shared__ __align__(16) short hits[kWarps][kWarpList];
  __shared__ int wcount[kWarps];
  __shared__ int park;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* rows = a.plan;
  const int* conf_g = a.plan + a.tier;
  K5_STAMP_BEGIN;

  if (blockIdx.x == 0) {
    // the first valid node, once a launch: the pad slots' seed
    if (threadIdx.x == 0) park = INT_MAX;
    // the domains and their counts in shared memory when they fit
    int* ntopo = a.N <= kWarps * kWarpList / 2
                     ? reinterpret_cast<int*>(&hits[0][0]) : nullptr;
    int* hist = a.T <= kBlockList ? blist : a.topo0;
    for (int n = threadIdx.x; n < a.N && ntopo; n += blockDim.x)
      ntopo[n] = a.ntopo[n];
    if (ntopo == nullptr) ntopo = const_cast<int*>(a.ntopo);
    for (int t = threadIdx.x; t < a.T; t += blockDim.x) hist[t] = 0;
    __syncthreads();
    for (int n = threadIdx.x; n < a.N; n += blockDim.x)
      if (a.valid[n]) {
        atomicMin(&park, n);
        break;
      }
    // topo0: the real rows' domains from the staged tiles, minus the
    // closure rows' (every closure row is real)
    K5_MARK(4);
    ff_for_tiles<kTile, kStages>(tile, a.assignment, a.n_real,
                                 [&](int t, const int* buf) {
      const int len = min(kTile, a.n_real - t * kTile);
      K5_PART_BEGIN;
      int dom[kTile / kThreads];  // branch-free: the loads overlap
#pragma unroll
      for (int r = 0; r < kTile / kThreads; ++r) {
        const int i = r * kThreads + threadIdx.x;
        const int n = buf[min(i, len - 1)];
        dom[r] = i < len && n >= 0 && n < a.N ? ntopo[min(max(n, 0), a.N - 1)]
                                              : -1;
      }
#pragma unroll
      for (int r = 0; r < kTile / kThreads; ++r) hist_add(hist, dom[r], 1);
      K5_PART_END;
    }, waited);
    K5_MARK(5);
    constexpr int kAhead = 8;  // closure rows a thread loads at once
    for (int j0 = 0; j0 < a.n_sub; j0 += kThreads * kAhead) {
      int v[kAhead];  // a closure row, then its node
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int j = j0 + q * kThreads + threadIdx.x;
        v[q] = j < a.n_sub ? rows[j] : INT_MAX;
      }
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        v[q] = v[q] < a.n_real ? a.assignment[v[q]] : -1;
#pragma unroll
      for (int q = 0; q < kAhead; ++q)
        hist_add(hist, v[q] >= 0 && v[q] < a.N ? ntopo[v[q]] : -1, -1);
    }
    __syncthreads();
    K5_MARK(6);
    const int node0 = park == INT_MAX ? 0 : park;
    for (int j = a.n_sub + threadIdx.x; j < a.tier; j += blockDim.x)
      a.seed_out[j] = node0;
    if (hist != a.topo0)
      for (int t = threadIdx.x; t < a.T; t += blockDim.x) a.topo0[t] = hist[t];
    K5_STAMP_END(0);
    return;
  }

  if ((int)blockIdx.x <= n_slot_blocks) {
    // slot role: a warp a slot
    for (int i = threadIdx.x; i < a.n_conf + a.n_coloc; i += blockDim.x)
      dyn[i] = conf_g[i];
    __syncthreads();
    K5_MARK(4);
    const int j = ((int)blockIdx.x - 1) * kWarps + warp;
    if (j >= a.tier) return;
    const bool real = j < a.n_sub;
    const int src = min(rows[j], a.S - 1);
    if (wl < 3)
      a.demand_out[(size_t)j * 3 + wl] =
          real ? a.demand[(size_t)src * 3 + wl] : 0.f;
    if (wl == 0 && real) a.seed_out[j] = a.assignment[src];
    const size_t eb = (size_t)a.W * (a.packed ? 4 : 1);
    warp_row(static_cast<char*>(a.elig_out) + (size_t)j * eb,
             real ? static_cast<const char*>(a.elig) + (size_t)src * eb
                  : nullptr,
             eb, a.packed ? 0xffffffffu : 0x01010101u);
    if (a.pref != nullptr)
      warp_row(a.pref_out + (size_t)j * a.N,
               real ? a.pref + (size_t)src * a.N : nullptr,
               (size_t)a.N * 4, 0u);
    remap_ids(a.cids, a.K, src, real, dyn, a.n_conf,
              a.sub_conflict + (size_t)j * a.Kc, a.Kc);
    remap_ids(a.colids, a.C, src, real, dyn + a.n_conf, a.n_coloc,
              a.sub_coloc + (size_t)j * a.Cc, a.Cc);
    K5_STAMP_END(1);
    return;
  }

  // node role: a warp a node, the frozen rows of 8 nodes a block
  const int n_words = (a.n_real + 31) / 32;
  unsigned* closure = reinterpret_cast<unsigned*>(dyn);
  int* sconf = dyn + n_words;
  int* scol = sconf + a.n_conf;
  const int n0 = ((int)blockIdx.x - 1 - n_slot_blocks) * kWarps;
  const int n = n0 + warp;
  const int n_hi = min(n0 + kWarps, a.N);
  int* used_row = a.used0 + (size_t)n * a.G_sub;
  int* coloc_row = a.coloc0 + (size_t)n * a.Gc1;
  const unsigned lower = (1u << wl) - 1u;
  float l0 = 0.f, l1 = 0.f, l2 = 0.f;
  int cnt_b = 0;  // the block's listed frozen rows
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) closure[i] = 0u;
  for (int i = threadIdx.x; i < a.n_conf + a.n_coloc; i += blockDim.x)
    sconf[i] = conf_g[i];
  if (n < a.N) {
    for (int g = wl; g < a.G_sub; g += 32) used_row[g] = 0;
    for (int g = wl; g < a.Gc1; g += 32) coloc_row[g] = 0;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < a.n_sub; j += blockDim.x) {
    const int r = rows[j];
    if (r < a.n_real) atomicOr(&closure[r >> 5], 1u << (r & 31));
  }
  K5_MARK(4);
  ff_for_tiles<kTile, kStages>(tile, a.assignment, a.n_real,
                               [&](int t, const int* buf) {
    const int base = t * kTile;
    const int len = min(kTile, a.n_real - base);
    // the block's one scan of the tile: warp w takes kTile / 8 entries,
    // its frozen rows on the block's nodes listed in row order
    constexpr int kSpan = kTile / kWarps;
    unsigned m[kSpan / 32];
    int mine = 0;
    K5_PART_BEGIN;
#pragma unroll
    for (int r = 0; r < kSpan / 32; ++r) {  // branch-free: the loads overlap
      const int i = min(warp * kSpan + r * 32 + wl, len - 1);
      const int v = buf[i], row = base + i;
      const unsigned in = closure[row >> 5] >> (row & 31);
      const bool hit = warp * kSpan + r * 32 + wl < len && v >= n0 &&
                       v < n_hi && !(in & 1u);
      m[r] = __ballot_sync(0xffffffffu, hit);
      mine += __popc(m[r]);
    }
    K5_PART_END;
    if (wl == 0) wcount[warp] = mine;
    __syncthreads();
    int c = wl < kWarps ? wcount[wl] : 0;  // a scan of the warps' counts
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, o);
      if (wl >= o) c += y;
    }
    const int total = __shfl_sync(0xffffffffu, c, kWarps - 1);
    int off = __shfl_sync(0xffffffffu, c, warp > 0 ? warp - 1 : 0);
    if (warp == 0) off = 0;
    if (cnt_b + total > kBlockList) {  // full: add what is listed first
      flush_node(a, blist, cnt_b, hits[warp], sconf, scol, used_row,
                 coloc_row, l0, l1, l2);
      __syncthreads();
      cnt_b = 0;
    }
    off += cnt_b;
#pragma unroll
    for (int r = 0; r < kSpan / 32; ++r) {
      const int i = warp * kSpan + r * 32 + wl;
      if ((m[r] >> wl) & 1u)
        blist[off + __popc(m[r] & lower)] = (base + i) * 8 + (buf[i] - n0);
      off += __popc(m[r]);
    }
    cnt_b += total;
  }, waited);
  K5_MARK(5);
  flush_node(a, blist, cnt_b, hits[warp], sconf, scol, used_row, coloc_row,
             l0, l1, l2);
  K5_MARK(6);
  if (n < a.N && wl == 0) {
    a.load0[(size_t)n * 3 + 0] = l0;
    a.load0[(size_t)n * 3 + 1] = l1;
    a.load0[(size_t)n * 3 + 2] = l2;
  }
  K5_STAMP_END(2);
}

__global__ void __launch_bounds__(kThreads)
k5_commit_kernel(int C, int tier, int S, const int* __restrict__ best_assign,
                 const float* __restrict__ best_viol,
                 const float* __restrict__ best_soft,
                 const int* __restrict__ rows,
                 const int* __restrict__ assignment, int* out,
                 int* best_out) {
  __shared__ int vals[kCommitElems];
  __shared__ int range[3];  // winning chain, first and end slot
  const int i0 = blockIdx.x * kCommitElems;
  const int len = min(kCommitElems, S - i0);
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    const int lo = warp_lower_bound(rows, tier, i0);
    if ((threadIdx.x & 31) == 0) range[1] = lo;
  } else if (warp == 1) {
    const int hi = warp_lower_bound(rows, tier, i0 + len);
    if ((threadIdx.x & 31) == 0) range[2] = hi;
  } else if (threadIdx.x == 64) {
    float min_viol = best_viol[0];
    for (int c = 1; c < C; ++c) min_viol = fminf(min_viol, best_viol[c]);
    int best = 0;
    float best_key = best_viol[0] == min_viol ? best_soft[0] : CUDART_INF_F;
    for (int c = 1; c < C; ++c) {
      const float key = best_viol[c] == min_viol ? best_soft[c] : CUDART_INF_F;
      if (key < best_key) {
        best_key = key;
        best = c;
      }
    }
    range[0] = best;
    if (blockIdx.x == 0) best_out[0] = best;
  }
  for (int i = threadIdx.x; i < len; i += blockDim.x) vals[i] = assignment[i0 + i];
  __syncthreads();
  const int* win = best_assign + (size_t)range[0] * tier;
  for (int j = range[1] + threadIdx.x; j < range[2]; j += blockDim.x)
    vals[rows[j] - i0] = win[j];
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) out[i0 + i] = vals[i];
}

}  // namespace

FF_EXPORT long long ff_k5_stage_size() { return sizeof(K5Stage); }

// once a process and device: allow the stage's dynamic shared memory
FF_EXPORT int ff_k5_bind() {
  cudaFuncSetAttribute(k5_stage_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMaxDynSmem);
  return static_cast<int>(cudaGetLastError());
}

FF_EXPORT int ff_k5_stage(const K5Stage* args, cudaStream_t stream) {
  const K5Stage& a = *args;
  const size_t smem =
      (size_t)((a.n_real + 31) / 32 + a.n_conf + a.n_coloc) * sizeof(int);
  if (smem > (size_t)kMaxDynSmem || a.tier < 1 || a.n_sub > a.tier)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slot = (a.tier + kWarps - 1) / kWarps;
  const int n_node = (a.N + kWarps - 1) / kWarps;
  k5_stage_kernel<<<1 + n_slot + n_node, kThreads, smem, stream>>>(a, n_slot);
  return static_cast<int>(cudaGetLastError());
}

FF_EXPORT int ff_k5_commit(int C, int tier, int S, const int* best_assign,
                           const float* best_viol, const float* best_soft,
                           const int* rows, const int* assignment, int* out,
                           int* best_out, cudaStream_t stream) {
  const int blocks = (S + kCommitElems - 1) / kCommitElems;
  k5_commit_kernel<<<blocks > 0 ? blocks : 1, kThreads, 0, stream>>>(
      C, tier, S, best_assign, best_viol, best_soft, rows, assignment, out,
      best_out);
  return static_cast<int>(cudaGetLastError());
}
