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
// leading axis, one chain each, the state (L, 1, ...). One block per lane
// (grid L) runs the solo loop on its lane's planes, so a lane equals a solo
// pre-repair; the moves come back as (L,).
//
// Bound: latency. The iterations are strictly sequential (each reads the
// state the last one left), and one reads a few KB: the card's bandwidth
// and ALUs idle, and an iteration costs its chain of latencies and
// barriers. A barrier waits for the loads its threads have in flight (an
// L2 round trip), so the loop keeps loads away from its barrier. Design:
//   - 512 threads build the list of stranded services and stage their
//     demand, ids, the ids each shares with the next, and eligibility rows,
//     and the node state (load, capacity x FF_CAP_TOL, max(capacity, 1e-6),
//     utilization, topology domain, validity), in shared memory; then the
//     loop runs on at most 8 warps (a named barrier), the rest exit;
//   - each loop thread OWNS J consecutive nodes (J a power of two up to 8,
//     a template argument): only the owner reads or writes a node's state
//     during the loop, so a move's update needs no barrier before the next
//     score, and a move recomputes the state at its two nodes only;
//   - one barrier an iteration: warp argmins meet in shared memory
//     (double-buffered by iteration parity) and every warp reduces the warp
//     results itself;
//   - after that barrier, each thread loads the next service's conflict
//     column at its nodes (the occupancy of its ids, at L2) while the
//     owners of the move's two nodes commit it, and sums it before the next
//     score. The loads precede the commit's atomics in program order, so
//     they miss exactly the current move, which the owners patch by the two
//     services' shared ids.
// Beyond 2,048 nodes, with more than 4 conflict ids a service, or where
// the planes do not all fit the 227 KB of shared memory, 1,024 threads
// each walk their nodes (n = tid, tid + 1024, ...) and read the conflict
// columns as they score them (J = 0); a plane that does not fit (the
// staged eligibility rows first, then the node state) lives in a global
// scratch, and the same code reads it there.
#ifdef K2_PHASES
#define FF_PHASES 1
#endif
#include "common.cuh"

namespace {

constexpr int kPrefetchIds = 4;          // conflict ids held in registers
constexpr int kMaxJ = 8;                 // nodes a loop thread owns
constexpr int kPipeThreads = 512;        // the block, J > 0
constexpr int kLoopThreads = 256;        // ... of which at most this loop
constexpr int kWalkThreads = 1024;       // the block and the loop, J = 0
constexpr int kStatePad = 256;           // >= J * loop threads - N
constexpr size_t kSmemBudget = 230400;   // of the 232,448 a block may use

struct K2Args {
  int S, N, G, Gc1, T, K, Kc, packed, stride, max_moves;
  const float* demand;
  const float* cap;
  const int* cids;
  const int* colids;
  const void* elig;
  const unsigned char* valid;
  const int* ntopo;
  int* asg;
  float* ld;
  int* us;
  int* co;
  int* tp;
  int* moves_out;
  int* scratch;  // (L, k2_scratch_ints) of int
  int meta_smem, state_smem, elig_smem;  // 1: that plane lives in shared memory
  int loop_threads;
};

// per listed service: s, its node, demand (3, float bits), K ids, Kc ids,
// and the ids it shares with the next listed service
__host__ __device__ inline int meta_stride(int K, int Kc) { return 6 + K + Kc; }
__host__ __device__ inline int list_cap(int S, int max_moves) {
  const int m = S < max_moves ? S : max_moves;
  return m < 1 ? 1 : m;
}
__host__ __device__ inline size_t meta_ints(const K2Args& a) {
  return (size_t)list_cap(a.S, a.max_moves) * meta_stride(a.K, a.Kc);
}
// the node state by slot: load (3), capacity x tolerance (3),
// max(capacity, 1e-6) (3), utilization, topology domain (int bits) as
// planes of P = N + kStatePad slots, then validity as P bytes
constexpr int kStatePlanes = 11;
__host__ __device__ inline int state_slots(int N) { return N + kStatePad; }
__host__ __device__ inline size_t state_ints(int N) {
  return kStatePlanes * (size_t)state_slots(N) + (state_slots(N) + 3) / 4;
}
__host__ __device__ inline size_t elig_ints(const K2Args& a) {
  return (size_t)list_cap(a.S, a.max_moves) * ((a.N + 31) / 32);
}
__host__ __device__ inline size_t scratch_ints(const K2Args& a) {
  return meta_ints(a) + state_ints(a.N) + elig_ints(a);
}

// max over the resources of load / max(capacity, 1e-6), given the
// clamped capacities
__device__ __forceinline__ float util_of(float l0, float l1, float l2,
                                         float m0, float m1, float m2) {
  return fmaxf(fmaxf(l0 / m0, l1 / m1), l2 / m2);
}

// (score, node) min over the warp; every lane gets it
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ff_better_min(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__host__ __device__ constexpr int log2_of(int j) {
  return j <= 1 ? 0 : 1 + log2_of(j / 2);
}

// Node ownership. J > 0: thread t owns nodes t*J .. t*J + J - 1, its j-th
// node's state at slot j * nt + t (consecutive threads, consecutive
// slots); J == 0: thread n % nt owns node n, at slot n.
template <int J>
__device__ __forceinline__ int owner_of(int n, int nt) {
  if constexpr (J > 0) return n >> log2_of(J);
  else return n % nt;
}
template <int J>
__device__ __forceinline__ int slot_of(int n, int nt) {
  if constexpr (J > 0) return (n & (J - 1)) * nt + (n >> log2_of(J));
  else return n;
}

// K2's score of node n (state slot sl) for a service of demand d with
// `conf` conflicting occupants: the reference's clean fit / eligible /
// inf ladder
__device__ __forceinline__ float node_score(const float* st, int P, int sl,
                                            bool el, int conf, float d0,
                                            float d1, float d2) {
  const bool fits = (st[sl] + d0 <= st[3 * P + sl]) &&
                    (st[P + sl] + d1 <= st[4 * P + sl]) &&
                    (st[2 * P + sl] + d2 <= st[5 * P + sl]);
  const float util = st[9 * P + sl];
  return (fits && conf == 0 && el) ? util : (el ? util + 1e6f : CUDART_INF_F);
}

// the barrier of the loop threads alone (the others have exited)
__device__ __forceinline__ void loop_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// one block an SM at most: the loop's registers (J > 0: up to 128 a thread)
template <int J>
__global__ void __launch_bounds__(J > 0 ? kPipeThreads : kWalkThreads, 1)
    k2_kernel(K2Args p, FFLanes ls) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ float red_v[2][32];
  __shared__ int red_i[2][32];
  // the list's scan: 8 services a thread a round, at most 256 warp counts
  constexpr int kRound = 8;
  __shared__ int cnt[257];

  const int S = p.S, N = p.N, G = p.G, Gc1 = p.Gc1, K = p.K, Kc = p.Kc;
  const int packed = p.packed, stride = p.stride;
  // this block's lane: every stacked plane and the state are contiguous
  // (L, ...), so a lane's stride is its per-lane size
  const size_t l = blockIdx.x;
  const float* demand = p.demand + l * S * 3;
  const float* cap = p.cap + l * N * 3;
  const int* cids = p.cids + l * S * K;
  const int* colids = p.colids + l * S * Kc;
  const void* elig = static_cast<const char*>(p.elig) +
                     l * S * stride * (packed ? sizeof(int) : 1);
  const unsigned char* valid = p.valid + l * N;
  const int* ntopo = p.ntopo + l * N;
  const int n_real = ls.n_real[l];
  int* asg = p.asg + l * S;
  float* ld = p.ld + l * N * 3;
  int* us = p.us + l * N * G;
  int* co = p.co + l * N * Gc1;
  int* tp = p.tp + l * p.T;

  // the planes: with J > 0 all in shared memory (the launcher sees to
  // it, so the loads are shared-memory loads); with J == 0 each in shared
  // memory or in this lane's global scratch
  int* meta;
  float* st;
  unsigned* eb;
  if constexpr (J > 0) {
    meta = reinterpret_cast<int*>(dsm);
    st = reinterpret_cast<float*>(dsm + meta_ints(p) * 4);
    eb = reinterpret_cast<unsigned*>(dsm + (meta_ints(p) + state_ints(N)) * 4);
  } else {
    int* gs = p.scratch + l * scratch_ints(p);
    unsigned char* sp = dsm;
    meta = p.meta_smem ? reinterpret_cast<int*>(sp) : gs;
    if (p.meta_smem) sp += meta_ints(p) * 4;
    st = p.state_smem ? reinterpret_cast<float*>(sp)
                      : reinterpret_cast<float*>(gs + meta_ints(p));
    if (p.state_smem) sp += state_ints(N) * 4;
    eb = p.elig_smem ? reinterpret_cast<unsigned*>(sp)
                     : reinterpret_cast<unsigned*>(gs + meta_ints(p) +
                                                   state_ints(N));
  }
  const int P = state_slots(N);
  unsigned char* vd =
      reinterpret_cast<unsigned char*>(st + kStatePlanes * (size_t)P);
  const int MS = meta_stride(K, Kc), W32 = (N + 31) / 32;
  const int cap_n = list_cap(S, p.max_moves);
  const int tid = threadIdx.x, nt = blockDim.x, lt = p.loop_threads;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
#ifdef FF_PHASES
  unsigned long long* ph = ff_phase_row();
  long long c_score = 0, c_reduce = 0, c_commit = 0, ct;
  const long long clk0 = clock64();
  if (ph) ph[0] = ff_globaltimer();
#endif

  // 0. the node state, at each node's slot for its loop owner
  for (int n = tid; n < N; n += nt) {
    const int sl = slot_of<J>(n, lt);
    const float l0 = ld[(size_t)n * 3 + 0], l1 = ld[(size_t)n * 3 + 1],
                l2 = ld[(size_t)n * 3 + 2];
    const float c0 = cap[(size_t)n * 3 + 0], c1 = cap[(size_t)n * 3 + 1],
                c2 = cap[(size_t)n * 3 + 2];
    const float m0 = fmaxf(c0, 1e-6f), m1 = fmaxf(c1, 1e-6f),
                m2 = fmaxf(c2, 1e-6f);
    st[sl] = l0;
    st[P + sl] = l1;
    st[2 * P + sl] = l2;
    st[3 * P + sl] = c0 * FF_CAP_TOL;
    st[4 * P + sl] = c1 * FF_CAP_TOL;
    st[5 * P + sl] = c2 * FF_CAP_TOL;
    st[6 * P + sl] = m0;
    st[7 * P + sl] = m1;
    st[8 * P + sl] = m2;
    st[9 * P + sl] = util_of(l0, l1, l2, m0, m1, m2);
    st[10 * P + sl] = __int_as_float(ntopo[n]);
    vd[sl] = valid[n];
  }

  // 1. the first cap_n stranded services in index order, with their nodes:
  //    kRound services a thread a round, warp ballots, one scan
  int n_todo = 0;
  for (int base = 0; base < S && n_todo < cap_n; base += kRound * nt) {
    int av[kRound];
    bool sb[kRound];
    unsigned bal[kRound];
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int s = base + k * nt + tid;
      av[k] = s < S ? asg[s] : 0;
    }
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      const int s = base + k * nt + tid;
      sb[k] = s < S && (!ff_elig(elig, packed, stride, s, av[k]) ||
                        valid[av[k]] == 0);
      bal[k] = __ballot_sync(0xffffffffu, sb[k]);
      if (lane == 0) cnt[k * nw + warp] = __popc(bal[k]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the counts in (k, warp) order
      const int total = kRound * nw, per = (total + 31) / 32;  // per <= 8
      int loc[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int x = lane * per + q;
        loc[q] = sum;
        if (q < per && x < total) sum += cnt[x];
      }
      int inc = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int x = lane * per + q;
        if (q < per && x < total) cnt[x] = inc - sum + loc[q];
      }
      if (lane == 31) cnt[256] = inc;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRound; ++k) {
      if (!sb[k]) continue;
      const int pos = n_todo + cnt[k * nw + warp] +
                      __popc(bal[k] & ((1u << lane) - 1u));
      if (pos < cap_n) {
        meta[pos * MS] = base + k * nt + tid;
        meta[pos * MS + 1] = av[k];
      }
    }
    n_todo += cnt[256];
    __syncthreads();  // cnt is rewritten by the next round
  }
  const int iters = min(n_todo, min(cap_n, p.max_moves));

  // 2. stage the listed services' demand, ids, the ids each shares with
  //    the next (counted with multiplicity), and eligibility bits
  const int F = 3 + K + Kc;
#pragma unroll 4
  for (int e = tid; e < iters * (F + 1); e += nt) {
    const int i = e / (F + 1), f = e - i * (F + 1);
    const size_t s = meta[i * MS];
    int v = 0;
    if (f < 3) {
      v = __float_as_int(demand[s * 3 + f]);
    } else if (f < 3 + K) {
      v = cids[s * K + f - 3];
    } else if (f < F) {
      v = colids[s * Kc + f - 3 - K];
    } else if (i + 1 < iters) {
      const size_t t = meta[(i + 1) * MS];
      for (int k = 0; k < K; ++k) {
        const int id = cids[s * K + k];
        if (id < 0) continue;
        for (int q = 0; q < K; ++q) v += cids[t * K + q] == id;
      }
    }
    meta[i * MS + 2 + f] = v;
  }
#pragma unroll 4
  for (int e = tid; e < iters * W32; e += nt) {
    const int i = e / W32, w = e - i * W32;
    const size_t s = meta[i * MS];
    unsigned bits = 0;
    if (packed) {
      bits = static_cast<unsigned>(static_cast<const int*>(elig)[s * stride + w]);
    } else {
      const unsigned char* row = static_cast<const unsigned char*>(elig) + s * stride;
      for (int q = 0; q < 32 && w * 32 + q < N; ++q)
        bits |= static_cast<unsigned>(row[w * 32 + q] != 0) << q;
    }
    eb[e] = bits;
  }
  __syncthreads();
#ifdef FF_PHASES
  const long long c_list = clock64();
#endif

  // 3. one relocation an iteration, on the loop threads
  if (tid >= lt) return;
  const int lw = lt >> 5;
  constexpr int JR = J > 0 ? J : 1;
  int cur[JR];                  // service i's conflict count, owned nodes
  int pv[JR][kPrefetchIds];     // service i+1's, loaded during the commit
  int pfix[JR];                 // ... and its patch
  if constexpr (J > 0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int n = tid * J + j;
      int c = 0;
      for (int k = 0; k < K && iters > 0; ++k) {
        const int id = meta[5 + k];
        if (n < N && id >= 0) c += __ldcg(us + (size_t)n * G + id);
      }
      cur[j] = c;
      pfix[j] = 0;
    }
  }
  int moves = 0;
  for (int i = 0; i < iters; ++i) {
#ifdef FF_PHASES
    ct = clock64();
#endif
    const int* mi = meta + i * MS;
    const int* ids = mi + 5;
    const int s = mi[0], a = mi[1];
    const float d0 = __int_as_float(mi[2]), d1 = __int_as_float(mi[3]),
                d2 = __int_as_float(mi[4]);
    const unsigned* erow = eb + (size_t)i * W32;
    const bool more = i + 1 < iters;
    const int* nids = ids + MS;  // service i+1's ids
    float best = CUDART_INF_F;
    int best_n = INT_MAX;
    if constexpr (J > 0) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int n = tid * J + j;
        if (n >= N) break;
        const int sl = j * lt + tid;
        const bool el = ((erow[n >> 5] >> (n & 31)) & 1u) && vd[sl];
        const float sc = node_score(st, P, sl, el, cur[j], d0, d1, d2);
        if (sc < best) {  // ascending n: the first index wins ties
          best = sc;
          best_n = n;
        }
      }
    } else {
      for (int n = tid; n < N; n += lt) {
        int conf = 0;
        for (int k = 0; k < K; ++k) {
          const int id = ids[k];
          if (id >= 0) conf += __ldcg(us + (size_t)n * G + id);
        }
        const bool el = ((erow[n >> 5] >> (n & 31)) & 1u) && vd[n];
        const float sc = node_score(st, P, n, el, conf, d0, d1, d2);
        if (sc < best) {
          best = sc;
          best_n = n;
        }
      }
    }
    warp_argmin(best, best_n);
    const int par = i & 1;
    if (lane == 0) {
      red_v[par][warp] = best;
      red_i[par][warp] = best_n;
    }
#ifdef FF_PHASES
    c_score += clock64() - ct;
    ct = clock64();
#endif
    loop_sync(lt);
    best = lane < lw ? red_v[par][lane] : CUDART_INF_F;
    best_n = lane < lw ? red_i[par][lane] : INT_MAX;
    warp_argmin(best, best_n);
#ifdef FF_PHASES
    c_reduce += clock64() - ct;
    ct = clock64();
#endif
    if constexpr (J > 0) {
      // service i+1's conflict column, in flight through the commit
#pragma unroll
      for (int k = 0; k < kPrefetchIds; ++k) {
        const int id = (more && k < K) ? nids[k] : -1;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int n = tid * J + j;
          pv[j][k] = (n < N && id >= 0) ? __ldcg(us + (size_t)n * G + id) : 0;
        }
      }
    }
    if (isfinite(best)) {
      const int b = best_n;
      // the owners of a and b move the service off a and onto b
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int n = side == 0 ? a : b;
        if (owner_of<J>(n, lt) != tid) continue;
        const int sl = slot_of<J>(n, lt);
        // load + (-d) off a, load + d onto b: the plain version's order
        const float l0 = st[sl] + (side == 0 ? -d0 : d0),
                    l1 = st[P + sl] + (side == 0 ? -d1 : d1),
                    l2 = st[2 * P + sl] + (side == 0 ? -d2 : d2);
        st[sl] = l0;
        st[P + sl] = l1;
        st[2 * P + sl] = l2;
        st[9 * P + sl] = util_of(l0, l1, l2, st[6 * P + sl], st[7 * P + sl],
                                 st[8 * P + sl]);
        ld[(size_t)n * 3 + 0] = l0;
        ld[(size_t)n * 3 + 1] = l1;
        ld[(size_t)n * 3 + 2] = l2;
        const int dv = side == 0 ? -1 : 1;
        for (int k = 0; k < K; ++k) {
          const int id = ids[k];
          if (id >= 0) atomicAdd(us + (size_t)n * G + id, dv);
        }
        for (int k = 0; k < Kc; ++k) {
          const int id = mi[5 + K + k];
          if (id >= 0) atomicAdd(co + (size_t)n * Gc1 + id, dv);
        }
        if constexpr (J > 0) {
          // service i+1's column at n was loaded before this move: patch
          // it by the ids the two services share
#pragma unroll
          for (int j = 0; j < J; ++j)
            if ((n & (J - 1)) == j) pfix[j] += dv * mi[5 + K + Kc];
        }
        if (s < n_real) atomicAdd(&tp[__float_as_int(st[10 * P + sl])], dv);
        if (side == 1) asg[s] = b;
      }
      ++moves;
    }
    if constexpr (J > 0) {  // service i+1's column: the loads and the patch
#pragma unroll
      for (int j = 0; j < J; ++j) {
        int c = pfix[j];
#pragma unroll
        for (int k = 0; k < kPrefetchIds; ++k) c += pv[j][k];
        cur[j] = c;
        pfix[j] = 0;
      }
    }
#ifdef FF_PHASES
    c_commit += clock64() - ct;
#endif
  }
  if (tid == 0) p.moves_out[l] = moves;
#ifdef FF_PHASES
  if (ph) {
    const long long clk1 = clock64();
    ph[1] = ff_globaltimer();
    ph[2] = clk1 - clk0;
    ph[3] = c_list - clk0;
    ph[4] = c_score;
    ph[5] = c_reduce;
    ph[6] = c_commit;
    ph[7] = iters;
    ph[8] = moves;
  }
#endif
}

template <int J>
cudaError_t launch(int L, int threads, size_t smem, const K2Args& a,
                   const FFLanes& lanes, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k2_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  k2_kernel<J><<<L, threads, smem, stream>>>(a, lanes);
  return cudaGetLastError();
}

}  // namespace

// ints of global scratch a lane needs (the wrapper allocates L of them)
FF_EXPORT long long ff_k2_scratch_ints(int S, int N, int K, int Kc,
                                       int max_moves) {
  K2Args a{};
  a.S = S;
  a.N = N;
  a.K = K;
  a.Kc = Kc;
  a.max_moves = max_moves;
  return static_cast<long long>(scratch_ints(a));
}

FF_EXPORT int ff_k2_prerepair(
    int L, int S, int N, int G, int Gc1, int T, const float* demand,
    const float* cap, const int* cids, int K, const int* colids, int Kc,
    const void* elig, int packed, int stride, const unsigned char* valid,
    const int* ntopo, FFLanes lanes, int* assignment, float* load, int* used,
    int* coloc, int* topo, int max_moves, int* moves, int* scratch,
    cudaStream_t stream) {
  // scratch: (L, ff_k2_scratch_ints(S, N, K, Kc, max_moves)) of int
  if (L < 1 || L > FF_MAX_LANES || S < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  K2Args a{S, N, G, Gc1, T, K, Kc, packed, stride, max_moves < 0 ? 0 : max_moves,
           demand, cap, cids, colids, elig, valid, ntopo, assignment, load,
           used, coloc, topo, moves, scratch, 0, 0, 0, 0};
  // shared memory first for the listed services, then the node state, then
  // the eligibility rows; what does not fit stays in the global scratch
  size_t smem = 0;
  const size_t need[3] = {meta_ints(a) * 4, state_ints(N) * 4, elig_ints(a) * 4};
  int* flag[3] = {&a.meta_smem, &a.state_smem, &a.elig_smem};
  for (int q = 0; q < 3; ++q)
    if (smem + need[q] <= kSmemBudget) {
      *flag[q] = 1;
      smem += need[q];
    }
  // J: the fewest nodes a loop thread that keep the loop to 8 warps
  int J = 1;
  while (J < kMaxJ && (N + J - 1) / J > kLoopThreads) J <<= 1;
  a.loop_threads = ((N + J - 1) / J + 31) / 32 * 32;
  int threads = kPipeThreads;
  if (K > kPrefetchIds || a.loop_threads > kLoopThreads ||
      !(a.meta_smem && a.state_smem && a.elig_smem)) {
    J = 0;
    a.loop_threads = threads = kWalkThreads;
  }
  cudaError_t e;
  switch (J) {
    case 1: e = launch<1>(L, threads, smem, a, lanes, stream); break;
    case 2: e = launch<2>(L, threads, smem, a, lanes, stream); break;
    case 4: e = launch<4>(L, threads, smem, a, lanes, stream); break;
    case 8: e = launch<8>(L, threads, smem, a, lanes, stream); break;
    default: e = launch<0>(L, threads, smem, a, lanes, stream); break;
  }
  return static_cast<int>(e);
}
