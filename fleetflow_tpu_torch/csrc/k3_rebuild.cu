// K3: exact rebuild of the carried chain state, and the exact violation gate.
//
// Replaces fleetflow_tpu/solver/anneal.py::chain_states_from_assignment and
// fleetflow_tpu/solver/kernels.py::violation_stats (node_loads,
// group_counts, _skew_excess): from C assignments (C, S) build
//   load  (C, N, 3) f32   Σ demand of the services on each node
//   used  (C, N, G) i32   services per (node, conflict id)
//   coloc (C, N, Gc) i32  services per (node, colocation id)
//   topo  (C, T) i32      real services per topology domain
// optionally onto a frozen base, and the five exact stats per chain:
// capacity cells over cap·(1+1e-6), Σ C(c,2) conflict pairs, services on
// ineligible or invalid nodes, relu(max - min - max_skew), total.
//
// Determinism: a float atomicAdd sums a node's rows in a run-dependent
// order, which can flip a cell at the 1e-6 edge. Each node's load is
// therefore its base plus its services' demand added one at a time in
// service-index order: the order of the reference's CPU scatter, so the
// result is bit-equal to it. The integer planes use atomics (exact in any
// order). Out-of-range assignments are dropped, as XLA drops them.
//
// Lanes (the tenant multiplexer): L same-tier problems stacked on a
// leading axis and C chains each fold into L·C rows; row r reads the planes
// of lane r / C at that lane's stride (every stacked plane is a contiguous
// (L, ...) tensor) and its n_real from the by-value lane scalars. A solo
// call is L = 1. A frozen base is one remainder shared by every row.
//
// Bound: bytes. The rebuild reads the assignment, demand and id tables
// once and writes the planes; at S=10000, N=1000, G≈830 the (C, N, G) used
// plane (zeroed, then scattered) dominates.
//
// Design: at most 3 launches (2 without the stats):
//   1. init: the integer planes zeroed or copied from the base, the row
//      accumulators zeroed; the base's own conflict pairs counted once;
//   2. build, two roles of one grid: scatter blocks add each service's
//      conflict, colocation and topology counts with atomics (with the
//      stats, the value an increment finds is the number of pairs it
//      adds, so the pairs are summed here and the stats never read the
//      (C, N, G) plane); load blocks give one warp to each node: the block
//      stages the row's assignment in shared-memory tiles with
//      asynchronous copies (cp.async, double-buffered), and the warp walks
//      each tile with __ballot_sync(a == n), listing its node's services
//      in lane (= index) order, then gathers their demand 32 at a time
//      and adds it in list order, tile after tile: service order, with no
//      counting sort (the scheme of csrc/node_rows.cuh, shared with K5);
//   3. stats: capacity cells and eligibility per row, block sums by
//      atomics; the last block of a row (a __threadfence + atomicAdd
//      counter) takes the skew from the topology counts and writes the
//      five stats.
#include "common.cuh"
#include "node_rows.cuh"

#define K3_THREADS 256
#define K3_INIT_BLOCKS 1024  // init blocks a row at most (base pair slots)

namespace {

constexpr int kWarps = K3_THREADS / 32;  // nodes per load block

// grid (blocks, L·C): zero or copy the integer planes of row y; zero its
// accumulators; count the base's conflict pairs once (row 0's blocks)
__global__ void __launch_bounds__(K3_THREADS)
k3_init(int N, int G, int Gc1, int T, const int* __restrict__ used0,
        const int* __restrict__ coloc0, const int* __restrict__ topo0,
        int* used, int* coloc, int* topo, unsigned long long* acc,
        unsigned long long* base_pairs, int* done) {
  __shared__ long long sm[32];
  const int c = blockIdx.y;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  const size_t nu = (size_t)N * G, nc = (size_t)N * Gc1;
  long long pairs = 0;
  for (size_t i = tid; i < nu; i += step) {
    const int u = used0 ? used0[i] : 0;
    used[c * nu + i] = u;
    pairs += (long long)u * (u - 1) / 2;
  }
  for (size_t i = tid; i < nc; i += step)
    coloc[c * nc + i] = coloc0 ? coloc0[i] : 0;
  for (size_t i = tid; i < (size_t)T; i += step)
    topo[(size_t)c * T + i] = topo0 ? topo0[i] : 0;
  if (tid < 4) acc[(size_t)c * 4 + tid] = 0ull;
  if (tid == 0) done[c] = 0;
  if (c == 0 && base_pairs != nullptr) {
    pairs = block_sum_ll(pairs, sm);
    if (threadIdx.x == 0) base_pairs[blockIdx.x] = (unsigned long long)pairs;
  }
}

// grid (scatter blocks + load blocks, L·C), K3_THREADS threads
__global__ void __launch_bounds__(K3_THREADS)
k3_build(int C, int S, int N, int G, int Gc1, int T, int n_scatter,
         const int* __restrict__ assign, const float* __restrict__ demand,
         const int* __restrict__ cids, int K,
         const int* __restrict__ colids, int Kc,
         const int* __restrict__ ntopo, FFLanes ls,
         const float* __restrict__ load0, float* load, int* used, int* coloc,
         int* topo, unsigned long long* acc) {
  __shared__ int tile[2][FF_ROW_TILE];
  __shared__ short hits[kWarps][FF_ROW_TILE];
  __shared__ long long sm[32];
  const int c = blockIdx.y;
  const size_t lane = c / C;
  const int* as = assign + (size_t)c * S;
  if ((int)blockIdx.x < n_scatter) {
    // scatter role: one thread a service
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    long long pairs = 0;
    if (s < S) {
      cids += lane * S * K;
      colids += lane * S * Kc;
      ntopo += lane * N;
      const int a = as[s];
      if (a >= 0 && a < N) {
        const size_t row = (size_t)c * N + a;
        for (int k = 0; k < K; ++k) {
          const int id = cids[(size_t)s * K + k];
          if (id >= 0) pairs += atomicAdd(&used[row * G + id], 1);
        }
        for (int k = 0; k < Kc; ++k) {
          const int id = colids[(size_t)s * Kc + k];
          if (id >= 0) atomicAdd(&coloc[row * Gc1 + id], 1);
        }
        if (s < ls.n_real[lane]) atomicAdd(&topo[(size_t)c * T + ntopo[a]], 1);
      }
    }
    if (acc != nullptr) {
      pairs = block_sum_ll(pairs, sm);
      if (threadIdx.x == 0 && pairs)
        atomicAdd(&acc[(size_t)c * 4 + 1], (unsigned long long)pairs);
    }
    return;
  }
  // load role: warp w of the block sums node n's services in index order
  // (csrc/node_rows.cuh): per tile it lists its node's services and adds
  // their demand in list order
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = ((int)blockIdx.x - n_scatter) * kWarps + warp;
  const float* dem = demand + lane * S * 3;
  short* list = hits[warp];
  float l0 = 0.f, l1 = 0.f, l2 = 0.f;
  if (load0 != nullptr && n < N) {
    l0 = load0[n * 3 + 0];
    l1 = load0[n * 3 + 1];
    l2 = load0[n * 3 + 2];
  }
  ff_for_tiles<FF_ROW_TILE, 2>(tile, as, S, [&](int t, const int* buf) {
    const int base = t * FF_ROW_TILE;
    const int len = min(FF_ROW_TILE, S - base);
    int cnt = 0;
    for (int j = 0; j < len; j += 32) {
      const int i = j + wl;
      cnt = ff_list_append(n < N && i < len && buf[i] == n, (short)i, list,
                           cnt);
    }
    __syncwarp();
    ff_sum_listed(dem, base, list, cnt, l0, l1, l2);
  });
  if (n < N && wl == 0) {
    float* out = load + ((size_t)c * N + n) * 3;
    out[0] = l0;
    out[1] = l1;
    out[2] = l2;
  }
}

// grid (blocks, L·C): per-row capacity cells and eligibility counts; the
// last block of a row adds the skew and writes the five stats
__global__ void __launch_bounds__(K3_THREADS)
k3_stats(int C, int S, int N, int T, const float* __restrict__ load,
         const float* __restrict__ cap, const int* __restrict__ assign,
         const void* elig, int packed, int stride,
         const unsigned char* __restrict__ valid,
         const int* __restrict__ topo, int max_skew,
         const unsigned long long* __restrict__ base_pairs, int n_base,
         unsigned long long* acc, int* done, float* stats) {
  __shared__ long long sm[32];
  __shared__ float sv[32];
  __shared__ int si[32];
  __shared__ int last;
  const int c = blockIdx.y;
  const size_t lane = c / C;
  cap += lane * N * 3;
  elig = static_cast<const char*>(elig) + lane * S * stride * (packed ? sizeof(int) : 1);
  valid += lane * N;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  long long cells = 0, bad = 0;
  const float* ld = load + (size_t)c * N * 3;
  for (size_t i = tid; i < (size_t)N * 3; i += step)
    cells += ld[i] > cap[i] * FF_CAP_TOL;
  const int* as = assign + (size_t)c * S;
  for (size_t s = tid; s < (size_t)S; s += step) {
    const int a = as[s];
    if (a < 0 || a >= N) {  // out of range: off every node
      bad += 2;
      continue;
    }
    bad += (!ff_elig(elig, packed, stride, (int)s, a)) + (valid[a] == 0);
  }
  cells = block_sum_ll(cells, sm);
  bad = block_sum_ll(bad, sm);
  if (threadIdx.x == 0) {
    atomicAdd(&acc[c * 4 + 0], (unsigned long long)cells);
    atomicAdd(&acc[c * 4 + 2], (unsigned long long)bad);
    __threadfence();
    last = atomicAdd(&done[c], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the row's last block: skew from the topology counts, then the stats
  float hi = -CUDART_INF_F, lo = CUDART_INF_F;
  int dummy = 0;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float v = (float)__ldcg(&topo[(size_t)c * T + t]);
    hi = fmaxf(hi, v);
    lo = fminf(lo, v);
  }
  block_arg<false>(hi, dummy, sv, si);
  block_arg<true>(lo, dummy, sv, si);
  long long bp = 0;
  for (int b = threadIdx.x; b < n_base; b += blockDim.x)
    bp += (long long)__ldcg(&base_pairs[b]);
  bp = block_sum_ll(bp, sm);
  if (threadIdx.x == 0) {
    long long skew = 0;
    if (max_skew > 0) {
      const long long spread = (long long)hi - (long long)lo;
      skew = spread - max_skew > 0 ? spread - max_skew : 0;
    }
    const long long cells_t = (long long)__ldcg(&acc[c * 4 + 0]);
    const long long pairs_t = (long long)__ldcg(&acc[c * 4 + 1]) + bp;
    const long long bad_t = (long long)__ldcg(&acc[c * 4 + 2]);
    float* out = stats + (size_t)c * 5;
    out[0] = (float)cells_t;
    out[1] = (float)pairs_t;
    out[2] = (float)bad_t;
    out[3] = (float)skew;
    out[4] = (float)(cells_t + pairs_t + bad_t + skew);
  }
}

}  // namespace

FF_EXPORT int ff_k3_rebuild(
    const int* assign, int L, int C, int S, int N, int G, int Gc1, int T,
    const float* demand, const int* cids, int K, const int* colids, int Kc,
    const int* ntopo, FFLanes lanes, const float* load0, const int* used0,
    const int* coloc0, const int* topo0, float* load, int* used, int* coloc,
    int* topo, const float* cap, const void* elig, int packed, int stride,
    const unsigned char* valid, int max_skew, float* stats, int* scratch,
    cudaStream_t stream) {
  // the L·C rows of (lane, chain); scratch: acc (4 u64 a row) | base pairs
  // (K3_INIT_BLOCKS u64) | done (an int a row)
  if (L < 1 || L > FF_MAX_LANES) return static_cast<int>(cudaErrorInvalidValue);
  const int R = L * C;
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(scratch);
  unsigned long long* base_pairs = acc + (size_t)4 * R;
  int* done = reinterpret_cast<int*>(base_pairs + K3_INIT_BLOCKS);
  const bool with_stats = stats != nullptr;
  const int Gmax = G > Gc1 ? G : Gc1;
  const int n_init = ff_blocks((long long)N * (Gmax > T ? Gmax : T),
                               K3_THREADS * 4, K3_INIT_BLOCKS);
  unsigned long long* bp = with_stats && used0 != nullptr ? base_pairs : nullptr;
  k3_init<<<dim3(n_init, R), K3_THREADS, 0, stream>>>(
      N, G, Gc1, T, used0, coloc0, topo0, used, coloc, topo, acc, bp, done);
  const int n_scatter = (S + K3_THREADS - 1) / K3_THREADS;
  const int n_load = (N + kWarps - 1) / kWarps;
  k3_build<<<dim3(n_scatter + n_load, R), K3_THREADS, 0, stream>>>(
      C, S, N, G, Gc1, T, n_scatter, assign, demand, cids, K, colids, Kc,
      ntopo, lanes, load0, load, used, coloc, topo,
      with_stats ? acc : nullptr);
  if (with_stats) {
    const int nb = ff_blocks((long long)(S > N * 3 ? S : N * 3), K3_THREADS * 2,
                             256);
    k3_stats<<<dim3(nb, R), K3_THREADS, 0, stream>>>(
        C, S, N, T, load, cap, assign, elig, packed, stride, valid, topo,
        max_skew, bp, bp != nullptr ? n_init : 0, acc, done, stats);
  }
  return static_cast<int>(cudaGetLastError());
}
