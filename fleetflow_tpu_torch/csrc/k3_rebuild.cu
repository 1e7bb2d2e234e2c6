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
// order, which can flip a cell at the 1e-6 edge. The load is therefore a
// STABLE counting sort of services by node (CSR: per-chunk node counts,
// their prefix over chunks and nodes, and each service's rank among the
// same-node services before it in its chunk), then one thread per node
// sums its segment, which is in service-index order: the order of the
// reference's CPU scatter, so the result is bit-equal to it. The integer
// planes use atomics (exact in any order).
//
// Lanes (the tenant multiplexer): L same-tier problems stacked on a
// leading axis and C chains each fold into L·C rows; row r reads the planes
// of lane r / C at that lane's stride (every stacked plane is a contiguous
// (L, ...) tensor) and its n_real from the by-value lane scalars. Each row
// keeps the stable, service-order load sum, so a lane's planes and stats
// equal a solo rebuild's bit for bit; a solo call is L = 1. A frozen base
// is one remainder shared by every row.
//
// Bound: bytes. The rebuild reads the assignment, demand and id tables
// once and writes the planes; at S=10000, N=1000, G≈830 the (C, N, G) used
// plane (zeroed, then scattered) dominates. Design: simple passes (init,
// scatter + chunk counts, prefix over chunks, prefix over nodes, stable
// fill, per-node sum, stats).
#include "common.cuh"

namespace {

__global__ void k3_init(int C, int N, int G, int Gc1, int T, int n_chunks,
                        const float* __restrict__ load0,
                        const int* __restrict__ used0,
                        const int* __restrict__ coloc0,
                        const int* __restrict__ topo0, float* load, int* used,
                        int* coloc, int* topo, int* ccount,
                        unsigned long long* acc) {
  const size_t tid = grid_tid(), step = grid_stride();
  const size_t nl = (size_t)N * 3, nu = (size_t)N * G, nc = (size_t)N * Gc1;
  for (size_t i = tid; i < C * nl; i += step) load[i] = load0 ? load0[i % nl] : 0.f;
  for (size_t i = tid; i < C * nu; i += step) used[i] = used0 ? used0[i % nu] : 0;
  for (size_t i = tid; i < C * nc; i += step) coloc[i] = coloc0 ? coloc0[i % nc] : 0;
  for (size_t i = tid; i < (size_t)C * T; i += step) topo[i] = topo0 ? topo0[i % T] : 0;
  for (size_t i = tid; i < (size_t)C * n_chunks * N; i += step) ccount[i] = 0;
  for (size_t i = tid; i < (size_t)C * 4; i += step) acc[i] = 0ull;
}

constexpr int kChunk = 256;  // services per block of the stable fill

// grid (chunks, L·C), kChunk threads: integer scatters and per-chunk counts
__global__ void k3_scatter(int C, int S, int N, int G, int Gc1, int T,
                           const int* __restrict__ assign,
                           const int* __restrict__ cids, int K,
                           const int* __restrict__ colids, int Kc,
                           const int* __restrict__ ntopo, FFLanes ls,
                           int* used, int* coloc, int* topo, int* ccount) {
  const int c = blockIdx.y, chunk = blockIdx.x;
  const int s = chunk * kChunk + threadIdx.x;
  if (s >= S) return;
  const size_t lane = c / C;
  cids += lane * S * K;
  colids += lane * S * Kc;
  ntopo += lane * N;
  const int n_real = ls.n_real[lane];
  const int a = assign[(size_t)c * S + s];
  if (a < 0 || a >= N) return;  // out of range: dropped, as XLA drops it
  atomicAdd(&ccount[((size_t)c * gridDim.x + chunk) * N + a], 1);
  const size_t row = (size_t)c * N + a;
  for (int k = 0; k < K; ++k) {
    const int id = cids[(size_t)s * K + k];
    if (id >= 0) atomicAdd(&used[row * G + id], 1);
  }
  for (int k = 0; k < Kc; ++k) {
    const int id = colids[(size_t)s * Kc + k];
    if (id >= 0) atomicAdd(&coloc[row * Gc1 + id], 1);
  }
  if (s < n_real) atomicAdd(&topo[(size_t)c * T + ntopo[a]], 1);
}

// one thread per (row, node): exclusive prefix of the chunk counts over
// chunks, leaving the node's total in counts
__global__ void k3_chunk_scan(int C, int N, int n_chunks, int* ccount,
                              int* counts) {
  const size_t step = grid_stride();
  for (size_t i = grid_tid(); i < (size_t)C * N; i += step) {
    const int c = (int)(i / N), n = (int)(i % N);
    int run = 0;
    for (int j = 0; j < n_chunks; ++j) {
      int* p = &ccount[((size_t)c * n_chunks + j) * N + n];
      const int v = *p;
      *p = run;
      run += v;
    }
    counts[i] = run;
  }
}

// one block per row: exclusive scan of the per-node counts
__global__ void k3_scan(int N, const int* __restrict__ counts, int* offsets) {
  __shared__ int part[1024];
  const int c = blockIdx.x;
  const int chunk = (N + blockDim.x - 1) / blockDim.x;
  const int lo = min(N, (int)threadIdx.x * chunk), hi = min(N, lo + chunk);
  const int* cnt = counts + (size_t)c * N;
  int sum = 0;
  for (int n = lo; n < hi; ++n) sum += cnt[n];
  part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) {
      const int v = part[t];
      part[t] = run;
      run += v;
    }
    offsets[(size_t)c * (N + 1) + N] = run;
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (int n = lo; n < hi; ++n) {
    offsets[(size_t)c * (N + 1) + n] = run;
    run += cnt[n];
  }
}

// grid (chunks, L·C), kChunk threads: service s goes to its node's offset +
// the same-node count of earlier chunks + its rank within its own chunk
__global__ void k3_fill(int S, int N, const int* __restrict__ assign,
                        const int* __restrict__ offsets,
                        const int* __restrict__ ccount, int* perm) {
  __shared__ int node[kChunk];
  const int c = blockIdx.y, chunk = blockIdx.x;
  const int s = chunk * kChunk + threadIdx.x;
  int a = -1;
  if (s < S) {
    a = assign[(size_t)c * S + s];
    if (a >= N) a = -1;
  }
  node[threadIdx.x] = a;
  __syncthreads();
  if (a < 0) return;
  int rank = 0;
  for (int t = 0; t < (int)threadIdx.x; ++t) rank += node[t] == a;
  const int pos = offsets[(size_t)c * (N + 1) + a] +
                  ccount[((size_t)c * gridDim.x + chunk) * N + a] + rank;
  perm[(size_t)c * S + pos] = s;
}

// one thread per (row, node): sum the node's services, already in index
// order, onto the base row
__global__ void k3_load(int rows, int C, int S, int N,
                        const int* __restrict__ offsets,
                        const int* __restrict__ perm,
                        const float* __restrict__ demand,
                        const float* __restrict__ load0, float* load) {
  const size_t step = grid_stride();
  for (size_t i = grid_tid(); i < (size_t)rows * N; i += step) {
    const int c = (int)(i / N), n = (int)(i % N);
    const int lo = offsets[(size_t)c * (N + 1) + n];
    const int hi = offsets[(size_t)c * (N + 1) + n + 1];
    const int* seg = perm + (size_t)c * S;
    const float* dem = demand + (size_t)(c / C) * S * 3;  // the row's lane
    float l0 = load0 ? load0[n * 3 + 0] : 0.f;
    float l1 = load0 ? load0[n * 3 + 1] : 0.f;
    float l2 = load0 ? load0[n * 3 + 2] : 0.f;
    for (int x = lo; x < hi; ++x) {
      const int s = seg[x];
      l0 = l0 + dem[(size_t)s * 3 + 0];
      l1 = l1 + dem[(size_t)s * 3 + 1];
      l2 = l2 + dem[(size_t)s * 3 + 2];
    }
    float* out = load + ((size_t)c * N + n) * 3;
    out[0] = l0;
    out[1] = l1;
    out[2] = l2;
  }
}

// grid (blocks, L·C): per-row counts of the three integer stats
__global__ void k3_stats(int C, int S, int N, int G,
                         const float* __restrict__ load,
                         const float* __restrict__ cap,
                         const int* __restrict__ used,
                         const int* __restrict__ assign, const void* elig,
                         int packed, int stride,
                         const unsigned char* __restrict__ valid,
                         unsigned long long* acc) {
  __shared__ long long sm[32];
  const int c = blockIdx.y;
  const size_t lane = c / C;
  cap += lane * N * 3;
  elig = static_cast<const char*>(elig) + lane * S * stride * (packed ? sizeof(int) : 1);
  valid += lane * N;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t step = (size_t)gridDim.x * blockDim.x;
  long long cells = 0, pairs = 0, bad = 0;
  const float* ld = load + (size_t)c * N * 3;
  for (size_t i = tid; i < (size_t)N * 3; i += step)
    cells += ld[i] > cap[i] * FF_CAP_TOL;
  const int* us = used + (size_t)c * N * G;
  for (size_t i = tid; i < (size_t)N * G; i += step) {
    const long long u = us[i];
    pairs += u * (u - 1) / 2;
  }
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
  pairs = block_sum_ll(pairs, sm);
  bad = block_sum_ll(bad, sm);
  if (threadIdx.x == 0) {
    atomicAdd(&acc[c * 4 + 0], (unsigned long long)cells);
    atomicAdd(&acc[c * 4 + 1], (unsigned long long)pairs);
    atomicAdd(&acc[c * 4 + 2], (unsigned long long)bad);
  }
}

// one block per row: skew from the topology counts, then the five stats
__global__ void k3_finalize(int T, const int* __restrict__ topo, int max_skew,
                            const unsigned long long* __restrict__ acc,
                            float* stats) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const int c = blockIdx.x;
  float hi = -CUDART_INF_F, lo = CUDART_INF_F;
  int dummy = 0;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const float v = (float)topo[(size_t)c * T + t];
    hi = fmaxf(hi, v);
    lo = fminf(lo, v);
  }
  block_arg<false>(hi, dummy, sv, si);
  block_arg<true>(lo, dummy, sv, si);
  if (threadIdx.x == 0) {
    long long skew = 0;
    if (max_skew > 0) {
      const long long spread = (long long)hi - (long long)lo;
      skew = spread - max_skew > 0 ? spread - max_skew : 0;
    }
    const long long cells = (long long)acc[c * 4 + 0];
    const long long pairs = (long long)acc[c * 4 + 1];
    const long long bad = (long long)acc[c * 4 + 2];
    float* out = stats + (size_t)c * 5;
    out[0] = (float)cells;
    out[1] = (float)pairs;
    out[2] = (float)bad;
    out[3] = (float)skew;
    out[4] = (float)(cells + pairs + bad + skew);
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
  // the L·C rows of (lane, chain); scratch: acc (4 u64 per row) | counts
  // (rows,N) | offsets (rows,N+1) | perm (rows,S) | chunk counts
  // (rows,chunks,N)
  if (L < 1 || L > FF_MAX_LANES) return static_cast<int>(cudaErrorInvalidValue);
  const int R = L * C;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(scratch);
  int* counts = scratch + 8 * R;
  int* offsets = counts + (size_t)R * N;
  int* perm = offsets + (size_t)R * (N + 1);
  int* ccount = perm + (size_t)R * S;
  const int th = 256;
  const long long big = (long long)R * N * (G > 3 ? G : 3);
  k3_init<<<ff_blocks(big, th), th, 0, stream>>>(
      R, N, G, Gc1, T, n_chunks, load0, used0, coloc0, topo0, load, used,
      coloc, topo, ccount, acc);
  const dim3 chunks(n_chunks, R);
  k3_scatter<<<chunks, kChunk, 0, stream>>>(C, S, N, G, Gc1, T, assign, cids,
                                           K, colids, Kc, ntopo, lanes, used,
                                           coloc, topo, ccount);
  k3_chunk_scan<<<ff_blocks((long long)R * N, 128), 128, 0, stream>>>(
      R, N, n_chunks, ccount, counts);
  k3_scan<<<R, 1024, 0, stream>>>(N, counts, offsets);
  k3_fill<<<chunks, kChunk, 0, stream>>>(S, N, assign, offsets, ccount, perm);
  k3_load<<<ff_blocks((long long)R * N, 128), 128, 0, stream>>>(
      R, C, S, N, offsets, perm, demand, load0, load);
  if (stats != nullptr) {
    dim3 grid(ff_blocks((long long)N * (G > 3 ? G : 3), th, 64), R);
    k3_stats<<<grid, th, 0, stream>>>(C, S, N, G, load, cap, used, assign,
                                      elig, packed, stride, valid, acc);
    k3_finalize<<<R, 256, 0, stream>>>(T, topo, max_skew, acc, stats);
  }
  return static_cast<int>(cudaGetLastError());
}
