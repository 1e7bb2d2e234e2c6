// Host placer: constrained first-fit-decreasing (the native seed).
//
// The port's own copy of ``ff_place`` from native/placer.cpp, the C++
// counterpart of sched/host.py ``greedy_host_place`` for fleet-scale
// instances where the Python loop is the bottleneck. It is the seed behind
// solve(seed_impl="native"), the per-slice FFD of the partitioned seed and
// NativeGreedyScheduler; and ``ff_dep_depths``, the Kahn levels of a
// dependency CSR. Built with g++ into _ext_build/ at first use
// (fleetflow_tpu_torch/_ext.py) and loaded with ctypes
// (fleetflow_tpu_torch/native/lib.py).
//
// Semantics mirror sched/host.py exactly (same ordering, same strategy
// rules, same least-bad fallback, same float recipe), so the two backends
// are interchangeable and tested against each other.
//
// C ABI: every array is caller-allocated and flat; -1 pads id matrices.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct ConflictTable {
    // occupancy[group * N + node] = 1 when (group, node) is taken
    std::vector<uint8_t> occupancy;
    int32_t n_nodes = 0;
    int32_t n_groups = 0;

    void init(int32_t groups, int32_t nodes) {
        n_groups = groups;
        n_nodes = nodes;
        occupancy.assign(static_cast<size_t>(groups) * nodes, 0);
    }
    bool taken(int32_t group, int32_t node) const {
        return occupancy[static_cast<size_t>(group) * n_nodes + node] != 0;
    }
    void take(int32_t group, int32_t node) {
        occupancy[static_cast<size_t>(group) * n_nodes + node] = 1;
    }
};

int32_t max_id(const int32_t* ids, int64_t len) {
    int32_t m = -1;
    for (int64_t i = 0; i < len; ++i) m = std::max(m, ids[i]);
    return m;
}

}  // namespace

extern "C" {

// Returns the number of hard-constraint violations (services placed
// least-bad because nothing fit). 0 = feasible placement.
//
//   demand    f64[S*R]      capacity  f64[N*R]
//   eligible  u8[S*N]       node_valid u8[N]
//   dep_depth i32[S]
//   port_ids  i32[S*P], volume_ids i32[S*V], anti_ids i32[S*A]  (-1 pad)
//   strategy  0=spread_across_pool 1=pack_into_dedicated 2=fill_lowest
//   out_assignment i32[S]
int64_t ff_place(int32_t S, int32_t N, int32_t R,
                 const double* demand, const double* capacity,
                 const uint8_t* eligible, const uint8_t* node_valid,
                 const int32_t* dep_depth,
                 const int32_t* port_ids, int32_t P,
                 const int32_t* volume_ids, int32_t V,
                 const int32_t* anti_ids, int32_t A,
                 int32_t strategy,
                 int32_t* out_assignment) {
    // ---- order: dep depth asc, then biggest total demand first ----------
    std::vector<double> total_demand(S, 0.0);
    for (int32_t s = 0; s < S; ++s)
        total_demand[s] = std::accumulate(demand + (int64_t)s * R,
                                          demand + (int64_t)s * R + R, 0.0);
    std::vector<int32_t> order(S);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t b) {
                         if (dep_depth[a] != dep_depth[b])
                             return dep_depth[a] < dep_depth[b];
                         return total_demand[a] > total_demand[b];
                     });

    // ---- conflict tables -------------------------------------------------
    ConflictTable ports, volumes, antis;
    ports.init(max_id(port_ids, (int64_t)S * P) + 1, N);
    volumes.init(max_id(volume_ids, (int64_t)S * V) + 1, N);
    antis.init(max_id(anti_ids, (int64_t)S * A) + 1, N);

    std::vector<double> load((int64_t)N * R, 0.0);
    int64_t violations = 0;
    // Reciprocals once: the scoring loops below multiply instead of
    // divide (~12M divides saved at 10k x 1k, measured 68 -> 59 ms).
    // sched/host.py uses the SAME float recipe (multiply + plain sum, no
    // mean) so the two backends keep bit-identical argmins — edit both
    // together or the parity tests fail on near-ties.
    //
    // Deliberately NOT fused into one candidates+fit pass: keeping the
    // cheap eligible&valid scan separate from the fit/conflict scan over
    // the dense cands vector measured ~30 ms FASTER than a fused loop
    // (branch patterns stay homogeneous per loop).
    std::vector<double> inv_cap((int64_t)N * R);
    for (int64_t i = 0; i < (int64_t)N * R; ++i)
        inv_cap[i] = 1.0 / std::max(capacity[i], 1e-9);

    std::vector<int32_t> fits;
    fits.reserve(N);
    std::vector<int32_t> cands;
    cands.reserve(N);

    auto conflicts_at = [&](int32_t s, int32_t n) -> bool {
        for (int32_t k = 0; k < P; ++k) {
            int32_t g = port_ids[(int64_t)s * P + k];
            if (g >= 0 && ports.taken(g, n)) return true;
        }
        for (int32_t k = 0; k < V; ++k) {
            int32_t g = volume_ids[(int64_t)s * V + k];
            if (g >= 0 && volumes.taken(g, n)) return true;
        }
        for (int32_t k = 0; k < A; ++k) {
            int32_t g = anti_ids[(int64_t)s * A + k];
            if (g >= 0 && antis.taken(g, n)) return true;
        }
        return false;
    };

    for (int32_t oi = 0; oi < S; ++oi) {
        const int32_t s = order[oi];
        const double* dem = demand + (int64_t)s * R;

        // candidates: eligible & valid, else valid, else everything.
        // A fallback-level placement IS an eligibility violation even
        // when it fits (host.py `inelig`): report it so fallback-policy
        // relaxation can kick in upstream.
        cands.clear();
        for (int32_t n = 0; n < N; ++n)
            if (eligible[(int64_t)s * N + n] && node_valid[n])
                cands.push_back(n);
        bool inelig = cands.empty();
        if (cands.empty())
            for (int32_t n = 0; n < N; ++n)
                if (node_valid[n]) cands.push_back(n);
        if (cands.empty())
            for (int32_t n = 0; n < N; ++n) cands.push_back(n);

        fits.clear();
        for (int32_t n : cands) {
            const double* cap = capacity + (int64_t)n * R;
            double* ld = load.data() + (int64_t)n * R;
            bool fit = true;
            for (int32_t r = 0; r < R; ++r)
                if (ld[r] + dem[r] > cap[r]) { fit = false; break; }
            if (fit && !conflicts_at(s, n)) fits.push_back(n);
        }

        int32_t chosen;
        if (!fits.empty()) {
            if (strategy == 2) {  // fill_lowest
                chosen = *std::min_element(fits.begin(), fits.end());
            } else {
                // summed relative utilization per node (host.py parity:
                // same multiply+sum recipe, NO /R — a constant factor
                // cannot change the argmin but its rounding could flip
                // near-ties between the backends)
                double best_util = strategy == 1 ? -1.0 : 1e300;
                chosen = fits[0];
                for (int32_t n : fits) {
                    const double* ic = inv_cap.data() + (int64_t)n * R;
                    const double* ld = load.data() + (int64_t)n * R;
                    double util = 0.0;
                    for (int32_t r = 0; r < R; ++r)
                        util += ld[r] * ic[r];
                    if (strategy == 1 ? util > best_util : util < best_util) {
                        best_util = util;
                        chosen = n;
                    }
                }
            }
            if (inelig) ++violations;   // placed, but on an ineligible node
        } else {
            // least-bad: minimize total relative overflow over candidates
            // (same multiply-by-reciprocal recipe as host.py)
            double best_over = 1e300;
            chosen = cands[0];
            for (int32_t n : cands) {
                const double* ic = inv_cap.data() + (int64_t)n * R;
                const double* cap = capacity + (int64_t)n * R;
                const double* ld = load.data() + (int64_t)n * R;
                double over = 0.0;
                for (int32_t r = 0; r < R; ++r) {
                    double o = ld[r] + dem[r] - cap[r];
                    if (o > 0) over += o * ic[r];
                }
                if (over < best_over) { best_over = over; chosen = n; }
            }
            ++violations;
        }

        out_assignment[s] = chosen;
        double* ld = load.data() + (int64_t)chosen * R;
        for (int32_t r = 0; r < R; ++r) ld[r] += dem[r];
        for (int32_t k = 0; k < P; ++k) {
            int32_t g = port_ids[(int64_t)s * P + k];
            if (g >= 0) ports.take(g, chosen);
        }
        for (int32_t k = 0; k < V; ++k) {
            int32_t g = volume_ids[(int64_t)s * V + k];
            if (g >= 0) volumes.take(g, chosen);
        }
        for (int32_t k = 0; k < A; ++k) {
            int32_t g = anti_ids[(int64_t)s * A + k];
            if (g >= 0) antis.take(g, chosen);
        }
    }

    return violations;
}

// Kahn-level dependency depths over a CSR adjacency (service -> its deps).
// Returns -1 on cycle, else max depth. (native analog of
// lower/tensors.py dependency_depths; native/lib.py native_dep_depths)
int64_t ff_dep_depths(int32_t S,
                      const int32_t* dep_indptr,   // i32[S+1]
                      const int32_t* dep_indices,  // i32[nnz], dep targets
                      int32_t* out_depth) {        // i32[S]
    std::vector<int32_t> remaining(S, 0);
    std::vector<std::vector<int32_t>> dependents(S);
    for (int32_t s = 0; s < S; ++s) {
        remaining[s] = dep_indptr[s + 1] - dep_indptr[s];
        for (int32_t k = dep_indptr[s]; k < dep_indptr[s + 1]; ++k)
            dependents[dep_indices[k]].push_back(s);
    }
    std::vector<int32_t> queue;
    queue.reserve(S);
    for (int32_t s = 0; s < S; ++s)
        if (remaining[s] == 0) { out_depth[s] = 0; queue.push_back(s); }
    size_t head = 0;
    int32_t max_depth = 0;
    int64_t seen = (int64_t)queue.size();
    while (head < queue.size()) {
        int32_t u = queue[head++];
        for (int32_t v : dependents[u]) {
            out_depth[v] = std::max(out_depth[v], out_depth[u] + 1);
            if (--remaining[v] == 0) {
                max_depth = std::max(max_depth, out_depth[v]);
                queue.push_back(v);
                ++seen;
            }
        }
    }
    if (seen != S) return -1;  // cycle
    return max_depth;
}

}  // extern "C"
