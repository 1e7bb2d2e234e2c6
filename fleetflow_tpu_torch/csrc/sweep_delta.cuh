// The per-move annealing-cost delta shared by K1 (k1_sweep.cu) and K7
// (k7_sharded_sweep.cu; its cross-rank elect takes the team form,
// move_delta_team): the counterpart of the reference's
// fleetflow_tpu/solver/anneal.py::_move_delta_core, which its single-device
// sweep (_proposal_delta) and its service-axis sharded sweep
// (solver/sharded.py, proposal_delta) share term for term. Both kernels
// include this one copy, so a legal sweep of one is a legal sweep of the
// other.
#pragma once

#include "common.cuh"

namespace {

// one staged problem (TorchProblem): the (S, ·) planes by global service
// row, the node planes, the statics. `sticky_prev` is null when the solve
// is not sticky (K7 never is); `n_real` marks the phantom rows.
struct Problem {
  int S, N, G, Gc1, T, K, Kc;
  const float* demand;
  const float* cap;
  const int* cids;
  const int* colids;
  const void* elig;
  int packed, stride;
  const unsigned char* valid;
  const int* ntopo;
  const float* pref;
  const int* sticky_prev;
  float sticky_w;
  int strategy, max_skew, n_real;
};

__device__ __forceinline__ float overflow_mass(const float l[3], const float c[3]) {
  const float x0 = fmaxf(l[0] - c[0], 0.f) / fmaxf(c[0], 1e-6f);
  const float x1 = fmaxf(l[1] - c[1], 0.f) / fmaxf(c[1], 1e-6f);
  const float x2 = fmaxf(l[2] - c[2], 0.f) / fmaxf(c[2], 1e-6f);
  return (x0 + x1) + x2;
}

__device__ __forceinline__ float soft_rows(const Problem& p, const float la[3],
                                           const float lb[3], const float ca[3],
                                           const float cb[3]) {
  if (p.strategy != 0 && p.strategy != 1) return 0.f;
  float usq = 0.f;
  bool first = true;
  for (int r = 0; r < 3; ++r) {
    const float u = la[r] / fmaxf(ca[r], 1e-6f);
    usq = first ? u * u : usq + u * u;
    first = false;
  }
  for (int r = 0; r < 3; ++r) {
    const float u = lb[r] / fmaxf(cb[r], 1e-6f);
    usq = usq + u * u;
  }
  return p.strategy == 0 ? usq / (float)p.N : -usq / (float)p.N;
}

__device__ __forceinline__ float skew_pen(int tmax, int tmin, int max_skew) {
  return fmaxf((float)(tmax - tmin) - (float)max_skew, 0.f) * 1e3f;
}

__device__ float move_delta(const Problem& p, const float* ld, const int* us,
                            const int* co, const int* tp, int tmax, int tmin,
                            int s, int a, int b) {
  const bool ea = ff_elig(p.elig, p.packed, p.stride, s, a) && p.valid[a];
  const bool eb = ff_elig(p.elig, p.packed, p.stride, s, b) && p.valid[b];
  float d_pref = 0.f;
  if (p.pref != nullptr)
    d_pref = (p.pref[(size_t)s * p.N + a] - p.pref[(size_t)s * p.N + b]) / (float)p.S;
  if (p.sticky_prev != nullptr) {
    const int prev = p.sticky_prev[s];
    const bool anch = ff_elig(p.elig, p.packed, p.stride, s, prev) && p.valid[prev];
    d_pref = d_pref + p.sticky_w * ((float)(a == prev && anch) - (float)(b == prev && anch));
  }
  float d[3], ca[3], cb[3], la[3], lb[3], la2[3], lb2[3];
  for (int r = 0; r < 3; ++r) {
    d[r] = p.demand[(size_t)s * 3 + r];
    ca[r] = p.cap[(size_t)a * 3 + r];
    cb[r] = p.cap[(size_t)b * 3 + r];
    la[r] = ld[(size_t)a * 3 + r];
    lb[r] = ld[(size_t)b * 3 + r];
    la2[r] = la[r] - d[r];
    lb2[r] = lb[r] + d[r];
  }
  const float over_before = overflow_mass(la, ca) + overflow_mass(lb, cb);
  const float over_after = overflow_mass(la2, ca) + overflow_mass(lb2, cb);
  const float d_cap = (over_after - over_before) * 1e3f;

  int conf_a = 0, conf_b = 0;
  for (int k = 0; k < p.K; ++k) {
    const int id = p.cids[(size_t)s * p.K + k];
    if (id < 0) continue;
    conf_a += us[(size_t)a * p.G + id] - 1;
    conf_b += us[(size_t)b * p.G + id];
  }
  const float d_conf = (float)(conf_b - conf_a) * 1e4f;
  const float d_elig = ((float)ea - (float)eb) * 1e6f;

  float d_skew = 0.f;
  if (p.max_skew > 0) {
    const int r = s < p.n_real ? 1 : 0;
    const int ta = p.ntopo[a], tb = p.ntopo[b];
    int hi = INT_MIN, lo = INT_MAX;
    for (int t = 0; t < p.T; ++t) {
      const int v = tp[t] - (t == ta ? r : 0) + (t == tb ? r : 0);
      hi = max(hi, v);
      lo = min(lo, v);
    }
    d_skew = skew_pen(hi, lo, p.max_skew) - skew_pen(tmax, tmin, p.max_skew);
  }

  const float soft_before = soft_rows(p, la, lb, ca, cb);
  const float soft_after = soft_rows(p, la2, lb2, ca, cb);
  int col_a = 0, col_b = 0;
  for (int k = 0; k < p.Kc; ++k) {
    const int id = p.colids[(size_t)s * p.Kc + k];
    if (id < 0) continue;
    col_a += co[(size_t)a * p.Gc1 + id] - 1;
    col_b += co[(size_t)b * p.Gc1 + id];
  }
  const float d_coloc = (float)(col_a - col_b) / (float)(p.S > 1 ? p.S : 1);
  return d_cap + d_conf + d_elig + d_skew + (soft_after - soft_before) + d_pref + d_coloc;
}

// move_delta for a team of g lanes (a power of two <= 32; `tl` this lane,
// `tmask` the team's lanes), K7's cross-rank elect: the lanes split the
// conflict-id, coloc-id and skew loops, whose integer sums and extrema are
// order-free and combined with shuffles, and every lane then computes the
// float terms as move_delta does, in its order, so every lane returns
// move_delta's value (the tests hold the kernel bit-equal to the plain
// version). The reads are issued in two waves before any arithmetic
// waits on them, those that need only the service and the target (with
// the source `a` in flight beside them), then those that need `a` or an
// id (the eligibility and validity read both, not one behind the other):
// ~3 loads deep from the proposal where move_delta's chain is ~14.
__device__ __forceinline__ float move_delta_team(
    const Problem& p, const float* ld, const int* us, const int* co,
    const int* tp, int tmax, int tmin, int s, int a, int b, int tl, int g,
    unsigned tmask) {
  const int id0 = tl < p.K ? p.cids[(size_t)s * p.K + tl] : -1;
  const int cl0 = tl < p.Kc ? p.colids[(size_t)s * p.Kc + tl] : -1;
  float d[3], ca[3], cb[3], la[3], lb[3], la2[3], lb2[3];
  for (int r = 0; r < 3; ++r) {
    d[r] = p.demand[(size_t)s * 3 + r];
    cb[r] = p.cap[(size_t)b * 3 + r];
    lb[r] = ld[(size_t)b * 3 + r];
  }
  const bool eb_bit = ff_elig(p.elig, p.packed, p.stride, s, b);
  const bool vb = p.valid[b] != 0;
  const float pb = p.pref != nullptr ? p.pref[(size_t)s * p.N + b] : 0.f;
  for (int r = 0; r < 3; ++r) {
    ca[r] = p.cap[(size_t)a * 3 + r];
    la[r] = ld[(size_t)a * 3 + r];
  }
  const bool ea_bit = ff_elig(p.elig, p.packed, p.stride, s, a);
  const bool va = p.valid[a] != 0;
  const float pa = p.pref != nullptr ? p.pref[(size_t)s * p.N + a] : 0.f;
  int conf_a = 0, conf_b = 0, col_a = 0, col_b = 0;
  if (id0 >= 0) {
    conf_a += us[(size_t)a * p.G + id0] - 1;
    conf_b += us[(size_t)b * p.G + id0];
  }
  if (cl0 >= 0) {
    col_a += co[(size_t)a * p.Gc1 + cl0] - 1;
    col_b += co[(size_t)b * p.Gc1 + cl0];
  }
  for (int k = tl + g; k < p.K; k += g) {  // ids past the team's width
    const int id = p.cids[(size_t)s * p.K + k];
    if (id < 0) continue;
    conf_a += us[(size_t)a * p.G + id] - 1;
    conf_b += us[(size_t)b * p.G + id];
  }
  for (int k = tl + g; k < p.Kc; k += g) {
    const int id = p.colids[(size_t)s * p.Kc + k];
    if (id < 0) continue;
    col_a += co[(size_t)a * p.Gc1 + id] - 1;
    col_b += co[(size_t)b * p.Gc1 + id];
  }
  int hi = INT_MIN, lo = INT_MAX;
  if (p.max_skew > 0) {
    const int r = s < p.n_real ? 1 : 0;
    const int ta = p.ntopo[a], tb = p.ntopo[b];
    for (int t = tl; t < p.T; t += g) {
      const int v = tp[t] - (t == ta ? r : 0) + (t == tb ? r : 0);
      hi = max(hi, v);
      lo = min(lo, v);
    }
  }
  for (int o = g >> 1; o > 0; o >>= 1) {
    conf_a += __shfl_xor_sync(tmask, conf_a, o);
    conf_b += __shfl_xor_sync(tmask, conf_b, o);
    col_a += __shfl_xor_sync(tmask, col_a, o);
    col_b += __shfl_xor_sync(tmask, col_b, o);
    hi = max(hi, __shfl_xor_sync(tmask, hi, o));
    lo = min(lo, __shfl_xor_sync(tmask, lo, o));
  }
  const bool ea = ea_bit && va;
  const bool eb = eb_bit && vb;
  float d_pref = 0.f;
  if (p.pref != nullptr) d_pref = (pa - pb) / (float)p.S;
  if (p.sticky_prev != nullptr) {
    const int prev = p.sticky_prev[s];
    const bool anch = ff_elig(p.elig, p.packed, p.stride, s, prev) && p.valid[prev];
    d_pref = d_pref + p.sticky_w * ((float)(a == prev && anch) - (float)(b == prev && anch));
  }
  for (int r = 0; r < 3; ++r) {
    la2[r] = la[r] - d[r];
    lb2[r] = lb[r] + d[r];
  }
  const float over_before = overflow_mass(la, ca) + overflow_mass(lb, cb);
  const float over_after = overflow_mass(la2, ca) + overflow_mass(lb2, cb);
  const float d_cap = (over_after - over_before) * 1e3f;
  const float d_conf = (float)(conf_b - conf_a) * 1e4f;
  const float d_elig = ((float)ea - (float)eb) * 1e6f;
  float d_skew = 0.f;
  if (p.max_skew > 0)
    d_skew = skew_pen(hi, lo, p.max_skew) - skew_pen(tmax, tmin, p.max_skew);
  const float soft_before = soft_rows(p, la, lb, ca, cb);
  const float soft_after = soft_rows(p, la2, lb2, ca, cb);
  const float d_coloc = (float)(col_a - col_b) / (float)(p.S > 1 ? p.S : 1);
  return d_cap + d_conf + d_elig + d_skew + (soft_after - soft_before) + d_pref + d_coloc;
}

// (max, min) of the topology counts `tp` over the block (every thread gets
// both); ends with a barrier
__device__ __forceinline__ void block_topo_range(const int* tp, int T,
                                                 int& tmax, int& tmin,
                                                 float* red_v, int* red_i) {
  float hi = -CUDART_INF_F, lo = CUDART_INF_F;
  int dummy = 0;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    hi = fmaxf(hi, (float)tp[t]);
    lo = fminf(lo, (float)tp[t]);
  }
  block_arg<false>(hi, dummy, red_v, red_i);
  block_arg<true>(lo, dummy, red_v, red_i);
  tmax = (int)hi;
  tmin = (int)lo;
}

}  // namespace
