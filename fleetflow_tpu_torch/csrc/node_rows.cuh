// A node's rows in index order, and their demand summed in that order.
//
// K3 (the load of each chain) and K5 (the sub-solve's frozen load) both
// give one warp to a node and must add its rows' demand one at a time in
// row-index order: the order of the reference's CPU scatter (and of
// np.add.at), so the float result is bit-equal to it. The scheme:
//   1. the block stages the (S,) assignment in shared-memory tiles with
//      asynchronous copies (cp.async), kStages - 1 tiles ahead of the one
//      it reads: ff_for_tiles (K3 double-buffers 1024-entry tiles; K5,
//      whose per-tile work is short, takes 2048-entry tiles so it pays
//      its per-tile barriers half as often);
//   2. each warp lists its node's rows of the tile with __ballot_sync, in
//      lane (= index) order, appending to its own list: ff_list_append;
//   3. the warp gathers the listed rows' demand 32 at a time, one row a
//      lane, and adds them in list order through shuffles: ff_add_chunk
//      adds one gathered chunk, ff_sum_listed gathers and adds a list. A
//      node holding thousands of rows pays one gather per 32, and the adds
//      never wait on a load they do not need.
// K3 lists tile offsets (short) and adds tile by tile; K5 lists a block's
// frozen rows over many tiles first and gathers them once (its rows' ids
// ride the same gather).
#pragma once

#include <cuda_pipeline.h>

#define FF_ROW_TILE 1024  // assignments staged per tile (4 KB) by K3

// stage tile t of the (S,) array `src` into `buf` (kTile entries) with
// cp.async, as one committed group (an empty group past the end)
template <int kTile>
__device__ __forceinline__ void ff_stage_tile(int* buf, const int* src, int S,
                                              int t) {
  const int base = t * kTile;
  const int len = min(kTile, S - base);
  for (int i = threadIdx.x; i < len; i += blockDim.x)
    __pipeline_memcpy_async(&buf[i], &src[base + i], sizeof(int));
  __pipeline_commit();
}

// body(t, tile) for the tiles t = 0, 1, ... (kTile entries each) of the
// (S,) array `src`, each staged in bufs[t % kStages] kStages - 1 tiles
// ahead (every thread of the block calls it; body runs between two
// barriers). With `waited`, the cycles spent staging and waiting for
// tiles are added to it (a phase stamp).
template <int kTile, int kStages, typename Body>
__device__ __forceinline__ void ff_for_tiles(int (*bufs)[kTile],
                                             const int* src, int S,
                                             Body body,
                                             long long* waited = nullptr) {
  const int n_tiles = (S + kTile - 1) / kTile;
  if (n_tiles <= 0) return;
  for (int t = 0; t < kStages - 1; ++t)  // empty groups past the end
    ff_stage_tile<kTile>(bufs[t], src, S, t);
  for (int t = 0; t < n_tiles; ++t) {
    const long long w0 = waited ? clock64() : 0;
    ff_stage_tile<kTile>(bufs[(t + kStages - 1) % kStages], src, S,
                         t + kStages - 1);
    __pipeline_wait_prior(kStages - 1);  // tile t has landed
    __syncthreads();
    if (waited) *waited += clock64() - w0;
    body(t, static_cast<const int*>(bufs[t % kStages]));
    __syncthreads();  // the buffer is restaged on
  }
  __pipeline_wait_prior(0);
}

// the lanes with `hit` append `v` at list[cnt...], in lane order; returns
// the new count, the same in every lane. Called by all 32 lanes.
template <typename T>
__device__ __forceinline__ int ff_list_append(bool hit, T v, T* list,
                                              int cnt) {
  const unsigned lower = (1u << (threadIdx.x & 31)) - 1u;
  const unsigned bal = __ballot_sync(0xffffffffu, hit);
  if (hit) list[cnt + __popc(bal & lower)] = v;
  return cnt + __popc(bal);
}

// l += lane q's (e0, e1, e2) for q = 0 .. m - 1, in that order, in every
// lane. Called by all 32 lanes.
__device__ __forceinline__ void ff_add_chunk(float e0, float e1, float e2,
                                             int m, float& l0, float& l1,
                                             float& l2) {
#pragma unroll 4
  for (int q = 0; q < m; ++q) {  // the listed rows, in order
    l0 = l0 + __shfl_sync(0xffffffffu, e0, q);
    l1 = l1 + __shfl_sync(0xffffffffu, e1, q);
    l2 = l2 + __shfl_sync(0xffffffffu, e2, q);
  }
}

// l += dem[(base + list[k]) * 3 + r] for k = 0 .. cnt - 1, in that order,
// in every lane. Called by all 32 lanes after a __syncwarp of the list.
__device__ __forceinline__ void ff_sum_listed(const float* dem, int base,
                                              const short* list, int cnt,
                                              float& l0, float& l1,
                                              float& l2) {
  const int wl = threadIdx.x & 31;
  for (int k0 = 0; k0 < cnt; k0 += 32) {
    float e0 = 0.f, e1 = 0.f, e2 = 0.f;
    if (k0 + wl < cnt) {
      const float* d = dem + (size_t)(base + list[k0 + wl]) * 3;
      e0 = d[0];
      e1 = d[1];
      e2 = d[2];
    }
    ff_add_chunk(e0, e1, e2, min(32, cnt - k0), l0, l1, l2);
  }
}
