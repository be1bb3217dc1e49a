// List-driven exact nearest-face search, for Hopper (sm_90a): the kernel
// template shared by listed_knn.cu (wide tie rule) and listed_knn_slim.cu
// (slim tie rule).
//
// Replaces the TPU kernels dual_space_nerf_tpu/ops/pruned_knn.py:_listed_kernel
// and :_listed_kernel_slim (one pl.pallas_call site, wrapper
// pruned_search_listed). The centroids sit in kd-leaf TILES of 128 slots
// (padded slots at 1e15). For every PLAN ROW of plan_p consecutive points the
// caller supplies a visit list: tile ids sorted by the row's lower bound, the
// number of listed tiles, and the sorted squared lower bounds. Every tile that
// can hold the nearest centroid of any point of the row is listed, so walking
// the list gives the exact argmin of
//   d2 = (dx*dx + dy*dy) + dz*dz
// over all centroids, as a tile-slot id (tile * 128 + lane).
//
// Bound on the H100: operations. A 524,288-point search of the render visits
// ~10-20 of 128 tiles per row: ~1e9 point-centroid pairs of 9 FP32 ops
// against ~9 MB moved (points, ids, lists; the 192 KB of centroids stay in L2).
//
// Design: a thread block is 128 consecutive points of one plan row, one point
// per thread, its running best (d2, slot) in registers. Each listed tile is
// staged through shared memory (128 float4, one load per thread, double
// buffered so a visit costs one barrier) and read by broadcast. The TPU
// kernel's (P, 128) running-minimum slab, its 8-row plan slab and its static
// unroll are answers to Mosaic and are not carried over.
//
// Tie rules (exact ties in d2), kept from the TPU kernels:
// - wide: per LANE (slot position in its tile) the first-visited tile keeps
//   the lane; among the lanes at the minimum the smallest slot id wins. A
//   per-thread 128-bit lane mask records which lanes already hold the current
//   minimum: it is cleared on a strict improvement and read only on a tie.
// - slim: the smallest slot id among all visited slots at the minimum.
//
// kTighten (wide only): before each visit after the first, the block skips
// the rest of its list once no point's best reaches the next lower bound
// (lists are sorted, bests only shrink). Exact: a skipped tile's centroids
// are all farther than every point's best.
//
// Exactness: the arithmetic is spelled with __fsub_rn/__fmul_rn/__fadd_rn in
// the plain version's order (ops/pruned_knn.py:listed_search_plain), so nvcc
// contracts nothing and the ids equal the plain version's on every point.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace listed {

constexpr int kThreads = 128;  // points per thread block
constexpr int kTile = 128;     // centroid slots per tile

__device__ __forceinline__ float dist2(float px, float py, float pz, const float4 c) {
  const float dx = __fsub_rn(px, c.x);
  const float dy = __fsub_rn(py, c.y);
  const float dz = __fsub_rn(pz, c.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// pts: (n_pts, 3), n_pts a multiple of kThreads and of plan_p, plan_p a
// multiple of kThreads; cent_t: (3, n_slots); order, lbs: (rows, row_stride);
// counts: (rows,), each >= 1; out: (n_pts,) slot ids.
template <bool kWide, bool kTighten>
__global__ void __launch_bounds__(kThreads)
listed_kernel(const float* __restrict__ pts, const float* __restrict__ cent_t,
              const int* __restrict__ order, const int* __restrict__ counts,
              const float* __restrict__ lbs, int* __restrict__ out, int plan_p,
              int row_stride, int n_slots) {
  __shared__ float4 tile[2][kTile];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const int row = (blockIdx.x * kThreads) / plan_p;
  const float px = pts[3 * i + 0];
  const float py = pts[3 * i + 1];
  const float pz = pts[3 * i + 2];
  const int cnt = counts[row];
  const int* list = order + static_cast<size_t>(row) * row_stride;
  const float* lb = lbs + static_cast<size_t>(row) * row_stride;

  float best = CUDART_INF_F;
  int best_id = 0;
  unsigned mask[4] = {0u, 0u, 0u, 0u};  // wide: lanes that hold the minimum
  int buf = 0;
  for (int v = 0; v < cnt; ++v) {
    if (kTighten && v > 0) {
      if (!__syncthreads_or(lb[v] <= best)) break;
    }
    const int base = list[v] * kTile;
    tile[buf][tid] = make_float4(cent_t[base + tid], cent_t[n_slots + base + tid],
                                 cent_t[2 * n_slots + base + tid], 0.0f);
    // one barrier per visit: the other buffer was last read before the
    // previous visit's barrier
    __syncthreads();
    if (kWide) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        unsigned m = mask[w];
#pragma unroll 8
        for (int b = 0; b < 32; ++b) {
          const int lane = w * 32 + b;
          const float d2 = dist2(px, py, pz, tile[buf][lane]);
          if (d2 < best) {
            best = d2;
            best_id = base + lane;
            mask[0] = mask[1] = mask[2] = mask[3] = 0u;
            m = 1u << b;
          } else if (d2 == best && !((m >> b) & 1u)) {
            m |= 1u << b;
            best_id = min(best_id, base + lane);
          }
        }
        mask[w] = m;
      }
    } else {
#pragma unroll 8
      for (int lane = 0; lane < kTile; ++lane) {
        const float d2 = dist2(px, py, pz, tile[buf][lane]);
        if (d2 < best) {
          best = d2;
          best_id = base + lane;
        } else if (d2 == best) {
          best_id = min(best_id, base + lane);
        }
      }
    }
    buf ^= 1;
  }
  out[i] = best_id;
}

}  // namespace listed
