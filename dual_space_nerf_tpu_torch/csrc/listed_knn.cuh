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
// Bound on the H100: instruction issue. A 524,288-point search of the render
// visits ~10 of 128 tiles per row: ~6.9e8 point-centroid pairs of 9 FP32
// operations that may not fuse into an FMA (the tie rule), a floor of 0.185 ms
// at 33.5e12 instructions per second, against ~9 MB moved (points, ids,
// lists; the 192 KB of centroids stay in L2).
//
// Design: a thread block is ONE WARP holding the 128 consecutive points of
// one block of a plan row, kPts = 4 per lane in registers, each with its
// running best (d2, slot). Per block:
// - the row's count, tile ids (and, with kTighten, lower bounds) are read
//   into shared memory once;
// - listed tiles are copied ahead with cp.async (16 bytes a lane, from the
//   three 512-byte coordinate rows a tile has in cent_t (3, n_slots)) into a
//   ring of kStages stages, so tiles v+1 .. v+kStages-1 are in flight while
//   tile v is computed;
// - a centroid is read by broadcast (3 LDS.128 per 4 slots) and serves the
//   lane's 4 points; per point and chunk of kChunk slots one fminf per pair,
//   the 4 points' chunk minima in one basic block and one branch a chunk;
//   the tie branch (lane mask or smallest id) runs only when a chunk's
//   minimum is <= the running best, and recomputes that chunk's distances.
// One warp per block needs no block barrier: __syncwarp orders the ring.
// The blocks take the plan rows longest list first (order_rows, a counting
// sort launched ahead of the search). A block's time grows with its list;
// in the rows' own order, long lists that start late run with few warps
// beside them at the end, which measured as the largest loss at the
// render's blocked points on an H100.
// The TPU kernel's (P, 128) running-minimum slab, its 8-row plan slab and
// its static unroll are answers to Mosaic and are not carried over.
//
// Ring order (one __syncwarp per visit): at visit v every lane waits until
// its own copies of tile v have landed (cp.async.wait_group kStages-2); the
// __syncwarp makes every lane's copies visible and guarantees that every
// lane has finished computing visit v-1; only then is tile v+kStages-1
// issued, into visit v-1's stage. One commit group per visit, empty at the
// end of the list, keeps the group count; a block leaves only after
// cp.async.wait_group 0.
//
// Tie rules (exact ties in d2), kept from the TPU kernels:
// - wide: per LANE (slot position in its tile) the first-visited tile keeps
//   the lane; among the lanes at the minimum the smallest slot id wins. A
//   per-point 128-bit lane mask records which lanes already hold the current
//   minimum: it is cleared on a strict improvement and read only on a tie.
// - slim: the smallest slot id among all visited slots at the minimum.
// A chunk whose minimum is above the running best changes nothing under
// either rule, so skipping its tie branch is exact. Inside the branch the
// per-slot sequence of the rules is taken in closed form over the chunk's
// slots at its minimum m (a bit mask eq): if m is below the best, m is the
// new best, this tile holds exactly the lanes of eq and the first of them
// is the id; if m equals the best, the lanes of eq that no earlier tile
// holds join the mask and the first of them competes for the id (wide), or
// the first slot of eq does (slim).
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

constexpr int kThreads = 32;                 // one warp per block
constexpr int kPts = 4;                      // points per lane
constexpr int kBlockPts = kThreads * kPts;   // 128 points per block
constexpr int kTile = 128;                   // centroid slots per tile
constexpr int kStages = 2;                   // tiles in the ring
constexpr int kChunk = 8;                    // slots per fminf chunk
constexpr int kStageVec = 3 * kTile / 4;     // float4 per stage (x, y, z rows)

__device__ __forceinline__ float dist2(float px, float py, float pz, float cx, float cy,
                                       float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// min over a chunk of d2, as a tree; fminf is exact, so the order does not
// change the value
__device__ __forceinline__ float chunk_min(float px, float py, float pz, const float* cx,
                                           const float* cy, const float* cz) {
  float d[kChunk];
#pragma unroll
  for (int j = 0; j < kChunk; ++j) d[j] = dist2(px, py, pz, cx[j], cy[j], cz[j]);
#pragma unroll
  for (int w = 1; w < kChunk; w *= 2) {
#pragma unroll
    for (int j = 0; j + w < kChunk; j += 2 * w) d[j] = fminf(d[j], d[j + w]);
  }
  return d[0];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory of one block: the ring, then the row's tile ids,
// then (kTighten) its lower bounds.
__host__ __device__ constexpr size_t smem_bytes(int row_stride, bool tighten) {
  return sizeof(float4) * kStages * kStageVec +
         static_cast<size_t>(row_stride) * 4 * (tighten ? 2 : 1);
}

// pts: (n_pts, 3), n_pts a multiple of kBlockPts and of plan_p, plan_p a
// multiple of kBlockPts; cent_t: (3, n_slots), 16-byte aligned, n_slots a
// multiple of 4; order, lbs: (rows, row_stride); counts: (rows,), each
// >= 1; out: (n_pts,) slot ids.
template <bool kWide, bool kTighten>
__global__ void __launch_bounds__(kThreads, 16)
listed_kernel(const float* __restrict__ pts, const float* __restrict__ cent_t,
              const int* __restrict__ order, const int* __restrict__ counts,
              const float* __restrict__ lbs, const int* __restrict__ row_of_rank,
              int* __restrict__ out, int plan_p, int row_stride, int n_slots) {
  extern __shared__ float4 smem[];
  float4* ring = smem;
  int* list = reinterpret_cast<int*>(ring + kStages * kStageVec);
  float* lb = reinterpret_cast<float*>(list + row_stride);
  const int lane = threadIdx.x;
  const int per_row = plan_p / kBlockPts;  // blocks of one plan row
  const int row = row_of_rank[blockIdx.x / per_row];
  const int p0 = row * plan_p + (blockIdx.x % per_row) * kBlockPts;
  const int cnt = counts[row];
  for (int v = lane; v < cnt; v += kThreads) {
    list[v] = order[static_cast<size_t>(row) * row_stride + v];
    if (kTighten) lb[v] = lbs[static_cast<size_t>(row) * row_stride + v];
  }
  __syncwarp();

  float px[kPts], py[kPts], pz[kPts], best[kPts];
  int best_id[kPts];
  unsigned mask[kPts][4];  // wide: lanes that hold the minimum
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int i = p0 + k * kThreads + lane;
    px[k] = pts[3 * i + 0];
    py[k] = pts[3 * i + 1];
    pz[k] = pts[3 * i + 2];
    best[k] = CUDART_INF_F;
    best_id[k] = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) mask[k][w] = 0u;
  }

  // tile list[v] -> stage v % kStages: lane l copies 16 bytes of each row
  auto issue = [&](int v) {
    const float* src = cent_t + list[v] * kTile + 4 * lane;
    float4* dst = ring + (v % kStages) * kStageVec + lane;
#pragma unroll
    for (int r = 0; r < 3; ++r) cp_async16(dst + r * (kTile / 4), src + static_cast<size_t>(r) * n_slots);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < cnt) issue(s);
    cp_async_commit();
  }

  for (int v = 0; v < cnt; ++v) {
    if (kTighten && v > 0) {
      bool reach = false;
#pragma unroll
      for (int k = 0; k < kPts; ++k) reach |= lb[v] <= best[k];
      if (!__any_sync(0xffffffffu, reach)) break;
    }
    cp_async_wait<kStages - 2>();  // this lane's copies of tile v have landed
    __syncwarp();                  // every lane's have; visit v-1 is done
    if (v + kStages - 1 < cnt) issue(v + kStages - 1);
    cp_async_commit();
    const float4* tx = ring + (v % kStages) * kStageVec;
    const float4* ty = tx + kTile / 4;
    const float4* tz = ty + kTile / 4;
    const int base = list[v] * kTile;
#pragma unroll
    for (int w = 0; w < 4; ++w) {  // 32-slot words of the lane mask
#pragma unroll 1
      for (int c = 0; c < 32; c += kChunk) {
        const int q = (w * 32 + c) / 4;
        float cx[kChunk], cy[kChunk], cz[kChunk];
#pragma unroll
        for (int g = 0; g < kChunk / 4; ++g) {
          const float4 x = tx[q + g], y = ty[q + g], z = tz[q + g];
          cx[4 * g + 0] = x.x; cx[4 * g + 1] = x.y; cx[4 * g + 2] = x.z; cx[4 * g + 3] = x.w;
          cy[4 * g + 0] = y.x; cy[4 * g + 1] = y.y; cy[4 * g + 2] = y.z; cy[4 * g + 3] = y.w;
          cz[4 * g + 0] = z.x; cz[4 * g + 1] = z.y; cz[4 * g + 2] = z.z; cz[4 * g + 3] = z.w;
        }
        // every point's chunk minimum in one basic block, one branch a chunk
        float m[kPts];
        bool hit = false;
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          m[k] = chunk_min(px[k], py[k], pz[k], cx, cy, cz);
          hit |= m[k] <= best[k];
        }
        if (hit) {  // the tie branch: rare after the first visits
#pragma unroll
          for (int k = 0; k < kPts; ++k) {
            if (m[k] <= best[k]) {
              // the chunk's distances again: the same roundings, the same
              // values; eq marks the chunk's slots at the minimum, in word w
              unsigned eq = 0u;
#pragma unroll
              for (int j = 0; j < kChunk; ++j)
                eq |= (dist2(px[k], py[k], pz[k], cx[j], cy[j], cz[j]) == m[k] ? 1u : 0u) << j;
              eq <<= c;
              const int word0 = base + w * 32;  // slot of bit 0 of word w
              if (kWide) {
                if (m[k] < best[k]) {
                  // a new minimum: this tile keeps the lanes that reach it,
                  // the first of them is the smallest slot
                  best[k] = m[k];
#pragma unroll
                  for (int u = 0; u < 4; ++u) mask[k][u] = 0u;
                  mask[k][w] = eq;
                  best_id[k] = word0 + __ffs(eq) - 1;
                } else {
                  // a tie: only lanes that no earlier tile holds at the minimum
                  const unsigned fresh = eq & ~mask[k][w];
                  if (fresh) {
                    mask[k][w] |= fresh;
                    best_id[k] = min(best_id[k], word0 + __ffs(fresh) - 1);
                  }
                }
              } else {
                const int slot = word0 + __ffs(eq) - 1;
                best_id[k] = m[k] < best[k] ? slot : min(best_id[k], slot);
                best[k] = m[k];
              }
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int k = 0; k < kPts; ++k) out[p0 + k * kThreads + lane] = best_id[k];
}

constexpr int kBins = 256;  // list-length classes of the row order

__device__ __forceinline__ int length_bin(int count, int row_stride) {
  return min(max(count, 0), row_stride) * (kBins - 1) / max(row_stride, 1);
}

// The plan rows by decreasing list length (a counting sort in one block, by
// kBins length classes; within a class in no fixed order): row_of_rank[r]
// is the row that the r-th block group searches. A block's time grows with
// its list, so taking the longest lists first keeps a long one from starting
// last and running alone at the end (longest-processing-time order). Each
// row's ids are its own, so the order changes no result.
__global__ void __launch_bounds__(1024)
order_rows(const int* __restrict__ counts, int* __restrict__ row_of_rank, int rows,
           int row_stride) {
  __shared__ int start[kBins];
  if (threadIdx.x < kBins) start[threadIdx.x] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    atomicAdd(&start[length_bin(counts[r], row_stride)], 1);
  __syncthreads();
  if (threadIdx.x < 32) {
    // exclusive scan over the classes from the longest down: lane l owns
    // classes kBins-1-8l .. kBins-8-8l
    constexpr int kPer = kBins / 32;
    const int l = threadIdx.x;
    int own[kPer], sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) sum += own[q] = start[kBins - 1 - kPer * l - q];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (l >= o) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      start[kBins - 1 - kPer * l - q] = run;
      run += own[q];
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    row_of_rank[atomicAdd(&start[length_bin(counts[r], row_stride)], 1)] = r;
}

// Launch one variant: the row order, then the search on grid n_pts /
// kBlockPts, one warp a block, with the dynamic shared memory of its ring
// and list. row_of_rank: (rows,) int32 scratch. Returns cudaGetLastError().
template <bool kWide, bool kTighten>
int launch(const float* pts, const float* cent_t, const int* order, const int* counts,
           const float* lbs, int* row_of_rank, int* out, int n_pts, int plan_p, int row_stride,
           int n_slots, cudaStream_t stream) {
  if (n_pts > 0) {
    order_rows<<<1, 1024, 0, stream>>>(counts, row_of_rank, n_pts / plan_p, row_stride);
    listed_kernel<kWide, kTighten>
        <<<n_pts / kBlockPts, kThreads, smem_bytes(row_stride, kTighten), stream>>>(
            pts, cent_t, order, counts, lbs, row_of_rank, out, plan_p, row_stride, n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of one variant at this row stride.
template <bool kWide, bool kTighten>
int blocks_per_sm(int row_stride) {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, listed_kernel<kWide, kTighten>, kThreads,
                                                smem_bytes(row_stride, kTighten));
  return blocks;
}

}  // namespace listed
