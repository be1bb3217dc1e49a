// Sphere-pruned exact nearest-face search over 512-face tiles, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/pruned_knn.py:_pruned_kernel
// (wrapper pruned_search_presorted). The centroids arrive in kd order, cut
// into tiles of 512 with a bounding sphere each (padded slots at 1e15). For
// every block of block_p consecutive points:
// - the block's sphere: the midpoint of the points' bounding box, and the
//   distance to the farthest point, rho;
// - a lower bound per tile, lb[t] = (|c_t - ctr| - r_t) - rho;
// - the seed tile t0, the first argmin of lb, is visited first; then every
//   other tile in index order is visited iff lb[t] < thresh, where thresh =
//   sqrt(max over the block's points of their best d2), taken after the
//   seed and again after each visited tile whose (t + 1) % tighten == 0.
// The result is the exact argmin of
//   d2 = (dx*dx + dy*dy) + dz*dz
// over the visited tiles, as a kd-order id (tile * 512 + lane).
//
// Bound on the H100: instruction issue. At the render's blocked 524,288
// points the blocks visit 13.7 of 27 tiles: 3.7e9 point-centroid pairs of
// 9 FP32 operations that may not fuse into an FMA (the tie rule), a floor
// of ~0.99 ms at 33.5e12 single instructions per second, twice the 67
// TFLOP/s bound; the bytes (points, ids, 165 KB of centroids in L2) are
// ~8 MB. The sphere, the bounds and the thresholds add ~1% to the floor.
//
// Design:
// - kPts = 4 points a thread (1 where block_p is not a multiple of 128), so
//   a 512-point block is 128 threads: one broadcast read of a centroid from
//   shared memory (3 LDS.128 for 4 slots) serves all the thread's points.
// - The block's reductions (bounding box, rho, the seed's argmin, the
//   threshold) are warp shuffles and one shared-memory step over at most
//   8 warps (32 at kPts = 1).
// - Per point and chunk of kChunk slots one fminf per pair, then one
//   predicated compare with the running best: a strict improvement records
//   only the chunk, and the id's slot inside it is found once per point at
//   the end (the chunk's first slot at the best, recomputed from L2 with
//   the same roundings). Recomputing the chunk at each improvement, in a
//   branch, made the kernel 8-12% slower on an H100 (PERF.md).
// - Tiles are copied ahead with cp.async (16 bytes a copy, from the three
//   2 KB coordinate rows a tile has in cent_t (3, f_pad)) into a ring of
//   kStages = 2 stages: while tile v is computed, the next candidate is in
//   flight. The threshold only shrinks, so the next visited tile is never
//   before the next candidate: the first later tile (not t0) with lb <
//   the threshold as it stood before tile v. If tile v's tightening
//   rejects the candidate, its copy is dropped and the next tile that
//   passes is copied without overlap. The visit test is taken against the
//   threshold of the plain version at every tile, so a prefetch never
//   changes which tiles are visited.
// - The blocks run in the points' own order. Taking them longest visit list
//   first measured 4-6% faster on an H100 with the lists known in advance
//   (PERF.md); a list is known only after its block's seed visit, so no
//   pass ahead of the search orders them.
// The TPU kernel's block mean (an order-dependent sum) is replaced by the
// bounding-box midpoint: only min and max are reduced, so the plain version
// (ops/pruned_knn.py:pruned_search_plain) repeats every bound bit for bit.
// Its per-lane running minimum slab is replaced by the tie rule in closed
// form (below).
//
// Ring order (one __syncthreads per visit): visit v computes stage st while
// its candidate's copies land in stage st ^ 1. After visit v every thread
// waits for its own copies (cp.async.wait_group 0), and the barrier makes
// every thread's copies visible, the threshold's per-warp maxima readable,
// and guarantees that every thread has finished computing stage st; only
// after that barrier is stage st written again (by the copy issued at the
// top of visit v + 1). A rejected candidate's stage st ^ 1 is read by no
// one, so its replacement is issued right after the barrier and waited
// for with a second barrier. The threshold's per-warp maxima alternate
// between two rows: a row is written again only after the barrier that
// follows every read of it.
//
// Tie rule (exact ties in d2), kept from the TPU kernel: per LANE (slot
// position in its tile) the first-visited tile that reaches the lane's
// minimum holds the lane; among the lanes at the final minimum D the
// smallest held id wins. A lane l at D is held by the seed t0 if d2(t0, l)
// == D, else by the smallest visited tile that reaches D at l (the others
// are visited in index order). Streamed over the visits, in closed form:
// - a strict improvement m < best: the first slot of the chunk at m is the
//   id (no earlier tile reaches m at any lane, so this tile holds them);
// - an exact tie m == best competes with the id only if one of its slots
//   is smaller. Visits after the seed run in index order, so every visited
//   slot is larger than every slot before it, except the seed's: a tie can
//   change the id only in a tile t < t0 while the seed holds the id. Then
//   its first lane l at m that the seed does not hold (d2(t0, l) != best)
//   takes the id, and a lane the seed holds does not compete (the seed's
//   centroid is re-read from L2, on exact ties only). Once a tile t < t0
//   holds the id, every later tie has larger slots.
// A later strict improvement restarts the id, as it clears every lane in
// the TPU kernel. tests/test_torch_port_pruned_knn.py holds a replica of
// this stream against the plain version's per-lane running minimum on
// planted ties.
//
// Exactness: __fsub_rn/__fmul_rn/__fadd_rn/__fsqrt_rn in the plain
// version's order, so nvcc contracts nothing and the ids equal the plain
// version's. fminf, fmaxf and the compares are exact.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 512;                 // centroid slots per tile
constexpr int kStages = 2;                 // tiles in the ring
constexpr int kChunk = 16;                 // slots per fminf chunk
constexpr int kStageVec = 3 * kTile / 4;   // float4 per stage (x, y, z rows)
constexpr int kMaxTiles = 1024;            // lower bounds kept in shared memory
constexpr int kMaxWarps = 32;
static_assert(kTile % kChunk == 0 && kChunk % 4 == 0, "chunks are whole float4 groups");

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

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// An exact tie at the best in a tile before the seed, while the seed holds
// the id: the first lane of ``eq`` (bit j: slot chunk + j) that the seed
// does not hold at ``best`` takes the id; else ``id`` stays.
__device__ __noinline__ int seed_free_lane(unsigned eq, int chunk, int id, float best, float px,
                                           float py, float pz, const float* __restrict__ cent_t,
                                           int f_pad, int t0) {
  while (eq) {
    const int j = __ffs(eq) - 1;
    const int s0 = t0 * kTile + (chunk + j) % kTile;
    if (dist2(px, py, pz, __ldg(cent_t + s0), __ldg(cent_t + f_pad + s0),
              __ldg(cent_t + 2 * f_pad + s0)) != best) {
      return chunk + j;
    }
    eq &= eq - 1;
  }
  return id;
}

// One visited tile (stage tx) of slots base .. base + kTile - 1. Per chunk
// each point's minimum m; m < best records the chunk (its first slot at
// the new best is the id, found at the end). kTies (a tile before the
// seed): an exact tie m == best while the seed holds the id may take it.
template <int kPts, bool kTies>
__device__ __forceinline__ void visit_tile(const float4* tx, int base, int t0, const float* px,
                                           const float* py, const float* pz, float* best, int* id,
                                           const float* __restrict__ cent_t, int f_pad) {
  const float4* ty = tx + kTile / 4;
  const float4* tz = ty + kTile / 4;
#pragma unroll 1
  for (int c = 0; c < kTile; c += kChunk) {
    float cxs[kChunk], cys[kChunk], czs[kChunk];
#pragma unroll
    for (int g = 0; g < kChunk / 4; ++g) {
      const float4 x = tx[c / 4 + g], y = ty[c / 4 + g], z = tz[c / 4 + g];
      cxs[4 * g + 0] = x.x; cxs[4 * g + 1] = x.y; cxs[4 * g + 2] = x.z; cxs[4 * g + 3] = x.w;
      cys[4 * g + 0] = y.x; cys[4 * g + 1] = y.y; cys[4 * g + 2] = y.z; cys[4 * g + 3] = y.w;
      czs[4 * g + 0] = z.x; czs[4 * g + 1] = z.y; czs[4 * g + 2] = z.z; czs[4 * g + 3] = z.w;
    }
    float m[kPts];
    bool tie[kPts], any_tie = false;
#pragma unroll
    for (int k = 0; k < kPts; ++k) {
      m[k] = chunk_min(px[k], py[k], pz[k], cxs, cys, czs);
      tie[k] = kTies && m[k] == best[k] && id[k] >= t0 * kTile;
      any_tie |= tie[k];
      if (m[k] < best[k]) {  // predicated: no branch
        best[k] = m[k];
        id[k] = base + c;
      }
    }
    if (kTies && any_tie) {  // exact ties only
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        if (tie[k]) {
          unsigned eq = 0u;
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            eq |= (dist2(px[k], py[k], pz[k], cxs[j], cys[j], czs[j]) == m[k] ? 1u : 0u) << j;
          id[k] = seed_free_lane(eq, base + c, id[k], best[k], px[k], py[k], pz[k], cent_t, f_pad, t0);
        }
      }
    }
  }
}

// pts: (n_pts, 3), n_pts a multiple of block_p = blockDim.x * kPts; cent_t:
// (3, f_pad), 16-byte aligned, f_pad = n_tiles * kTile; tile_c, tile_r:
// (8, t_pad); 1 <= n_tiles <= kMaxTiles; out: (n_pts,) kd-order ids.
template <int kPts>
__global__ void __launch_bounds__(kPts == 1 ? 1024 : 256)
pruned_kernel(const float* __restrict__ pts, const float* __restrict__ cent_t,
              const float* __restrict__ tile_c, const float* __restrict__ tile_r,
              int* __restrict__ out, int n_tiles, int f_pad, int t_pad, int tighten) {
  __shared__ float4 ring[kStages * kStageVec];
  __shared__ float lb[kMaxTiles];
  __shared__ float red_box[6][kMaxWarps];
  __shared__ float red_rho[kMaxWarps];
  __shared__ float red_lb[kMaxWarps];
  __shared__ int red_t[kMaxWarps];
  __shared__ float red_th[2][kMaxWarps];
  const int n_thr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = n_thr >> 5;
  const int p0 = blockIdx.x * n_thr * kPts;

  float px[kPts], py[kPts], pz[kPts], best[kPts];
  int id[kPts];  // a slot of the chunk that holds the id: its first slot at best from there
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int i = p0 + k * n_thr + tid;
    px[k] = pts[3 * i + 0];
    py[k] = pts[3 * i + 1];
    pz[k] = pts[3 * i + 2];
    best[k] = CUDART_INF_F;
  }

  // the block's sphere: bounding-box midpoint, farthest point
  float box[6] = {px[0], py[0], pz[0], px[0], py[0], pz[0]};
#pragma unroll
  for (int k = 1; k < kPts; ++k) {
    box[0] = fminf(box[0], px[k]);
    box[1] = fminf(box[1], py[k]);
    box[2] = fminf(box[2], pz[k]);
    box[3] = fmaxf(box[3], px[k]);
    box[4] = fmaxf(box[4], py[k]);
    box[5] = fmaxf(box[5], pz[k]);
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    box[j] = j < 3 ? warp_min(box[j]) : warp_max(box[j]);
    if (lane == 0) red_box[j][warp] = box[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float v = red_box[j][0];
    for (int w = 1; w < n_warps; ++w) v = j < 3 ? fminf(v, red_box[j][w]) : fmaxf(v, red_box[j][w]);
    box[j] = v;
  }
  const float cx = __fmul_rn(0.5f, __fadd_rn(box[0], box[3]));
  const float cy = __fmul_rn(0.5f, __fadd_rn(box[1], box[4]));
  const float cz = __fmul_rn(0.5f, __fadd_rn(box[2], box[5]));
  float r2 = dist2(px[0], py[0], pz[0], cx, cy, cz);
#pragma unroll
  for (int k = 1; k < kPts; ++k) r2 = fmaxf(r2, dist2(px[k], py[k], pz[k], cx, cy, cz));
  r2 = warp_max(r2);
  if (lane == 0) red_rho[warp] = r2;
  __syncthreads();
  for (int w = 0; w < n_warps; ++w) r2 = fmaxf(r2, red_rho[w]);
  const float rho = __fsqrt_rn(r2);

  // the tiles' lower bounds, and the seed: their first argmin
  float lb_min = CUDART_INF_F;
  int t_min = INT_MAX;
  for (int t = tid; t < n_tiles; t += n_thr) {
    const float d = __fsqrt_rn(dist2(tile_c[t], tile_c[t_pad + t], tile_c[2 * t_pad + t], cx, cy, cz));
    const float v = __fsub_rn(__fsub_rn(d, tile_r[t]), rho);
    lb[t] = v;
    if (v < lb_min || (v == lb_min && t < t_min)) {
      lb_min = v;
      t_min = t;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, lb_min, o);
    const int ot = __shfl_xor_sync(0xffffffffu, t_min, o);
    if (ov < lb_min || (ov == lb_min && ot < t_min)) {
      lb_min = ov;
      t_min = ot;
    }
  }
  if (lane == 0) {
    red_lb[warp] = lb_min;
    red_t[warp] = t_min;
  }
  __syncthreads();  // also publishes lb
  for (int w = 0; w < n_warps; ++w) {
    const float ov = red_lb[w];
    const int ot = red_t[w];
    if (ov < lb_min || (ov == lb_min && ot < t_min)) {
      lb_min = ov;
      t_min = ot;
    }
  }
  const int t0 = t_min;
#pragma unroll
  for (int k = 0; k < kPts; ++k) id[k] = t0 * kTile;  // d2 overflows everywhere: the seed's first slot

  // tile t -> stage st, one commit group
  auto issue = [&](int t, int st) {
    float4* dst = ring + st * kStageVec;
    for (int j = tid; j < kStageVec; j += n_thr) {
      const int r = j / (kTile / 4), q = j % (kTile / 4);
      cp_async16(dst + j, cent_t + static_cast<size_t>(r) * f_pad + static_cast<size_t>(t) * kTile + 4 * q);
    }
    cp_async_commit();
  };
  // the first tile from t on that the plain version would visit at thresh
  auto next_tile = [&](int t, float thresh) {
    while (t < n_tiles && (t == t0 || !(lb[t] < thresh))) ++t;
    return t;
  };

  issue(t0, 0);
  cp_async_wait_all();
  __syncthreads();
  float thresh = CUDART_INF_F;
  int cur = t0, st = 0, pos = -1, row = 0;
  for (;;) {
    int nxt = next_tile(pos + 1, thresh);
    if (nxt < n_tiles) issue(nxt, st ^ 1);

    const float4* tx = ring + st * kStageVec;
    if (cur < t0) {
      visit_tile<kPts, true>(tx, cur * kTile, t0, px, py, pz, best, id, cent_t, f_pad);
    } else {
      visit_tile<kPts, false>(tx, cur * kTile, t0, px, py, pz, best, id, cent_t, f_pad);
    }

    // the threshold after this tile: per-warp maxima now, the block's after
    // the barrier
    const bool tight = cur == t0 || (tighten > 0 && (cur + 1) % tighten == 0);
    if (tight) {
      float v = best[0];
#pragma unroll
      for (int k = 1; k < kPts; ++k) v = fmaxf(v, best[k]);
      v = warp_max(v);
      if (lane == 0) red_th[row][warp] = v;
    }
    if (nxt >= n_tiles) break;
    cp_async_wait_all();  // this thread's copies of the candidate have landed
    __syncthreads();      // every thread's have; stage st is free; red_th[row] is written
    if (tight) {
      float v = red_th[row][0];
      for (int w = 1; w < n_warps; ++w) v = fmaxf(v, red_th[row][w]);
      thresh = __fsqrt_rn(v);
      row ^= 1;
    }
    if (!(lb[nxt] < thresh)) {  // the tightened threshold rejects the candidate
      nxt = next_tile(nxt + 1, thresh);
      if (nxt >= n_tiles) break;
      issue(nxt, st ^ 1);
      cp_async_wait_all();
      __syncthreads();
    }
    cur = nxt;
    pos = nxt;
    st ^= 1;
  }
  cp_async_wait_all();  // no copy outlives the block
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    // the id: the first slot at best from id[k] to the end of its chunk
    int slot = id[k];
    const int end = (slot / kChunk + 1) * kChunk;
    for (int s = slot; s < end; ++s) {
      if (dist2(px[k], py[k], pz[k], __ldg(cent_t + s), __ldg(cent_t + f_pad + s),
                __ldg(cent_t + 2 * f_pad + s)) == best[k]) {
        slot = s;
        break;
      }
    }
    out[p0 + k * n_thr + tid] = slot;
  }
}

constexpr int points_per_thread(int block_p) { return block_p % (32 * 4) == 0 ? 4 : 1; }

}  // namespace

// pts: (n_pts, 3) float32, n_pts a multiple of block_p; cent_t: (3, f_pad)
// float32 in kd order, 16-byte aligned, f_pad = n_tiles * 512; tile_c,
// tile_r: (8, t_pad) float32 (rows 0..2 the tile centers, row 0 the radii);
// out: (n_pts,) int32 kd-order ids. block_p: a multiple of 32, at most 1024;
// 1 <= n_tiles <= 1024. tighten: 0 keeps the seed threshold, k > 0 tightens
// after a visited tile whose index + 1 is a multiple of k. Returns
// cudaGetLastError().
extern "C" int pruned_knn_launch(const float* pts, const float* cent_t, const float* tile_c,
                                 const float* tile_r, int* out, int n_pts, int block_p,
                                 int n_tiles, int f_pad, int t_pad, int tighten,
                                 void* stream) {
  if (n_pts > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = n_pts / block_p;
    if (points_per_thread(block_p) == 4) {
      pruned_kernel<4><<<blocks, block_p / 4, 0, s>>>(pts, cent_t, tile_c, tile_r, out, n_tiles,
                                                     f_pad, t_pad, tighten);
    } else {
      pruned_kernel<1><<<blocks, block_p, 0, s>>>(pts, cent_t, tile_c, tile_r, out, n_tiles, f_pad,
                                                 t_pad, tighten);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Points a thread holds at this block size.
extern "C" int pruned_knn_points_per_thread(int block_p) { return points_per_thread(block_p); }

// Resident blocks per SM at this block size (occupancy query, launches nothing).
extern "C" int pruned_knn_blocks_per_sm(int block_p) {
  int blocks = 0;
  if (points_per_thread(block_p) == 4) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pruned_kernel<4>, block_p / 4, 0);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pruned_kernel<1>, block_p, 0);
  }
  return blocks;
}
