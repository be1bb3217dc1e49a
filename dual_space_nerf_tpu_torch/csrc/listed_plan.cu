// Visit plan of the list-driven nearest-face search, for Hopper (sm_90a).
//
// In the JAX package the plan is plain XLA ahead of the TPU kernel
// (dual_space_nerf_tpu/ops/pruned_knn.py:643-691, _listed_search_sorted). As
// plain torch ops it costs ~24 passes over an (N, T) float32 array: 8x the
// search kernel it feeds. This kernel computes the same plan without that
// array ever leaving the SM.
//
// For every ROW of plan_p consecutive points and every tile t:
//   u_p   = min over tiles of |p - witness_t|, inflated by 1 + 1e-5 and 1e-6:
//           an upper bound on p's nearest-centroid distance;
//   lb2   = dist2(p, AABB_t), a lower bound on p's distance to tile t;
//   visit = any p of the row has lb2 <= u_p^2;  key = min over the row of lb2
// and the row's tiles sorted by (visit ? key : inf), ties by tile id: order,
// the sorted keys, and the number of listed tiles.
//
// Bound on the H100: instruction issue. Taken pair by pair, the plan costs
// 25 single FP32 instructions a (point, tile) pair (9 for the witness
// distance, 16 for the AABB bound, its test and its min; no FMA, since the
// plan must equal its plain version bit for bit): 1.7e9 for a 524,288-point
// search of 128 tiles, against ~10 MB moved.
//
// Design: most pairs need not be taken. A row's points are spatially
// coherent, and both sums are monotone in their terms under round-to-
// nearest, so a bound computed with the plain version's own operations from
// the row's bounding box B is a bound on every point's value:
//   - witness cull: pick a witness w0 near the row's first point and let
//     U = max over the row of d2(p, w0) (the exact rounded value). A witness
//     whose rounded d2 to B (the per-axis gaps between w and B, squared and
//     summed as d2 is) exceeds U is, for every point, farther than w0, so
//     it cannot be the minimum: u_p is the min over the witnesses kept;
//   - tile cull: with M = max over the row of u_p^2, a tile whose rounded
//     lb2 to B (the gaps between its AABB and B) exceeds M has lb2 > u_p^2
//     for every point: it is not listed, and its key does not matter.
// Both drop pairs only where the plain version's comparison is strict, so
// the plan is the same bits. A block of 128 threads takes a row (blocks
// that walked 2 to 8 rows, with the witnesses staged once, measured slower
// on the H100). It loads the points and their box, picks w0, culls the
// witnesses into a list, takes each point's min over that list (u_p^2),
// culls the tiles into a list, and gives each warp candidate tiles to scan
// over all the row's points (min and any by shuffles). The stable order follows in
// closed form, without a sort: a listed tile's rank is the number of listed
// tiles with a smaller (key, id), counted over the short candidate list; an
// unlisted tile's rank is L (the row's listed tiles) plus the number of
// unlisted tiles with a smaller id, counted in a mask of the listed tiles
// (one bit a tile). Each tile then scatters its id and key.
//
// Exactness: only min, max, any and counts are reduced, the arithmetic of
// every value that reaches the plan is spelled with __fsub_rn / __fmul_rn /
// __fadd_rn / __fsqrt_rn in the plain version's order
// (ops/pruned_knn.py:listed_plan_plain), and the culls are exact bounds, so
// order, counts and keys equal the plain version's bit for bit. Keys are
// non-negative sums of squares (never -0), so float order is total on them.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float ex, float ey, float ez) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
}

// the rounded distance from a coordinate x in [b_lo, b_hi] to v is at least this
__device__ __forceinline__ float gap_to_point(float v, float b_lo, float b_hi) {
  return v > b_hi ? __fsub_rn(v, b_hi) : (v < b_lo ? __fsub_rn(b_lo, v) : 0.0f);
}

// ... and to the interval [lo, hi] (lo <= hi; otherwise no bound)
__device__ __forceinline__ float gap_to_interval(float lo, float hi, float b_lo, float b_hi) {
  if (!(lo <= hi)) return 0.0f;
  return lo > b_hi ? __fsub_rn(lo, b_hi) : (hi < b_lo ? __fsub_rn(b_lo, hi) : 0.0f);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// append ``keep`` lanes' values to a shared list through its counter
__device__ __forceinline__ int append_pos(bool keep, int* counter) {
  const unsigned m = __ballot_sync(kFull, keep);
  const int lane = threadIdx.x & 31;
  int pos = 0;
  if (lane == 0 && m) pos = atomicAdd(counter, __popc(m));
  return __shfl_sync(kFull, pos, 0) + __popc(m & ((1u << lane) - 1u));
}

// reduction slots (8 floats a warp), a witness key a warp, two counters
constexpr int kMisc = 8 * kWarps * 4 + kWarps * 8 + 8;

__host__ __device__ inline size_t smem_bytes(int plan_p, int n_tiles) {
  return static_cast<size_t>(2) * n_tiles * sizeof(float4) +   // witnesses, kept witnesses
         static_cast<size_t>(plan_p) * sizeof(float4) +        // points, u^2
         static_cast<size_t>(2) * n_tiles * sizeof(float) +    // candidate ids, keys
         kMisc + static_cast<size_t>((n_tiles + 31) / 32) * sizeof(unsigned);  // listed mask
}

// the shared memory a block may take without opting in to more
constexpr size_t kSmemMax = 48 * 1024;

inline bool fits(int plan_p, int n_tiles) {
  return plan_p >= 1 && n_tiles >= 1 && smem_bytes(plan_p, n_tiles) <= kSmemMax;
}

__global__ void __launch_bounds__(kThreads)
listed_plan_kernel(const float* __restrict__ pts, const float* __restrict__ tile_c,
                   const float* __restrict__ tile_r, int* __restrict__ order,
                   int* __restrict__ counts, float* __restrict__ lbs, int plan_p, int n_tiles,
                   int t_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* wit = reinterpret_cast<float4*>(smem);
  float4* wkept = wit + n_tiles;
  float4* pt = wkept + n_tiles;
  int* cand = reinterpret_cast<int*>(pt + plan_p);
  float* ckey = reinterpret_cast<float*>(cand + n_tiles);
  float* red = ckey + n_tiles;                       // [kWarps][8] floats
  unsigned long long* near0 = reinterpret_cast<unsigned long long*>(red + 8 * kWarps);  // [kWarps]
  int* n_wkept = reinterpret_cast<int*>(near0 + kWarps);
  int* n_cand = n_wkept + 1;
  unsigned* listed_mask = reinterpret_cast<unsigned*>(n_cand + 1);
  const int n_words = (n_tiles + 31) >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int row = blockIdx.x;
  const float* rp = pts + static_cast<size_t>(row) * plan_p * 3;
  // each thread stages the witnesses it reads first (step 1, same indices)
  for (int t = tid; t < n_tiles; t += kThreads) {
    wit[t] = make_float4(tile_r[t], tile_r[t_pad + t], tile_r[2 * t_pad + t], 0.0f);
  }

  // 1. the row's points and box; a witness near the first point
  float b[6] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F,
                -CUDART_INF_F};
  for (int p = tid; p < plan_p; p += kThreads) {
    const float x = rp[3 * p + 0], y = rp[3 * p + 1], z = rp[3 * p + 2];
    pt[p] = make_float4(x, y, z, 0.0f);
    b[0] = fminf(b[0], x);
    b[1] = fminf(b[1], y);
    b[2] = fminf(b[2], z);
    b[3] = fmaxf(b[3], x);
    b[4] = fmaxf(b[4], y);
    b[5] = fmaxf(b[5], z);
  }
  unsigned long long best = ~0ull;  // (d2 bits, tile id): d2 >= 0 orders as an unsigned
  {
    const float x = rp[0], y = rp[1], z = rp[2];
    for (int t = tid; t < n_tiles; t += kThreads) {
      const float4 w = wit[t];
      const float d = sq3(__fsub_rn(x, w.x), __fsub_rn(y, w.y), __fsub_rn(z, w.z));
      const unsigned long long k =
          (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | static_cast<unsigned>(t);
      best = k < best ? k : best;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, best, off);
    best = o < best ? o : best;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    b[i] = warp_min(b[i]);
    b[3 + i] = warp_max(b[3 + i]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) red[8 * warp + i] = b[i];
    near0[warp] = best;
  }
  if (tid == 0) *n_wkept = *n_cand = 0;
  for (int i = tid; i < n_words; i += kThreads) listed_mask[i] = 0u;
  __syncthreads();  // (also: the witnesses are staged)

#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = red[i];
  best = near0[0];
  for (int w = 1; w < kWarps; ++w) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      b[i] = fminf(b[i], red[8 * w + i]);
      b[3 + i] = fmaxf(b[3 + i], red[8 * w + 3 + i]);
    }
    best = near0[w] < best ? near0[w] : best;
  }
  const float4 w0 = wit[static_cast<int>(best & 0xffffffffull)];

  // 2. U: the row's largest distance to w0 (exact rounded values)
  float u_max = 0.0f;
  for (int p = tid; p < plan_p; p += kThreads) {
    const float4 q = pt[p];
    u_max = fmaxf(u_max, sq3(__fsub_rn(q.x, w0.x), __fsub_rn(q.y, w0.y), __fsub_rn(q.z, w0.z)));
  }
  u_max = warp_max(u_max);
  if (lane == 0) red[8 * warp + 6] = u_max;
  __syncthreads();
  u_max = red[6];
  for (int w = 1; w < kWarps; ++w) u_max = fmaxf(u_max, red[8 * w + 6]);

  // 3. witness cull: keep the witnesses that may be some point's nearest
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + tid;
    bool keep = false;
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (t < n_tiles) {
      w = wit[t];
      keep = sq3(gap_to_point(w.x, b[0], b[3]), gap_to_point(w.y, b[1], b[4]),
                 gap_to_point(w.z, b[2], b[5])) <= u_max;
    }
    const int pos = append_pos(keep, n_wkept);
    if (keep) wkept[pos] = w;
  }
  __syncthreads();

  // 4. per point, the inflated squared distance to the nearest witness
  const int n_w = *n_wkept;
  float m_max = 0.0f;
  for (int p = tid; p < plan_p; p += kThreads) {
    const float4 q = pt[p];
    float d = CUDART_INF_F;
    for (int j = 0; j < n_w; ++j) {
      const float4 w = wkept[j];
      d = fminf(d, sq3(__fsub_rn(q.x, w.x), __fsub_rn(q.y, w.y), __fsub_rn(q.z, w.z)));
    }
    float u = __fsqrt_rn(d);
    u = __fadd_rn(__fmul_rn(u, 1.00001f), 1e-6f);
    const float u2 = __fmul_rn(u, u);
    pt[p].w = u2;
    m_max = fmaxf(m_max, u2);
  }
  m_max = warp_max(m_max);
  if (lane == 0) red[8 * warp + 7] = m_max;
  __syncthreads();
  m_max = red[7];
  for (int w = 1; w < kWarps; ++w) m_max = fmaxf(m_max, red[8 * w + 7]);

  // 5. tile cull: keep the tiles some point may list
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + tid;
    bool keep = false;
    if (t < n_tiles) {
      const float g0 = gap_to_interval(__ldg(tile_c + t), __ldg(tile_c + 3 * t_pad + t), b[0], b[3]);
      const float g1 = gap_to_interval(__ldg(tile_c + t_pad + t), __ldg(tile_c + 4 * t_pad + t), b[1], b[4]);
      const float g2 = gap_to_interval(__ldg(tile_c + 2 * t_pad + t), __ldg(tile_c + 5 * t_pad + t), b[2], b[5]);
      keep = sq3(g0, g1, g2) <= m_max;
    }
    const int pos = append_pos(keep, n_cand);
    if (keep) cand[pos] = t;
  }
  __syncthreads();

  // 6. each warp scans candidate tiles over the row: listed, and the key
  const int n_c = *n_cand;
  for (int c = warp; c < n_c; c += kWarps) {
    const int t = cand[c];
    const float lx = __ldg(tile_c + t), ly = __ldg(tile_c + t_pad + t), lz = __ldg(tile_c + 2 * t_pad + t);
    const float hx = __ldg(tile_c + 3 * t_pad + t), hy = __ldg(tile_c + 4 * t_pad + t);
    const float hz = __ldg(tile_c + 5 * t_pad + t);
    float kmin = CUDART_INF_F;
    bool visit = false;
    for (int p = lane; p < plan_p; p += 32) {
      const float4 a = pt[p];
      // distance to the interval [lo, hi] along each axis
      const float lb2 = sq3(__fsub_rn(fminf(fmaxf(a.x, lx), hx), a.x),
                            __fsub_rn(fminf(fmaxf(a.y, ly), hy), a.y),
                            __fsub_rn(fminf(fmaxf(a.z, lz), hz), a.z));
      visit |= lb2 <= a.w;
      kmin = fminf(kmin, lb2);
    }
    kmin = warp_min(kmin);
    visit = __any_sync(kFull, visit);
    if (lane == 0) {
      ckey[c] = visit ? kmin : CUDART_INF_F;
      if (visit) atomicOr(&listed_mask[t >> 5], 1u << (t & 31));
    }
  }
  __syncthreads();

  // 7. the stable order in closed form
  int n_listed = 0;
  for (int i = 0; i < n_words; ++i) n_listed += __popc(listed_mask[i]);
  int* order_row = order + static_cast<size_t>(row) * n_tiles;
  float* lbs_row = lbs + static_cast<size_t>(row) * n_tiles;
  for (int t = tid; t < n_tiles; t += kThreads) {
    const unsigned word = listed_mask[t >> 5];
    int rank;
    float k = CUDART_INF_F;
    if ((word >> (t & 31)) & 1u) {
      // listed: the listed tiles with a smaller key, or an equal key and a
      // smaller id (the candidates not listed have key inf)
      for (int j = 0; j < n_c; ++j) {
        if (cand[j] == t) k = ckey[j];
      }
      rank = 0;
      for (int j = 0; j < n_c; ++j) {
        const float kj = ckey[j];
        rank += (kj < k) || (kj == k && cand[j] < t);
      }
    } else {
      // unlisted: behind every listed tile, in id order
      int below = __popc(word & ((1u << (t & 31)) - 1u));
      for (int i = 0; i < (t >> 5); ++i) below += __popc(listed_mask[i]);
      rank = n_listed + (t - below);
    }
    order_row[rank] = t;
    lbs_row[rank] = k;
  }
  if (tid == 0) counts[row] = n_listed;
}

}  // namespace

// Dynamic shared memory of a block, in bytes.
extern "C" int listed_plan_smem(int plan_p, int n_tiles) {
  return static_cast<int>(smem_bytes(plan_p, n_tiles));
}

// 1 if the launcher takes this row size and tile count (the block's shared
// memory fits), else 0.
extern "C" int listed_plan_fits(int plan_p, int n_tiles) { return fits(plan_p, n_tiles) ? 1 : 0; }

// Resident blocks per SM at this row size and tile count.
extern "C" int listed_plan_blocks_per_sm(int plan_p, int n_tiles) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, listed_plan_kernel, kThreads,
                                                smem_bytes(plan_p, n_tiles));
  return n;
}

// pts: (n_pts, 3) float32, n_pts a multiple of plan_p; tile_c, tile_r: (8,
// t_pad) float32 (`listed_tables`); order, lbs: (n_pts / plan_p, n_tiles);
// counts: (n_pts / plan_p,). Contiguous, on the stream's device.
// One block a row. Returns cudaGetLastError(), or cudaErrorInvalidValue
// when listed_plan_fits is 0.
extern "C" int listed_plan_launch(const float* pts, const float* tile_c, const float* tile_r,
                                  int* order, int* counts, float* lbs, int n_pts, int plan_p,
                                  int n_tiles, int t_pad, void* stream) {
  if (!fits(plan_p, n_tiles)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n_pts / plan_p;
  if (rows > 0) {
    listed_plan_kernel<<<rows, kThreads, smem_bytes(plan_p, n_tiles), static_cast<cudaStream_t>(stream)>>>(
        pts, tile_c, tile_r, order, counts, lbs, plan_p, n_tiles, t_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
