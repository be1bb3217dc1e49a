// Sphere-pruned exact nearest-face search over 512-face tiles (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/pruned_knn.py:_pruned_kernel
// (wrapper pruned_search_presorted). The centroids arrive in kd order, cut
// into tiles of 512 with a bounding sphere each (padded slots at 1e15). For
// every block of block_p consecutive points the kernel takes the block's own
// bounding sphere, a lower bound lb[t] = |tile center - block center| -
// tile radius - block radius per tile, seeds every point's best from the tile
// with the smallest bound, and then visits the tiles in index order, skipping
// each whose bound is not below the threshold sqrt(max over points of best),
// tightened after a visit. The result is the exact argmin of
//   d2 = (dx*dx + dy*dy) + dz*dz
// as a kd-order id (tile * 512 + lane).
//
// Bound on the H100: operations (9 FP32 ops per visited point-centroid pair;
// the visited share depends on how tight the blocks are).
//
// Design: one thread per point, the running best in registers; the thread
// block IS the point block, so the sphere, the threshold and the skip test
// are block reductions and a uniform branch. Only min and max are reduced,
// which makes every value independent of the reduction order: the block
// center is the midpoint of the points' bounding box (the TPU kernel takes
// their mean, whose rounding depends on the order of the sum), so the plain
// version (ops/pruned_knn.py:pruned_search_plain) reproduces every bound bit
// for bit. Each visited tile is staged through shared memory (512 float4,
// double buffered) and read by broadcast.
//
// Tie rule (exact ties in d2), kept from the TPU kernel: per LANE (position
// in its tile) the first-visited tile keeps the lane, the seed tile being
// visited first; among the lanes at the minimum the smallest id wins. A
// per-thread 512-bit lane mask records which lanes already hold the current
// minimum: cleared on a strict improvement, read only on a tie.
//
// Exactness: __fsub_rn/__fmul_rn/__fadd_rn/__fsqrt_rn in the plain version's
// order, so nvcc contracts nothing and the ids equal the plain version's.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 512;       // centroid slots per tile
constexpr int kWords = kTile / 32;
constexpr int kMaxTiles = 1024;  // lower bounds kept in shared memory

__device__ __forceinline__ float dist2(float px, float py, float pz, float cx, float cy,
                                       float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// max (or min) of v over the block, returned to every thread. blockDim.x is a
// multiple of 32. min and max do not depend on the order of the reduction.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, other) : fminf(v, other);
  }
  __syncthreads();  // red is no longer read
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int k = 1; k < (blockDim.x >> 5); ++k) r = kMax ? fmaxf(r, red[k]) : fminf(r, red[k]);
  return r;
}

struct Best {
  float d2;
  int id;
  unsigned mask[kWords];  // lanes that hold the minimum
};

__device__ __forceinline__ void visit(Best& b, const float4* tile, int base, float px,
                                      float py, float pz) {
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    unsigned m = b.mask[w];
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const int lane = w * 32 + k;
      const float4 c = tile[lane];
      const float d2 = dist2(px, py, pz, c.x, c.y, c.z);
      if (d2 < b.d2) {
        b.d2 = d2;
        b.id = base + lane;
#pragma unroll
        for (int j = 0; j < kWords; ++j) b.mask[j] = 0u;
        m = 1u << k;
      } else if (d2 == b.d2 && !((m >> k) & 1u)) {
        m |= 1u << k;
        b.id = min(b.id, base + lane);
      }
    }
    b.mask[w] = m;
  }
}

__global__ void __launch_bounds__(1024)
pruned_kernel(const float* __restrict__ pts, const float* __restrict__ cent_t,
              const float* __restrict__ tile_c, const float* __restrict__ tile_r,
              int* __restrict__ out, int n_tiles, int f_pad, int t_pad, int tighten) {
  __shared__ float4 tile[2][kTile];
  __shared__ float lb[kMaxTiles];
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * blockDim.x + tid;
  const float px = pts[3 * i + 0];
  const float py = pts[3 * i + 1];
  const float pz = pts[3 * i + 2];

  // the block's sphere: bounding-box midpoint, farthest point
  const float cx = __fmul_rn(0.5f, __fadd_rn(block_reduce<false>(px, red), block_reduce<true>(px, red)));
  const float cy = __fmul_rn(0.5f, __fadd_rn(block_reduce<false>(py, red), block_reduce<true>(py, red)));
  const float cz = __fmul_rn(0.5f, __fadd_rn(block_reduce<false>(pz, red), block_reduce<true>(pz, red)));
  const float rho = __fsqrt_rn(block_reduce<true>(dist2(px, py, pz, cx, cy, cz), red));

  for (int t = tid; t < n_tiles; t += blockDim.x) {
    const float d = __fsqrt_rn(dist2(tile_c[t], tile_c[t_pad + t], tile_c[2 * t_pad + t], cx, cy, cz));
    lb[t] = __fsub_rn(__fsub_rn(d, tile_r[t]), rho);
  }
  __syncthreads();
  int t0 = 0;
  for (int t = 1; t < n_tiles; ++t) {
    if (lb[t] < lb[t0]) t0 = t;
  }

  Best b;
  b.d2 = CUDART_INF_F;
  b.id = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) b.mask[j] = 0u;

  int buf = 0;
  float thresh = CUDART_INF_F;
  // v = -1 is the seed tile t0; then every tile in index order
  for (int v = -1; v < n_tiles; ++v) {
    const int t = v < 0 ? t0 : v;
    if (v >= 0 && (t == t0 || !(lb[t] < thresh))) continue;
    for (int j = tid; j < kTile; j += blockDim.x) {
      const int s = t * kTile + j;
      tile[buf][j] = make_float4(cent_t[s], cent_t[f_pad + s], cent_t[2 * f_pad + s], 0.0f);
    }
    // the other buffer was last read before the previous visit's barrier
    __syncthreads();
    visit(b, tile[buf], t * kTile, px, py, pz);
    buf ^= 1;
    if (v < 0 || (tighten > 0 && (v + 1) % tighten == 0)) {
      thresh = __fsqrt_rn(block_reduce<true>(b.d2, red));
    }
  }
  out[i] = b.id;
}

}  // namespace

// pts: (n_pts, 3) float32, n_pts a multiple of block_p; cent_t: (3, f_pad)
// float32 in kd order, f_pad = n_tiles * 512; tile_c, tile_r: (8, t_pad)
// float32 (rows 0..2 the tile centers, row 0 the radii); out: (n_pts,) int32
// kd-order ids. block_p: a multiple of 32, at most 1024; n_tiles <= 1024.
// tighten: 0 keeps the seed threshold, k > 0 tightens after a visited tile
// whose index + 1 is a multiple of k. Returns cudaGetLastError().
extern "C" int pruned_knn_launch(const float* pts, const float* cent_t, const float* tile_c,
                                 const float* tile_r, int* out, int n_pts, int block_p,
                                 int n_tiles, int f_pad, int t_pad, int tighten,
                                 void* stream) {
  if (n_pts > 0) {
    pruned_kernel<<<n_pts / block_p, block_p, 0, static_cast<cudaStream_t>(stream)>>>(
        pts, cent_t, tile_c, tile_r, out, n_tiles, f_pad, t_pad, tighten);
  }
  return static_cast<int>(cudaGetLastError());
}
