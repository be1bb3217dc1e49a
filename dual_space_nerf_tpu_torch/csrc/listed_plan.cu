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
// Bound on the H100: operations (~23 FP32 ops per point-tile pair, 1.5e9 for
// a 524,288-point search of 128 tiles, against ~10 MB moved).
//
// Design: one thread block per row. Witnesses and AABBs of all tiles sit in
// shared memory. Phase 1 gives each point a thread (u_p^2, kept in shared
// memory with the point); phase 2 gives each tile a thread that walks the
// row's points by broadcast; a bitonic sort of 64-bit (key bits, tile id)
// pairs in shared memory orders the row. Keys are sums of squares, so their
// bit patterns sort as unsigned integers, and the tile id in the low word
// makes the order that of a stable sort.
//
// Exactness: only min, max and any are reduced, and the arithmetic is spelled
// with __fsub_rn/__fmul_rn/__fadd_rn/__fsqrt_rn in the plain version's order
// (ops/pruned_knn.py:listed_plan_plain), so order, counts and keys equal the
// plain version's bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float sq3(float ex, float ey, float ez) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
}

// shared memory: float4 pt[plan_p] (x, y, z, u^2), unsigned long long
// keys[n_sort], float tab[9][n_tiles] (witness xyz, lo xyz, hi xyz).
__global__ void __launch_bounds__(kThreads)
listed_plan_kernel(const float* __restrict__ pts, const float* __restrict__ tile_c,
                   const float* __restrict__ tile_r, int* __restrict__ order,
                   int* __restrict__ counts, float* __restrict__ lbs, int plan_p,
                   int n_tiles, int t_pad, int n_sort) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* pt = reinterpret_cast<float4*>(smem);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(pt + plan_p);
  float* tab = reinterpret_cast<float*>(keys + n_sort);
  const int tid = threadIdx.x;
  const int row = blockIdx.x;

  for (int j = tid; j < 3 * n_tiles; j += kThreads) {
    const int dim = j / n_tiles, t = j - dim * n_tiles;
    tab[j] = tile_r[dim * t_pad + t];                         // witness
    tab[3 * n_tiles + j] = tile_c[dim * t_pad + t];           // AABB lo
    tab[6 * n_tiles + j] = tile_c[(3 + dim) * t_pad + t];     // AABB hi
  }
  __syncthreads();
  const float* wx = tab;
  const float* wy = tab + n_tiles;
  const float* wz = tab + 2 * n_tiles;

  // phase 1: per point, the inflated squared distance to the nearest witness
  for (int p = tid; p < plan_p; p += kThreads) {
    const float* src = pts + 3 * (static_cast<size_t>(row) * plan_p + p);
    const float x = src[0], y = src[1], z = src[2];
    float d = CUDART_INF_F;
    for (int t = 0; t < n_tiles; ++t) {
      d = fminf(d, sq3(__fsub_rn(x, wx[t]), __fsub_rn(y, wy[t]), __fsub_rn(z, wz[t])));
    }
    float u = __fsqrt_rn(d);
    u = __fadd_rn(__fmul_rn(u, 1.00001f), 1e-6f);
    pt[p] = make_float4(x, y, z, __fmul_rn(u, u));
  }
  __syncthreads();

  // phase 2: per tile, is it listed for the row, and its smallest bound
  for (int t = tid; t < n_sort; t += kThreads) {
    float key = CUDART_INF_F;
    if (t < n_tiles) {
      const float lx = tab[3 * n_tiles + t], ly = tab[4 * n_tiles + t], lz = tab[5 * n_tiles + t];
      const float hx = tab[6 * n_tiles + t], hy = tab[7 * n_tiles + t], hz = tab[8 * n_tiles + t];
      bool visit = false;
      for (int p = 0; p < plan_p; ++p) {
        const float4 q = pt[p];
        // distance to the interval [lo, hi] along each axis
        const float lb2 = sq3(__fsub_rn(fminf(fmaxf(q.x, lx), hx), q.x),
                              __fsub_rn(fminf(fmaxf(q.y, ly), hy), q.y),
                              __fsub_rn(fminf(fmaxf(q.z, lz), hz), q.z));
        visit |= lb2 <= q.w;
        key = fminf(key, lb2);
      }
      if (!visit) key = CUDART_INF_F;
    }
    // tiles past n_tiles pad the sort and stay behind every real tile
    keys[t] = t < n_tiles
        ? (static_cast<unsigned long long>(__float_as_uint(key)) << 32) | static_cast<unsigned>(t)
        : ~0ull;
  }
  __syncthreads();

  // bitonic sort of n_sort (a power of two) keys, ascending
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n_sort; i += kThreads) {
        const int partner = i ^ j;
        if (partner > i) {
          const unsigned long long a = keys[i], b = keys[partner];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // the lists come out sorted, so the listed tiles are the finite prefix
  for (int i = tid; i < n_tiles; i += kThreads) {
    const float key = __uint_as_float(static_cast<unsigned>(keys[i] >> 32));
    order[static_cast<size_t>(row) * n_tiles + i] = static_cast<int>(keys[i] & 0xffffffffull);
    lbs[static_cast<size_t>(row) * n_tiles + i] = key;
    const bool listed = key < CUDART_INF_F;
    const bool next_listed =
        i + 1 < n_tiles && __uint_as_float(static_cast<unsigned>(keys[i + 1] >> 32)) < CUDART_INF_F;
    if (listed && !next_listed) counts[row] = i + 1;
    if (i == 0 && !listed) counts[row] = 0;
  }
}

}  // namespace

// pts: (n_pts, 3) float32, n_pts a multiple of plan_p; tile_c, tile_r: (8,
// t_pad) float32 (`listed_tables`); order, lbs: (n_pts / plan_p, n_tiles);
// counts: (n_pts / plan_p,). n_sort: the power of two >= n_tiles. Contiguous,
// on the stream's device. Returns cudaGetLastError(), or cudaErrorInvalidValue
// when the row does not fit the 48 KB of static-limit shared memory.
extern "C" int listed_plan_launch(const float* pts, const float* tile_c, const float* tile_r,
                                  int* order, int* counts, float* lbs, int n_pts, int plan_p,
                                  int n_tiles, int t_pad, int n_sort, void* stream) {
  const size_t smem = static_cast<size_t>(plan_p) * sizeof(float4) +
                      static_cast<size_t>(n_sort) * sizeof(unsigned long long) +
                      static_cast<size_t>(9) * n_tiles * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pts > 0) {
    listed_plan_kernel<<<n_pts / plan_p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        pts, tile_c, tile_r, order, counts, lbs, plan_p, n_tiles, t_pad, n_sort);
  }
  return static_cast<int>(cudaGetLastError());
}
