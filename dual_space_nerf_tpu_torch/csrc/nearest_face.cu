// Brute-force nearest face (K=1 nearest triangle centroid), for Hopper (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/nearest_face.py:_nearest_kernel
// (wrapper nearest_face_pallas). For each point, the index of the centroid
// with the smallest squared distance d2 = (dx*dx + dy*dy) + dz*dz in float32;
// on a tie the smallest index wins.
//
// Bound on the H100: operations. A search of the render's main path is
// 524,288 points x 13,776 centroids = 7.2e9 pairs of ~9 FP32 ops (3 sub,
// 3 mul, 2 add, 1 compare); it moves only 6.3 MB (points, centroids, ids).
//
// Design: one thread per point keeps its running best (distance, index) in
// registers. The block stages the centroids through shared memory in tiles
// of 2048 float4 (32 KB); every thread of a warp reads the same centroid at
// once, a broadcast without bank conflicts. Faces are visited in increasing
// index with a strict '<', which gives the smallest index on a tie.
//
// Exactness: the arithmetic is spelled with __fsub_rn/__fmul_rn/__fadd_rn
// in the plain version's order (ops/nearest_face.py:nearest_face_plain).
// Otherwise nvcc contracts a*a + b*b into an FMA and breaks float32 near-ties
// differently from the plain version. The expanded form
// |p|^2 - 2 p.c + |c|^2 is not used: it misranks near-ties.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

__global__ void __launch_bounds__(kThreads)
nearest_face_kernel(const float* __restrict__ pts, const float* __restrict__ cents,
                    int* __restrict__ out, int n_pts, int n_faces) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_pts;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (valid) {
    px = pts[3 * i + 0];
    py = pts[3 * i + 1];
    pz = pts[3 * i + 2];
  }
  float best = CUDART_INF_F;
  int best_i = 0;
  for (int start = 0; start < n_faces; start += kTile) {
    const int nt = min(kTile, n_faces - start);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < nt; j += blockDim.x) {
      const float* c = cents + 3 * (start + j);
      tile[j] = make_float4(c[0], c[1], c[2], 0.0f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < nt; ++j) {
      const float4 c = tile[j];
      const float dx = __fsub_rn(px, c.x);
      const float dy = __fsub_rn(py, c.y);
      const float dz = __fsub_rn(pz, c.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 < best) {
        best = d2;
        best_i = start + j;
      }
    }
  }
  if (valid) out[i] = best_i;
}

}  // namespace

// pts: (n_pts, 3) float32; cents: (n_faces, 3) float32; out: (n_pts,) int32.
// Contiguous, on the stream's device. Returns cudaGetLastError().
extern "C" int nearest_face_launch(const float* pts, const float* cents, int* out,
                                   int n_pts, int n_faces, void* stream) {
  if (n_pts > 0) {
    nearest_face_kernel<<<(n_pts + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(pts, cents, out,
                                                               n_pts, n_faces);
  }
  return static_cast<int>(cudaGetLastError());
}
