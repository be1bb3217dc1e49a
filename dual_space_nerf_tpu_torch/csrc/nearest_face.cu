// Brute-force nearest face (K=1 nearest triangle centroid), for Hopper (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/nearest_face.py:_nearest_kernel
// (wrapper nearest_face_pallas). For each point, the index of the centroid
// with the smallest squared distance d2 = (dx*dx + dy*dy) + dz*dz in float32;
// on a tie the smallest index wins.
//
// Bound on the H100: instruction issue. A search of the render's main path
// is 524,288 points x 13,776 centroids = 7.2e9 pairs; it moves only 6.3 MB
// (points, centroids, ids). Each pair needs 3 sub, 3 mul, 2 add and one
// compare, and the tie rule forbids fusing any of them into an FMA (below),
// so 9 issued FP32 instructions a pair: at 33.5e12 single instructions per
// second (132 SMs x 128 lanes x 1.98 GHz) that is a floor of 1.94 ms, twice
// the 67 TFLOP/s bound, which counts an FMA as two operations. Every other
// instruction a pair issues (a shared-memory load, a select, a branch) is
// time above that floor.
//
// Design:
// - kPts points per thread, in registers: one broadcast read of a centroid
//   from shared memory serves all of them (6 LDS.128 for 8 centroids and
//   kPts points). 4 points a thread (1024-point blocks) measured faster than
//   8 (2048) at both main-path shapes: more blocks even out the SMs' rounds,
//   and fewer registers leave room for more blocks per SM.
// - Centroid tiles of kTile are copied into a ring of kStages shared-memory
//   stages with cp.async (16-byte copies of the (F, 3) array as it lies in
//   memory), so tile t+1 is in flight while tile t is computed. The 220 KB
//   of centroids stay in L2.
// - The argmin runs by chunks of kChunk centroids: per point one fminf per
//   pair, then the chunk's minimum is compared with the running best, all
//   kPts points in one basic block and one branch a chunk (a branch per
//   point ends the block and serialises the points). Only when a minimum is
//   strictly smaller is the first index in the chunk that attains it found,
//   by recomputing the chunk's distances (the same roundings, so the same
//   values). Chunks are visited in increasing index and compared with '<',
//   so a tie keeps the smallest index.
// - Face split (grid.y, chosen by the wrapper when there are too few point
//   blocks to fill the SMs evenly, as at the training step's 352,000
//   points): each split searches a range of faces and merges with a 64-bit
//   atomicMin on (float_as_uint(d2) << 32) | index. For d2 >= 0 the key
//   orders by distance, then by index: the tie rule, whatever the order in
//   which blocks finish, so every run gives the same ids.
//
// Barrier order of the ring (one __syncthreads per tile): at the top of
// iteration t every thread waits until its own copies of tile t have landed
// (cp.async.wait_group kStages-2), then the barrier makes every thread's
// copies visible and guarantees that every thread has finished computing
// tile t-1; only then is tile t+kStages-1 issued, into tile t-1's stage.
//
// Exactness: the arithmetic is spelled with __fsub_rn/__fmul_rn/__fadd_rn
// in the plain version's order (ops/nearest_face.py:nearest_face_plain).
// Otherwise nvcc contracts a*a + b*b into an FMA and breaks float32 near-ties
// differently from the plain version. The expanded form
// |p|^2 - 2 p.c + |c|^2 is not used: it misranks near-ties. fminf and the
// strict compare are exact.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPts = 4;                      // points per thread
constexpr int kBlockPts = kThreads * kPts;   // points per block
constexpr int kTile = 1024;                  // centroids per stage (12 KB)
constexpr int kStages = 2;
constexpr int kChunk = 8;                    // centroids per fminf chunk
static_assert(kTile % kChunk == 0 && kChunk % 4 == 0, "chunks are whole float4 groups");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dist2(float px, float py, float pz, float cx, float cy,
                                       float cz) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// min over the chunk of d2, as a tree (depth 3 for 8); fminf is exact, so
// the order does not change the value
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

// Copy centroids [t0, t0 + nt) into a stage (floats in the (F, 3) order),
// t0 a multiple of 4 so that the 16-byte copies are aligned; the floats
// after the last whole 16 bytes go by 4-byte copies, and the stage is padded
// with +inf up to a whole chunk (d2 = inf is never below the running best).
__device__ __forceinline__ void issue_tile(float* stage, const float* __restrict__ cents,
                                           int t0, int nt) {
  const float* src = cents + 3 * t0;
  const int n_floats = 3 * nt;
  const int n_vec = n_floats / 4;
  for (int q = threadIdx.x; q < n_vec; q += kThreads) cp_async16(stage + 4 * q, src + 4 * q);
  const int tail = 4 * n_vec + threadIdx.x;
  if (tail < n_floats) cp_async4(stage + tail, src + tail);
  const int n_pad = 3 * (((nt + kChunk - 1) / kChunk) * kChunk);
  for (int q = n_floats + threadIdx.x; q < n_pad; q += kThreads) stage[q] = CUDART_INF_F;
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads, 2)
nearest_face_kernel(const float* __restrict__ pts, const float* __restrict__ cents,
                    int* __restrict__ out, unsigned long long* __restrict__ keys, int n_pts,
                    int n_faces, int faces_per_split) {
  __shared__ __align__(16) float ring[kStages][3 * kTile];
  const int f_begin = blockIdx.y * faces_per_split;
  const int f_end = min(n_faces, f_begin + faces_per_split);
  const int n_tiles = f_begin < f_end ? (f_end - f_begin + kTile - 1) / kTile : 0;
  const int i0 = blockIdx.x * kBlockPts + threadIdx.x;

  float px[kPts], py[kPts], pz[kPts], best[kPts];
  int best_i[kPts];
#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int i = i0 + k * kThreads;
    const bool valid = i < n_pts;
    px[k] = valid ? pts[3 * i + 0] : 0.0f;
    py[k] = valid ? pts[3 * i + 1] : 0.0f;
    pz[k] = valid ? pts[3 * i + 2] : 0.0f;
    best[k] = CUDART_INF_F;
    best_i[k] = 0;
  }

  // prologue: the first kStages-1 tiles in flight, one commit group each
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      const int t0 = f_begin + s * kTile;
      issue_tile(ring[s], cents, t0, min(kTile, f_end - t0));
    }
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile t have landed
    __syncthreads();               // everyone's have; tile t-1 is no longer read
    {
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        const int t0 = f_begin + tn * kTile;
        issue_tile(ring[tn % kStages], cents, t0, min(kTile, f_end - t0));
      }
      cp_async_commit();  // an empty group at the end keeps the count
    }
    const int start = f_begin + t * kTile;
    const int nt = min(kTile, f_end - start);
    const float4* s4 = reinterpret_cast<const float4*>(ring[t % kStages]);
    for (int c = 0; c < nt; c += kChunk) {
      // kChunk centroids by broadcast: 4 centroids in 3 float4
      float cx[kChunk], cy[kChunk], cz[kChunk];
#pragma unroll
      for (int g = 0; g < kChunk / 4; ++g) {
        const float4 a = s4[3 * (c / 4 + g) + 0];
        const float4 b = s4[3 * (c / 4 + g) + 1];
        const float4 e = s4[3 * (c / 4 + g) + 2];
        cx[4 * g + 0] = a.x; cy[4 * g + 0] = a.y; cz[4 * g + 0] = a.z;
        cx[4 * g + 1] = a.w; cy[4 * g + 1] = b.x; cz[4 * g + 1] = b.y;
        cx[4 * g + 2] = b.z; cy[4 * g + 2] = b.w; cz[4 * g + 2] = e.x;
        cx[4 * g + 3] = e.y; cy[4 * g + 3] = e.z; cz[4 * g + 3] = e.w;
      }
      // the chunk's minimum for every point (one basic block, kPts x kChunk
      // independent pairs), then one branch for all of them
      float m[kPts];
      bool hit = false;
#pragma unroll
      for (int k = 0; k < kPts; ++k) {
        m[k] = chunk_min(px[k], py[k], pz[k], cx, cy, cz);
        hit |= m[k] < best[k];
      }
      if (hit) {  // rare after the first tiles: recompute to find the index
#pragma unroll
        for (int k = 0; k < kPts; ++k) {
          if (m[k] < best[k]) {
            int jm = kChunk - 1;
#pragma unroll
            for (int j = kChunk - 2; j >= 0; --j)
              jm = dist2(px[k], py[k], pz[k], cx[j], cy[j], cz[j]) == m[k] ? j : jm;
            best[k] = m[k];
            best_i[k] = start + c + jm;
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int k = 0; k < kPts; ++k) {
    const int i = i0 + k * kThreads;
    if (i < n_pts) {
      if (kSplit) {
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(best[k])) << 32) |
            static_cast<unsigned>(best_i[k]);
        atomicMin(keys + i, key);
      } else {
        out[i] = best_i[k];
      }
    }
  }
}

__global__ void unpack_kernel(const unsigned long long* __restrict__ keys, int* __restrict__ out,
                              int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<int>(keys[i] & 0xffffffffull);
}

}  // namespace

// pts: (n_pts, 3) float32; cents: (n_faces, 3) float32, 16-byte aligned;
// out: (n_pts,) int32; splits >= 1 face ranges (grid.y); keys: (n_pts,)
// uint64 scratch, read only when splits > 1 (the launcher fills it with
// ~0, the kernel merges into it, a second kernel unpacks the ids).
// Contiguous, on the stream's device. Returns cudaGetLastError().
extern "C" int nearest_face_launch(const float* pts, const float* cents, int* out, void* keys,
                                   int n_pts, int n_faces, int splits, void* stream) {
  if (n_pts <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // face ranges start on a multiple of 4 (aligned 16-byte copies)
  const int per = ((n_faces + splits - 1) / splits + 3) / 4 * 4;
  const dim3 grid((n_pts + kBlockPts - 1) / kBlockPts, splits);
  if (splits > 1) {
    auto* k = static_cast<unsigned long long*>(keys);
    cudaMemsetAsync(k, 0xff, sizeof(unsigned long long) * static_cast<size_t>(n_pts), s);
    nearest_face_kernel<true><<<grid, kThreads, 0, s>>>(pts, cents, out, k, n_pts, n_faces, per);
    unpack_kernel<<<(n_pts + 255) / 256, 256, 0, s>>>(k, out, n_pts);
  } else {
    nearest_face_kernel<false><<<grid, kThreads, 0, s>>>(pts, cents, out, nullptr, n_pts,
                                                         n_faces, per);
  }
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the kernel (split or not): the occupancy query
// that chip_smoke.py reports beside the build's registers.
extern "C" int nearest_face_blocks_per_sm(int split) {
  int blocks = 0;
  if (split) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, nearest_face_kernel<true>, kThreads, 0);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, nearest_face_kernel<false>, kThreads, 0);
  }
  return blocks;
}

// Points per block, for the wrapper's choice of splits.
extern "C" int nearest_face_block_points(int) { return kBlockPts; }
