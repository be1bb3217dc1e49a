// Geometry-guided near/far tightening (GG), for Hopper (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/gg_pallas.py:_gg_kernel
// (wrapper gg_near_far_pallas). For each ray: the smallest entry z and the
// largest exit z over gamma-spheres around all V mesh vertices, with every
// ray starting at ray_o[0] (pinhole camera, as in the reference), z taken
// along the unit direction and divided by |ray_d|. A ray that touches no
// sphere keeps its near/far.
//
// Bound on the H100: operations. One launch of the render's main path is
// 8192 rays x 6890 vertices = 5.6e7 (ray, vertex) pairs of ~8 FP32 ops, read
// from a 110 KB vertex table; the bytes (rays in, near/far out, the table
// once) are under 0.3 MB.
//
// Design: a prologue kernel turns the vertices into one float4 per vertex,
// (v - o, |v - o|^2), so the pair loop does no per-vertex setup. Then one
// warp per ray: its 32 lanes stride over the table with coalesced 16-byte
// loads (the table stays in L1/L2 for every warp of an SM), keep a running
// min/max in registers, and meet in a shuffle reduction. The sqrt runs only
// for the few vertices that are inside. 8192 rays make 8192 warps, enough to
// fill all 132 SMs, which one thread per ray (8192 threads) would not.
//
// Every operation is spelled with an IEEE-rounded intrinsic in the plain
// version's order (geometry/sampling.py:gg_near_far), so nvcc cannot fuse a
// multiply and an add into an FMA and the result equals the plain version
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 99999.0f;
constexpr int kThreads = 256;  // 8 rays (warps) per block

__global__ void gg_rel_kernel(const float* __restrict__ verts,
                              const float* __restrict__ ray_o,
                              float4* __restrict__ rel, int n_verts) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_verts) return;
  const float rx = __fsub_rn(verts[3 * v + 0], ray_o[0]);
  const float ry = __fsub_rn(verts[3 * v + 1], ray_o[1]);
  const float rz = __fsub_rn(verts[3 * v + 2], ray_o[2]);
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                             __fmul_rn(rz, rz));
  rel[v] = make_float4(rx, ry, rz, r2);
}

__global__ void __launch_bounds__(kThreads)
gg_kernel(const float4* __restrict__ rel, const float* __restrict__ ray_d,
          const float* __restrict__ near, const float* __restrict__ far,
          float* __restrict__ near_out, float* __restrict__ far_out,
          int n_rays, int n_verts, float gamma2) {
  const int ray = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (ray >= n_rays) return;  // uniform across the warp

  const float x = ray_d[3 * ray + 0];
  const float y = ray_d[3 * ray + 1];
  const float z = ray_d[3 * ray + 2];
  const float norm = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z)));
  const float dx = __fdiv_rn(x, norm);
  const float dy = __fdiv_rn(y, norm);
  const float dz = __fdiv_rn(z, norm);

  float z_min = kBig;
  float z_max = -kBig;
  for (int v = lane; v < n_verts; v += 32) {
    const float4 r = __ldg(&rel[v]);
    const float z0 = __fadd_rn(__fadd_rn(__fmul_rn(dx, r.x), __fmul_rn(dy, r.y)),
                               __fmul_rn(dz, r.z));
    const float d2 = __fsub_rn(r.w, __fmul_rn(z0, z0));
    if (d2 < gamma2) {
      const float delta = __fsqrt_rn(fmaxf(__fsub_rn(gamma2, d2), 0.0f));
      z_min = fminf(z_min, __fsub_rn(z0, delta));
      z_max = fmaxf(z_max, __fadd_rn(z0, delta));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    z_min = fminf(z_min, __shfl_xor_sync(0xffffffffu, z_min, off));
    z_max = fmaxf(z_max, __shfl_xor_sync(0xffffffffu, z_max, off));
  }
  if (lane == 0) {
    const float zn = __fdiv_rn(z_min, norm);
    const float zf = __fdiv_rn(z_max, norm);
    const bool hit = (z_min < kBig) && (zn < zf);
    near_out[ray] = hit ? zn : near[ray];
    far_out[ray] = hit ? zf : far[ray];
  }
}

}  // namespace

// ray_o, ray_d: (n_rays, 3); near, far, near_out, far_out: (n_rays,);
// verts: (n_verts, 3); rel: (n_verts, 4) scratch. All float32, contiguous,
// on the stream's device. Returns cudaGetLastError() after the launches.
extern "C" int gg_near_far_launch(const float* ray_o, const float* ray_d,
                                  const float* near, const float* far,
                                  const float* verts, float* rel,
                                  float* near_out, float* far_out, int n_rays,
                                  int n_verts, float gamma2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rays > 0 && n_verts > 0) {
    gg_rel_kernel<<<(n_verts + 255) / 256, 256, 0, s>>>(
        verts, ray_o, reinterpret_cast<float4*>(rel), n_verts);
    const int rays_per_block = kThreads / 32;
    gg_kernel<<<(n_rays + rays_per_block - 1) / rays_per_block, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(rel), ray_d, near, far, near_out,
        far_out, n_rays, n_verts, gamma2);
  }
  return static_cast<int>(cudaGetLastError());
}
