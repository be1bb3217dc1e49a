// Geometry-guided near/far tightening (GG), for Hopper (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/gg_pallas.py:_gg_kernel
// (wrapper gg_near_far_pallas). For each ray: the smallest entry z and the
// largest exit z over gamma-spheres around all V mesh vertices, with every
// ray starting at ray_o[0] (pinhole camera, as in the reference), z taken
// along the unit direction and divided by |ray_d|. A ray that touches no
// sphere keeps its near/far.
//
// Bound on the H100: instruction issue. One launch of the render's main
// path is 8192 rays x 6890 vertices = 5.6e7 (ray, vertex) pairs; the bytes
// (rays in, near/far out, the vertices once) are under 0.3 MB. The kernel
// must equal its plain version bit for bit, so no multiply and add may fuse
// into an FMA: a pair costs 8 single FP32 instructions (z0: 3 mul, 2 add;
// d2: mul, sub; the compare) and a pair inside a sphere 7 more.
//
// Design: one launch, one block per tile of 32 consecutive rays (adjacent
// pixels in a render chunk). The 32 lanes of each warp are the tile's rays
// and the block's 16 warps split the vertices, so one broadcast 16-byte
// shared load serves 32 pairs. The block stages the vertices in passes of
// 1024 as (v - o, |v - o|^2), computed in the plain version's rounding
// order, keeps only those whose sphere may touch a ray of the tile (the
// cull, below), and the warps walk that list two vertices at a time (two
// independent chains) while each thread's loads of the next pass are in
// flight. At these sizes the kernel is bound by latency more than by issue,
// hence 16 warps a block. Each ray's min/max meets over the warps in shared
// memory; min and max are exact in any order, so neither the split nor the
// list's order (an atomic counter) changes a bit. Measured on the H100 and
// dropped: 2 or 4 rays a thread (fewer, longer blocks: slower at both the
// render's 8192 rays and the step's 5500).
//
// The cull. Let a be the unit direction of the tile's middle ray and rho the
// largest |d_i - a| over the tile's unit directions d_i. For a vertex r
// (relative to the origin) and every ray of the tile,
//   |r x d_i| >= |r x a| - |r| |d_i - a| >= |r x a| - |r| rho =: lb,
// and |r x d_i| is r's distance from the ray's line (|d_i| = 1 within 3e-7).
// A vertex is dropped for the whole tile when lb > 0 and
// lb^2 > gamma^2 + 1e-4 |r|^2, with lb computed from rho inflated by 1e-3
// relative and 1e-4 absolute, which covers the float rounding of lb itself
// (~1e-6 |r|). The kernel's d2 = |r|^2 - z0^2 differs from the exact squared
// distance by under 2e-6 |r|^2 (a few roundings of terms <= |r|^2, and
// |d_i|^2 = 1 within 6e-7), so a dropped pair has d2 > gamma^2: the plain
// version counts it as outside too, and the result is the same bits. On the
// render's first chunk the cull keeps ~11% of the pairs.
//
// A pair inside a sphere costs a sqrt (~15 instructions with its range
// check) only when its entry or exit can still move the ray's min or max:
// with d2 >= 0 the sqrt is at most sqrt(gamma^2), so z0 -/+ that bound
// brackets both, and rounding is monotone.
//
// Every operation of the result is spelled with an IEEE-rounded intrinsic
// in the plain version's order (geometry/sampling.py:gg_near_far), so nvcc
// cannot fuse a multiply and an add into an FMA and the result equals the
// plain version bit for bit. The cull's own arithmetic is a bound with a
// margin and may round as it likes.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 99999.0f;
constexpr int kWarps = 16;                   // vertex slots of a block
constexpr int kThreads = 32 * kWarps;        // 512; a block's rays: 32
constexpr int kTile = 1024;                  // vertices staged per pass (16 KB)
constexpr int kPer = kTile / kThreads;       // vertices a thread stages per pass

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// a fast square root for the cull's bound (relative error ~1e-7, covered by its margin)
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one inside pair's entry and exit; the sqrt is skipped when neither can
// move: for d2 >= 0, delta <= gmax = sqrt(gamma2), so z0 -/+ delta lies
// within z0 -/+ gmax (both rounded monotonically)
__device__ __forceinline__ void inside(float z0, float d2, float gamma2, float gmax, float& lo,
                                       float& hi) {
  if (d2 >= 0.0f && __fsub_rn(z0, gmax) > lo && __fadd_rn(z0, gmax) < hi) return;
  const float delta = __fsqrt_rn(fmaxf(__fsub_rn(gamma2, d2), 0.0f));
  lo = fminf(lo, __fsub_rn(z0, delta));
  hi = fmaxf(hi, __fadd_rn(z0, delta));
}

// the pairs (this ray, staged vertices a and b) in the plain version's rounding order
__device__ __forceinline__ void pair2(const float4 a, const float4 b, float dx, float dy, float dz,
                                      float& lo, float& hi, float gamma2, float gmax) {
  const float za = __fadd_rn(__fadd_rn(__fmul_rn(dx, a.x), __fmul_rn(dy, a.y)), __fmul_rn(dz, a.z));
  const float zb = __fadd_rn(__fadd_rn(__fmul_rn(dx, b.x), __fmul_rn(dy, b.y)), __fmul_rn(dz, b.z));
  const float da = __fsub_rn(a.w, __fmul_rn(za, za));
  const float db = __fsub_rn(b.w, __fmul_rn(zb, zb));
  if (da < gamma2) inside(za, da, gamma2, gmax, lo, hi);
  if (db < gamma2) inside(zb, db, gamma2, gmax, lo, hi);
}

__global__ void __launch_bounds__(kThreads)
gg_kernel(const float* __restrict__ ray_o, const float* __restrict__ ray_d,
          const float* __restrict__ near, const float* __restrict__ far,
          const float* __restrict__ verts, float* __restrict__ near_out,
          float* __restrict__ far_out, int n_rays, int n_verts, float gamma2) {
  __shared__ float4 rel[kTile];
  __shared__ float red_lo[kWarps][32];
  __shared__ float red_hi[kWarps][32];
  __shared__ int n_kept[2];  // per staged pass, alternating
  __shared__ float rho_s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = blockIdx.x * 32;

  const int ray = min(base + lane, n_rays - 1);  // past the end: computed, not written
  const float norm = __fsqrt_rn(sq3(ray_d[3 * ray + 0], ray_d[3 * ray + 1], ray_d[3 * ray + 2]));
  const float dx = __fdiv_rn(ray_d[3 * ray + 0], norm);
  const float dy = __fdiv_rn(ray_d[3 * ray + 1], norm);
  const float dz = __fdiv_rn(ray_d[3 * ray + 2], norm);
  float lo = kBig, hi = -kBig;
  const float ox = ray_o[0], oy = ray_o[1], oz = ray_o[2];
  const float gmax = __fsqrt_rn(gamma2);

  // the cull's cone: the middle ray's direction a and the tile's radius rho
  const int mid = min(base + 16, n_rays - 1);
  const float mx = ray_d[3 * mid + 0], my = ray_d[3 * mid + 1], mz = ray_d[3 * mid + 2];
  const float inv = 1.0f / sqrtf(mx * mx + my * my + mz * mz);
  const float ax = mx * inv, ay = my * inv, az = mz * inv;
  if (warp == 0) {
    const float ex = dx - ax, ey = dy - ay, ez = dz - az;
    float rho = sqrtf(ex * ex + ey * ey + ez * ez);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) rho = fmaxf(rho, __shfl_xor_sync(0xffffffffu, rho, off));
    if (lane == 0) rho_s = rho * 1.001f + 1e-4f;
  }
  if (tid == 0) n_kept[0] = n_kept[1] = 0;

  // each thread's raw vertices of the next pass, loaded ahead
  float px[kPer], py[kPer], pz[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = i * kThreads + tid;
    if (j < n_verts) {
      px[i] = verts[3 * j + 0];
      py[i] = verts[3 * j + 1];
      pz[i] = verts[3 * j + 2];
    }
  }

  for (int v0 = 0, k = 0; v0 < n_verts; v0 += kTile, ++k) {
    const int cnt = min(kTile, n_verts - v0);
    __syncthreads();  // every thread is done with the previous pass; rho_s and n_kept are set
    int* kept = &n_kept[k & 1];
    const float rho = rho_s;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {  // every thread runs each step: the ballot takes the whole warp
      const int j = i * kThreads + tid;
      float rx = 0.0f, ry = 0.0f, rz = 0.0f, r2 = 0.0f;
      bool keep = j < cnt;
      if (keep) {
        rx = __fsub_rn(px[i], ox);
        ry = __fsub_rn(py[i], oy);
        rz = __fsub_rn(pz[i], oz);
        r2 = sq3(rx, ry, rz);
        const float cx = ry * az - rz * ay, cy = rz * ax - rx * az, cz = rx * ay - ry * ax;
        const float lb = sqrt_approx(cx * cx + cy * cy + cz * cz) - sqrt_approx(r2) * rho;
        keep = !(lb > 0.0f && lb * lb > gamma2 + 1e-4f * r2);
      }
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      int pos = 0;
      if (lane == 0 && m) pos = atomicAdd(kept, __popc(m));
      pos = __shfl_sync(0xffffffffu, pos, 0) + __popc(m & ((1u << lane) - 1u));
      if (keep) rel[pos] = make_float4(rx, ry, rz, r2);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {  // the next pass's vertices, in flight over this pass's pairs
      const int j = v0 + kTile + i * kThreads + tid;
      if (j < n_verts) {
        px[i] = verts[3 * static_cast<size_t>(j) + 0];
        py[i] = verts[3 * static_cast<size_t>(j) + 1];
        pz[i] = verts[3 * static_cast<size_t>(j) + 2];
      }
    }
    __syncthreads();
    const int n = *kept;
    if (tid == 0) n_kept[(k + 1) & 1] = 0;  // the next pass's counter: read last before this pass's first barrier
    int j = warp;
    for (; j + kWarps < n; j += 2 * kWarps) pair2(rel[j], rel[j + kWarps], dx, dy, dz, lo, hi, gamma2, gmax);
    if (j < n) {  // one left: pair it with itself (min and max do not mind)
      const float4 q = rel[j];
      pair2(q, q, dx, dy, dz, lo, hi, gamma2, gmax);
    }
  }

  // over the warps
  red_lo[warp][lane] = lo;
  red_hi[warp][lane] = hi;
  __syncthreads();
  if (tid < 32 && base + tid < n_rays) {  // warp 0: lane tid holds ray base + tid
    float z_min = red_lo[0][tid], z_max = red_hi[0][tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      z_min = fminf(z_min, red_lo[w][tid]);
      z_max = fmaxf(z_max, red_hi[w][tid]);
    }
    const float zn = __fdiv_rn(z_min, norm);
    const float zf = __fdiv_rn(z_max, norm);
    const bool hit = (z_min < kBig) && (zn < zf);
    near_out[ray] = hit ? zn : near[ray];
    far_out[ray] = hit ? zf : far[ray];
  }
}

}  // namespace

// The rays a block takes (one a lane) and the vertices it stages a pass.
extern "C" int gg_near_far_ray_tile() { return 32; }
extern "C" int gg_near_far_vertex_pass() { return kTile; }

// Resident blocks per SM of the kernel.
extern "C" int gg_near_far_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gg_kernel, kThreads, 0);
  return n;
}

// ray_o, ray_d: (n_rays, 3); near, far, near_out, far_out: (n_rays,);
// verts: (n_verts, 3). All float32, contiguous, on the stream's device.
// One launch; returns cudaGetLastError() after it.
extern "C" int gg_near_far_launch(const float* ray_o, const float* ray_d,
                                  const float* near, const float* far,
                                  const float* verts, float* near_out, float* far_out,
                                  int n_rays, int n_verts, float gamma2, void* stream) {
  if (n_rays > 0 && n_verts > 0) {
    gg_kernel<<<(n_rays + 31) / 32, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ray_o, ray_d, near, far, verts, near_out, far_out, n_rays, n_verts, gamma2);
  }
  return static_cast<int>(cudaGetLastError());
}
