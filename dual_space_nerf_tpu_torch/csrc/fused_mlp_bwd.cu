// Fused SpaceNet backward: for N points of x = [pe | code | pose] and the
// cotangents sbar (of sigma) and, with color, ebar (of the essence) and gbar
// (of gpe), the input cotangent xbar, gpe (recomputed), and every weight
// gradient.
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/fused_mlp.py:_bwd_kernel
// (pallas_call at :507): recompute of the backbone, first-order backprop of
// sbar and ebar, then the second-order vjp of the g-recursion driven by gbar
// (the derivation is in ops/fused_mlp.py). The plain version is
// ops/fused_mlp.py::fused_bwd_plain. The products run on the tiled core of
// fused_mlp_tiled.cuh (shared-memory slabs, 8 x 8 register micro-tiles).
//
// Bound on the H100: FP32 operations, ~1.3 M multiply-adds per point for
// sigma alone and ~2.7 M with color, of which ~0.45 M / ~0.9 M are the
// weight gradients' sums over the points; the inputs and outputs move
// 0.7-1.2 KB per point. The TPU kernel carries the weight gradients from
// one grid step to the next in VMEM; here blocks run in parallel, so each
// block of the persistent grid adds its tiles' sums into its own 1.87 MB
// slice of `partials`, and a second kernel adds the slices in block order:
// two runs give the same bits, and no atomics are used. Per layer the first-
// and second-order terms go into one pass: Kbar_l += h_{l-1}^T dz_l +
// gb_{l-1}^T u_l.
//
// Traffic per tile of 64 points beside the FMAs, in device memory or L2:
// - the slice's read-modify-write, 2 x 1.7-1.9 MB (27-29 KB per point and
//   direction: the larger the tile, the less);
// - the scratch rows: each layer product writes its 256 output rows (64 KB)
//   once and reads its input rows and its mask rows once; each weight
//   gradient reads its operands twice (two 128-row sub-tiles per side), and
//   with color both pairs: ~4 MB per tile without color, ~8.5 MB with
//   (~65 / ~135 KB per point);
// - the weights, 2.1 MB (3.6 MB with the transposes) from L2.
//
// fused_mlp_bwd_fast_launch is the JAX kernel's fast=True: the same kernel
// built with the core's FAST flag (fused_mlp_tiled.cuh's header). Every
// operand of every product is rounded to bfloat16, weights, activations and
// the cotangent rows of the chains and of the weight gradients alike; the
// ReLU masks, the bias gradients, k8's gradient sums (sbar h7 and gb7) and
// the rank-1 term sbar k8 read float32, as the JAX body's jnp.sum and
// elementwise products do. Its bound is at the rate of its type, bf16
// products with float32 sums on the tensor cores (989 TFLOP/s dense on an
// H100 SXM, ~1.4 ms a production step); this first form runs them as FP32
// FMAs on the CUDA cores (67 TFLOP/s) until its tensor-core redesign.
#include "fused_mlp_tiled.cuh"

using namespace fmlp_tiled;
using fmlp::O_B10;
using fmlp::O_B8;
using fmlp::O_K10;
using fmlp::O_K10T;
using fmlp::O_K9T;
using fmlp::G_FLOATS;

// Every routine of the tiled core ends on a barrier; the barriers here order
// the per-thread loops between them.
template <bool COLOR, bool FAST>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ sbar,
                     const float* __restrict__ ebar, const float* __restrict__ gbar,
                     const float* __restrict__ w, float* __restrict__ xbar,
                     float* __restrict__ gpe, float* __restrict__ partials,
                     float* __restrict__ scratch, int n) {
  extern __shared__ __align__(16) float sm[];
  float* s = scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  float* G = partials + (size_t)blockIdx.x * G_FLOATS;
  const int ntiles = (n + P - 1) / P;
  // gbar's rows 63..86 stay zero: K1's gradient takes gbar as an 87-row operand
  for (int i = threadIdx.x; i < (88 - PE) * P; i += NT) row(s, R_GBAR + PE)[i] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int t0 = t * P;
    load_rows(row(s, R_X), x, IN, t0, n);
    load_rows(row(s, R_SB), sbar, 1, t0, n);
    if (COLOR) {
      load_rows(row(s, R_EB), ebar, 3, t0, n);
      load_rows(row(s, R_GBAR), gbar, PE, t0, n);
    }
    __syncthreads();
    backbone<FAST>(sm, s, w);  // h1..h7, the forward's

    // ---- first order: the sigma and essence cotangents ----
    if (COLOR) {
      essence_hidden<FAST>(sm, s, w);  // e1 = relu(h7 K9 + b9), the forward's
      // the narrow essence head, per thread: de1 = (ebar K10^T) * (z9 > 0),
      // and z9 > 0 exactly where e1 > 0
      for (int i = threadIdx.x; i < E * P; i += NT) {
        const int j = i / P, p = i - j * P;
        float z = 0.f;
        for (int k = 0; k < 3; ++k)
          z = fmaf(op<FAST>(row(s, R_EB + k)[p]), op<FAST>(__ldg(w + O_K10T + k * E + j)), z);
        row(s, R_DE1)[i] = row(s, R_E1)[i] > 0.f ? z : 0.f;
      }
      // K10 (E, 3) and b10: one owner thread per element (FAST rounds K10's
      // factors, not b10's sum)
      for (int i = threadIdx.x; i < E * 3 + 3; i += NT) {
        const float* a = i < E * 3 ? row(s, R_E1 + i / 3) : nullptr;
        const float* b = row(s, R_EB + (i < E * 3 ? i % 3 : i - E * 3));
        float acc = 0.f;
        for (int p = 0; p < P; ++p)
          acc = a != nullptr ? fmaf(op<FAST>(a[p]), op<FAST>(b[p]), acc) : acc + b[p];
        G[i < E * 3 ? O_K10 + i : O_B10 + i - E * 3] += acc;
      }
      __syncthreads();
      wgrad<false, FAST>(sm, G + O_K9, W, E, hrow(s, 7), row(s, R_DE1), nullptr, nullptr, G + O_B9);
    }
    // dz7 = m7 * (sbar k8 + de1 K9^T)
    layer<RANK1 | MASK, true, W, FAST>(sm, dzrow(s, 7), W,
                              COLOR ? wide(row(s, R_DE1), E, w + O_K9T) : none(), none(), nullptr,
                              hrow(s, 7), row(s, R_SB), w + O_K8);
    // k8 and b8: sums of sbar h7 and of sbar over the tile, one owner each
    for (int j = threadIdx.x; j < W; j += NT) {
      const float* h7 = hrow(s, 7) + j * P;
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc = fmaf(row(s, R_SB)[p], h7[p], acc);
      G[O_K8 + j] += acc;
    }
    if (threadIdx.x == 0) {
      float sb = 0.f;
      for (int p = 0; p < P; ++p) sb += row(s, R_SB)[p];
      G[O_B8] += sb;
    }
    // dz6 = m6 (dz7 K7^T), ..., dz4 = m4 (dz5 K5a^T), ..., dz1
    for (int l = 7; l >= 2; --l)
      masked<FAST>(sm, dzrow(s, l - 1), dzrow(s, l), w + ktw(l), hrow(s, l - 1));
    // xbar = dz1 K1^T, plus dz5 K5b^T on the pe lanes (the skip layer); the
    // transposes' rows are 87 and 63 floats: 4-byte copies
    layer<0, false, 128, FAST>(sm, row(s, R_OUT), IN, {dzrow(s, 1), w + O_K1T, W, IN, IN},
                         {dzrow(s, 5), w + O_K5BT, W, PE, PE}, nullptr, nullptr, nullptr, nullptr);
    store_rows(xbar, row(s, R_OUT), IN, t0, n);

    // ---- second order: the g-recursion (u7..u1, gpe) and the start of its
    // vjp, gb1 = m1 (gbar K1[:63]) ----
    float* gb = row(s, R_GB);
    float* gb_next = row(s, R_GB + W);
    if (COLOR) {
      g_chain<FAST>(sm, s, w);  // u7..u1 and gpe, the forward's
      store_rows(gpe, row(s, R_OUT2), PE, t0, n);
      layer<MASK, true, W, FAST>(sm, gb, W, wide(row(s, R_GBAR), PE, w + O_K1), none(), nullptr,
                        hrow(s, 1), nullptr, nullptr);
    }

    // ---- the weight gradients: Kbar_l += h_{l-1}^T dz_l (+ gb_{l-1}^T u_l
    // with color, gb running up the chain: gb_l = m_l (gb_{l-1} K_l), gb5 =
    // m5 (gb4 K5a + gbar K5b)) ----
    wgrad<COLOR, FAST>(sm, G + O_K1, IN, W, row(s, R_X), dzrow(s, 1), row(s, R_GBAR), urow(s, 1),
                 G + O_B1);
    for (int l = 2; l <= 7; ++l) {
      wgrad<COLOR, FAST>(sm, G + kw(l), W, W, hrow(s, l - 1), dzrow(s, l), gb, urow(s, l),
                   G + O_B1 + (l - 1) * W);
      if (l == 5)
        wgrad<COLOR, FAST>(sm, G + O_K5B, PE, W, row(s, R_X), dzrow(s, 5), row(s, R_GBAR), urow(s, 5),
                     nullptr);
      if (COLOR) {
        layer<MASK, true, W, FAST>(sm, gb_next, W, wide(gb, W, w + kw(l)),
                          l == 5 ? wide(row(s, R_GBAR), PE, w + O_K5B) : none(), nullptr,
                          hrow(s, l), nullptr, nullptr);
        float* tmp = gb; gb = gb_next; gb_next = tmp;
      }
    }
    // k8 += the sum of gb7 over the points (the owner of k8[j] as above)
    if (COLOR) {
      for (int j = threadIdx.x; j < W; j += NT) {
        const float* g7 = gb + j * P;
        float acc = 0.f;
        for (int p = 0; p < P; ++p) acc += g7[p];
        G[O_K8 + j] += acc;
      }
    }
    __syncthreads();  // the next tile overwrites the scratch
  }
}

// out[e] = sum over the slices g = 0..nslices-1, in that order, of partials[g][e]
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ partials, int nslices,
                                        float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= G_FLOATS) return;
  float acc = 0.f;
  for (int g = 0; g < nslices; ++g) acc += partials[(size_t)g * G_FLOATS + e];
  out[e] = acc;
}

// the dynamic shared memory of the variants on the current device (before
// the occupancy query and the launch)
template <bool FAST>
static cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_bwd_kernel<true, FAST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fused_mlp_bwd_kernel<false, FAST>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

template <bool FAST>
static int grid_blocks(int with_color) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (allow_smem<FAST>() != cudaSuccess) return -1;
  cudaError_t err = with_color
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel<true, FAST>,
                                                      NT, SMEM_BYTES)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel<false, FAST>,
                                                      NT, SMEM_BYTES);
  if (err != cudaSuccess) return -1;
  return sms * per_sm;
}

template <bool FAST>
static int launch(const float* x, const float* sbar, const float* ebar, const float* gbar,
                  const float* w, float* xbar, float* gpe, float* partials, float* grads,
                  float* scratch, int n, int with_color, int blocks, void* stream) {
  const int ntiles = (n + P - 1) / P;
  const int grid = blocks < ntiles ? blocks : ntiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem<FAST>();
  if (err != cudaSuccess) return (int)err;
  if (grid > 0) {
    if (with_color) {
      fused_mlp_bwd_kernel<true, FAST><<<grid, NT, SMEM_BYTES, st>>>(
          x, sbar, ebar, gbar, w, xbar, gpe, partials, scratch, n);
    } else {
      fused_mlp_bwd_kernel<false, FAST><<<grid, NT, SMEM_BYTES, st>>>(
          x, sbar, ebar, gbar, w, xbar, gpe, partials, scratch, n);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fused_mlp_reduce_kernel<<<(G_FLOATS + 255) / 256, 256, 0, st>>>(partials, grid > 0 ? grid : 0,
                                                                 grads);
  return (int)cudaGetLastError();
}

// resident blocks of the persistent grid of each variant; scratch floats,
// tile points and dynamic shared bytes of a block (both variants': the
// wrappers ask the float32 kernel's names)
extern "C" int fused_mlp_bwd_blocks(int with_color) { return grid_blocks<false>(with_color); }
extern "C" int fused_mlp_bwd_fast_blocks(int with_color) { return grid_blocks<true>(with_color); }
extern "C" int fused_mlp_bwd_scratch(int) { return SCRATCH_FLOATS; }
extern "C" int fused_mlp_bwd_tile(int) { return P; }
extern "C" int fused_mlp_bwd_smem(int) { return SMEM_BYTES; }

// x (n, 87), sbar (n,), ebar (n, 3), gbar (n, 63) (the last two with color);
// w the flat weights; out: xbar (n, 87), gpe (n, 63) (with color), grads
// (G_FLOATS); partials: blocks * G_FLOATS zeros; scratch: blocks *
// SCRATCH_FLOATS floats.
extern "C" int fused_mlp_bwd_launch(const float* x, const float* sbar, const float* ebar,
                                    const float* gbar, const float* w, float* xbar, float* gpe,
                                    float* partials, float* grads, float* scratch, int n,
                                    int with_color, int blocks, void* stream) {
  return launch<false>(x, sbar, ebar, gbar, w, xbar, gpe, partials, grads, scratch, n,
                       with_color, blocks, stream);
}

// the same with bfloat16 feeds
extern "C" int fused_mlp_bwd_fast_launch(const float* x, const float* sbar, const float* ebar,
                                         const float* gbar, const float* w, float* xbar,
                                         float* gpe, float* partials, float* grads,
                                         float* scratch, int n, int with_color, int blocks,
                                         void* stream) {
  return launch<true>(x, sbar, ebar, gbar, w, xbar, gpe, partials, grads, scratch, n,
                      with_color, blocks, stream);
}
