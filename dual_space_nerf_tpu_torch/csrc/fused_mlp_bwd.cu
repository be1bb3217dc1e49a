// Fused SpaceNet backward: for N points of x = [pe | code | pose] and the
// cotangents sbar (of sigma) and, with color, ebar (of the essence) and gbar
// (of gpe), the input cotangent xbar, gpe (recomputed), and every weight
// gradient.
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/fused_mlp.py:_bwd_kernel
// (pallas_call at :507): recompute of the backbone, first-order backprop of
// sbar and ebar, then the second-order vjp of the g-recursion driven by gbar
// (the derivation is in ops/fused_mlp.py). The plain version is
// ops/fused_mlp.py::fused_bwd_plain.
//
// Bound on the H100: FP32 operations, ~1.3 M multiply-adds per point for
// sigma alone and ~2.7 M with color, of which ~0.9 M are the weight
// gradients' sums over the points. The TPU kernel carries the weight
// gradients from one grid step to the next in VMEM; here blocks run in
// parallel, so each block of the persistent grid adds its tiles' sums into
// its own slice of `partials` (2 MB, L2-resident while the block works on
// it) and a second kernel adds the slices in block order: two runs give the
// same bits, and no atomics are used. Per layer the first- and second-order
// terms go into one pass: Kbar_l += h_{l-1}^T dz_l + gb_{l-1}^T u_l.
#include "fused_mlp.cuh"

using namespace fmlp;

template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ sbar,
                     const float* __restrict__ ebar, const float* __restrict__ gbar,
                     const float* __restrict__ w, float* __restrict__ xbar,
                     float* __restrict__ gpe, float* __restrict__ partials,
                     float* __restrict__ scratch, int n) {
  float* s = scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  float* G = partials + (size_t)blockIdx.x * G_FLOATS;
  const int ntiles = (n + P - 1) / P;
  // gbar's rows 63..87 stay zero: K1's gradient takes gbar as an 87-row operand
  for (int i = threadIdx.x; i < (88 - PE) * LD; i += NT) row(s, R_GBAR + PE)[i] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int t0 = t * P;
    load_rows(row(s, R_X), x, IN, t0, n);
    load_rows(row(s, R_SB), sbar, 1, t0, n);
    if (COLOR) {
      load_rows(row(s, R_EB), ebar, 3, t0, n);
      load_rows(row(s, R_GBAR), gbar, PE, t0, n);
    }
    __syncthreads();
    backbone(s, w);

    // ---- first order: the sigma and essence cotangents ----
    if (COLOR) {
      layer<BIAS | RELU>(row(s, R_E1), E, hrow(s, 7), W, w + O_K9, E, nullptr, 0, nullptr, 0, 0,
                         w + O_B9, nullptr, nullptr, nullptr);
      __syncthreads();
      // de1 = (ebar K10^T) * (z9 > 0), and z9 > 0 exactly where e1 > 0
      layer<MASK>(row(s, R_DE1), E, row(s, R_EB), 3, w + O_K10T, E, nullptr, 0, nullptr, 0, 0,
                  nullptr, row(s, R_E1), nullptr, nullptr);
      __syncthreads();
      wgrad<false>(G + O_K10, E, 3, row(s, R_E1), row(s, R_EB), nullptr, nullptr, G + O_B10);
      wgrad<false>(G + O_K9, W, E, hrow(s, 7), row(s, R_DE1), nullptr, nullptr, G + O_B9);
    }
    // dz7 = m7 * (sbar k8 + de1 K9^T)
    layer<RANK1 | MASK>(dzrow(s, 7), W, COLOR ? row(s, R_DE1) : nullptr, E, w + O_K9T, W, nullptr,
                        0, nullptr, 0, 0, nullptr, hrow(s, 7), row(s, R_SB), w + O_K8);
    // k8 and b8: sums of sbar h7 and of sbar over the tile
    wgrad<false>(G + O_K8, 1, W, row(s, R_SB), hrow(s, 7), nullptr, nullptr, nullptr);
    if (threadIdx.x == 0) {
      float sb = 0.f;
      for (int p = 0; p < P; ++p) sb += row(s, R_SB)[p];
      G[O_B8] += sb;
    }
    __syncthreads();
    for (int l = 7; l >= 6; --l) {
      layer<MASK>(dzrow(s, l - 1), W, dzrow(s, l), W, w + kt_off(l), W, nullptr, 0, nullptr, 0, 0,
                  nullptr, hrow(s, l - 1), nullptr, nullptr);
      __syncthreads();
    }
    layer<MASK>(dzrow(s, 4), W, dzrow(s, 5), W, w + O_K5AT, W, nullptr, 0, nullptr, 0, 0, nullptr,
                hrow(s, 4), nullptr, nullptr);
    __syncthreads();
    for (int l = 4; l >= 2; --l) {
      layer<MASK>(dzrow(s, l - 1), W, dzrow(s, l), W, w + kt_off(l), W, nullptr, 0, nullptr, 0, 0,
                  nullptr, hrow(s, l - 1), nullptr, nullptr);
      __syncthreads();
    }
    // xbar = dz1 K1^T, plus dz5 K5b^T on the pe lanes (the skip layer)
    layer<0>(row(s, R_OUT), IN, dzrow(s, 1), W, w + O_K1T, IN, dzrow(s, 5), W, w + O_K5BT, PE, PE,
             nullptr, nullptr, nullptr, nullptr);
    __syncthreads();
    store_rows(xbar, row(s, R_OUT), IN, t0, n);

    if (!COLOR) {
      wgrad<false>(G + O_K1, IN, W, row(s, R_X), dzrow(s, 1), nullptr, nullptr, G + O_B1);
      for (int l = 2; l <= 4; ++l)
        wgrad<false>(G + k_off(l), W, W, hrow(s, l - 1), dzrow(s, l), nullptr, nullptr,
                     G + O_B1 + (l - 1) * W);
      wgrad<false>(G + O_K5A, W, W, hrow(s, 4), dzrow(s, 5), nullptr, nullptr, G + O_B1 + 4 * W);
      wgrad<false>(G + O_K5B, PE, W, row(s, R_X), dzrow(s, 5), nullptr, nullptr, nullptr);
      for (int l = 6; l <= 7; ++l)
        wgrad<false>(G + k_off(l), W, W, hrow(s, l - 1), dzrow(s, l), nullptr, nullptr,
                     G + O_B1 + (l - 1) * W);
      __syncthreads();  // the next tile overwrites the scratch
      continue;
    }

    // ---- second order: the vjp of the g-recursion, driven by gbar ----
    g_recursion(s, w, row(s, R_OUT2));
    store_rows(gpe, row(s, R_OUT2), PE, t0, n);
    float* gb = row(s, R_GB);
    float* gb_next = row(s, R_GB + W);
    // gb1 = m1 (gbar K1[:63])
    layer<MASK>(gb, W, row(s, R_GBAR), PE, w + O_K1, W, nullptr, 0, nullptr, 0, 0, nullptr,
                hrow(s, 1), nullptr, nullptr);
    __syncthreads();
    wgrad<true>(G + O_K1, IN, W, row(s, R_X), dzrow(s, 1), row(s, R_GBAR), urow(s, 1), G + O_B1);
    for (int l = 2; l <= 4; ++l) {
      wgrad<true>(G + k_off(l), W, W, hrow(s, l - 1), dzrow(s, l), gb, urow(s, l),
                  G + O_B1 + (l - 1) * W);
      layer<MASK>(gb_next, W, gb, W, w + k_off(l), W, nullptr, 0, nullptr, 0, 0, nullptr,
                  hrow(s, l), nullptr, nullptr);
      __syncthreads();
      float* tmp = gb; gb = gb_next; gb_next = tmp;
    }
    wgrad<true>(G + O_K5A, W, W, hrow(s, 4), dzrow(s, 5), gb, urow(s, 5), G + O_B1 + 4 * W);
    wgrad<true>(G + O_K5B, PE, W, row(s, R_X), dzrow(s, 5), row(s, R_GBAR), urow(s, 5), nullptr);
    // gb5 = m5 (gb4 K5a + gbar K5b)
    layer<MASK>(gb_next, W, gb, W, w + O_K5A, W, row(s, R_GBAR), PE, w + O_K5B, W, W, nullptr,
                hrow(s, 5), nullptr, nullptr);
    __syncthreads();
    { float* tmp = gb; gb = gb_next; gb_next = tmp; }
    for (int l = 6; l <= 7; ++l) {
      wgrad<true>(G + k_off(l), W, W, hrow(s, l - 1), dzrow(s, l), gb, urow(s, l),
                  G + O_B1 + (l - 1) * W);
      layer<MASK>(gb_next, W, gb, W, w + k_off(l), W, nullptr, 0, nullptr, 0, 0, nullptr,
                  hrow(s, l), nullptr, nullptr);
      __syncthreads();
      float* tmp = gb; gb = gb_next; gb_next = tmp;
    }
    // k8 += sum over the points of gb7 (the same thread owns k8[j] as above)
    for (int j = threadIdx.x; j < W; j += NT) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc += gb[j * LD + p];
      G[O_K8 + j] += acc;
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

extern "C" int fused_mlp_bwd_blocks(int with_color) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  cudaError_t err = with_color
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel<true>, NT, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel<false>, NT, 0);
  if (err != cudaSuccess) return -1;
  return sms * per_sm;
}

extern "C" int fused_mlp_bwd_scratch(int) { return SCRATCH_FLOATS; }

// x (n, 87), sbar (n,), ebar (n, 3), gbar (n, 63) (the last two with color);
// w the flat weights; out: xbar (n, 87), gpe (n, 63) (with color), grads
// (G_FLOATS); partials: blocks * G_FLOATS zeros; scratch: blocks *
// SCRATCH_FLOATS floats.
extern "C" int fused_mlp_bwd_launch(const float* x, const float* sbar, const float* ebar,
                                    const float* gbar, const float* w, float* xbar, float* gpe,
                                    float* partials, float* grads, float* scratch, int n,
                                    int with_color, int blocks, void* stream) {
  const int ntiles = (n + P - 1) / P;
  const int grid = blocks < ntiles ? blocks : ntiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (grid > 0) {
    if (with_color) {
      fused_mlp_bwd_kernel<true><<<grid, NT, 0, st>>>(x, sbar, ebar, gbar, w, xbar, gpe, partials,
                                                      scratch, n);
    } else {
      fused_mlp_bwd_kernel<false><<<grid, NT, 0, st>>>(x, sbar, ebar, gbar, w, xbar, gpe,
                                                       partials, scratch, n);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fused_mlp_reduce_kernel<<<(G_FLOATS + 255) / 256, 256, 0, st>>>(partials, grid > 0 ? grid : 0,
                                                                 grads);
  return (int)cudaGetLastError();
}
