// Fused SpaceNet forward: sigma, and with color the essence and
// gpe = d(sigma)/d(pe) (the g-recursion), for N points of x = [pe | code | pose].
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/fused_mlp.py:_fwd_kernel
// (pallas_call at :461). The math and the plain version are in
// ops/fused_mlp.py; the building blocks and the design in fused_mlp.cuh.
//
// Bound on the H100: FP32 operations, ~0.43 M multiply-adds per point for
// sigma alone and ~0.89 M with color, against 0.35-0.6 KB of inputs and
// outputs per point. What the design does about it: the whole chain runs on
// one tile of 32 points per block without a round trip of an activation to
// device memory; each weight is read once per tile from L2 and used for 32
// points from registers. The TPU kernel's 128-lane pads (k8, k10, b8, b10 and
// the 128-wide gpe) do not exist here.
#include "fused_mlp.cuh"

using namespace fmlp;

template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ sigma, float* __restrict__ essence,
                     float* __restrict__ gpe, float* __restrict__ scratch, int n) {
  float* s = scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  const int ntiles = (n + P - 1) / P;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int t0 = t * P;
    load_rows(row(s, R_X), x, IN, t0, n);
    __syncthreads();
    backbone(s, w);
    // sigma = h7 . k8 + b8 (one output row)
    layer<BIAS>(row(s, R_OUT), 1, hrow(s, 7), W, w + O_K8, 1, nullptr, 0, nullptr, 0, 0,
                w + O_B8, nullptr, nullptr, nullptr);
    if (COLOR) {
      layer<BIAS | RELU>(row(s, R_E1), E, hrow(s, 7), W, w + O_K9, E, nullptr, 0, nullptr, 0, 0,
                         w + O_B9, nullptr, nullptr, nullptr);
    }
    __syncthreads();
    store_rows(sigma, row(s, R_OUT), 1, t0, n);
    if (COLOR) {
      layer<BIAS>(row(s, R_OUT2), 3, row(s, R_E1), E, w + O_K10, 3, nullptr, 0, nullptr, 0, 0,
                  w + O_B10, nullptr, nullptr, nullptr);
      __syncthreads();
      store_rows(essence, row(s, R_OUT2), 3, t0, n);
      __syncthreads();
      g_recursion(s, w, row(s, R_OUT2));
      store_rows(gpe, row(s, R_OUT2), PE, t0, n);
    }
    __syncthreads();  // the next tile overwrites the scratch
  }
}

extern "C" int fused_mlp_fwd_blocks(int with_color) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  cudaError_t err = with_color
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_kernel<true>, NT, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_kernel<false>, NT, 0);
  if (err != cudaSuccess) return -1;
  return sms * per_sm;
}

extern "C" int fused_mlp_fwd_scratch(int) { return SCRATCH_FLOATS; }

// x (n, 87), w the flat weights; sigma (n,), essence (n, 3), gpe (n, 63)
// (the last two only with color); scratch: blocks * SCRATCH_FLOATS floats.
extern "C" int fused_mlp_fwd_launch(const float* x, const float* w, float* sigma, float* essence,
                                    float* gpe, float* scratch, int n, int with_color,
                                    int blocks, void* stream) {
  const int ntiles = (n + P - 1) / P;
  const int grid = blocks < ntiles ? blocks : ntiles;
  if (grid <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_color) {
    fused_mlp_fwd_kernel<true><<<grid, NT, 0, st>>>(x, w, sigma, essence, gpe, scratch, n);
  } else {
    fused_mlp_fwd_kernel<false><<<grid, NT, 0, st>>>(x, w, sigma, essence, gpe, scratch, n);
  }
  return (int)cudaGetLastError();
}
