// Fused SpaceNet forward: sigma, and with color the essence and
// gpe = d(sigma)/d(pe) (the g-recursion), for N points of x = [pe | code | pose].
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/fused_mlp.py:_fwd_kernel
// (pallas_call at :461). The math and the plain version are in
// ops/fused_mlp.py. The products run on the tiled core of
// fused_mlp_tiled.cuh, through the backbone, essence_hidden and g_chain
// routines that fused_mlp_bwd.cu also runs: the gpe of this kernel is the
// backward's recomputed gpe, bit for bit.
//
// Bound on the H100: FP32 operations, ~0.43 M multiply-adds per point for
// sigma alone and ~0.89 M with color, against 0.35-0.6 KB of inputs and
// outputs per point. What the design does about it: every product is a
// layer product of the tiled core (shared-memory slabs, 8 x 8 register
// micro-tiles, 64-point tiles); no activation of a whole batch goes to
// device memory, only the tile's rows in the block's scratch, laid out as
// the backward's. The heads too narrow for a micro-tile (sigma: one output, the essence: three)
// are per-thread dot products, one owner thread per output. The TPU
// kernel's 128-lane pads (k8, k10, b8, b10 and the 128-wide gpe) do not
// exist here.
//
// fused_mlp_fwd_fast_launch is the JAX kernel's fast=True (the same
// pallas_call with bfloat16 feeds): every product's operands rounded to
// bfloat16, the sums in float32, the products on the tensor cores
// (fused_mlp_tc.cuh). Bound: bf16 products with float32 sums at 989 TFLOP/s
// dense on an H100 SXM, ~0.47 ms a production step. Its rows are bf16 in
// the block's scratch (x, h1..h7, e1, u1..u7: 30-60 KB a point of traffic
// against the float32 form's ~2x), the weights a pre-rounded bf16 buffer
// (1.9 MB) read from L2. It runs the same backbone and g-chain routines as
// the fast backward: the same gpe bit for bit.
#include "fused_mlp_tc.cuh"
#include "fused_mlp_tiled.cuh"

using namespace fmlp_tiled;
using fmlp::O_B10;
using fmlp::O_B8;
using fmlp::O_K10;

static_assert(NT == 4 * P, "one owner thread per head output: sigma and three essence rows");

// Every routine of the tiled core ends on a barrier; the barriers here order
// the per-thread loops between them.
template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ sigma, float* __restrict__ essence,
                     float* __restrict__ gpe, float* __restrict__ scratch, int n) {
  extern __shared__ __align__(16) float sm[];
  float* s = scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  const int ntiles = (n + P - 1) / P;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int t0 = t * P;
    load_rows(row(s, R_X), x, IN, t0, n);
    __syncthreads();
    backbone(sm, s, w);
    if (COLOR) essence_hidden(sm, s, w);
    // the heads, one owner thread per output: threads 0..63 sigma = h7 . k8
    // + b8 of their point, with color threads 64..255 the essence e1 K10 +
    // b10, output (i - 64) / 64 of point i % 64
    if (threadIdx.x < P) {
      const float* h7 = hrow(s, 7);
      const int p = threadIdx.x;
      float z = 0.f;
#pragma unroll 8
      for (int k = 0; k < W; ++k) z = fmaf(h7[k * P + p], __ldg(w + O_K8 + k), z);
      if (t0 + p < n) sigma[t0 + p] = z + __ldg(w + O_B8);
    } else if (COLOR) {
      const int j = threadIdx.x / P - 1, p = threadIdx.x % P;
      const float* e1 = row(s, R_E1);
      float z = 0.f;
#pragma unroll 8
      for (int k = 0; k < E; ++k)
        z = fmaf(e1[k * P + p], __ldg(w + O_K10 + k * 3 + j), z);
      if (t0 + p < n) essence[(size_t)(t0 + p) * 3 + j] = z + __ldg(w + O_B10 + j);
    }
    if (COLOR) {
      g_chain(sm, s, w);  // reads h1..h7, writes only the u and gpe rows
      store_rows(gpe, row(s, R_OUT2), PE, t0, n);
    }
    __syncthreads();  // the next tile overwrites the scratch
  }
}

namespace fmlp_tc {

// The bfloat16-fed forward on the tensor-core core: the float32 kernel's
// steps on bf16 rows. Every routine ends on a barrier.
template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_fwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const bf* __restrict__ wb, float* __restrict__ sigma,
                        float* __restrict__ essence, float* __restrict__ gpe,
                        bf* __restrict__ scratch, int n) {
  using R = Rec<COLOR>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* sm = reinterpret_cast<bf*>(smem);
  bf* r = scratch + (size_t)blockIdx.x * R::FWD * P;
  const int ntiles = (n + P - 1) / P;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int t0 = t * P;
    load_rows_bf(rrow(r, R::X), x, IN, XR, t0, n, reinterpret_cast<float*>(smem));
    backbone<COLOR, false>(sm, r, w, wb, nullptr, nullptr);
    if (COLOR) essence_hidden<COLOR>(sm, r, w, wb);
    // the heads, one owner thread per output, on the bf16 rows and the
    // rounded weights: threads 0..63 sigma = h7 . k8 + b8, with color
    // threads 64..255 the essence e1 K10 + b10
    if (threadIdx.x < P) {
      const int p = threadIdx.x;
      const bf* h7 = rrow(r, R::H + 6 * W);
      float z = 0.f;
#pragma unroll 8
      for (int k = 0; k < W; ++k) z = fmaf(from_bf(h7[k * P + p]), op(__ldg(w + fmlp::O_K8 + k)), z);
      if (t0 + p < n) sigma[t0 + p] = z + __ldg(w + fmlp::O_B8);
    } else if (COLOR) {
      const int j = threadIdx.x / P - 1, p = threadIdx.x % P;
      const bf* e1 = rrow(r, R::E1);
      float z = 0.f;
#pragma unroll 8
      for (int k = 0; k < E; ++k)
        z = fmaf(from_bf(e1[k * P + p]), op(__ldg(w + fmlp::O_K10 + k * 3 + j)), z);
      if (t0 + p < n) essence[(size_t)(t0 + p) * 3 + j] = z + __ldg(w + fmlp::O_B10 + j);
    }
    if (COLOR) g_chain<COLOR>(sm, r, w, wb, gpe, t0, n);  // writes only the u rows and gpe
    __syncthreads();  // the next tile overwrites the scratch
  }
}

template <bool COLOR>
static cudaError_t allow_smem() {
  return cudaFuncSetAttribute(fused_mlp_fwd_tc_kernel<COLOR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

static int grid_blocks(int with_color) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  cudaError_t err = with_color ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return -1;
  err = with_color
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_tc_kernel<true>, NT,
                                                      SMEM_BYTES)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_tc_kernel<false>, NT,
                                                      SMEM_BYTES);
  if (err != cudaSuccess) return -1;
  return sms * per_sm;
}

static int launch(const float* x, const float* w, const bf* wb, float* sigma, float* essence,
                  float* gpe, bf* scratch, int n, int with_color, int blocks, void* stream) {
  const int ntiles = (n + P - 1) / P;
  const int grid = blocks < ntiles ? blocks : ntiles;
  if (grid <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = with_color ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return (int)err;
  if (with_color) {
    fused_mlp_fwd_tc_kernel<true><<<grid, NT, SMEM_BYTES, st>>>(x, w, wb, sigma, essence, gpe,
                                                                scratch, n);
  } else {
    fused_mlp_fwd_tc_kernel<false><<<grid, NT, SMEM_BYTES, st>>>(x, w, wb, sigma, essence, gpe,
                                                                 scratch, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace fmlp_tc

// the dynamic shared memory of the variants on the current device (before
// the occupancy query and the launch)
static cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_fwd_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fused_mlp_fwd_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

static int grid_blocks(int with_color) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  if (allow_smem() != cudaSuccess) return -1;
  cudaError_t err = with_color
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_kernel<true>, NT,
                                                      SMEM_BYTES)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_kernel<false>, NT,
                                                      SMEM_BYTES);
  if (err != cudaSuccess) return -1;
  return sms * per_sm;
}

static int launch(const float* x, const float* w, float* sigma, float* essence, float* gpe,
                  float* scratch, int n, int with_color, int blocks, void* stream) {
  const int ntiles = (n + P - 1) / P;
  const int grid = blocks < ntiles ? blocks : ntiles;
  if (grid <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (with_color) {
    fused_mlp_fwd_kernel<true><<<grid, NT, SMEM_BYTES, st>>>(x, w, sigma, essence, gpe, scratch, n);
  } else {
    fused_mlp_fwd_kernel<false><<<grid, NT, SMEM_BYTES, st>>>(x, w, sigma, essence, gpe, scratch, n);
  }
  return (int)cudaGetLastError();
}

// resident blocks of the persistent grid; scratch floats, tile points and
// dynamic shared bytes of a block
extern "C" int fused_mlp_fwd_blocks(int with_color) { return grid_blocks(with_color); }
extern "C" int fused_mlp_fwd_scratch(int) { return SCRATCH_FLOATS; }
extern "C" int fused_mlp_fwd_tile(int) { return P; }
extern "C" int fused_mlp_fwd_smem(int) { return SMEM_BYTES; }

// x (n, 87), w the flat weights; sigma (n,), essence (n, 3), gpe (n, 63)
// (the last two only with color); scratch: blocks * SCRATCH_FLOATS floats.
extern "C" int fused_mlp_fwd_launch(const float* x, const float* w, float* sigma, float* essence,
                                    float* gpe, float* scratch, int n, int with_color,
                                    int blocks, void* stream) {
  return launch(x, w, sigma, essence, gpe, scratch, n, with_color, blocks, stream);
}

// the bfloat16-fed variant: the same, with wb the bf16 weight buffer
// (fmlp_tc::WB_ELEMS) and scratch blocks * fused_mlp_fwd_fast_scratch bf16
extern "C" int fused_mlp_fwd_fast_blocks(int with_color) { return fmlp_tc::grid_blocks(with_color); }
extern "C" int fused_mlp_fwd_fast_scratch(int with_color) {
  return (with_color ? fmlp_tc::Rec<true>::FWD : fmlp_tc::Rec<false>::FWD) * fmlp_tc::P;
}
extern "C" int fused_mlp_fwd_fast_smem(int) { return fmlp_tc::SMEM_BYTES; }
extern "C" int fused_mlp_fwd_fast_launch(const float* x, const float* w, const void* wb,
                                         float* sigma, float* essence, float* gpe, void* scratch,
                                         int n, int with_color, int blocks, void* stream) {
  return fmlp_tc::launch(x, w, static_cast<const fmlp_tc::bf*>(wb), sigma, essence, gpe,
                         static_cast<fmlp_tc::bf*>(scratch), n, with_color, blocks, stream);
}
