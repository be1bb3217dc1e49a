// Fused SpaceNet backward: for N points of x = [pe | code | pose] and the
// cotangents sbar (of sigma) and, with color, ebar (of the essence) and gbar
// (of gpe), the input cotangent xbar, gpe (recomputed), and every weight
// gradient.
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/fused_mlp.py:_bwd_kernel
// (pallas_call at :507): recompute of the backbone, first-order backprop of
// sbar and ebar, then the second-order vjp of the g-recursion driven by gbar
// (the derivation is in ops/fused_mlp.py). The plain version is
// ops/fused_mlp.py::fused_bwd_plain. The TPU kernel carries the weight
// gradients from one grid step to the next in VMEM; here blocks run in
// parallel, so the sums over the points are a pass of their own.
//
// The float32 kernel (fused_mlp_bwd_launch), on the tiled core of
// fused_mlp_tiled.cuh (shared-memory slabs, 8 x 8 register micro-tiles):
// - The chain (`fused_mlp_bwd_kernel`): a persistent grid walks the tiles of
//   P = 64 points; per tile the recompute, the first-order backprop, xbar,
//   and with color the g-recursion, gpe and its vjp up the chain (gb1 = m1
//   (gbar K1[:63]), gb_l = m_l (gb_{l-1} K_l), gb5 = m5 (gb4 K5a + gbar
//   K5b)). Each tile's rows go into a record of its own (`Rec32`): x,
//   h1..h7, dz1..dz7, and with color e1, de1, gbar, u1..u7, gb1..gb7, ~15 /
//   ~32 KB a point. The bias, k8, K10 and b9, b10 sums go to the block's
//   slice of `small` (~10 KB), summed over the blocks in block order by a
//   second kernel.
// - The weight gradients (`fused_mlp_wgrad_f32_kernel`): block (tile, s)
//   owns one 128 x 128 tile of one gradient (K1, K2..K7, K5b, with color
//   K9) and the s-th of `splits` contiguous shares of the tiles of points.
//   It sums both terms of a second-order gradient (h^T dz + gb^T u) in
//   registers, one fmaf a term, p-slabs of 32 points double-buffered by
//   `cp.async`, and adds the sum to its partial tile every FLUSH tiles of
//   points; a reduce adds the shares in share order.
// - Records take device memory: a call walks its points in chunks of
//   `chunk` tiles (whole waves of the chain's grid, under the wrapper's
//   budget, ops/fused_mlp.py::wgrad_plan), each chunk's chain then its
//   pass, which adds into the same partial tiles in chunk order.
// Two runs give the same bits: fixed orders everywhere, no atomics.
//
// Bound on the H100: FP32 operations, ~1.3 M multiply-adds per point for
// sigma alone and ~2.7 M with color, of which ~0.45 M / ~0.9 M are the
// weight gradients' sums over the points. The pass needs each record once
// from device memory (the blocks of one share read a tile's record at about
// the same time) and does 28 / 30 gradient tiles of 128 x 128 x 64 (x 2
// terms) multiply-adds a tile: 59 / 122 MFLOP on 0.96 / 2.05 MB, ~60
// FLOP/B against the card's 20, so it is bound by its FMAs; its partial
// tiles (~33 MB) stay in L2. The chain writes each record once.
//
// fused_mlp_bwd_fast_launch is the JAX kernel's fast=True: every operand
// of every product rounded to bfloat16, weights, activations and the
// cotangent rows of the chains and of the weight gradients alike; the ReLU
// masks, the bias gradients, k8's gradient sums (sbar h7 and gb7) and the
// rank-1 term sbar k8 read float32, as the JAX body's jnp.sum and
// elementwise products do. Bound: bf16 products with float32 sums on the
// tensor cores, 989 TFLOP/s dense on an H100 SXM, ~1.4 ms a production
// step. Its design is the float32 kernel's on other cores:
// - the chain (recompute, first-order backprop, xbar, the g-recursion and
//   gb1..gb7) runs on the tensor-core core of fused_mlp_tc.cuh and writes
//   each tile's bf16 rows (x, h, dz, and with color e1, u, de1, gbar, gb)
//   into a record of its own, ~0.47 / ~0.94 MB a tile of 64 points, for
//   all the call's tiles at once;
// - the bias, k8, K10 and b9, b10 sums, per block, go to a 10 KB slice of
//   `small`, summed over the blocks in block order by a second kernel;
// - the weight gradients are a pass of their own over the records
//   (`fused_mlp_wgrad_kernel`): each block takes a 128 x 128 tile of one
//   gradient and a fixed share of the tiles of points, sums their products
//   on the tensor cores (both terms of a second-order gradient, h^T dz +
//   gb^T u, as one sum), and writes its partial tile; a reduce adds the
//   shares in order. The pass reads each record ~2x (~5 GB a production
//   step), and the records cost ~2.6 GB of device memory at the step's
//   352,000 points.
#include "fused_mlp_tc.cuh"
#include "fused_mlp_tiled.cuh"

using namespace fmlp_tiled;
using fmlp::O_K10T;
using fmlp::O_K9T;
using fmlp::G_FLOATS;

namespace fmlp_tc {

using fmlp::O_K1;
using fmlp::O_K5B;
using fmlp::O_K8;
using fmlp::O_K9;
using fmlp::O_B9;

// a block's slice of `small`: k8, b1..b7, b8 (G's [O_K8, O_B8]), then b9,
// k10, b10 (G's [O_B9, G_FLOATS))
constexpr int S_K8 = 0;
constexpr int S_B1 = S_K8 + W;         // b_l at S_B1 + (l - 1) * W
constexpr int S_B8 = S_B1 + 7 * W;
constexpr int S_HEAD = S_B8 + 1;       // = O_B8 + 1 - O_K8
constexpr int S_B9 = S_HEAD;
constexpr int S_K10 = S_B9 + E;
constexpr int S_B10 = S_K10 + 3 * E;
constexpr int SMALL = S_B10 + 3;
static_assert(S_HEAD == fmlp::O_B8 + 1 - O_K8 && SMALL - S_HEAD == G_FLOATS - O_B9,
              "the small slice mirrors G's two runs");

// The bfloat16-fed backward chain on the tensor-core core: the tile's rows
// into its record (the weight-gradient pass reads them), the small sums into
// the block's slice. Every routine ends on a barrier; the barriers here
// order the per-thread loops between them.
template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_bwd_tc_kernel(const float* __restrict__ x, const float* __restrict__ sbar,
                        const float* __restrict__ ebar, const float* __restrict__ gbar,
                        const float* __restrict__ w, const bf* __restrict__ wb,
                        float* __restrict__ xbar, float* __restrict__ gpe,
                        float* __restrict__ small, bf* __restrict__ rows, int n) {
  using R = Rec<COLOR>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf* sm = reinterpret_cast<bf*>(smem);
  float* sb = reinterpret_cast<float*>(smem + SLAB_BYTES);  // sbar of the tile, then ebar's 3 rows
  float* eb = sb + P;
  float* G = small + (size_t)blockIdx.x * SMALL;
  const int ntiles = (n + P - 1) / P;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int t0 = t * P;
    bf* r = rows + (size_t)t * R::ROWS * P;
    for (int i = threadIdx.x; i < 4 * P; i += NT) {
      const int k = i / P, p = i % P;
      const bool v = t0 + p < n && (k == 0 || COLOR);
      sb[i] = !v ? 0.f : k == 0 ? sbar[t0 + p] : ebar[(size_t)(t0 + p) * 3 + k - 1];
    }
    load_rows_bf(rrow(r, R::X), x, IN, XR, t0, n, reinterpret_cast<float*>(smem));
    if (COLOR) load_rows_bf(rrow(r, R::GBAR), gbar, PE, XR, t0, n, reinterpret_cast<float*>(smem));
    // h1..h7, the forward's; k8 += sum_p sbar h7 on the way
    backbone<COLOR, true>(sm, r, w, wb, sb, G + S_K8);

    // ---- first order: the sigma and essence cotangents ----
    if (COLOR) {
      essence_hidden<COLOR>(sm, r, w, wb);  // e1, the forward's
      const bf* e1 = rrow(r, R::E1);
      // the narrow essence head, one thread per j: de1 = (ebar K10^T) * (e1
      // > 0) into the DE1 rows, b9 += its sum over the tile
      if (threadIdx.x < E) {
        const int j = threadIdx.x;
        float k10[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) k10[k] = op(__ldg(w + fmlp::O_K10T + k * E + j));
        float bsum = 0.f;
        for (int p0 = 0; p0 < P; p0 += 8) {
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int p = p0 + q;
            float z = 0.f;
#pragma unroll
            for (int k = 0; k < 3; ++k) z = fmaf(op(eb[k * P + p]), k10[k], z);
            z = e1[j * P + p] != 0 ? z : 0.f;
            bsum += z;
            const uint32_t b = to_bf(z);
            v[q / 2] = q % 2 == 0 ? b : v[q / 2] | (b << 16);
          }
          *reinterpret_cast<uint4*>(rrow(r, R::DE1) + j * P + p0) = make_uint4(v[0], v[1], v[2], v[3]);
        }
        G[S_B9 + j] += bsum;
      }
      // K10 (E, 3) and b10: one owner thread per element
      for (int i = threadIdx.x; i < E * 3 + 3; i += NT) {
        const float* b = eb + (i < E * 3 ? i % 3 : i - E * 3) * P;
        float acc = 0.f;
        if (i < E * 3) {
          const bf* a = e1 + (i / 3) * P;
          for (int p = 0; p < P; ++p) acc = fmaf(from_bf(a[p]), op(b[p]), acc);
          G[S_K10 + i] += acc;
        } else {
          for (int p = 0; p < P; ++p) acc += b[p];
          G[S_B10 + i - E * 3] += acc;
        }
      }
      __syncthreads();
    }
    // dz7 = m7 * (sbar k8 + de1 K9^T); b7 += its sum
    {
      Epi e = epi_rows(rrow(r, R::DZ + 6 * W), rrow(r, R::H + 6 * W));
      e.rs = sb;
      e.cv = w + O_K8;
      e.gsum = G + S_B1 + 6 * W;
      tlayer<RANK1 | MASK | WSUM, W>(sm, COLOR ? Pair{rrow(r, R::DE1), wb + B_K9T, E} : none(),
                                     none(), e);
    }
    if (threadIdx.x == 0) {  // b8: the sum of sbar over the tile
      float s = 0.f;
      for (int p = 0; p < P; ++p) s += sb[p];
      G[S_B8] += s;
    }
    // dz6 = m6 (dz7 K7^T), ..., dz4 = m4 (dz5 K5a^T), ..., dz1; b_l += their sums
    for (int l = 7; l >= 2; --l) {
      Epi e = epi_rows(rrow(r, R::DZ + (l - 2) * W), rrow(r, R::H + (l - 2) * W));
      e.gsum = G + S_B1 + (l - 2) * W;
      tlayer<MASK | WSUM, W>(sm, {rrow(r, R::DZ + (l - 1) * W), wb + bkt(l), W}, none(), e);
    }
    // xbar = dz1 K1^T, plus dz5 K5b^T on the pe lanes (the skip layer)
    {
      Epi e = epi_rows(nullptr);
      e.fout = xbar;
      e.J = IN;
      e.t0 = t0;
      e.n = n;
      tlayer<F32OUT, 128>(sm, {rrow(r, R::DZ), wb + B_K1T, W},
                          {rrow(r, R::DZ + 4 * W), wb + B_K5BT, W}, e);
    }

    // ---- second order: the g-recursion (u7..u1, gpe) and its vjp up the
    // chain: gb1 = m1 (gbar K1[:63]), gb_l = m_l (gb_{l-1} K_l), gb5 = m5
    // (gb4 K5a + gbar K5b); k8 += the sum of gb7 ----
    if (COLOR) {
      g_chain<COLOR>(sm, r, w, wb, gpe, t0, n);  // u7..u1 and gpe, the forward's
      tlayer<MASK, W>(sm, {rrow(r, R::GBAR), wb + B_K1, 64}, none(),
                      epi_rows(rrow(r, R::GB), rrow(r, R::H)));
      for (int l = 2; l <= 6; ++l)
        tlayer<MASK, W>(sm, {rrow(r, R::GB + (l - 2) * W), wb + bk(l), W},
                        l == 5 ? Pair{rrow(r, R::GBAR), wb + B_K5B, 64} : none(),
                        epi_rows(rrow(r, R::GB + (l - 1) * W), rrow(r, R::H + (l - 1) * W)));
      Epi e = epi_rows(nullptr, rrow(r, R::H + 6 * W));
      e.gsum = G + S_K8;
      tlayer<MASK | WSUM, W>(sm, {rrow(r, R::GB + 5 * W), wb + B_K7, W}, none(), e);
    }
    __syncthreads();  // the next tile's loads reuse the shared rows
  }
}

// ---- the weight-gradient pass --------------------------------------------------------
// Job i: G[off + k * J + j] = sum over every tile's points of A1[k][p]
// B1[j][p] (+ A2[k][p] B2[j][p] with color), the operands rows of the tile's
// record (row offsets), k < K, j < J. The float32 pass runs the same jobs
// on its own records.
struct Job {
  int a1, b1, a2, b2, K, J, off;
};
template <bool COLOR, class R = Rec<COLOR>>
__device__ __forceinline__ Job job(int i) {
  const int a2 = COLOR ? R::GBAR : -1;
  if (i == 0) return {R::X, R::DZ, a2, R::U, IN, W, O_K1};  // K1: x^T dz1 + gbar^T u1
  if (i <= 6) {                                            // K2..K7 (K5a): h^T dz + gb^T u
    const int l = i + 1;
    return {R::H + (l - 2) * W, R::DZ + (l - 1) * W, COLOR ? R::GB + (l - 2) * W : -1,
            R::U + (l - 1) * W, W, W, l == 5 ? fmlp::O_K5A : fmlp::k_off(l)};
  }
  if (i == 7) return {R::X, R::DZ + 4 * W, a2, R::U + 4 * W, PE, W, O_K5B};  // pe^T dz5 + gbar^T u5
  return {R::H + 6 * W, R::DE1, -1, -1, W, E, O_K9};                           // K9: h7^T de1
}
constexpr int GT = 128;                 // a gradient tile, GT x GT
constexpr int LDP = P + 8;              // bf16 row stride of a staged operand slab (144 bytes)
constexpr int G_STAGE = 2 * GT * LDP;   // bf16 of one stage: A and B rows of one tile of points
constexpr int WGRAD_SMEM = 2 * G_STAGE * 2;
__host__ __device__ constexpr int njobs(bool color) { return color ? 9 : 8; }
__host__ __device__ constexpr int job_tiles(int i) { return i == 0 || i == 7 ? 2 : i == 8 ? 2 : 4; }
__host__ __device__ constexpr int gemm_tiles(bool color) { return color ? 30 : 28; }

// tile index -> its job, and its first row k0 and column j0; R: the record
// whose rows the job names (the float32 backward's is Rec32)
template <bool COLOR, class R = Rec<COLOR>>
__device__ __forceinline__ Job gemm_tile(int tile, int& k0, int& j0) {
  int i = 0;
  while (tile >= job_tiles(i)) tile -= job_tiles(i++);
  const Job jb = job<COLOR, R>(i);
  const int jt = (jb.J + GT - 1) / GT;
  k0 = (tile / jt) * GT;
  j0 = (tile % jt) * GT;
  return jb;
}

// one tile of points of one term into a stage: As[k][p] (GT rows of A from
// k0), Bs[j][p] (GT rows of B from j0); rows past K / J are zeros
__device__ __forceinline__ void gslab_load(bf* st, const bf* rec, int a, int b, int K, int J, int k0,
                                           int j0) {
  bf* As = st;
  bf* Bs = st + GT * LDP;
#pragma unroll
  for (int u = 0; u < GT * (P / 8) / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    const int rr = i / (P / 8), c = 8 * (i % (P / 8));
    const bool va = k0 + rr < K, vb = j0 + rr < J;
    cp16(As + rr * LDP + c, va ? rec + (size_t)(a + k0 + rr) * P + c : rec, va);
    cp16(Bs + rr * LDP + c, vb ? rec + (size_t)(b + j0 + rr) * P + c : rec, vb);
  }
  cp_commit();
}

// Block (tile, s): the gradient tile's sum over the tiles of points [ta, tb)
// of split s, both terms of each in turn, into its partial tile
// part[s][tile]. Warp (wk, wj) owns rows 64 wk.. and columns 32 wj.. of the
// tile: 4 x 4 MMA tiles; A = the A rows ([k][p], `ldmatrix`), B = the B rows
// read as [j][p] (`ldmatrix`). The MMAs sum FLUSH tiles of points at a
// time (a tensor core truncates the small terms of a long sum); each such
// sum is added to the partial tile, which only this thread touches, with
// one rounding.
constexpr int FLUSH = 16;
template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_wgrad_kernel(const bf* __restrict__ rows, int ntiles, int splits, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf* sm = reinterpret_cast<bf*>(smem);
  int k0, j0;
  const Job jb = gemm_tile<COLOR>(blockIdx.x, k0, j0);
  const int s = blockIdx.y;
  const int ta = (int)((long long)ntiles * s / splits), tb = (int)((long long)ntiles * (s + 1) / splits);
  const int terms = jb.a2 >= 0 ? 2 : 1;
  const int n = (tb - ta) * terms;
  const size_t rec = (size_t)Rec<COLOR>::ROWS * P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wk = warp >> 2, wj = warp & 3, mi = lane >> 3, mr = lane & 7;
  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;
  auto load = [&](int q) {
    const int t = ta + q / terms;
    const bool second = q % terms == 1;
    gslab_load(sm + (q & 1) * G_STAGE, rows + t * rec, second ? jb.a2 : jb.a1,
               second ? jb.b2 : jb.b1, jb.K, jb.J, k0, j0);
  };
  float* out = part + ((size_t)s * gridDim.x + blockIdx.x) * GT * GT;
  const int g = lane >> 2, tq = lane & 3;
  bool first = true;
  auto flush = [&]() {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = wk * 64 + mt * 16 + g + 8 * h, j = wj * 32 + nt * 8 + 2 * tq;
          float2* o = reinterpret_cast<float2*>(out + k * GT + j);
          float2 v = first ? make_float2(0.f, 0.f) : *o;
          v.x += acc[mt][nt][2 * h];
          v.y += acc[mt][nt][2 * h + 1];
          *o = v;
          acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
        }
    first = false;
  };
  if (n > 0) {
    load(0);
    for (int q = 0; q < n; ++q) {
      if (q + 1 < n) {
        load(q + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const bf* As = sm + (q & 1) * G_STAGE;
      const bf* Bs = As + GT * LDP;
#pragma unroll
      for (int pp = 0; pp < P; pp += 16) {
        // A: matrices (k 0-7, p 0-7), (k 8-15, p 0-7), (k 0-7, p 8-15), (k 8-15, p 8-15)
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldsm4(a[mt], As + (wk * 64 + mt * 16 + mr + ((mi & 1) << 3)) * LDP + pp + ((mi >> 1) << 3));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          // B: matrices (j 0-7, p 0-7), (j 0-7, p 8-15), (j 8-15, p 0-7), (j 8-15, p 8-15)
          uint32_t b[4];
          ldsm4(b, Bs + (wj * 32 + np * 16 + mr + ((mi >> 1) << 3)) * LDP + pp + ((mi & 1) << 3));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
      __syncthreads();
      if ((q + 1) % (FLUSH * terms) == 0 || q + 1 == n) flush();
    }
  }
  if (first) flush();  // no points: zeros
}

// grads of the pass's gradients = the splits' partial tiles added in order
template <bool COLOR>
__global__ void fused_mlp_wgrad_reduce(const float* __restrict__ part, int splits,
                                       float* __restrict__ grads) {
  int k0, j0;
  const Job jb = gemm_tile<COLOR>(blockIdx.y, k0, j0);
  const int e = blockIdx.x * blockDim.x + threadIdx.x, k = e / GT, j = e % GT;
  if (k0 + k >= jb.K || j0 + j >= jb.J) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[((size_t)s * gridDim.y + blockIdx.y) * GT * GT + e];
  grads[jb.off + (size_t)(k0 + k) * jb.J + j0 + j] = acc;
}

// grads of the small sums = the blocks' slices added in block order
__global__ void fused_mlp_small_reduce(const float* __restrict__ small, int nblocks,
                                       float* __restrict__ grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= SMALL) return;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b) acc += small[(size_t)b * SMALL + i];
  grads[i < S_HEAD ? O_K8 + i : O_B9 + i - S_HEAD] = acc;
}

template <bool COLOR>
static cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_bwd_tc_kernel<COLOR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fused_mlp_wgrad_kernel<COLOR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, WGRAD_SMEM);
}

static int grid_blocks(int with_color) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  cudaError_t err = with_color ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return -1;
  err = with_color
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_tc_kernel<true>, NT,
                                                      SMEM_BYTES)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_tc_kernel<false>, NT,
                                                      SMEM_BYTES);
  if (err != cudaSuccess) return -1;
  return sms * per_sm;
}

template <bool COLOR>
static int launch(const float* x, const float* sbar, const float* ebar, const float* gbar,
                  const float* w, const bf* wb, float* xbar, float* gpe, float* small, float* part,
                  bf* rows, float* grads, int n, int blocks, int splits, cudaStream_t st) {
  const int ntiles = (n + P - 1) / P;
  const int grid = blocks < ntiles ? blocks : ntiles;
  cudaError_t err = allow_smem<COLOR>();
  if (err != cudaSuccess) return (int)err;
  if (grid > 0) {
    fused_mlp_bwd_tc_kernel<COLOR><<<grid, NT, SMEM_BYTES, st>>>(x, sbar, ebar, gbar, w, wb, xbar,
                                                                 gpe, small, rows, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fused_mlp_wgrad_kernel<COLOR><<<dim3(gemm_tiles(COLOR), splits), NT, WGRAD_SMEM, st>>>(
        rows, ntiles, splits, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fused_mlp_wgrad_reduce<COLOR><<<dim3(GT * GT / 256, gemm_tiles(COLOR)), 256, 0, st>>>(
        part, splits, grads);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  fused_mlp_small_reduce<<<(SMALL + 255) / 256, 256, 0, st>>>(small, grid > 0 ? grid : 0, grads);
  return (int)cudaGetLastError();
}

}  // namespace fmlp_tc

// ---- the float32 backward ---------------------------------------------------------
using fmlp_tc::S_B1;
using fmlp_tc::S_B10;
using fmlp_tc::S_B8;
using fmlp_tc::S_B9;
using fmlp_tc::S_K10;
using fmlp_tc::S_K8;
using fmlp_tc::SMALL;

// The rows of one tile's record (P floats each). With color, the tiled
// core's scratch layout, so that the routines the forward shares (backbone,
// essence_hidden, g_chain) write h, e1, u and gpe where the forward's do;
// then gb1..gb6, and gb7 (only summed) in the scratch's gb rows.
// Density-only: x, h1..h7, dz1..dz7, sbar and the xbar tile. The names are
// the bf16 record's (fmlp_tc::Rec), so the pass runs the bf16 pass's jobs.
template <bool COLOR>
struct Rec32 {
  static constexpr int X = R_X;
  static constexpr int H = R_H;
  static constexpr int U = R_U;
  static constexpr int DZ = COLOR ? R_DZ : R_U;
  static constexpr int E1 = R_E1;
  static constexpr int DE1 = R_DE1;
  static constexpr int EB = R_EB;
  static constexpr int GBAR = R_GBAR;  // 87 rows, 63..86 zero
  static constexpr int GB7 = R_GB;
  static constexpr int SB = COLOR ? R_SB : DZ + 7 * W;
  static constexpr int OUT = COLOR ? R_OUT : SB + 1;
  static constexpr int GB = fmlp_tiled::ROWS;  // gb1..gb6
  static constexpr int ROWS = COLOR ? GB + 6 * W : OUT + 88;
};

// gsum[j] += the sum over the tile's points of rows[j], j < J: one owner
// thread per j
__device__ __forceinline__ void row_sums(const float* rows, int J, float* gsum) {
  for (int j = threadIdx.x; j < J; j += NT) {
    const float4* b = reinterpret_cast<const float4*>(rows + j * P);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 v = b[q];
      s += v.x; s += v.y; s += v.z; s += v.w;
    }
    gsum[j] += s;
  }
}

// The chain: tile t's rows into record t, the small sums into the block's
// slice of `small`. Every routine of the tiled core ends on a barrier; the
// barriers here order the per-thread loops between them.
template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_bwd_kernel(const float* __restrict__ x, const float* __restrict__ sbar,
                     const float* __restrict__ ebar, const float* __restrict__ gbar,
                     const float* __restrict__ w, float* __restrict__ xbar,
                     float* __restrict__ gpe, float* __restrict__ small,
                     float* __restrict__ rec, int n) {
  using R = Rec32<COLOR>;
  extern __shared__ __align__(16) float sm[];
  float* G = small + (size_t)blockIdx.x * SMALL;
  const int ntiles = (n + P - 1) / P;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int t0 = t * P;
    float* s = rec + (size_t)t * R::ROWS * P;
    auto dz = [&](int l) { return s + (R::DZ + (l - 1) * W) * P; };
    auto gb = [&](int l) { return s + (l == 7 ? R::GB7 : R::GB + (l - 1) * W) * P; };
    load_rows(row(s, R::X), x, IN, t0, n);
    load_rows(row(s, R::SB), sbar, 1, t0, n);
    if (COLOR) {
      load_rows(row(s, R::EB), ebar, 3, t0, n);
      load_rows(row(s, R::GBAR), gbar, PE, t0, n);
      // K1's gradient takes gbar as an 87-row operand: rows 63..86 zero
      for (int i = threadIdx.x; i < (IN - PE) * P; i += NT) row(s, R::GBAR + PE)[i] = 0.f;
    }
    __syncthreads();
    backbone(sm, s, w);  // h1..h7, the forward's

    // ---- first order: the sigma and essence cotangents ----
    if (COLOR) {
      essence_hidden(sm, s, w);  // e1 = relu(h7 K9 + b9), the forward's
      // the narrow essence head, per thread: de1 = (ebar K10^T) * (z9 > 0),
      // and z9 > 0 exactly where e1 > 0
      for (int i = threadIdx.x; i < E * P; i += NT) {
        const int j = i / P, p = i - j * P;
        float z = 0.f;
        for (int k = 0; k < 3; ++k)
          z = fmaf(row(s, R::EB + k)[p], __ldg(w + O_K10T + k * E + j), z);
        row(s, R::DE1)[i] = row(s, R::E1)[i] > 0.f ? z : 0.f;
      }
      // K10 (E, 3) and b10: one owner thread per element
      for (int i = threadIdx.x; i < E * 3 + 3; i += NT) {
        const float* a = i < E * 3 ? row(s, R::E1 + i / 3) : nullptr;
        const float* b = row(s, R::EB + (i < E * 3 ? i % 3 : i - E * 3));
        float acc = 0.f;
        for (int p = 0; p < P; ++p)
          acc = a != nullptr ? fmaf(a[p], b[p], acc) : acc + b[p];
        G[i < E * 3 ? S_K10 + i : S_B10 + i - E * 3] += acc;
      }
      __syncthreads();
      row_sums(row(s, R::DE1), E, G + S_B9);
    }
    // dz7 = m7 * (sbar k8 + de1 K9^T)
    layer<RANK1 | MASK, true>(sm, dz(7), W, COLOR ? wide(row(s, R::DE1), E, w + O_K9T) : none(),
                              none(), nullptr, hrow(s, 7), row(s, R::SB), w + O_K8);
    // k8 and b8: sums of sbar h7 and of sbar over the tile, one owner each
    for (int j = threadIdx.x; j < W; j += NT) {
      const float* h7 = hrow(s, 7) + j * P;
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc = fmaf(row(s, R::SB)[p], h7[p], acc);
      G[S_K8 + j] += acc;
    }
    if (threadIdx.x == 0) {
      float sb = 0.f;
      for (int p = 0; p < P; ++p) sb += row(s, R::SB)[p];
      G[S_B8] += sb;
    }
    // dz6 = m6 (dz7 K7^T), ..., dz4 = m4 (dz5 K5a^T), ..., dz1
    for (int l = 7; l >= 2; --l) masked(sm, dz(l - 1), dz(l), w + ktw(l), hrow(s, l - 1));
    // xbar = dz1 K1^T, plus dz5 K5b^T on the pe lanes (the skip layer); the
    // transposes' rows are 87 and 63 floats: 4-byte copies
    layer<0, false, 128>(sm, row(s, R::OUT), IN, {dz(1), w + O_K1T, W, IN, IN},
                         {dz(5), w + O_K5BT, W, PE, PE}, nullptr, nullptr, nullptr, nullptr);
    store_rows(xbar, row(s, R::OUT), IN, t0, n);
    for (int l = 1; l <= 7; ++l) row_sums(dz(l), W, G + S_B1 + (l - 1) * W);  // b1..b7

    // ---- second order: the g-recursion (u7..u1, gpe) and its vjp up the
    // chain, gb1..gb7; k8 += the sum of gb7 ----
    if (COLOR) {
      g_chain(sm, s, w);  // u7..u1 and gpe, the forward's
      store_rows(gpe, row(s, R_OUT2), PE, t0, n);
      layer<MASK, true>(sm, gb(1), W, wide(row(s, R::GBAR), PE, w + O_K1), none(), nullptr,
                        hrow(s, 1), nullptr, nullptr);
      for (int l = 2; l <= 7; ++l)
        layer<MASK, true>(sm, gb(l), W, wide(gb(l - 1), W, w + kw(l)),
                          l == 5 ? wide(row(s, R::GBAR), PE, w + O_K5B) : none(), nullptr,
                          hrow(s, l), nullptr, nullptr);
      for (int j = threadIdx.x; j < W; j += NT) {
        const float* g7 = gb(7) + j * P;
        float acc = 0.f;
        for (int p = 0; p < P; ++p) acc += g7[p];
        G[S_K8 + j] += acc;
      }
    }
    __syncthreads();  // the next tile's loads reuse the shared memory
  }
}

// The weight-gradient pass. Block (tile, s): the gradient tile's sum over
// the records [ta, tb) of split s, both terms of each in turn, into its
// partial tile part[s][tile] (accumulate: added to it, as a later chunk's
// pass does). Thread (tx, ty) keeps rows ty + 16 i and columns tx + 16 jj
// of the tile (`wslab_mac`); every FLUSH records of points its sums are
// added to the partial tile, whose entries only it touches, so that no
// float32 sum runs over more than FLUSH * 2P terms.
constexpr int FLUSH = 4;
static_assert(2 * W_STAGE <= SMEM_FLOATS, "the pass's two stages fit the chain's shared memory");
template <bool COLOR>
__global__ void __launch_bounds__(NT, 2)
fused_mlp_wgrad_f32_kernel(const float* __restrict__ rec, int ntiles, int splits, int accumulate,
                           float* __restrict__ part) {
  using R = Rec32<COLOR>;
  extern __shared__ __align__(16) float sm[];
  int k0, j0;
  const fmlp_tc::Job jb = fmlp_tc::gemm_tile<COLOR, R>(blockIdx.x, k0, j0);
  const int s = blockIdx.y;
  const int ta = (int)((long long)ntiles * s / splits), tb = (int)((long long)ntiles * (s + 1) / splits);
  constexpr int NS = P / BP;  // p-slabs a record
  const int per_tile = (jb.a2 >= 0 ? 2 : 1) * NS;
  const int n = (tb - ta) * per_tile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  auto load = [&](int q) {
    const float* r = rec + (size_t)(ta + q / per_tile) * R::ROWS * P;
    const bool second = q % per_tile >= NS;
    wslab_load(sm + (q & 1) * W_STAGE, r + (second ? jb.a2 : jb.a1) * P,
               r + (second ? jb.b2 : jb.b1) * P, jb.K, jb.J, k0, j0, (q % NS) * BP);
  };
  float* out = part + ((size_t)s * gridDim.x + blockIdx.x) * WG * WG;
  bool first = !accumulate;
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float* o = out + (ty + 16 * i) * WG + tx + 16 * jj;
        *o = (first ? 0.f : *o) + acc[i][jj];
        acc[i][jj] = 0.f;
      }
    first = false;
  };
  if (n > 0) {
    load(0);
    for (int q = 0; q < n; ++q) {
      if (q + 1 < n) {
        load(q + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      wslab_mac(sm + (q & 1) * W_STAGE, acc);
      __syncthreads();
      if ((q + 1) % (FLUSH * per_tile) == 0 || q + 1 == n) flush();
    }
  }
  if (first) flush();  // no points, and the first chunk: zeros
}

template <bool COLOR>
static cudaError_t allow_smem() {
  cudaError_t e = cudaFuncSetAttribute(fused_mlp_bwd_kernel<COLOR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fused_mlp_wgrad_f32_kernel<COLOR>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

static int grid_blocks(int with_color) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
  cudaError_t err = with_color ? allow_smem<true>() : allow_smem<false>();
  if (err != cudaSuccess) return -1;
  err = with_color
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel<true>, NT,
                                                      SMEM_BYTES)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel<false>, NT,
                                                      SMEM_BYTES);
  if (err != cudaSuccess) return -1;
  return sms * per_sm;
}

// Per chunk of `chunk` records: the chain over its points, then the pass
// (into `part`, added to it after the first chunk); then the two reduces.
template <bool COLOR>
static int launch(const float* x, const float* sbar, const float* ebar, const float* gbar,
                  const float* w, float* xbar, float* gpe, float* small, float* part, float* rec,
                  float* grads, int n, int blocks, int chunk, int splits, cudaStream_t st) {
  const int ntiles = (n + P - 1) / P;
  const int grid = blocks < chunk ? blocks : chunk;
  const int tiles = fmlp_tc::gemm_tiles(COLOR);
  cudaError_t err = allow_smem<COLOR>();
  if (err != cudaSuccess) return (int)err;
  for (int t0 = 0; t0 < ntiles; t0 += chunk) {
    const int m = ntiles - t0 < chunk ? ntiles - t0 : chunk;
    const size_t p0 = (size_t)t0 * P;
    const int nc = n - (int)p0 < m * P ? n - (int)p0 : m * P;
    fused_mlp_bwd_kernel<COLOR><<<m < grid ? m : grid, NT, SMEM_BYTES, st>>>(
        x + p0 * IN, sbar + p0, COLOR ? ebar + p0 * 3 : nullptr, COLOR ? gbar + p0 * PE : nullptr, w,
        xbar + p0 * IN, COLOR ? gpe + p0 * PE : nullptr, small, rec, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fused_mlp_wgrad_f32_kernel<COLOR><<<dim3(tiles, splits), NT, SMEM_BYTES, st>>>(rec, m, splits,
                                                                                 t0 > 0, part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (ntiles > 0) {
    fmlp_tc::fused_mlp_wgrad_reduce<COLOR><<<dim3(WG * WG / 256, tiles), 256, 0, st>>>(part, splits,
                                                                                      grads);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  fmlp_tc::fused_mlp_small_reduce<<<(SMALL + 255) / 256, 256, 0, st>>>(small, ntiles > 0 ? grid : 0,
                                                                       grads);
  return (int)cudaGetLastError();
}

// The float32 kernel's sizes: resident blocks of the chain's grid; floats
// of one tile's record; points a tile; gradient tiles of the pass; floats
// of a block's slice of `small`; dynamic shared bytes of the chain and of
// the pass.
extern "C" int fused_mlp_bwd_blocks(int with_color) { return grid_blocks(with_color); }
extern "C" int fused_mlp_bwd_record(int with_color) {
  return (with_color ? Rec32<true>::ROWS : Rec32<false>::ROWS) * P;
}
extern "C" int fused_mlp_bwd_tile(int) { return P; }
extern "C" int fused_mlp_bwd_gemm_tiles(int with_color) { return fmlp_tc::gemm_tiles(with_color); }
extern "C" int fused_mlp_bwd_small(int) { return SMALL; }
extern "C" int fused_mlp_bwd_smem(int) { return SMEM_BYTES; }

// x (n, 87), sbar (n,), ebar (n, 3), gbar (n, 63) (the last two with color);
// w the flat weights; out: xbar (n, 87), gpe (n, 63) (with color), grads
// (G_FLOATS), zeros (the density-only variant leaves the color heads'
// entries as they are). small: blocks * small floats, zeros; part: splits *
// gemm tiles * 128 * 128 floats; rec: chunk records; chunk >= 1 tiles a
// chunk, splits >= 1 shares a chunk (ops/fused_mlp.py::wgrad_plan).
extern "C" int fused_mlp_bwd_launch(const float* x, const float* sbar, const float* ebar,
                                    const float* gbar, const float* w, float* xbar, float* gpe,
                                    float* small, float* part, float* rec, float* grads, int n,
                                    int with_color, int blocks, int chunk, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_color
      ? launch<true>(x, sbar, ebar, gbar, w, xbar, gpe, small, part, rec, grads, n, blocks, chunk,
                     splits, st)
      : launch<false>(x, sbar, ebar, gbar, w, xbar, gpe, small, part, rec, grads, n, blocks, chunk,
                      splits, st);
}

// The bfloat16-fed variant. Its sizes: resident blocks of the chain's grid;
// bf16 of one tile's record; gradient tiles of the weight-gradient pass;
// floats of a block's slice of `small`; dynamic shared bytes of the chain
// and of the pass.
extern "C" int fused_mlp_bwd_fast_blocks(int with_color) { return fmlp_tc::grid_blocks(with_color); }
extern "C" int fused_mlp_bwd_fast_record(int with_color) {
  return (with_color ? fmlp_tc::Rec<true>::ROWS : fmlp_tc::Rec<false>::ROWS) * fmlp_tc::P;
}
extern "C" int fused_mlp_bwd_fast_gemm_tiles(int with_color) { return fmlp_tc::gemm_tiles(with_color); }
extern "C" int fused_mlp_bwd_fast_small(int) { return fmlp_tc::SMALL; }
extern "C" int fused_mlp_bwd_fast_smem(int) { return fmlp_tc::SMEM_BYTES; }
extern "C" int fused_mlp_bwd_fast_wgrad_smem(int) { return fmlp_tc::WGRAD_SMEM; }

// x, sbar, ebar, gbar, w, xbar, gpe as above; wb the bf16 weight buffer;
// small: blocks * small floats, zeros; part: splits * gemm tiles * 128 * 128
// floats; rows: ceil(n / 64) records of bf16; grads (G_FLOATS), zeros (the
// density-only variant leaves the color heads' entries as they are).
extern "C" int fused_mlp_bwd_fast_launch(const float* x, const float* sbar, const float* ebar,
                                         const float* gbar, const float* w, const void* wb,
                                         float* xbar, float* gpe, float* small, float* part,
                                         void* rows, float* grads, int n, int with_color,
                                         int blocks, int splits, void* stream) {
  const auto* b = static_cast<const fmlp_tc::bf*>(wb);
  auto* r = static_cast<fmlp_tc::bf*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_color
      ? fmlp_tc::launch<true>(x, sbar, ebar, gbar, w, b, xbar, gpe, small, part, r, grads, n,
                              blocks, splits, st)
      : fmlp_tc::launch<false>(x, sbar, ebar, gbar, w, b, xbar, gpe, small, part, r, grads, n,
                               blocks, splits, st);
}
