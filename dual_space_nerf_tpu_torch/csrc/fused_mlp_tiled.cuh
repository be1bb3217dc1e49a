// The fused SpaceNet chain's tiled product core for the float32 pair:
// shared-memory operand slabs and register micro-tiles, FP32 on the CUDA
// cores. The float32 kernels of fused_mlp_fwd.cu and fused_mlp_bwd.cu run
// on it, through the same backbone, e1 and g-chain routines (end of this
// file); the weight layout and the widths are fused_mlp.cuh's.
//
// Design:
// - A persistent grid of 256-thread blocks, two per SM; block b takes the
//   tiles of P = 64 points b, b + grid, ... in order.
// - The activations of a tile live in device memory, in the block's own
//   scratch (the forward) or in the tile's record (the backward, whose
//   weight-gradient pass reads them afterwards), feature-major: row f holds
//   feature f of the P points, so a row is 16 float4s. They reach shared
//   memory only in bulk, as 16-byte `cp.async` copies of whole slabs, never
//   as per-thread reads.
// - A layer product out[j][p] = sum_k in[k][p] M[k][j] (M row-major, the
//   weight or its packed transpose) streams k-slabs of BK rows of M and of
//   the input rows through two shared buffers: the copy of slab s + 1 is in
//   flight while slab s is multiplied. Thread (lane, warp) keeps an 8 x 8
//   micro-tile in registers, columns
//   4 lane .. 4 lane + 3 and 128 + the same, points 8 warp .. 8 warp + 7.
//   Per k it reads two float4s of M (a warp reads 512 contiguous bytes) and
//   two of the input (one address per warp): 64 FMAs per 4 shared loads. A
//   narrow product (J <= 128: the essence head's hidden layer, xbar, gpe)
//   keeps 4 x 8.
// - The backward's weight gradients G[k][j] = sum_p A[k][p] B[j][p] are a
//   pass of their own over the tiles' records (fused_mlp_bwd.cu), on the
//   slab routines at the end of the products: output tiles of 128 x 128,
//   p-slabs of BP points of 128 rows of A and of B through two shared
//   buffers (rows BP + 4 floats apart, so that eight neighbouring rows fall
//   in eight distinct bank groups); thread (tx, ty) keeps G's rows ty + 16 i
//   and columns tx + 16 i, i < 8, and reads eight float4s of B and eight of
//   A per four points: 256 FMAs per 16 shared loads. A block sums its share
//   of the records in registers and adds the sums to its partial tile every
//   few records of points.
// - Output tiles go back through shared memory, so that the epilogues read
//   and write device memory in whole rows of float4s.
// - `layer` is not inlined: it gets the 128 registers of the launch bounds
//   to itself (inlined into the kernel, the 64 accumulators and the
//   kernel's own state spilled).
// - Every sum runs over k (or p) in increasing order with one fmaf per term,
//   then the bias; the kernels' per-thread heads keep the same order. Rows
//   past K, columns past J and points past n come in as zeros and add
//   exactly nothing.
// - The bfloat16-fed pair (the `_fast` entry points) does not run here:
//   its products are on the tensor cores, fused_mlp_tc.cuh.
#pragma once

#include "fused_mlp.cuh"

namespace fmlp_tiled {

using fmlp::E;
using fmlp::IN;
using fmlp::PE;
using fmlp::W;
using fmlp::O_B1;
using fmlp::O_K1;
using fmlp::O_K1T;
using fmlp::O_K5A;
using fmlp::O_K5AT;
using fmlp::O_K5B;
using fmlp::O_K5BT;
using fmlp::O_K8;
using fmlp::O_K9;
using fmlp::O_B9;
using fmlp::k_off;
using fmlp::kt_off;

constexpr int P = 64;          // points per tile
constexpr int NT = 256;        // threads per block: 8 warps x 8 points
constexpr int BK = 16;         // k-slab of a layer product
constexpr int BP = 32;         // p-slab of a weight gradient
constexpr int WG = 128;        // weight-gradient output sub-tile, WG x WG
constexpr int LDW = BP + 4;    // shared row stride of the weight-gradient slabs
constexpr int LDO = P + 4;     // shared row stride of a staged layer output
constexpr int F_STAGE = BK * W + BK * P;  // floats of one layer-product slab
constexpr int W_STAGE = 2 * WG * LDW;     // floats of one weight-gradient slab
constexpr int cmax(int a, int b) { return a > b ? a : b; }
// two stages of slabs; a staged output tile reuses their room
constexpr int SMEM_FLOATS = cmax(cmax(2 * F_STAGE, 2 * W_STAGE), W * LDO);
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
static_assert(P == 8 * (NT / 32), "a layer product gives each warp 8 points");
static_assert(BK * P / 4 == NT, "one input chunk per thread and slab");
static_assert(NT == 2 * WG, "a weight-gradient sub-tile is 16 x 16 threads of 8 x 8");
static_assert(P % BP == 0 && BP % 4 == 0, "whole p-slabs of float4s");

// the scratch of one block (with color, the backward's record begins so), in
// rows of P floats
constexpr int R_X = 0;                 // x, 87 rows (+1)
constexpr int R_H = R_X + 88;          // h1..h7
constexpr int R_U = R_H + 7 * W;       // u1..u7 (g-recursion)
constexpr int R_DZ = R_U + 7 * W;      // dz1..dz7
constexpr int R_GB = R_DZ + 7 * W;     // two gb buffers
constexpr int R_E1 = R_GB + 2 * W;     // relu(h7 K9 + b9)
constexpr int R_DE1 = R_E1 + E;        // its cotangent
constexpr int R_SB = R_DE1 + E;        // sbar, 1 row
constexpr int R_EB = R_SB + 1;         // ebar, 3 rows
constexpr int R_GBAR = R_EB + 3;       // gbar as 87 rows, 63..86 zero (+1)
constexpr int R_OUT = R_GBAR + 88;     // an output tile, 87 rows (+1)
constexpr int R_OUT2 = R_OUT + 88;     // a second one, 63 rows (+1)
constexpr int ROWS = R_OUT2 + 64;
constexpr int SCRATCH_FLOATS = ROWS * P;

__device__ __forceinline__ float* row(float* s, int r) { return s + r * P; }
__device__ __forceinline__ float* hrow(float* s, int l) { return s + (R_H + (l - 1) * W) * P; }
__device__ __forceinline__ float* urow(float* s, int l) { return s + (R_U + (l - 1) * W) * P; }

// ---- asynchronous copies (cp.async; a copy of 0 source bytes fills zeros) ---
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The row copies between the tile and its point-major inputs and outputs
// take LB loads per thread into registers before the batch's stores: the
// compiler may not move a load past a store that could alias it, and one
// round trip per batch replaces one per element.
constexpr int LB = 8;

// rows [0, width) of dst <- the tile's points of src (n, width) row-major;
// points past n read as zero
__device__ void load_rows(float* dst, const float* __restrict__ src, int width, int t0, int n) {
  for (int b = 0; b < width * P; b += LB * NT) {
    float v[LB];
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int i = b + threadIdx.x + u * NT, p = i / width, f = i - p * width;
      v[u] = i < width * P && t0 + p < n ? src[(size_t)(t0 + p) * width + f] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int i = b + threadIdx.x + u * NT, p = i / width, f = i - p * width;
      if (i < width * P) dst[f * P + p] = v[u];
    }
  }
}

// the tile's valid points of out (n, width) row-major <- rows [0, width) of src
__device__ void store_rows(float* __restrict__ out, const float* src, int width, int t0, int n) {
  for (int b = 0; b < width * P; b += LB * NT) {
    float v[LB];
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int i = b + threadIdx.x + u * NT, p = i / width, f = i - p * width;
      v[u] = i < width * P ? src[f * P + p] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LB; ++u) {
      const int i = b + threadIdx.x + u * NT, p = i / width, f = i - p * width;
      if (i < width * P && t0 + p < n) out[(size_t)(t0 + p) * width + f] = v[u];
    }
  }
}

// ---- layer products ---------------------------------------------------------
// One operand pair of a layer product: K input rows `in` (scratch rows) and
// M (K, >= jv) row-major with row stride ldm; columns jv.. of M read as zero.
struct Src {
  const float* in;
  const float* M;
  int K, ldm, jv;
};

// the k-slab [k0, k0 + BK) of `s` into one shared stage: Ms[BK][JW], the
// first JW columns, and Is[BK][P]. ALIGNED: M and ldm are float4-aligned
// (16-byte copies), else 4-byte copies.
template <bool ALIGNED, int JW>
__device__ __forceinline__ void slab_load(float* st, const Src& s, int k0) {
  float* Ms = st;
  float* Is = st + BK * JW;
  {
    const int kk = threadIdx.x / (P / 4), c = 4 * (threadIdx.x % (P / 4));
    const bool v = k0 + kk < s.K;
    cp16(Is + kk * P + c, v ? s.in + (k0 + kk) * P + c : s.in, v);
  }
  if (ALIGNED) {
#pragma unroll
    for (int u = 0; u < BK * JW / 4 / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      const int kk = i / (JW / 4), j = 4 * (i % (JW / 4));
      const bool v = k0 + kk < s.K && j < s.jv;
      cp16(Ms + kk * JW + j, v ? s.M + (size_t)(k0 + kk) * s.ldm + j : s.M, v);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < BK * JW / NT; ++u) {
      const int i = threadIdx.x + u * NT;
      const int kk = i / JW, j = i % JW;
      const bool v = k0 + kk < s.K && j < s.jv;
      cp4(Ms + i, v ? s.M + (size_t)(k0 + kk) * s.ldm + j : s.M, v);
    }
  }
  cp_commit();
}

// acc[c][q] += sum over the slab's k of Is[k][8 warp + q] Ms[k][j_c], for
// the thread's columns j_c = 4 lane + c (c < 4) and, with JW = W, 128 + 4
// lane + c - 4 (c >= 4)
template <int JW>
__device__ __forceinline__ void slab_mac(const float* st, float (&acc)[8][8]) {
  constexpr int NC = JW / 32;  // columns per thread
  const float* Ms = st;
  const float* Is = st + BK * JW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(Ms + kk * JW + 4 * lane);
    const float4 a1 = NC == 8 ? *reinterpret_cast<const float4*>(Ms + kk * JW + 128 + 4 * lane)
                              : a0;
    const float4 b0 = *reinterpret_cast<const float4*>(Is + kk * P + 8 * warp);
    const float4 b1 = *reinterpret_cast<const float4*>(Is + kk * P + 8 * warp + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[c][q] = fmaf(b[q], a[c], acc[c][q]);
  }
}

// epilogues of `layer`
constexpr int BIAS = 1;   // + bias[j]
constexpr int RELU = 2;   // max(., 0)
constexpr int MASK = 4;   // 0 where mask[j][p] <= 0 (mask rows hold h = relu(z))
constexpr int RANK1 = 8;  // + rs[p] * cv[j] before the mask

// out[j][p] = epilogue(s1.in @ s1.M + s2.in @ s2.M) for j < J <= JW, JW =
// W or 128 (a narrow product); s2.K = 0 for one product, s1.K = 0 for none.
// out and the mask rows are scratch rows; rs is a scratch row. Ends on a
// barrier.
template <int EPI, bool ALIGNED, int JW = W>
__device__ __noinline__ void layer(float* sm, float* out, int J, const Src& s1, const Src& s2,
                                   const float* __restrict__ bias, const float* mask,
                                   const float* rs, const float* __restrict__ cv) {
  const int n1 = (s1.K + BK - 1) / BK;
  const int n = n1 + (s2.K + BK - 1) / BK;
  float acc[8][8];
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[c][q] = 0.f;
  if (n > 0) {
    slab_load<ALIGNED, JW>(sm, s1.K > 0 ? s1 : s2, 0);
    for (int s = 0; s < n; ++s) {
      if (s + 1 < n) {
        float* st = sm + ((s + 1) & 1) * F_STAGE;
        if (s + 1 < n1) slab_load<ALIGNED, JW>(st, s1, (s + 1) * BK);
        else slab_load<ALIGNED, JW>(st, s2, (s + 1 - n1) * BK);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      slab_mac<JW>(sm + (s & 1) * F_STAGE, acc);
      __syncthreads();
    }
  }
  // the slabs are done (the loop ended on a barrier): stage the tile
  const int lane = threadIdx.x & 31, pb = 8 * (threadIdx.x >> 5);
#pragma unroll
  for (int c = 0; c < JW / 32; ++c) {
    const int j = (c < 4 ? 4 * lane : 128 + 4 * lane) + (c & 3);
    if (j >= J) continue;
    *reinterpret_cast<float4*>(sm + j * LDO + pb) =
        make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    *reinterpret_cast<float4*>(sm + j * LDO + pb + 4) =
        make_float4(acc[c][4], acc[c][5], acc[c][6], acc[c][7]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < J * (P / 4); i += NT) {
    const int j = i / (P / 4), p = 4 * (i % (P / 4));
    const float4 a = *reinterpret_cast<const float4*>(sm + j * LDO + p);
    float v[4] = {a.x, a.y, a.z, a.w};
    float r[4], m[4];
    if (EPI & RANK1) {
      const float4 t = *reinterpret_cast<const float4*>(rs + p);
      r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
    }
    if (EPI & MASK) {
      const float4 t = *reinterpret_cast<const float4*>(mask + j * P + p);
      m[0] = t.x; m[1] = t.y; m[2] = t.z; m[3] = t.w;
    }
    const float b = (EPI & BIAS) ? __ldg(bias + j) : 0.f;
    const float cj = (EPI & RANK1) ? __ldg(cv + j) : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (EPI & BIAS) v[q] += b;
      if (EPI & RANK1) v[q] = fmaf(r[q], cj, v[q]);
      if (EPI & RELU) v[q] = fmaxf(v[q], 0.f);
      if (EPI & MASK) v[q] = m[q] > 0.f ? v[q] : 0.f;
    }
    *reinterpret_cast<float4*>(out + j * P + p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();  // the staged tile is read before the next copies land
}

// ---- weight gradients ---------------------------------------------------------
// one p-slab of the sub-tile (k0, j0): A rows k0.. and B rows j0.., points
// [pp, pp + BP), into As[WG][LDW], Bs[WG][LDW]; rows past K / J are zeros
__device__ __forceinline__ void wslab_load(float* st, const float* A, const float* B, int K,
                                           int J, int k0, int j0, int pp) {
  float* As = st;
  float* Bs = st + WG * LDW;
#pragma unroll
  for (int u = 0; u < WG * BP / 4 / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    const int r = i / (BP / 4), c = 4 * (i % (BP / 4));
    const bool va = k0 + r < K, vb = j0 + r < J;
    cp16(As + r * LDW + c, va ? A + (k0 + r) * P + pp + c : A, va);
    cp16(Bs + r * LDW + c, vb ? B + (j0 + r) * P + pp + c : B, vb);
  }
  cp_commit();
}

__device__ __forceinline__ void wslab_mac(const float* st, float (&acc)[8][8]) {
  const float* As = st;
  const float* Bs = st + WG * LDW;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 1
  for (int q = 0; q < BP; q += 4) {
    float4 b[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) b[jj] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * jj) * LDW + q);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDW + q);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float v = acc[i][jj];
        v = fmaf(a.x, b[jj].x, v);
        v = fmaf(a.y, b[jj].y, v);
        v = fmaf(a.z, b[jj].z, v);
        v = fmaf(a.w, b[jj].w, v);
        acc[i][jj] = v;
      }
    }
  }
}

// ---- the chain's routines, shared by both kernels ----------------------------
// no operand pair: a product of no rows
__device__ __forceinline__ Src none() { return {nullptr, nullptr, 0, 0, 0}; }

// a layer product's operand pair with a (K, W) weight of row stride W
__device__ __forceinline__ Src wide(const float* in, int K, const float* M) {
  return {in, M, K, W, W};
}

// a masked step of a chain: out = m (in M), M = K_l or its transpose
__device__ __forceinline__ void masked(float* sm, float* out, const float* in, const float* M,
                                       const float* mask) {
  layer<MASK, true>(sm, out, W, wide(in, W, M), none(), nullptr, mask, nullptr, nullptr);
}

// K_l (l = 2..7, K5a for 5) and its packed transpose
__device__ __forceinline__ int kw(int l) { return l == 5 ? O_K5A : k_off(l); }
__device__ __forceinline__ int ktw(int l) { return l == 5 ? O_K5AT : kt_off(l); }

// h1..h7 of the tile into the R_H rows, from x in the R_X rows; the skip
// layer adds pe (x's first 63 rows) K5b. Ends on a barrier.
__device__ __forceinline__ void backbone(float* sm, float* s, const float* __restrict__ w) {
  layer<BIAS | RELU, true>(sm, hrow(s, 1), W, wide(row(s, R_X), IN, w + O_K1), none(), w + O_B1,
                          nullptr, nullptr, nullptr);
  for (int l = 2; l <= 7; ++l)
    layer<BIAS | RELU, true>(sm, hrow(s, l), W, wide(hrow(s, l - 1), W, w + kw(l)),
                            l == 5 ? wide(row(s, R_X), PE, w + O_K5B) : none(),
                            w + O_B1 + (l - 1) * W, nullptr, nullptr, nullptr);
}

// e1 = relu(h7 K9 + b9) into the R_E1 rows, from all seven h rows (h7 the
// last); K9 sits at an odd offset: 4-byte copies. Ends on a barrier.
__device__ __forceinline__ void essence_hidden(float* sm, float* s, const float* __restrict__ w) {
  layer<BIAS | RELU, false, E>(sm, row(s, R_E1), E, {hrow(s, 7), w + O_K9, W, E, E}, none(),
                               w + O_B9, nullptr, nullptr, nullptr);
}

// the g-recursion u7..u1 (the R_U rows; u7 = m7 k8, then one masked
// product per layer with K7^T..K2^T, K5a^T for u4) and gpe = (u1
// K1^T)[:, :63] + u5 K5b^T into the R_OUT2 rows, from all seven h rows.
// The packed transposes' rows are 87 and 63 floats: 4-byte copies. Ends on
// a barrier.
__device__ __forceinline__ void g_chain(float* sm, float* s, const float* __restrict__ w) {
  for (int i = threadIdx.x; i < W * P; i += NT)
    urow(s, 7)[i] = hrow(s, 7)[i] > 0.f ? __ldg(w + O_K8 + i / P) : 0.f;
  __syncthreads();
  for (int l = 7; l >= 2; --l)
    masked(sm, urow(s, l - 1), urow(s, l), w + ktw(l), hrow(s, l - 1));
  layer<0, false, 128>(sm, row(s, R_OUT2), PE, {urow(s, 1), w + O_K1T, W, IN, PE},
                       {urow(s, 5), w + O_K5BT, W, PE, PE}, nullptr, nullptr, nullptr, nullptr);
}

}  // namespace fmlp_tiled
