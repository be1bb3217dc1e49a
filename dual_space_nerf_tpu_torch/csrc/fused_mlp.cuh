// The fused SpaceNet chain's building blocks, shared by fused_mlp_fwd.cu and
// fused_mlp_bwd.cu (ops/fused_mlp.py holds the math and the plain versions).
//
// Design (FP32 CUDA cores, no tensor cores, no library product):
// - A persistent grid: as many 256-thread blocks as the card holds at once;
//   block b takes the tiles of P = 32 points b, b + grid, ... in order.
// - Every vector of a tile lives in the block's own scratch (global memory,
//   L1/L2-resident), feature-major: row f holds feature f of the P points,
//   rows LD = P + 4 floats apart (16-byte aligned, so a row is read as
//   float4s; the 4-float skew spreads the column loads of `wgrad` over the
//   shared banks of L1). Nothing of a tile but its inputs and outputs goes
//   to device memory in bulk.
// - A product out = in @ M (M row-major (K, J), read from L2 with unit
//   stride across the threads) gives thread j the column j of the tile: P
//   accumulators in registers, the input rows read as broadcasts. Products
//   with a transposed weight read the transposed copy the wrapper packs.
// - A weight gradient G += A^T B over the tile's points gives thread j the
//   column j of B in registers and sums over the points for each row of A;
//   each block adds into its own slice of the partials, so no two blocks
//   write one address and no atomics are used.
#pragma once

#include <cuda_runtime.h>

namespace fmlp {

constexpr int W = 256;   // backbone width
constexpr int PE = 63;   // posenc lanes
constexpr int IN = 87;   // input lanes: [pe 63 | code 8 | pose 16]
constexpr int E = 128;   // essence hidden width
constexpr int P = 32;    // points per tile
constexpr int LD = P + 4;
constexpr int NT = 256;  // threads per block

// flat weight buffer, ops/fused_mlp.py::_W_LAYOUT
constexpr int O_K1 = 0;
constexpr int O_K2 = O_K1 + IN * W;
constexpr int O_K3 = O_K2 + W * W;
constexpr int O_K4 = O_K3 + W * W;
constexpr int O_K5A = O_K4 + W * W;
constexpr int O_K5B = O_K5A + W * W;
constexpr int O_K6 = O_K5B + PE * W;
constexpr int O_K7 = O_K6 + W * W;
constexpr int O_K8 = O_K7 + W * W;
constexpr int O_B1 = O_K8 + W;       // b_l at O_B1 + (l - 1) * W, l = 1..7
constexpr int O_B8 = O_B1 + 7 * W;
constexpr int O_K9 = O_B8 + 1;
constexpr int O_B9 = O_K9 + W * E;
constexpr int O_K10 = O_B9 + E;
constexpr int O_B10 = O_K10 + E * 3;
constexpr int G_FLOATS = O_B10 + 3;  // the gradient buffer is this first part
constexpr int O_K1T = G_FLOATS;
constexpr int O_K2T = O_K1T + W * IN;
constexpr int O_K3T = O_K2T + W * W;
constexpr int O_K4T = O_K3T + W * W;
constexpr int O_K5AT = O_K4T + W * W;
constexpr int O_K5BT = O_K5AT + W * W;
constexpr int O_K6T = O_K5BT + W * PE;
constexpr int O_K7T = O_K6T + W * W;
constexpr int O_K9T = O_K7T + W * W;
constexpr int O_K10T = O_K9T + E * W;
constexpr int W_FLOATS = O_K10T + 3 * E;

__host__ __device__ constexpr int k_off(int l) {  // K_l, l = 2..4, 6, 7
  return l == 2 ? O_K2 : l == 3 ? O_K3 : l == 4 ? O_K4 : l == 6 ? O_K6 : O_K7;
}
__host__ __device__ constexpr int kt_off(int l) {  // K_l^T
  return l == 2 ? O_K2T : l == 3 ? O_K3T : l == 4 ? O_K4T : l == 6 ? O_K6T : O_K7T;
}

// the scratch of one block, in rows of LD floats
constexpr int R_X = 0;                 // x, 88 rows
constexpr int R_H = R_X + 88;          // h1..h7
constexpr int R_U = R_H + 7 * W;       // u1..u7 (g-recursion)
constexpr int R_DZ = R_U + 7 * W;      // dz1..dz7 (backward)
constexpr int R_GB = R_DZ + 7 * W;     // two gb buffers (backward)
constexpr int R_E1 = R_GB + 2 * W;     // relu(h7 K9 + b9)
constexpr int R_DE1 = R_E1 + E;        // its cotangent (backward)
constexpr int R_SB = R_DE1 + E;        // sbar, 4 rows
constexpr int R_EB = R_SB + 4;         // ebar, 4 rows
constexpr int R_GBAR = R_EB + 4;       // gbar as 88 rows, 63..87 zero
constexpr int R_OUT = R_GBAR + 88;     // an output tile, 88 rows
constexpr int R_OUT2 = R_OUT + 88;     // a second one
constexpr int ROWS = R_OUT2 + 88;
constexpr int SCRATCH_FLOATS = ROWS * LD;

__device__ __forceinline__ float* row(float* s, int r) { return s + r * LD; }
__device__ __forceinline__ float* hrow(float* s, int l) { return s + (R_H + (l - 1) * W) * LD; }
__device__ __forceinline__ float* urow(float* s, int l) { return s + (R_U + (l - 1) * W) * LD; }
__device__ __forceinline__ float* dzrow(float* s, int l) { return s + (R_DZ + (l - 1) * W) * LD; }

// rows [0, width) of dst <- the tile's points of src (n, width) row-major;
// points past n read as zero
__device__ void load_rows(float* dst, const float* __restrict__ src, int width, int t0, int n) {
  for (int i = threadIdx.x; i < width * P; i += NT) {
    const int p = i / width, f = i - p * width;
    const int gp = t0 + p;
    dst[f * LD + p] = gp < n ? src[(size_t)gp * width + f] : 0.f;
  }
}

// the tile's valid points of out (n, width) row-major <- rows [0, width) of src
__device__ void store_rows(float* __restrict__ out, const float* src, int width, int t0, int n) {
  for (int i = threadIdx.x; i < width * P; i += NT) {
    const int p = i / width, f = i - p * width;
    const int gp = t0 + p;
    if (gp < n) out[(size_t)gp * width + f] = src[f * LD + p];
  }
}

// acc[p] += sum_k in[k][p] * M[k * ldm + j]
__device__ __forceinline__ void mac(float (&acc)[P], const float* in, int K,
                                    const float* __restrict__ M, int ldm, int j) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float w = __ldg(M + (size_t)k * ldm + j);
    const float4* a = reinterpret_cast<const float4*>(in + k * LD);
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 v = a[q];
      acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
    }
  }
}

// epilogues of `layer`
constexpr int BIAS = 1;   // + bias[j]
constexpr int RELU = 2;   // max(., 0)
constexpr int MASK = 4;   // 0 where mask[j][p] <= 0 (mask rows hold h = relu(z))
constexpr int RANK1 = 8;  // + rs[p] * cv[j] before the mask

// out[j][p] = epilogue(in @ M + in2 @ M2 (the second product for j < J2 only))
// for j < J; in2 may be null.
template <int EPI>
__device__ void layer(float* out, int J, const float* in, int K, const float* __restrict__ M,
                      int ldm, const float* in2, int K2, const float* __restrict__ M2, int ldm2,
                      int J2, const float* __restrict__ bias, const float* mask,
                      const float* rs, const float* __restrict__ cv) {
  for (int j = threadIdx.x; j < J; j += NT) {
    float acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = 0.f;
    if (in != nullptr) mac(acc, in, K, M, ldm, j);
    if (in2 != nullptr && j < J2) mac(acc, in2, K2, M2, ldm2, j);
    const float b = (EPI & BIAS) ? __ldg(bias + j) : 0.f;
    const float c = (EPI & RANK1) ? __ldg(cv + j) : 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float z = acc[p];
      if (EPI & BIAS) z += b;
      if (EPI & RANK1) z = fmaf(rs[p], c, z);
      if (EPI & RELU) z = fmaxf(z, 0.f);
      if (EPI & MASK) z = mask[j * LD + p] > 0.f ? z : 0.f;
      out[j * LD + p] = z;
    }
  }
}

// out[j][p] = (mask[j][p] > 0) * cv[j]: u7 = m7 * k8
__device__ void masked_const(float* out, const float* mask, const float* __restrict__ cv) {
  for (int i = threadIdx.x; i < W * P; i += NT) {
    const int j = i / P, p = i - j * P;
    out[j * LD + p] = mask[j * LD + p] > 0.f ? __ldg(cv + j) : 0.f;
  }
}

// G[k * J + j] += sum_p A1[k][p] B1[j][p] (+ sum_p A2[k][p] B2[j][p] when
// A2 is given) for k < K, j < J; gbias[j] += sum_p B1[j][p] when given.
// One thread per column j: no two threads write one address.
template <bool TWO>
__device__ void wgrad(float* G, int K, int J, const float* A1, const float* B1, const float* A2,
                      const float* B2, float* gbias) {
  for (int j = threadIdx.x; j < J; j += NT) {
    float b1[P], b2[P];
    const float4* c1 = reinterpret_cast<const float4*>(B1 + j * LD);
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 v = c1[q];
      b1[4 * q] = v.x; b1[4 * q + 1] = v.y; b1[4 * q + 2] = v.z; b1[4 * q + 3] = v.w;
    }
    if (TWO) {
      const float4* c2 = reinterpret_cast<const float4*>(B2 + j * LD);
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 v = c2[q];
        b2[4 * q] = v.x; b2[4 * q + 1] = v.y; b2[4 * q + 2] = v.z; b2[4 * q + 3] = v.w;
      }
    }
    if (gbias != nullptr) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) s += b1[p];
      gbias[j] += s;
    }
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
      const float4* a = reinterpret_cast<const float4*>(A1 + k * LD);
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 v = a[q];
        s = fmaf(v.x, b1[4 * q], s);
        s = fmaf(v.y, b1[4 * q + 1], s);
        s = fmaf(v.z, b1[4 * q + 2], s);
        s = fmaf(v.w, b1[4 * q + 3], s);
      }
      if (TWO) {
        const float4* a2 = reinterpret_cast<const float4*>(A2 + k * LD);
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          const float4 v = a2[q];
          s = fmaf(v.x, b2[4 * q], s);
          s = fmaf(v.y, b2[4 * q + 1], s);
          s = fmaf(v.z, b2[4 * q + 2], s);
          s = fmaf(v.w, b2[4 * q + 3], s);
        }
      }
      G[(size_t)k * J + j] += s;
    }
  }
}

// the backbone h1..h7 of the tile in the scratch rows, from x
__device__ void backbone(float* s, const float* __restrict__ w) {
  layer<BIAS | RELU>(hrow(s, 1), W, row(s, R_X), IN, w + O_K1, W, nullptr, 0, nullptr, 0, 0,
                     w + O_B1, nullptr, nullptr, nullptr);
  __syncthreads();
  for (int l = 2; l <= 4; ++l) {
    layer<BIAS | RELU>(hrow(s, l), W, hrow(s, l - 1), W, w + k_off(l), W, nullptr, 0, nullptr, 0,
                       0, w + O_B1 + (l - 1) * W, nullptr, nullptr, nullptr);
    __syncthreads();
  }
  // skip layer: h4 K5a + pe K5b, the pe being x's first 63 rows
  layer<BIAS | RELU>(hrow(s, 5), W, hrow(s, 4), W, w + O_K5A, W, row(s, R_X), PE, w + O_K5B, W,
                     W, w + O_B1 + 4 * W, nullptr, nullptr, nullptr);
  __syncthreads();
  for (int l = 6; l <= 7; ++l) {
    layer<BIAS | RELU>(hrow(s, l), W, hrow(s, l - 1), W, w + k_off(l), W, nullptr, 0, nullptr, 0,
                       0, w + O_B1 + (l - 1) * W, nullptr, nullptr, nullptr);
    __syncthreads();
  }
}

// u1..u7 of the g-recursion, then gpe (63 rows) into `gpe_rows`
__device__ void g_recursion(float* s, const float* __restrict__ w, float* gpe_rows) {
  masked_const(urow(s, 7), hrow(s, 7), w + O_K8);
  __syncthreads();
  // u6 = m6 (u7 K7^T), u5 = m5 (u6 K6^T)
  for (int l = 7; l >= 6; --l) {
    layer<MASK>(urow(s, l - 1), W, urow(s, l), W, w + kt_off(l), W, nullptr, 0, nullptr, 0, 0,
                nullptr, hrow(s, l - 1), nullptr, nullptr);
    __syncthreads();
  }
  layer<MASK>(urow(s, 4), W, urow(s, 5), W, w + O_K5AT, W, nullptr, 0, nullptr, 0, 0, nullptr,
              hrow(s, 4), nullptr, nullptr);
  __syncthreads();
  for (int l = 4; l >= 2; --l) {
    layer<MASK>(urow(s, l - 1), W, urow(s, l), W, w + kt_off(l), W, nullptr, 0, nullptr, 0, 0,
                nullptr, hrow(s, l - 1), nullptr, nullptr);
    __syncthreads();
  }
  // gpe = (u1 K1^T)[:, :63] + u5 K5b^T
  layer<0>(gpe_rows, PE, urow(s, 1), W, w + O_K1T, IN, urow(s, 5), W, w + O_K5BT, PE, PE,
           nullptr, nullptr, nullptr, nullptr);
  __syncthreads();
}

}  // namespace fmlp
