// The fused SpaceNet chain's tensor-core core: the layer products of the
// bfloat16-fed pair (the `_fast` entry points of fused_mlp_fwd.cu and
// fused_mlp_bwd.cu), bf16 x bf16 products with float32 sums on Hopper's
// tensor cores (`mma.sync.m16n8k16`, operands through `ldmatrix`). The
// float32 pair runs on fused_mlp_tiled.cuh, which this header leaves alone.
//
// What it computes is the JAX kernels' fast=True
// (dual_space_nerf_tpu/ops/fused_mlp.py:_cast / _dot / _dot_t): every
// operand of every product rounded to bfloat16 (to nearest even), the
// products and their sums in float32; ReLU masks, biases, bias sums, k8's
// sums and the rank-1 term sbar k8 read float32 values.
//
// Design:
// - Rows. A tile of P = 64 points keeps its activations and cotangents as
//   bfloat16 rows, feature-major (row f holds feature f of the 64 points,
//   128 bytes): the forward in the block's scratch, the backward in one
//   record per tile that the weight-gradient pass reads afterwards (`Rec`).
//   Each value is rounded once, in the epilogue that writes its row; the
//   products read only these rows and never round again.
// - Masks. A ReLU output's row keeps its mask exactly: a positive value
//   that rounds to a bfloat16 zero (below 2^-133) is stored as -0, whose
//   product adds exactly nothing, and the mask of a row entry is "its bits
//   are not zero" (`enc_relu`). No other float32 copy of an activation is
//   kept. Float32 values that a sum must see (k8's first-order sum over
//   sbar h7, the bias sums over dz, k8's second-order sum over gb7) are
//   summed in the epilogue that produces them, from the float32
//   accumulators (`WSUM`).
// - Weights. A separate buffer, pre-rounded to bfloat16 by the wrapper
//   (ops/fused_mlp.py::fast_weights), every matrix [K][JW] row-major with
//   K padded to a multiple of BK and JW = 256 or 128 columns, pads zero.
// - A layer product out[j][p] = sum_k in[k][p] M[k][j] is the MMA's
//   D[m = j][n = p] = sum_k A[j][k] B[k][p]: A is M read transposed
//   (`ldmatrix.trans` of the [k][j] slab), B the input rows read transposed
//   (`ldmatrix.trans` of the [k][p] slab); no transposing copy. k-slabs of
//   BK = 32 rows of M and of the input go through two shared buffers by
//   16-byte `cp.async` copies (the copy of slab s + 1 in flight while slab s
//   is multiplied), with rows padded by 16 bytes so that the eight rows of an
//   `ldmatrix` fall in eight distinct bank groups. Warp w owns outputs
//   j in [w JW/8, (w + 1) JW/8) for all 64 points: 2 (or 1) x 8 MMA tiles,
//   64 (or 32) float32 accumulators a thread.
// - The epilogue runs on the accumulators in registers: bias, rank-1 term,
//   ReLU, mask, the float32 sums over the points (each thread's 16 values
//   in order, then two butterfly shuffles: a fixed order, so two runs give
//   the same bits), and the bf16 row or the float32 output (xbar, gpe)
//   written straight to memory.
// - `tlayer` is not inlined: it gets the launch bounds' 128 registers to
//   itself.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "fused_mlp.cuh"

namespace fmlp_tc {

using fmlp::E;
using fmlp::IN;
using fmlp::PE;
using fmlp::W;

typedef uint16_t bf;  // the bits of a bfloat16

constexpr int P = 64;          // points per tile
constexpr int NT = 256;        // threads per block
constexpr int BK = 32;         // k-slab of a layer product
constexpr int LDI = P + 8;     // bf16 row stride of a staged input slab (144 bytes)
constexpr int XR = 96;         // rows of x and gbar: 87 (63) live, the rest zero

// the bf16 weight buffer (elements), ops/fused_mlp.py::_WB_LAYOUT
constexpr int B_K1 = 0;                 // [96][256], rows 87.. zero
constexpr int B_K2 = B_K1 + XR * W;
constexpr int B_K3 = B_K2 + W * W;
constexpr int B_K4 = B_K3 + W * W;
constexpr int B_K5A = B_K4 + W * W;
constexpr int B_K5B = B_K5A + W * W;    // [64][256], row 63 zero
constexpr int B_K6 = B_K5B + 64 * W;
constexpr int B_K7 = B_K6 + W * W;
constexpr int B_K9 = B_K7 + W * W;      // [256][128]
constexpr int B_K1T = B_K9 + W * E;     // [256][128], columns 87.. zero
constexpr int B_K2T = B_K1T + W * 128;
constexpr int B_K3T = B_K2T + W * W;
constexpr int B_K4T = B_K3T + W * W;
constexpr int B_K5AT = B_K4T + W * W;
constexpr int B_K5BT = B_K5AT + W * W;  // [256][128], columns 63.. zero
constexpr int B_K6T = B_K5BT + W * 128;
constexpr int B_K7T = B_K6T + W * W;
constexpr int B_K9T = B_K7T + W * W;    // [128][256]
constexpr int WB_ELEMS = B_K9T + E * W;

__host__ __device__ constexpr int bk(int l) {  // K_l, l = 2..7 (K5a for 5)
  return l == 2 ? B_K2 : l == 3 ? B_K3 : l == 4 ? B_K4 : l == 5 ? B_K5A : l == 6 ? B_K6 : B_K7;
}
__host__ __device__ constexpr int bkt(int l) {  // K_l^T
  return l == 2 ? B_K2T : l == 3 ? B_K3T : l == 4 ? B_K4T : l == 5 ? B_K5AT : l == 6 ? B_K6T : B_K7T;
}

// The rows of one tile (P bf16 each). The forward's scratch holds the first
// FWD rows (x, h1..h7, and with color e1 and u1..u7); the backward's record
// all ROWS: the forward's, then dz1..dz7 and with color de1, gbar and
// gb1..gb6 (gb7 is only summed).
template <bool COLOR>
struct Rec {
  static constexpr int X = 0;
  static constexpr int H = X + XR;
  static constexpr int E1 = H + 7 * W;
  static constexpr int U = E1 + E;
  static constexpr int FWD = COLOR ? U + 7 * W : E1;
  static constexpr int DZ = FWD;
  static constexpr int DE1 = DZ + 7 * W;
  static constexpr int GBAR = DE1 + E;
  static constexpr int GB = GBAR + XR;
  static constexpr int ROWS = COLOR ? GB + 6 * W : DZ + 7 * W;
};

// ---- bfloat16 bits --------------------------------------------------------------
__device__ __forceinline__ bf to_bf(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float from_bf(bf b) { return __bfloat162float(__ushort_as_bfloat16(b)); }
// a product's operand: v rounded to bfloat16, as a float
__device__ __forceinline__ float op(float v) { return from_bf(to_bf(v)); }
// a ReLU output's entry: its bfloat16, or -0 where a positive value rounds
// to zero, so that "bits != 0" is the mask v > 0
__device__ __forceinline__ bf enc_relu(float v) {
  if (!(v > 0.f)) return 0;
  const bf b = to_bf(v);
  return b == 0 ? bf(0x8000) : b;
}

__device__ __forceinline__ bf* rrow(bf* r, int row) { return r + row * P; }
__device__ __forceinline__ const bf* rrow(const bf* r, int row) { return r + row * P; }

// ---- asynchronous copies, ldmatrix and the MMA -----------------------------------
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += A (16 x 16, row) B (16 x 8, col): bf16 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d = A B, from a zero sum
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// ---- layer products ---------------------------------------------------------------
// One operand pair: K input rows `in` and M [K][JW] row-major (bf16 weight
// buffer), K a multiple of BK (the pads are zero rows).
struct Pair {
  const bf* in;
  const bf* M;
  int K;
};
__device__ __forceinline__ Pair none() { return {nullptr, nullptr, 0}; }

constexpr int STAGE = BK * (W + 8) + BK * LDI;  // bf16 of one slab stage (the widest)
constexpr int SLAB_BYTES = 2 * STAGE * 2;       // two stages
constexpr int SMALL_F32 = 4 * P;                // sbar and ebar of the tile, float32
constexpr int SMEM_BYTES = SLAB_BYTES + SMALL_F32 * 4;
static_assert(BK * P / 8 == NT, "one 16-byte input chunk a thread and slab");
static_assert(87 * P * 4 <= SLAB_BYTES, "x of a tile stages in the slab room");

// the k-slab [k0, k0 + BK) of `s` into one stage: Ms[BK][JW + 8], Is[BK][LDI]
template <int JW>
__device__ __forceinline__ void tslab_load(bf* st, const Pair& s, int k0) {
  bf* Ms = st;
  bf* Is = st + BK * (JW + 8);
  {
    const int r = threadIdx.x >> 3, c = 8 * (threadIdx.x & 7);
    cp16(Is + r * LDI + c, s.in + (k0 + r) * P + c, true);
  }
#pragma unroll
  for (int u = 0; u < BK * JW / 8 / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    const int r = i / (JW / 8), c = 8 * (i % (JW / 8));
    cp16(Ms + r * (JW + 8) + c, s.M + (size_t)(k0 + r) * JW + c, true);
  }
  cp_commit();
}

// acc[mt][nt] += the stage's products for the warp's output tiles: m-tile
// mt (outputs w JW/8 + 16 mt ..) and n-tile nt (points 8 nt ..). The
// tensor cores align the terms of an MMA to the largest and truncate, so a
// long chain of MMAs on one sum loses low bits of the small terms: the
// slab's 32 products go into a zero sum, which is then added to acc with
// one rounding (two MMAs and four FADDs an output tile).
static_assert(BK == 32, "a slab is two MMA depths");
template <int JW>
__device__ __forceinline__ void tslab_mma(const bf* st, float (&acc)[JW / 128][8][4]) {
  constexpr int MT = JW / 128;
  const bf* Ms = st;
  const bf* Is = st + BK * (JW + 8);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mi = lane >> 3, mr = lane & 7;
  // A = M^T: matrices (k 0-7, j 0-7), (k 0-7, j 8-15), (k 8-15, j 0-7), (k 8-15, j 8-15)
  uint32_t a[2][MT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm4t(a[h][mt], Ms + (16 * h + mr + ((mi >> 1) << 3)) * (JW + 8) + warp * 16 * MT +
                           mt * 16 + ((mi & 1) << 3));
#pragma unroll
  for (int np = 0; np < 4; ++np) {
    // B = in: matrices (k 0-7, p 0-7), (k 8-15, p 0-7), (k 0-7, p 8-15), (k 8-15, p 8-15)
    uint32_t b[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldsm4t(b[h], Is + (16 * h + mr + ((mi & 1) << 3)) * LDI + np * 16 + ((mi >> 1) << 3));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float t0[4], t1[4];
      mma0(t0, a[0][mt], b[0][0], b[0][1]);
      mma0(t1, a[0][mt], b[0][2], b[0][3]);
      mma(t0, a[1][mt], b[1][0], b[1][1]);
      mma(t1, a[1][mt], b[1][2], b[1][3]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[mt][2 * np][q] += t0[q];
        acc[mt][2 * np + 1][q] += t1[q];
      }
    }
  }
}

// epilogues of `tlayer`
constexpr int BIAS = 1;     // + bias[j]
constexpr int RELU = 2;     // max(., 0); the row keeps its mask (`enc_relu`)
constexpr int MASK = 4;     // 0 where the mask row's entry is 0
constexpr int RANK1 = 8;    // fmaf(rs[p], cv[j], .) before the mask
constexpr int WSUM = 16;    // gsum[j] += sum_p ws[p] * out (ws null: the plain sum)
constexpr int F32OUT = 32;  // out as float32 to fout (n, J) point-major, not a row

struct Epi {
  bf* out;             // bf16 rows [j][P] (none: null)
  float* fout;         // F32OUT: the output (n, J), the tile's points from t0
  const float* bias;   // [J]
  const bf* mask;      // rows [j][P]
  const float* rs;     // [P], float32 (RANK1)
  const float* cv;     // [J] (RANK1)
  const float* ws;     // [P] (WSUM), or null
  float* gsum;         // [J] (WSUM)
  int J, t0, n;
};

// out[j][p] = epilogue(s1.in @ s1.M + s2.in @ s2.M) for j < e.J <= JW; s2.K =
// 0 for one product, s1.K = 0 for none. Ends on a barrier.
template <int EPI, int JW>
__device__ __noinline__ void tlayer(bf* sm, const Pair s1, const Pair s2, const Epi e) {
  constexpr int MT = JW / 128;
  const int n1 = s1.K / BK;
  const int n = n1 + s2.K / BK;
  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  if (n > 0) {
    tslab_load<JW>(sm, n1 > 0 ? s1 : s2, 0);
    for (int s = 0; s < n; ++s) {
      if (s + 1 < n) {
        bf* st = sm + ((s + 1) & 1) * STAGE;
        if (s + 1 < n1) tslab_load<JW>(st, s1, (s + 1) * BK);
        else tslab_load<JW>(st, s2, (s + 1 - n1) * BK);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      tslab_mma<JW>(sm + (s & 1) * STAGE, acc);
      __syncthreads();
    }
  }
  // the accumulators: thread (g, q) of a warp holds outputs j = g and g + 8
  // of each m-tile at points 2q, 2q + 1 of each n-tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = warp * 16 * MT + mt * 16 + g + 8 * half;
      const bool live = j < e.J;
      const float b = (EPI & BIAS) && live ? __ldg(e.bias + j) : 0.f;
      const float cj = (EPI & RANK1) && live ? __ldg(e.cv + j) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = nt * 8 + 2 * tq;
        float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (EPI & BIAS) { v0 += b; v1 += b; }
        if (EPI & RANK1) { v0 = fmaf(e.rs[p], cj, v0); v1 = fmaf(e.rs[p + 1], cj, v1); }
        if (EPI & RELU) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
        if (EPI & MASK) {
          const uint32_t m = live ? *reinterpret_cast<const uint32_t*>(e.mask + j * P + p) : 0u;
          v0 = (m & 0xFFFFu) != 0u ? v0 : 0.f;
          v1 = (m >> 16) != 0u ? v1 : 0.f;
        }
        if (EPI & WSUM) {
          if (e.ws != nullptr) { sum = fmaf(e.ws[p], v0, sum); sum = fmaf(e.ws[p + 1], v1, sum); }
          else { sum += v0; sum += v1; }
        }
        if (!live) continue;
        if (EPI & F32OUT) {
          if (e.t0 + p < e.n) e.fout[(size_t)(e.t0 + p) * e.J + j] = v0;
          if (e.t0 + p + 1 < e.n) e.fout[(size_t)(e.t0 + p + 1) * e.J + j] = v1;
        } else if (e.out != nullptr) {
          const uint32_t lo = (EPI & RELU) ? enc_relu(v0) : to_bf(v0);
          const uint32_t hi = (EPI & RELU) ? enc_relu(v1) : to_bf(v1);
          *reinterpret_cast<uint32_t*>(e.out + j * P + p) = lo | (hi << 16);
        }
      }
      if (EPI & WSUM) {
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (tq == 0 && live) e.gsum[j] += sum;
      }
    }
  }
  __syncthreads();  // the rows are written before the next product reads them
}

__device__ __forceinline__ Epi epi_rows(bf* out, const bf* mask = nullptr) {
  return {out, nullptr, nullptr, mask, nullptr, nullptr, nullptr, nullptr, W, 0, 0};
}

// ---- the tile's inputs ----------------------------------------------------------------
// rows [0, rows) of dst <- the tile's points of src (n, width) float32
// point-major, as bf16; rows past width and points past n are zero. Stages
// through `stage` (width * P floats of shared memory); ends on a barrier.
__device__ void load_rows_bf(bf* dst, const float* __restrict__ src, int width, int rows, int t0,
                             int n, float* stage) {
  const int live = (n - t0 < P ? n - t0 : P) * width;
  for (int i = threadIdx.x; i < width * P; i += NT)
    stage[i] = i < live ? src[(size_t)t0 * width + i] : 0.f;
  __syncthreads();
  for (int c = threadIdx.x; c < rows * (P / 8); c += NT) {
    const int f = c / (P / 8), p0 = 8 * (c % (P / 8));
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = f < width ? to_bf(stage[(p0 + 2 * q) * width + f]) : 0u;
      const uint32_t hi = f < width ? to_bf(stage[(p0 + 2 * q + 1) * width + f]) : 0u;
      v[q] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst + f * P + p0) = make_uint4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
}

// ---- the chain's routines, shared by both kernels ----------------------------------------
// h1..h7 of the tile into its H rows, from x in its X rows; the skip layer
// adds pe (x's first 64 rows, K5b's row 63 zero) K5b. K8SUM (the backward):
// gk8[j] += sum_p sb[p] h7[j][p] on the way, from the float32 h7. Ends on
// a barrier.
template <bool COLOR, bool K8SUM>
__device__ __forceinline__ void backbone(bf* sm, bf* r, const float* __restrict__ w,
                                         const bf* __restrict__ wb, const float* sb, float* gk8) {
  using R = Rec<COLOR>;
  for (int l = 1; l <= 7; ++l) {
    const Pair s1 = l == 1 ? Pair{rrow(r, R::X), wb + B_K1, XR}
                           : Pair{rrow(r, R::H + (l - 2) * W), wb + bk(l), W};
    const Pair s2 = l == 5 ? Pair{rrow(r, R::X), wb + B_K5B, 64} : none();
    Epi e = epi_rows(rrow(r, R::H + (l - 1) * W));
    e.bias = w + fmlp::O_B1 + (l - 1) * W;
    if (K8SUM && l == 7) {
      e.ws = sb;
      e.gsum = gk8;
      tlayer<BIAS | RELU | WSUM, W>(sm, s1, s2, e);
    } else {
      tlayer<BIAS | RELU, W>(sm, s1, s2, e);
    }
  }
}

// e1 = relu(h7 K9 + b9) into the E1 rows. Ends on a barrier.
template <bool COLOR>
__device__ __forceinline__ void essence_hidden(bf* sm, bf* r, const float* __restrict__ w,
                                               const bf* __restrict__ wb) {
  using R = Rec<COLOR>;
  Epi e = epi_rows(rrow(r, R::E1));
  e.bias = w + fmlp::O_B9;
  e.J = E;
  tlayer<BIAS | RELU, 128>(sm, {rrow(r, R::H + 6 * W), wb + B_K9, W}, none(), e);
}

// the g-recursion u7..u1 (the U rows; u7 = m7 k8, then one masked product
// per layer with K7^T..K2^T, K5a^T for u4) and gpe = (u1 K1^T)[:, :63] + u5
// K5b^T, float32, to gpe (n, 63) at the tile's points. Ends on a barrier.
template <bool COLOR>
__device__ __forceinline__ void g_chain(bf* sm, bf* r, const float* __restrict__ w,
                                        const bf* __restrict__ wb, float* gpe, int t0, int n) {
  using R = Rec<COLOR>;
  const uint32_t* h7 = reinterpret_cast<const uint32_t*>(rrow(r, R::H + 6 * W));
  uint32_t* u7 = reinterpret_cast<uint32_t*>(rrow(r, R::U + 6 * W));
  for (int i = threadIdx.x; i < W * P / 2; i += NT) {
    const uint32_t k8 = to_bf(__ldg(w + fmlp::O_K8 + i / (P / 2)));
    const uint32_t m = h7[i];
    u7[i] = ((m & 0xFFFFu) != 0u ? k8 : 0u) | ((m >> 16) != 0u ? k8 << 16 : 0u);
  }
  __syncthreads();
  for (int l = 7; l >= 2; --l)
    tlayer<MASK, W>(sm, {rrow(r, R::U + (l - 1) * W), wb + bkt(l), W}, none(),
                    epi_rows(rrow(r, R::U + (l - 2) * W), rrow(r, R::H + (l - 2) * W)));
  Epi e = epi_rows(nullptr);
  e.fout = gpe;
  e.J = PE;
  e.t0 = t0;
  e.n = n;
  tlayer<F32OUT, 128>(sm, {rrow(r, R::U), wb + B_K1T, W}, {rrow(r, R::U + 4 * W), wb + B_K5BT, W},
                      e);
}

}  // namespace fmlp_tc
