// The fused SpaceNet chain's widths and flat weight layout, shared by
// fused_mlp_tiled.cuh (the product core both kernels run on),
// fused_mlp_fwd.cu and fused_mlp_bwd.cu; ops/fused_mlp.py holds the math,
// the plain versions and the same layout (`_W_LAYOUT`).
#pragma once

#include <cuda_runtime.h>

namespace fmlp {

constexpr int W = 256;   // backbone width
constexpr int PE = 63;   // posenc lanes
constexpr int IN = 87;   // input lanes: [pe 63 | code 8 | pose 16]
constexpr int E = 128;   // essence hidden width

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

}  // namespace fmlp
