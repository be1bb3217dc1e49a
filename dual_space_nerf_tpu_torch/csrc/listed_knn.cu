// List-driven exact nearest-face search, wide tie rule (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/pruned_knn.py:_listed_kernel.
// The kernel, its bound and its design are in listed_knn.cuh; this file is
// the entry point whose ties go, per lane, to the first-visited tile and then
// to the smallest slot id, with the optional in-kernel threshold (tighten).

#include "listed_knn.cuh"

// pts: (n_pts, 3) float32; cent_t: (3, n_slots) float32; order: (rows,
// row_stride) int32 tile ids; counts: (rows,) int32; lbs: (rows, row_stride)
// float32 sorted squared lower bounds; out: (n_pts,) int32 slot ids.
// Contiguous, on the stream's device; n_pts and plan_p multiples of 128,
// rows = n_pts / plan_p. Returns cudaGetLastError().
extern "C" int listed_knn_launch(const float* pts, const float* cent_t, const int* order,
                                 const int* counts, const float* lbs, int* out, int n_pts,
                                 int plan_p, int row_stride, int n_slots, int tighten,
                                 void* stream) {
  if (n_pts > 0) {
    const int grid = n_pts / listed::kThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tighten) {
      listed::listed_kernel<true, true><<<grid, listed::kThreads, 0, s>>>(
          pts, cent_t, order, counts, lbs, out, plan_p, row_stride, n_slots);
    } else {
      listed::listed_kernel<true, false><<<grid, listed::kThreads, 0, s>>>(
          pts, cent_t, order, counts, lbs, out, plan_p, row_stride, n_slots);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
