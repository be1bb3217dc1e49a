// List-driven exact nearest-face search, slim tie rule (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/pruned_knn.py:_listed_kernel_slim.
// The kernel, its bound and its design are in listed_knn.cuh; this file is
// the entry point whose ties go to the smallest slot id among all visited
// slots at the minimum. On a GPU the per-point running best is the natural
// layout for both rules; the two entry points differ only in the tie branch.

#include "listed_knn.cuh"

// Arguments as listed_knn_launch (listed_knn.cu), without the threshold.
extern "C" int listed_knn_slim_launch(const float* pts, const float* cent_t, const int* order,
                                      const int* counts, const float* lbs, int* out,
                                      int n_pts, int plan_p, int row_stride, int n_slots,
                                      void* stream) {
  if (n_pts > 0) {
    listed::listed_kernel<false, false>
        <<<n_pts / listed::kThreads, listed::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            pts, cent_t, order, counts, lbs, out, plan_p, row_stride, n_slots);
  }
  return static_cast<int>(cudaGetLastError());
}
