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
                                      const int* counts, const float* lbs, int* row_of_rank,
                                      int* out, int n_pts, int plan_p, int row_stride, int n_slots,
                                      void* stream) {
  return listed::launch<false, false>(pts, cent_t, order, counts, lbs, row_of_rank, out, n_pts,
                                      plan_p, row_stride, n_slots,
                                      static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM (occupancy query, launches nothing); the second
// argument is unused, as listed_knn_blocks_per_sm's signature.
extern "C" int listed_knn_slim_blocks_per_sm(int row_stride, int) {
  return listed::blocks_per_sm<false, false>(row_stride);
}

// Dynamic shared memory of a block, in bytes.
extern "C" int listed_knn_slim_smem(int row_stride, int) {
  return static_cast<int>(listed::smem_bytes(row_stride, false));
}
