// List-driven exact nearest-face search, wide tie rule (sm_90a).
//
// Replaces the TPU kernel dual_space_nerf_tpu/ops/pruned_knn.py:_listed_kernel.
// The kernel, its bound and its design are in listed_knn.cuh; this file is
// the entry point whose ties go, per lane, to the first-visited tile and then
// to the smallest slot id, with the optional in-kernel threshold (tighten).

#include "listed_knn.cuh"

// pts: (n_pts, 3) float32; cent_t: (3, n_slots) float32, 16-byte aligned;
// order: (rows, row_stride) int32 tile ids; counts: (rows,) int32; lbs:
// (rows, row_stride) float32 sorted squared lower bounds; row_of_rank:
// (rows,) int32 scratch (the rows longest list first); out: (n_pts,) int32
// slot ids. Contiguous, on the stream's device; n_pts and plan_p multiples
// of 128, rows = n_pts / plan_p, n_slots a multiple of 4. Returns
// cudaGetLastError().
extern "C" int listed_knn_launch(const float* pts, const float* cent_t, const int* order,
                                 const int* counts, const float* lbs, int* row_of_rank, int* out,
                                 int n_pts, int plan_p, int row_stride, int n_slots, int tighten,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tighten ? listed::launch<true, true>(pts, cent_t, order, counts, lbs, row_of_rank, out,
                                              n_pts, plan_p, row_stride, n_slots, s)
                 : listed::launch<true, false>(pts, cent_t, order, counts, lbs, row_of_rank, out,
                                               n_pts, plan_p, row_stride, n_slots, s);
}

// Resident blocks per SM (occupancy query, launches nothing).
extern "C" int listed_knn_blocks_per_sm(int row_stride, int tighten) {
  return tighten ? listed::blocks_per_sm<true, true>(row_stride)
                 : listed::blocks_per_sm<true, false>(row_stride);
}

// Dynamic shared memory of a block, in bytes.
extern "C" int listed_knn_smem(int row_stride, int tighten) {
  return static_cast<int>(listed::smem_bytes(row_stride, tighten != 0));
}
