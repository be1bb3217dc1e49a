from .clustered_knn import build_face_clusters
from .gg_cuda import GG_KERNEL, gg_near_far_cuda, gg_near_far_plain
from .nearest_face import (
    NEAREST_KERNEL,
    face_centroids,
    nearest_face,
    nearest_face_cuda,
    nearest_face_plain,
)
from .posenc import posenc, posenc_dim
from .pruned_knn import (
    LISTED_KERNEL,
    LISTED_PLAN_KERNEL,
    LISTED_SLIM_KERNEL,
    PRUNED_KERNEL,
    build_face_tiles,
    listed_tables,
    nearest_face_pruned,
    pruned_search_listed,
    pruned_search_presorted,
    slot_perm_from_tiles,
)

#: every CUDA kernel of the port, for builds and launch counts
KERNELS = (GG_KERNEL, NEAREST_KERNEL, LISTED_PLAN_KERNEL, LISTED_KERNEL, LISTED_SLIM_KERNEL,
           PRUNED_KERNEL)

__all__ = [
    "GG_KERNEL",
    "KERNELS",
    "LISTED_KERNEL",
    "LISTED_PLAN_KERNEL",
    "LISTED_SLIM_KERNEL",
    "NEAREST_KERNEL",
    "PRUNED_KERNEL",
    "build_face_clusters",
    "build_face_tiles",
    "face_centroids",
    "gg_near_far_cuda",
    "gg_near_far_plain",
    "listed_tables",
    "nearest_face",
    "nearest_face_cuda",
    "nearest_face_plain",
    "nearest_face_pruned",
    "posenc",
    "posenc_dim",
    "pruned_search_listed",
    "pruned_search_presorted",
    "slot_perm_from_tiles",
]
