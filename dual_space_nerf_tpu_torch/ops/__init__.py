from .clustered_knn import (
    build_face_clusters,
    cluster_geometry,
    nearest_face_clustered,
    nearest_face_grouped,
)
from .fused_mlp import BWD_FAST_KERNEL as FUSED_BWD_FAST_KERNEL
from .fused_mlp import BWD_KERNEL as FUSED_BWD_KERNEL
from .fused_mlp import FWD_FAST_KERNEL as FUSED_FWD_FAST_KERNEL
from .fused_mlp import FWD_KERNEL as FUSED_FWD_KERNEL
from .fused_mlp import fused_sigma, fused_sigma_essence_normal, nerf_params
from .gg_cuda import GG_KERNEL, gg_near_far_cuda, gg_near_far_plain
from .nearest_face import (
    NEAREST_KERNEL,
    face_centroids,
    nearest_face,
    nearest_face_cuda,
    nearest_face_plain,
    nearest_face_xla,
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
           PRUNED_KERNEL, FUSED_FWD_KERNEL, FUSED_BWD_KERNEL, FUSED_FWD_FAST_KERNEL,
           FUSED_BWD_FAST_KERNEL)

__all__ = [
    "FUSED_BWD_FAST_KERNEL",
    "FUSED_BWD_KERNEL",
    "FUSED_FWD_FAST_KERNEL",
    "FUSED_FWD_KERNEL",
    "GG_KERNEL",
    "KERNELS",
    "LISTED_KERNEL",
    "LISTED_PLAN_KERNEL",
    "LISTED_SLIM_KERNEL",
    "NEAREST_KERNEL",
    "PRUNED_KERNEL",
    "build_face_clusters",
    "build_face_tiles",
    "cluster_geometry",
    "face_centroids",
    "fused_sigma",
    "fused_sigma_essence_normal",
    "gg_near_far_cuda",
    "gg_near_far_plain",
    "listed_tables",
    "nearest_face",
    "nearest_face_clustered",
    "nearest_face_cuda",
    "nearest_face_grouped",
    "nearest_face_plain",
    "nearest_face_xla",
    "nearest_face_pruned",
    "nerf_params",
    "posenc",
    "posenc_dim",
    "pruned_search_listed",
    "pruned_search_presorted",
    "slot_perm_from_tiles",
]
