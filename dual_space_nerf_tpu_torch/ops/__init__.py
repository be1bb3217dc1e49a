from .gg_cuda import GG_KERNEL, gg_near_far_cuda, gg_near_far_plain
from .nearest_face import (
    NEAREST_KERNEL,
    face_centroids,
    nearest_face,
    nearest_face_cuda,
    nearest_face_plain,
)
from .posenc import posenc, posenc_dim

#: every CUDA kernel of the port, for builds and launch counts
KERNELS = (GG_KERNEL, NEAREST_KERNEL)

__all__ = [
    "GG_KERNEL",
    "KERNELS",
    "NEAREST_KERNEL",
    "face_centroids",
    "gg_near_far_cuda",
    "gg_near_far_plain",
    "nearest_face",
    "nearest_face_cuda",
    "nearest_face_plain",
    "posenc",
    "posenc_dim",
]
