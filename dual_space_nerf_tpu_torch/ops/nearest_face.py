"""Nearest face (K=1 nearest triangle centroid): kernel wrapper, plain
version and the `KNN_IMPL` dispatch.

Replaces the TPU kernel `dual_space_nerf_tpu/ops/nearest_face.py:_nearest_kernel`
(wrapper `nearest_face_pallas`), the brute-force search that the JAX
package's `KNN_IMPL: "pallas"` runs and that holds its faster searches to
exactness. The kernel is `csrc/nearest_face.cu`.

Bound on the H100: operations (7.2e9 point-centroid pairs of ~9 FP32 ops per
524,288-point search; 6.3 MB moved). One thread per point keeps its best in
registers while the block streams the centroids through shared memory; see
the source's header. Kernel and plain version compute the same direct
difference d2 = (dx*dx + dy*dy) + dz*dz with one rounding per operation and
the smallest index on a tie, so their ids are equal.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
NEAREST_KERNEL = CudaKernel(
    "nearest_face.cu",
    "nearest_face_launch",
    [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
)

# point-centroid pairs per slice of the plain version: it never holds N x F
_PLAIN_PAIRS = 1 << 24


def face_centroids(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Triangle centroids: verts (V, 3), faces (F, 3) int -> (F, 3).

    ((v0 + v1) + v2) * (1/3) in float32: the sum-times-reciprocal that the
    JAX package's mean lowers to, so both sides search the same centroids."""
    tris = verts[faces]
    return ((tris[:, 0] + tris[:, 1]) + tris[:, 2]) * (1.0 / 3.0)


def nearest_face_plain(pts: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_f |pts - centroids_f|^2, first index on a tie; (N,) int32.

    Direct differences, (dx*dx + dy*dy) + dz*dz, sliced over points so at
    most 2^24 distances exist at once."""
    n, f = pts.shape[0], centroids.shape[0]
    if f == 0:
        raise ValueError("nearest_face: no centroids")
    out = torch.empty((n,), dtype=torch.int32, device=pts.device)
    step = max(1, _PLAIN_PAIRS // f)
    cx, cy, cz = centroids.unbind(-1)
    for s in range(0, n, step):
        p = pts[s:s + step]
        dx = p[:, 0:1] - cx
        dy = p[:, 1:2] - cy
        dz = p[:, 2:3] - cz
        # (dx*dx + dy*dy) + dz*dz, in place: one rounding per operation
        d2 = dx.mul_(dx).add_(dy.mul_(dy)).add_(dz.mul_(dz))
        out[s:s + step] = d2.argmin(dim=1).to(torch.int32)
    return out


def nearest_face_cuda(pts: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per point: pts (N, 3), centroids (F, 3) float32 ->
    (N,) int32. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if pts.device.type == "cpu":
        return nearest_face_plain(pts, centroids)
    if pts.device.type != "cuda":
        raise ValueError(f"nearest_face: unsupported device {pts.device}")
    for name, t in (("pts", pts), ("centroids", centroids)):
        if t.dtype != torch.float32:
            raise TypeError(f"nearest_face: {name} must be float32, got {t.dtype}")
        if t.device != pts.device:
            raise ValueError(f"nearest_face: {name} is on {t.device}, expected {pts.device}")
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"nearest_face: {name} must be (n, 3), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"nearest_face: {name} must be contiguous")
    n, f = pts.shape[0], centroids.shape[0]
    if f == 0:
        raise ValueError("nearest_face: no centroids")
    if n * 3 >= 2**31 or f * 3 >= 2**31:
        raise ValueError("nearest_face: the kernel indexes with 32-bit ints")
    out = torch.empty((n,), dtype=torch.int32, device=pts.device)
    with torch.cuda.device(pts.device):
        NEAREST_KERNEL.launch(
            pts.data_ptr(), centroids.data_ptr(), out.data_ptr(), n, f,
            stream_ptr(pts.device),
        )
    return out


# The JAX package's KNN_IMPL values (dual_space_nerf_tpu/ops/nearest_face.py).
KNN_IMPLS = ("auto", "listed", "pruned", "grouped", "clustered", "pallas", "xla")
# Values this port serves, and the ROADMAP items that bring the others.
_PORTED = ("auto", "pallas")
_TO_COME = {
    "listed": "ROADMAP queue 2, item 3 (_listed_kernel)",
    "pruned": "ROADMAP queue 2, item 4 (_pruned_kernel)",
    "grouped": "ROADMAP queue 1, item 7 (nearest_face_grouped)",
    "clustered": "ROADMAP queue 1, item 7 (nearest_face_clustered)",
    "xla": "ROADMAP queue 1, item 7 (the expanded-form search, which misranks near-ties)",
}


def check_knn_impl(impl: str) -> None:
    """Raise unless ``impl`` is a search this port runs."""
    if impl not in KNN_IMPLS:
        raise ValueError(f"unknown knn_impl {impl!r}; expected one of {KNN_IMPLS}")
    if impl not in _PORTED:
        raise NotImplementedError(
            f"knn_impl {impl!r} is not ported yet; see {_TO_COME[impl]}"
        )


def nearest_face(pts: torch.Tensor, centroids: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Nearest-centroid index per point for a `MODEL.KNN_IMPL` value.

    "auto" and "pallas" run the brute-force search: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors. Every other value raises; no
    value quietly runs another search."""
    check_knn_impl(impl)
    return nearest_face_cuda(pts, centroids)
