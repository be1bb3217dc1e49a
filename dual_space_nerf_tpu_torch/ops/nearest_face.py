"""Nearest face (K=1 nearest triangle centroid): the brute-force kernel's
wrapper and plain version, the expanded-form search (`nearest_face_xla`)
and the `KNN_IMPL` dispatch (the tile-pruned searches are in
`ops/pruned_knn.py`, the cluster-pruned ones in `ops/clustered_knn.py`).

Replaces the TPU kernel `dual_space_nerf_tpu/ops/nearest_face.py:_nearest_kernel`
(wrapper `nearest_face_pallas`), the brute-force search that the JAX
package's `KNN_IMPL: "pallas"` runs and that holds its faster searches to
exactness. The kernel is `csrc/nearest_face.cu`.

Bound on the H100: instruction issue. A 524,288-point search is 7.2e9
point-centroid pairs of 9 FP32 operations that may not fuse into an FMA
(the tie rule), so its floor is 1.94 ms at 33.5e12 instructions per second,
twice the 67 TFLOP/s bound; it moves 6.3 MB. The kernel holds 4 points per
thread against centroid tiles copied into shared memory with `cp.async`,
takes a chunked `fminf` argmin, and, where the points make too few blocks
to fill the SMs evenly, splits the faces over the grid and merges with a
64-bit `atomicMin` (`face_splits`); see the source's header. Kernel and
plain version compute the same direct difference
d2 = (dx*dx + dy*dy) + dz*dz with one rounding per operation and the
smallest index on a tie, so their ids are equal.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..device import true_fp32
from .clustered_knn import nearest_face_clustered, nearest_face_grouped
from .cuda_build import CudaKernel, stream_ptr
from .pruned_knn import pruned_search_listed, pruned_search_presorted

_P = ctypes.c_void_p
_I = ctypes.c_int
NEAREST_KERNEL = CudaKernel(
    "nearest_face.cu",
    "nearest_face_launch",
    [_P, _P, _P, _P, _I, _I, _I, _P],
)
# face ranges of the kernel's grid: at most this many, of at least this
# many faces each
_MAX_SPLITS = 8
_MIN_SPLIT_FACES = 1024

# point-centroid pairs per slice of the plain version: it never holds N x F
_PLAIN_PAIRS = 1 << 24
# point-centroid pairs per slice of the expanded-form search
_XLA_PAIRS = 1 << 25


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


def face_splits(n_pts: int, n_faces: int, sms: int, block_points: int) -> int:
    """How many face ranges the brute-force kernel splits a search into.

    The kernel's blocks of ``block_points`` points each search one range;
    with s ranges a block does 1/s of the work. Modelling one block per SM
    at a time, the search takes ceil(blocks * s / sms) / s block-times. The
    smallest s that is 5% better than every smaller one is taken, up to
    `_MAX_SPLITS` ranges of at least `_MIN_SPLIT_FACES` faces. With the
    kernel's 1024-point blocks, 524,288 points make 512 blocks on 132 SMs:
    every s gives 4 rounds, so no split; 352,000 points make 344 blocks:
    3 ranges give 2.67 against 3."""
    blocks = -(-n_pts // block_points)
    best_s, best_t = 1, -(-blocks // sms)
    for s in range(2, min(_MAX_SPLITS, n_faces // _MIN_SPLIT_FACES) + 1):
        t = -(-blocks * s // sms) / s
        if t < 0.95 * best_t:
            best_s, best_t = s, t
    return best_s


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_splits(n_pts: int, n_faces: int) -> int:
    """`face_splits` for the kernel's blocks on the current card."""
    block_points = NEAREST_KERNEL.extra_function("nearest_face_block_points", [_I])(0)
    return face_splits(n_pts, n_faces, _sm_count(torch.cuda.current_device()), block_points)


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
    if centroids.data_ptr() % 16:
        raise ValueError("nearest_face: centroids must be 16-byte aligned (the kernel copies 16 bytes at a time)")
    return _nearest_face_launch(pts, centroids, None)


def _nearest_face_launch(pts: torch.Tensor, centroids: torch.Tensor, splits: int | None):
    """Launch the kernel on checked tensors; ``splits`` None takes
    `face_splits`' choice (a number forces one, for measurements)."""
    n, f = pts.shape[0], centroids.shape[0]
    dev = pts.device
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        if splits is None:
            splits = kernel_splits(n, f)
        keys = torch.empty((n,), dtype=torch.int64, device=dev) if splits > 1 else None
        NEAREST_KERNEL.launch(
            pts.data_ptr(), centroids.data_ptr(), out.data_ptr(),
            keys.data_ptr() if keys is not None else None, n, f, splits, stream_ptr(dev),
        )
    return out


# The JAX package's KNN_IMPL values (dual_space_nerf_tpu/ops/nearest_face.py).
KNN_IMPLS = ("auto", "listed", "pruned", "grouped", "clustered", "pallas", "xla")


def check_knn_impl(impl: str) -> None:
    """Raise unless ``impl`` is one of `KNN_IMPLS`."""
    if impl not in KNN_IMPLS:
        raise ValueError(f"unknown knn_impl {impl!r}; expected one of {KNN_IMPLS}")


def nearest_face_xla(pts: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmin_f of the expanded form |p|^2 - 2 p.c_f + |c_f|^2: (N,) int32,
    the JAX package's `nearest_face_xla` (its `KNN_IMPL: "xla"`).

    One float32 matmul (IEEE float32, TF32 off inside the call, as the JAX
    package's Precision.HIGHEST) and an argmin, first index on a tie,
    sliced over points so that at most `_XLA_PAIRS` distances exist at once.
    The form cancels |p|^2 against 2 p.c, so it misranks faces whose
    distances tie within its rounding (~|p|^2 float32 ulps): kept as the JAX
    package has it, not an exact search."""
    n, f = pts.shape[0], centroids.shape[0]
    if f == 0:
        raise ValueError("nearest_face_xla: no centroids")
    out = torch.empty((n,), dtype=torch.int32, device=pts.device)
    c2 = (centroids * centroids).sum(-1)[None, :]
    step = max(1, _XLA_PAIRS // f)
    for s in range(0, n, step):
        p = pts[s:s + step]
        with true_fp32():
            cross = p @ centroids.T
        d2 = ((p * p).sum(-1, keepdim=True) - 2.0 * cross) + c2
        out[s:s + step] = d2.argmin(dim=1).to(torch.int32)
    return out


def nearest_face(
    pts: torch.Tensor,
    centroids: torch.Tensor,
    impl: str = "auto",
    cluster_table: torch.Tensor | None = None,
    *,
    tile_table: torch.Tensor | None = None,
    face_perm: torch.Tensor | None = None,
) -> torch.Tensor:
    """Nearest-centroid index per point for a `MODEL.KNN_IMPL` value: (N,)
    int32 face ids.

    "auto" and "pallas" run the brute-force search. "listed" runs the
    list-driven search and needs ``tile_table`` (`build_face_tiles`);
    "pruned" runs the sphere-pruned search and needs ``face_perm`` (the kd
    order of the faces); both take the points as spatially coherent blocks.
    Each is a CUDA kernel on CUDA tensors and its plain version on CPU
    tensors. "clustered" and "grouped" (groups of one point, as the JAX
    dispatch runs it) need ``cluster_table`` (`build_face_clusters`); "xla"
    is the expanded-form argmin; these three are torch ops on either device.
    A missing table raises; no value quietly runs another search (the JAX
    package's "grouped" without a table runs its XLA argmin)."""
    check_knn_impl(impl)
    if impl == "listed":
        if tile_table is None:
            raise ValueError("knn_impl 'listed' needs the mesh's tile_table")
        return pruned_search_listed(pts, centroids, tile_table)
    if impl == "pruned":
        if face_perm is None:
            raise ValueError("knn_impl 'pruned' needs the mesh's face_perm")
        return pruned_search_presorted(pts, centroids, face_perm)
    if impl in ("grouped", "clustered"):
        if cluster_table is None:
            raise ValueError(f"knn_impl {impl!r} needs the mesh's cluster_table")
        if impl == "clustered":
            return nearest_face_clustered(pts, centroids, cluster_table)
        return nearest_face_grouped(pts.reshape(-1, 1, 3), centroids, cluster_table).reshape(-1)
    if impl == "xla":
        return nearest_face_xla(pts, centroids)
    return nearest_face_cuda(pts, centroids)
