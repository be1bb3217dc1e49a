"""Host item dict -> tensors on the renderer's device, with the mesh
tables of the tile-pruned nearest-face searches.

Train items become one fixed-size `TrainBatch`: the sampled rays sorted by
pixel locality (the searches' blocks are then tight) and padded to `nrays`
by wrapping, as in the JAX package's `data/batching.py`.

Eval images render in fixed-size chunks: `iter_ray_chunks` pads the tail
chunk by repeating its last ray, and the caller keeps the valid prefix.
"""

from __future__ import annotations

import hashlib
from typing import Iterator

import numpy as np
import torch

from ..ops import build_face_clusters, build_face_tiles, face_centroids, listed_tables
from ..renderer import MeshBundle, RayBatch
from ..training import TrainBatch


#: per (canonical mesh content, device): (faces, verts_cano, face_perm,
#: tile_table, cano_tables, cluster_table) on the device; oldest entries
#: leave first
_STATIC_MESH_CACHE: dict[tuple, tuple] = {}
_STATIC_MESH_CACHE_MAX = 8


def _mesh_cache_key(faces: np.ndarray, verts_cano: np.ndarray, device: torch.device) -> tuple:
    """Content-derived: an `id()` can be recycled after garbage collection
    and would serve another mesh's face order to an exact search."""
    f = np.ascontiguousarray(faces)
    v = np.ascontiguousarray(verts_cano)
    digest = hashlib.sha1(f.tobytes() + v.tobytes()).hexdigest()
    return (f.shape, str(f.dtype), v.shape, str(v.dtype), digest, str(device))


def _static_mesh_tables(faces: np.ndarray, verts_cano: np.ndarray, device: torch.device):
    """Build (and cache per canonical mesh and device) what does not change
    with the pose: the faces and canonical vertices on the device, the kd
    order of the faces (`face_perm`, for the pruned search), the kd-leaf
    tile table and the canonical mesh's listed-search tables, and the face
    clusters themselves (`cluster_table`, for the clustered and grouped
    searches). The partition
    is plain numpy on the float32 mean of each face's canonical vertices, as
    in the JAX package, so both build the same tables."""
    key = _mesh_cache_key(faces, verts_cano, device)
    hit = _STATIC_MESH_CACHE.get(key)
    if hit is None:
        faces_np = np.asarray(faces, np.int64)
        cents = np.asarray(verts_cano, np.float32)[faces_np].mean(axis=1)
        clusters = build_face_clusters(cents)
        faces_dev = torch.as_tensor(faces_np, device=device)
        cano_dev = torch.as_tensor(np.asarray(verts_cano, np.float32), device=device)
        face_perm = torch.as_tensor(clusters[clusters >= 0].ravel().astype(np.int64), device=device)
        tile_table = torch.as_tensor(build_face_tiles(cents), device=device)
        cano_tables = listed_tables(face_centroids(cano_dev, faces_dev), tile_table)
        hit = (faces_dev, cano_dev, face_perm, tile_table, cano_tables,
               torch.as_tensor(clusters, device=device))
        while len(_STATIC_MESH_CACHE) >= _STATIC_MESH_CACHE_MAX:
            _STATIC_MESH_CACHE.pop(next(iter(_STATIC_MESH_CACHE)))
        _STATIC_MESH_CACHE[key] = hit
    return hit


def item_to_mesh(item: dict, faces: np.ndarray, verts_cano: np.ndarray,
                 device: torch.device) -> MeshBundle:
    """The posed mesh of the item plus the canonical mesh, on ``device``,
    with the tables of the tile-pruned searches. The canonical tables come
    from the cache; the posed mesh's listed-search tables are derived here,
    once per item, so that no render chunk derives them again (the results
    are identical either way)."""
    faces_dev, cano_dev, face_perm, tile_table, cano_tables, cluster_table = _static_mesh_tables(
        faces, verts_cano, device
    )
    verts_world = torch.as_tensor(np.asarray(item["xyz"], np.float32), device=device)
    return MeshBundle(
        faces=faces_dev,
        verts_world=verts_world,
        verts_cano=cano_dev,
        face_perm=face_perm,
        tile_table=tile_table,
        cano_tables=cano_tables,
        world_tables=listed_tables(face_centroids(verts_world, faces_dev), tile_table),
        cluster_table=cluster_table,
    )


def _wrap_pad(x: np.ndarray, n: int) -> np.ndarray:
    """Pad to n rows by repeating the rows from the start."""
    if x.shape[0] == n:
        return x
    reps = -(-n // x.shape[0])
    return np.concatenate([x] * reps, axis=0)[:n]


def _spatial_ray_order(item: dict) -> np.ndarray:
    """Sampled rays in 16x16 pixel-tile order (row-major tiles, stable)."""
    coord = np.asarray(item["coord"])
    n_tile_cols = int(coord[:, 1].max()) // 16 + 1
    key = (coord[:, 0] // 16) * (n_tile_cols * 16) + (coord[:, 1] // 16) * 16 + (coord[:, 0] % 16)
    return np.argsort(key, kind="stable")


def item_to_train_batch(item: dict, nrays: int, device: torch.device) -> TrainBatch:
    """A train item as a `TrainBatch` of exactly ``nrays`` rays on ``device``."""
    if "coord" in item and len(item["coord"]) == len(item["ray_o"]):
        order = _spatial_ray_order(item)
        item = dict(item)
        for k in ("ray_o", "ray_d", "near", "far", "rgb", "occupancy", "coord"):
            if k in item:
                item[k] = np.asarray(item[k])[order]

    def dev(k):
        return torch.as_tensor(np.ascontiguousarray(_wrap_pad(np.asarray(item[k], np.float32), nrays)),
                               device=device)

    rays = RayBatch(
        ray_o=dev("ray_o"), ray_d=dev("ray_d"), near=dev("near"), far=dev("far"),
        frame=int(item["frame"]),
        body_pose=torch.as_tensor(np.asarray(item["poses"][1:24], np.float32), device=device),
    )
    return TrainBatch(rays=rays, rgb=dev("rgb"), occupancy=dev("occupancy"))


def iter_ray_chunks(
    item: dict, chunk: int, device: torch.device, frame_override: int | None = None
) -> Iterator[tuple[RayBatch, int]]:
    """Yield (RayBatch on ``device``, n_valid) fixed-size chunks covering all
    of the item's rays."""
    n = item["ray_o"].shape[0]
    frame = int(item["frame"]) if frame_override is None else int(frame_override)
    body_pose = torch.as_tensor(
        np.asarray(item["poses"][1:24], np.float32), device=device
    )
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        valid = end - start

        def pad(x):
            x = np.asarray(x[start:end], np.float32)
            if valid < chunk:
                x = np.concatenate(
                    [x, np.repeat(x[-1:], chunk - valid, axis=0)], axis=0
                )
            return torch.as_tensor(x, device=device)

        yield (
            RayBatch(
                ray_o=pad(item["ray_o"]),
                ray_d=pad(item["ray_d"]),
                near=pad(item["near"]),
                far=pad(item["far"]),
                frame=frame,
                body_pose=body_pose,
            ),
            valid,
        )
