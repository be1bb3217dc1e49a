"""Cluster-pruned nearest-face searches: the balanced k-d partition of a
mesh's faces (host side, numpy) and the `clustered` and `grouped` searches
over it, as the JAX package's `ops/clustered_knn.py`.

The partition is the port's own copy of the JAX package's: the same
centroids give the same leaves, entry for entry. The tile-pruned searches
(`ops/pruned_knn.py`) order and tile the faces by it.

The searches are plain torch ops on the caller's device (the JAX package
runs them in XLA; neither has a kernel of its own). Per point, the bound
|p - center_c| - radius_c of every cluster c, UNclamped (a clamp to 0 would
tie every cluster whose bounding sphere holds the point and let the order
of indices decide), ranks the clusters; the K best are searched exactly.
`nearest_face_clustered` takes the K per point, `nearest_face_grouped` per
group of consecutive points (min-aggregated bounds). The center distances
are the expanded form |p|^2 - 2 p.c + |c|^2 through a float32 matmul (the
JAX package's Precision.HIGHEST; TF32 is off inside the call), the exact
distances the direct (dx*dx + dy*dy) + dz*dz.

Ties: the K clusters are taken in increasing bound, equal bounds by
increasing index, as `jax.lax.top_k` orders them (a stable sort; `torch.topk`
does not promise an order); among the candidates the first at the minimum
wins, as the JAX package's strict-< update and `argmin` decide. Ids can
part from the JAX package's only where rounding differs: at float32
near-ties of two faces' distances, or of two clusters' bounds at the K-th
rank. Exact against brute force at the shipped K for near-surface points
(the JAX package's tests and `tests/test_torch_port_searches.py`); far
points may miss at near-ties.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import true_fp32

# candidate pairs (point x cluster slot) per slice of `nearest_face_grouped`
# when the caller does not fix the groups per slice: ~200 MB of gathered
# candidates and 64 MB of distances at a time (the JAX package takes 256
# groups a slice; the ids do not depend on it)
_GROUPED_PAIRS = 1 << 24


def kd_partition(ids: np.ndarray, pts: np.ndarray, n_leaves: int) -> list:
    """Balanced k-d median split: recursively halve along the widest axis
    until n_leaves compact, equal-size (+-1) leaves remain."""
    if n_leaves <= 1 or len(ids) <= 1:
        return [ids]
    p = pts[ids]
    axis = int(np.argmax(p.max(0) - p.min(0)))
    order = ids[np.argsort(p[:, axis], kind="stable")]
    half = len(order) // 2
    left_leaves = n_leaves // 2
    return kd_partition(order[:half], pts, left_leaves) + kd_partition(
        order[half:], pts, n_leaves - left_leaves
    )


def build_face_clusters(centroids_cano: np.ndarray, n_clusters: int = 256) -> np.ndarray:
    """(C, cap) int32 cluster -> face table, -1 where padded, from canonical
    centroids. Clusters keep at least 8 faces, so small meshes get fewer."""
    pts = np.asarray(centroids_cano)
    f = pts.shape[0]
    c = max(1, min(n_clusters, f // 8 if f >= 8 else 1))
    leaves = kd_partition(np.arange(f), pts, c)
    cap = max(len(leaf) for leaf in leaves)
    table = np.full((len(leaves), cap), -1, np.int32)
    for i, leaf in enumerate(leaves):
        table[i, : len(leaf)] = leaf
    return table


def cluster_geometry(centroids: torch.Tensor, table: torch.Tensor):
    """Per cluster, from the current centroid positions: centers (C, 3),
    radii (C,), the members' centroids (C, cap, 3), valid (C, cap) and the
    member ids (C, cap) with padding at 0."""
    valid = table >= 0
    safe_table = table.clamp_min(0).long()
    cent_table = centroids[safe_table]
    w = valid[..., None].to(centroids.dtype)
    counts = valid.sum(-1).clamp_min(1)[:, None].to(centroids.dtype)
    centers = (cent_table * w).sum(1) / counts
    r2 = _sq_dist(cent_table, centers[:, None])
    radius = torch.sqrt(torch.where(valid, r2, 0.0).max(-1).values)
    return centers, radius, cent_table, valid, safe_table


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(dx*dx + dy*dy) + dz*dz over the last axis, broadcast."""
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _center_bounds(p: torch.Tensor, centers: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """|p - center| - radius (n, C), the distance in the expanded form."""
    with true_fp32():
        cross = p @ centers.T
    d2 = ((p * p).sum(-1, keepdim=True) - 2.0 * cross) + (centers * centers).sum(-1)[None]
    return torch.sqrt(d2.clamp_min(0.0)) - radius[None]


def _k_best(bound: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (n, k) of the k smallest bounds per row, increasing, equal
    bounds by increasing index (`jax.lax.top_k` of -bound)."""
    return torch.sort(bound, dim=-1, stable=True).indices[:, :k]


def _check(pts: torch.Tensor, centroids: torch.Tensor, table: torch.Tensor, what: str) -> None:
    for name, t in (("centroids", centroids), ("table", table)):
        if t.device != pts.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected {pts.device}")
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"{what}: table must be (C, cap), got {tuple(table.shape)}")


def nearest_face_clustered(
    pts: torch.Tensor,
    centroids: torch.Tensor,
    table: torch.Tensor,
    k: int = 24,
    chunk: int = 32768,
) -> torch.Tensor:
    """pts (N, 3), centroids (F, 3), table (C, cap) -> (N,) int32: each
    point's nearest face among the members of its k clusters of smallest
    bound, ``chunk`` points at a time."""
    _check(pts, centroids, table, "nearest_face_clustered")
    c, cap = table.shape
    k = min(k, c)
    centers, radius, cent_table, valid, safe_table = cluster_geometry(centroids, table)
    out = torch.empty((pts.shape[0],), dtype=torch.int32, device=pts.device)
    for a in range(0, pts.shape[0], chunk):
        p = pts[a:a + chunk]
        top = _k_best(_center_bounds(p, centers, radius), k)        # (n, K)
        d2 = _sq_dist(p[:, None, None, :], cent_table[top])           # (n, K, cap)
        d2 = torch.where(valid[top], d2, torch.inf).reshape(p.shape[0], k * cap)
        # the first minimum in (cluster rank, slot) order: the JAX
        # package's per-cluster argmin and strict-< update
        best = d2.argmin(dim=-1, keepdim=True)
        out[a:a + chunk] = torch.gather(safe_table[top].reshape(p.shape[0], k * cap), 1, best)[:, 0]
    return out


def nearest_face_grouped(
    pts: torch.Tensor,
    centroids: torch.Tensor,
    table: torch.Tensor,
    k: int = 32,
    group_chunk: int | None = None,
) -> torch.Tensor:
    """Nearest face of GROUPED points (G, S, 3) -> (G, S) int32.

    The samples of a ray are spatially coherent, so one candidate set per
    group serves all its members: the k clusters of smallest bound, each
    cluster's bound the least over the group's points. ``group_chunk``
    groups are searched at a time (None: as many as `_GROUPED_PAIRS`
    candidate pairs allow); the ids do not depend on it."""
    _check(pts, centroids, table, "nearest_face_grouped")
    g, s, _ = pts.shape
    c, cap = table.shape
    k = min(k, c)
    if group_chunk is None:
        group_chunk = max(1, _GROUPED_PAIRS // (s * k * cap))
    centers, radius, cent_table, valid, safe_table = cluster_geometry(centroids, table)
    out = torch.empty((g, s), dtype=torch.int32, device=pts.device)
    for a in range(0, g, group_chunk):
        p = pts[a:a + group_chunk]                                    # (gc, S, 3)
        gc = p.shape[0]
        bound = _center_bounds(p.reshape(gc * s, 3), centers, radius)
        top = _k_best(bound.reshape(gc, s, c).amin(dim=1), k)       # (gc, K)
        cand_c = cent_table[top].reshape(gc, 1, k * cap, 3)
        d2 = _sq_dist(p[:, :, None, :], cand_c)                       # (gc, S, K*cap)
        d2 = torch.where(valid[top].reshape(gc, 1, k * cap), d2, torch.inf)
        best = d2.argmin(dim=-1)                                      # (gc, S)
        out[a:a + gc] = torch.gather(safe_table[top].reshape(gc, k * cap), 1, best)
    return out
