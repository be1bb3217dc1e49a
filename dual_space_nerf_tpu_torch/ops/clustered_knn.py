"""Balanced k-d partition of a mesh's faces (host side, numpy).

The port's own copy of the partition that the JAX package's
`ops/clustered_knn.py` builds: the same centroids give the same leaves,
entry for entry. The tile-pruned searches (`ops/pruned_knn.py`) order and
tile the faces by it. The `clustered` and `grouped` searches themselves are
not ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np


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
