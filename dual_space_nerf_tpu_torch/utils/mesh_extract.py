"""Iso-surface extraction by marching tetrahedra (numpy, on the host), and
a Wavefront .obj writer.

The port's own copy of the JAX package's `utils/mesh_extract.py`, held to
it bit for bit (`tests/test_torch_port_fine.py`): each grid cell splits into
six tetrahedra whose 16 crossing cases are derived in code, not read from a
table; odd cells mirror their corner labels so neighbouring cells share
their face diagonals (no cracks); triangles are oriented outward, duplicate
vertices welded and degenerate triangles dropped. A development and
visualisation path (`evaluation/visualizer.py`), not part of training.
"""

from __future__ import annotations

import numpy as np

# cube corner c (0..7) at offset (c & 1, (c >> 1) & 1, (c >> 2) & 1)
_CORNER_OFFSETS = np.array(
    [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
)
# 6-tetrahedra decomposition along the 0-7 body diagonal: one tet per
# monotone edge path 0 -> a -> b -> 7 (exactly tiles the cube, and every
# cube face is split along its (corner-0-adjacent) diagonal)
_TETS = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
         (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_case_table():
    """For each 4-bit inside-mask: list of triangles as triplets of
    tet-edge indices (into _TET_EDGES)."""
    edge_of = {frozenset(e): i for i, e in enumerate(_TET_EDGES)}
    table = []
    for mask in range(16):
        inside = [v for v in range(4) if mask >> v & 1]
        outside = [v for v in range(4) if not mask >> v & 1]
        tris = []
        if len(inside) == 1:
            i = inside[0]
            e = [edge_of[frozenset((i, o))] for o in outside]
            tris = [(e[0], e[1], e[2])]
        elif len(inside) == 3:
            o = outside[0]
            e = [edge_of[frozenset((o, i))] for i in inside]
            tris = [(e[0], e[2], e[1])]
        elif len(inside) == 2:
            i0, i1 = inside
            o0, o1 = outside
            a = edge_of[frozenset((i0, o0))]
            b = edge_of[frozenset((i0, o1))]
            c = edge_of[frozenset((i1, o0))]
            d = edge_of[frozenset((i1, o1))]
            tris = [(a, b, c), (c, b, d)]
        table.append(tris)
    return table


_CASES = _tet_case_table()


def marching_tetrahedra(
    grid: np.ndarray,
    level: float,
    origin: np.ndarray | None = None,
    spacing: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Extract the `level` iso-surface of a scalar grid (X, Y, Z).

    Returns (verts (M, 3) float32, faces (T, 3) int32). Vertex positions are
    origin + index * spacing (defaults: origin 0, spacing 1).
    """
    origin = np.zeros(3) if origin is None else np.asarray(origin, np.float64)
    spacing = np.ones(3) if spacing is None else np.asarray(spacing, np.float64)

    gx, gy, gz = grid.shape
    cx, cy, cz = gx - 1, gy - 1, gz - 1
    base = np.stack(
        np.meshgrid(
            np.arange(cx), np.arange(cy), np.arange(cz), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 3)                                            # (C, 3)

    # corner values through shifted grid views — no (C, 8, 3) index tensor;
    # only this (C, 8) array stays resident across the whole extraction
    n_cells = cx * cy * cz
    vals = np.empty((n_cells, 8), grid.dtype)
    for c in range(8):
        ox, oy, oz = _CORNER_OFFSETS[c]
        vals[:, c] = grid[ox : ox + cx, oy : oy + cy, oz : oz + cz].reshape(-1)

    # The 6-tet split of a cube is not face-consistent with its neighbors;
    # mirroring the corner labeling on odd-parity cells (c -> c ^ 7, a
    # checkerboard) makes every shared face's diagonal agree, so the mesh is
    # crack-free.
    parity = base.sum(axis=1) % 2                               # (C,)
    flip = parity == 1
    vals[flip] = vals[flip][:, [c ^ 7 for c in range(8)]]

    all_tris = []
    for tet in _TETS:
        tv = vals[:, tet]                                       # (C, 4)
        inside = tv > level
        mask = (
            inside[:, 0].astype(np.int64)
            | (inside[:, 1] << 1)
            | (inside[:, 2] << 2)
            | (inside[:, 3] << 3)
        )
        # bucket cells by case with ONE sort instead of 14 full-grid scans
        order = np.argsort(mask, kind="stable")
        bounds = np.searchsorted(mask[order], np.arange(17))
        for case in range(1, 15):
            sel = order[bounds[case] : bounds[case + 1]]
            if len(sel) == 0:
                continue
            sv = tv[sel]
            sel_flip = flip[sel]
            # corner positions on demand for the selected cells only; the
            # mirrored labeling's offset is the reflection 1 - offset
            off = np.broadcast_to(
                _CORNER_OFFSETS[list(tet)][None], (len(sel), 4, 3)
            )
            off = np.where(sel_flip[:, None, None], 1 - off, off)
            sp = origin + (base[sel][:, None, :] + off) * spacing
            # interpolated crossing point on each tet edge
            edge_pts = np.empty((len(sel), 6, 3))
            for ei, (a, b) in enumerate(_TET_EDGES):
                va = sv[:, a]
                vb = sv[:, b]
                denom = np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
                t = np.clip((level - va) / denom, 0.0, 1.0)
                edge_pts[:, ei] = sp[:, a] + t[:, None] * (sp[:, b] - sp[:, a])
            # outward direction: from the inside corners' centroid toward
            # the outside corners' — used to orient every emitted triangle
            # (the derived case table and the 6-tet split carry no
            # consistent handedness of their own; without this, half the
            # faces come out inward and viewers cull them)
            ins = [v for v in range(4) if case >> v & 1]
            outs = [v for v in range(4) if not case >> v & 1]
            outdir = sp[:, outs].mean(1) - sp[:, ins].mean(1)
            for (e0, e1, e2) in _CASES[case]:
                tri = np.stack(
                    [edge_pts[:, e0], edge_pts[:, e1], edge_pts[:, e2]], 1
                )
                nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
                swap = (nrm * outdir).sum(-1) < 0
                tri[swap] = tri[swap][:, ::-1]
                all_tris.append(tri)

    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(all_tris, axis=0)                     # (T, 3, 3)
    # weld duplicate vertices
    flat = tris.reshape(-1, 3)
    keys = np.round(flat / (spacing.min() * 1e-4)).astype(np.int64)
    _, uniq_idx, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    verts = flat[uniq_idx].astype(np.float32)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts, faces[ok]


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces + 1:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")
