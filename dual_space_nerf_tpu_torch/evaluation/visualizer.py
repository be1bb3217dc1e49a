"""Density-field mesh extraction and a turntable of the mesh (a development
path), as the JAX package's `evaluation/visualizer.py`.

`Visualizer3D` builds a world-space grid over the subject's bounds, warps
it to canonical space (`renderer.warp_world_to_canonical`, no ray
directions), queries the density in chunks (`renderer.density_grid`), zeroes
the points outside the transparent mask, extracts the iso-surface
(`utils/mesh_extract.py`) and writes it as a Wavefront .obj. The turntable
rasterises the mesh in numpy (`render_mesh_image`) and writes PNGs with the
port's own writer (`utils/image_io.py`), where the JAX package uses cv2.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops import face_centroids
from ..renderer import MeshBundle, RenderSettings, density_grid, warp_world_to_canonical
from ..utils.image_io import write_png
from ..utils.mesh_extract import marching_tetrahedra, save_obj


class Visualizer3D:
    """Mesh extraction from ``model``'s density on ``device`` (CUDA unless
    the caller passes another; the model is moved there, the mesh must be
    there)."""

    def __init__(self, model, settings: RenderSettings, resolution: int = 128,
                 level: float = 5.0, chunk: int = 100_000,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.settings = settings
        self.resolution = resolution
        self.level = level
        self.chunk = chunk

    def density_volume(self, mesh: MeshBundle, bounds: np.ndarray, frame: int,
                       body_pose: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(grid (R, R, R) float32, origin (3,), spacing (3,)) over the
        world box ``bounds`` (2, 3); body_pose: the (24, 3) SMPL poses, the
        root's first. One device-to-host copy at the end."""
        r = self.resolution
        dev = self.device
        axes = [np.linspace(bounds[0][a], bounds[1][a], r) for a in range(3)]
        pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
        spacing = (bounds[1] - bounds[0]) / (r - 1)
        pose = torch.as_tensor(np.asarray(body_pose[1:24], np.float32), device=dev)
        centroids_w = face_centroids(mesh.verts_world, mesh.faces)
        densities = []
        for start in range(0, len(pts), self.chunk):
            chunk_pts = torch.as_tensor(pts[start:start + self.chunk].astype(np.float32), device=dev)
            with torch.no_grad():
                pts_c, tmask, _ = warp_world_to_canonical(chunk_pts, mesh, centroids_w, self.settings)
                d = density_grid(self.model, pts_c, frame, pose, self.settings)
                densities.append(torch.where(tmask, 0.0, d))
        grid = torch.cat(densities).cpu().numpy().reshape(r, r, r)
        return grid, bounds[0], spacing

    def extract_mesh(self, mesh: MeshBundle, bounds: np.ndarray, frame: int,
                     body_pose: np.ndarray, out_path: str | None = None):
        """(verts (M, 3) float32, faces (T, 3) int32) of the density's
        ``level`` iso-surface; written to ``out_path`` (.obj) if given."""
        grid, origin, spacing = self.density_volume(mesh, bounds, frame, body_pose)
        verts, faces = marching_tetrahedra(grid, self.level, origin, spacing)
        if out_path:
            save_obj(out_path, verts, faces)
        return verts, faces

    def render_turntable(self, mesh: MeshBundle, bounds: np.ndarray, frame: int,
                         body_pose: np.ndarray, out_dir: str | None = None,
                         n_views: int = 10, size: int = 512) -> list[np.ndarray]:
        """The extracted mesh from ``n_views`` angles about the vertical:
        RGB uint8 frames; written to out_dir as mesh_###.png if given."""
        verts, faces = self.extract_mesh(mesh, bounds, frame, body_pose)
        frames = []
        for i in range(n_views):
            img = render_mesh_image(verts, faces, angle=2 * np.pi * i / n_views, size=size)
            frames.append(img)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"mesh_{i:03d}.png"), img[..., ::-1])
        return frames


def render_mesh_image(verts: np.ndarray, faces: np.ndarray, angle: float = 0.0,
                      size: int = 512, light_dir=(0.3, 0.5, 0.8)) -> np.ndarray:
    """Flat-shaded z-buffer rasterisation of a triangle mesh -> (H, W, 3)
    uint8 RGB, orthographic (x right, z up, y depth), in numpy: per triangle
    the barycentric coverage of its pixel box, far to near, with a z test
    per pixel. The JAX package's `render_mesh_image`, the same arithmetic."""
    if len(faces) == 0:
        return np.zeros((size, size, 3), np.uint8)
    v = np.asarray(verts, np.float64)
    center = 0.5 * (v.min(0) + v.max(0))
    scale = float(np.max(v.max(0) - v.min(0))) or 1.0
    v = (v - center) / scale
    ca, sa = np.cos(angle), np.sin(angle)
    rot = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]])
    v = v @ rot.T
    px = (v[:, 0] * 0.9 + 1.0) * 0.5 * (size - 1)
    py = (-v[:, 2] * 0.9 + 1.0) * 0.5 * (size - 1)
    depth = v[:, 1]

    tri = np.asarray(faces, np.int64)
    p0, p1, p2 = (np.stack([px[tri[:, k]], py[tri[:, k]]], -1) for k in range(3))
    w0, w1, w2 = (v[tri[:, k]] for k in range(3))
    n = np.cross(w1 - w0, w2 - w0)
    nn = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    ld = np.asarray(light_dir, np.float64)
    ld = ld / np.linalg.norm(ld)
    shade = 0.25 + 0.75 * np.abs(nn @ ld)                        # (F,)

    img = np.zeros((size, size), np.float64)
    zbuf = np.full((size, size), np.inf)
    order = np.argsort((depth[tri[:, 0]] + depth[tri[:, 1]] + depth[tri[:, 2]]) / 3.0)[::-1]
    for f in order:
        a, b, c = p0[f], p1[f], p2[f]
        lo = np.maximum(np.floor(np.minimum(np.minimum(a, b), c)).astype(int), 0)
        hi = np.minimum(np.ceil(np.maximum(np.maximum(a, b), c)).astype(int), size - 1)
        if (hi < lo).any():
            continue
        gx, gy = np.meshgrid(np.arange(lo[0], hi[0] + 1), np.arange(lo[1], hi[1] + 1))
        d = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(d) < 1e-12:
            continue
        u = ((gx - a[0]) * (c[1] - a[1]) - (gy - a[1]) * (c[0] - a[0])) / d
        w = ((b[0] - a[0]) * (gy - a[1]) - (b[1] - a[1]) * (gx - a[0])) / d
        inside = (u >= 0) & (w >= 0) & (u + w <= 1)
        if not inside.any():
            continue
        zd = depth[tri[f, 0]] * (1 - u - w) + depth[tri[f, 1]] * u + depth[tri[f, 2]] * w
        yy, xx, zz = gy[inside], gx[inside], zd[inside]
        closer = zz < zbuf[yy, xx]
        img[yy[closer], xx[closer]] = shade[f]
        zbuf[yy[closer], xx[closer]] = zz[closer]
    return (np.clip(img, 0, 1)[..., None] * np.array([0.85, 0.85, 0.95]) * 255).astype(np.uint8)
