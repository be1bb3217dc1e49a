"""Synthetic capsule-avatar dataset.

The real datasets (ZJU-MoCap, H36M) require licensed assets (SMPL pickle,
capture data) that ship outside the repo. This module provides a fully
self-contained stand-in with the same *shapes and semantics* — a capsule
"body" mesh playing the role of the posed SMPL (V verts, F faces), a bent
copy playing the canonical X-pose, pinhole cameras on a ring, and images
rendered analytically from a smooth emission function. A numpy copy of the
JAX package's `data/synthetic.py`: the same seed gives the same scene.

By default V/F match SMPL (6890 / 13776) so kernels are exercised at the
real sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticScene(NamedTuple):
    verts_world: np.ndarray   # (V, 3) float32 posed mesh
    verts_cano: np.ndarray    # (V, 3) float32 canonical mesh
    faces: np.ndarray         # (F, 3) int32
    poses: np.ndarray         # (24, 3) float32 SMPL-layout joint rot-vecs
    K: np.ndarray             # (3, 3)
    R: np.ndarray             # (3, 3)
    T: np.ndarray             # (3, 1)
    bounds: np.ndarray        # (2, 3) world AABB


def capsule_mesh(
    n_theta: int = 82, n_phi: int = 84, radius: float = 0.3, half_len: float = 0.6
) -> tuple[np.ndarray, np.ndarray]:
    """Closed capsule triangle mesh along z. Defaults give V=6890, F=13776
    (the SMPL vertex/face counts: V = n_theta*n_phi + 2, F = 2*V - 4)."""
    thetas = np.linspace(0, np.pi, n_theta + 2)[1:-1]
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing="ij")
    x = radius * np.sin(tt) * np.cos(pp)
    y = radius * np.sin(tt) * np.sin(pp)
    z = radius * np.cos(tt) + np.sign(np.cos(tt)) * half_len
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    top = np.array([[0.0, 0.0, radius + half_len]])
    bot = np.array([[0.0, 0.0, -radius - half_len]])
    verts = np.concatenate([top, verts, bot], axis=0).astype(np.float32)

    faces = []
    def vid(i, j):  # ring i, azimuth j
        return 1 + i * n_phi + (j % n_phi)

    for j in range(n_phi):  # top cap fan
        faces.append([0, vid(0, j), vid(0, j + 1)])
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            faces.append([a, b, c])
            faces.append([b, d, c])
    last = len(verts) - 1
    for j in range(n_phi):  # bottom cap fan
        faces.append([last, vid(n_theta - 1, j + 1), vid(n_theta - 1, j)])
    return verts, np.asarray(faces, np.int32)


def _bend(verts: np.ndarray, amount: float) -> np.ndarray:
    """Smooth z-dependent shear — the 'pose' deformation between spaces."""
    out = verts.copy()
    out[:, 0] += amount * np.tanh(2.0 * verts[:, 2])
    return out


def look_at_camera(
    eye: np.ndarray, target: np.ndarray, h: int, w: int, focal: float
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (K, R, T) with world-to-camera x = R p + T, z forward."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    right = np.cross(fwd, up)
    if np.linalg.norm(right) < 1e-6:
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)
    T = (-R @ eye)[:, None]
    K = np.array(
        [[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1.0]]
    )
    return K.astype(np.float64), R.astype(np.float64), T.astype(np.float64)


def make_scene(
    seed: int = 0,
    n_theta: int = 82,
    n_phi: int = 84,
    bend: float = 0.35,
    cam_angle: float = 0.0,
    h: int = 128,
    w: int = 128,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    verts_cano, faces = capsule_mesh(n_theta, n_phi)
    verts_world = _bend(verts_cano, bend) + np.array(
        [0.1, -0.05, 0.02], np.float32
    )
    poses = (0.1 * rng.standard_normal((24, 3))).astype(np.float32)
    eye = np.array([2.5 * np.cos(cam_angle), 2.5 * np.sin(cam_angle), 0.4])
    K, R, T = look_at_camera(eye, np.zeros(3), h, w, focal=1.2 * max(h, w))
    bounds = np.stack(
        [verts_world.min(0) - 0.1, verts_world.max(0) + 0.1]
    ).astype(np.float32)
    return SyntheticScene(verts_world, verts_cano, faces, poses, K, R, T, bounds)


def emission_color(pts_cano: np.ndarray, kind: str = "smooth") -> np.ndarray:
    """Ground-truth color field on canonical coordinates.

    kind="smooth": low-frequency sin field (the default capsule).
    kind="textured": adds high-frequency axial stripes and an azimuthal
    checker on top of the smooth base — exercises exactly the detail regime
    that importance-gated shading approximates, for harder quality A/Bs
    (the reference's real workload is ~28+ dB ZJU footage, not a smooth
    blob).
    """
    base = 0.5 + 0.5 * np.sin(3.0 * pts_cano + np.array([0.0, 2.1, 4.2]))
    if kind == "smooth":
        return base
    if kind != "textured":
        raise ValueError(f"unknown emission kind {kind!r}")
    x, y, z = pts_cano[..., 0], pts_cano[..., 1], pts_cano[..., 2]
    stripes = 0.25 * np.sin(24.0 * z)
    checker = 0.15 * np.sign(
        np.sin(8.0 * np.arctan2(y, x)) * np.sin(16.0 * z + 0.7)
    )
    out = base + (stripes + checker)[..., None] * np.array([1.0, -0.8, 0.6])
    return np.clip(out, 0.0, 1.0)
