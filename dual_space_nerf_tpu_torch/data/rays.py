"""Host-side ray generation (numpy), ZJU conventions.

The full-image part of the JAX package's `data/rays.py`: `get_rays` keeps
ray_d un-normalized, and `get_near_far_zju` is the reference's slab test
over an AABB inflated by 1 cm. The importance pixel sampler (`nrays > 0`)
needs the projected-box raster that the JAX package draws with
`cv2.fillPoly`; it comes with the training slice.
"""

from __future__ import annotations

import numpy as np


def get_rays(H, W, K, R, T, normalize: bool = False):
    """Per-pixel camera rays in world space: returns (ray_o, ray_d) (H, W, 3)."""
    rays_o = -(R.T @ T).ravel()
    i, j = np.meshgrid(
        np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = xy1 @ np.linalg.inv(K).T
    pixel_world = (pixel_camera - T.ravel()) @ R
    rays_d = pixel_world - rays_o[None, None]
    if normalize:
        rays_d = rays_d / np.linalg.norm(rays_d, axis=2, keepdims=True)
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o, rays_d


def get_near_far_zju(bounds, ray_o, ray_d):
    """AABB intersection, ZJU flavor. Returns (near, far, mask_at_box);
    near/far only for the rays in the mask."""
    bounds = bounds + np.array([-0.01, 0.01])[:, None]
    nominator = bounds[None] - ray_o[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        # axis-parallel rays yield inf/nan planes that the box test rejects
        d_intersect = (nominator / ray_d[:, None]).reshape(-1, 6)
        p_intersect = d_intersect[..., None] * ray_d[:, None] + ray_o[:, None]
    mn = bounds.ravel()[:3]
    mx = bounds.ravel()[3:]
    eps = 1e-6
    ok = np.ones(p_intersect.shape[:2], dtype=bool)
    for a in range(3):
        ok &= (p_intersect[..., a] >= mn[a] - eps) & (
            p_intersect[..., a] <= mx[a] + eps
        )
    mask_at_box = ok.sum(-1) == 2
    p_intervals = p_intersect[mask_at_box][ok[mask_at_box]].reshape(-1, 2, 3)
    ro = ray_o[mask_at_box]
    rd = ray_d[mask_at_box]
    norm_ray = np.linalg.norm(rd, axis=1)
    d0 = np.linalg.norm(p_intervals[:, 0] - ro, axis=1) / norm_ray
    d1 = np.linalg.norm(p_intervals[:, 1] - ro, axis=1) / norm_ray
    return np.minimum(d0, d1), np.maximum(d0, d1), mask_at_box


def sample_rays(img, K, R, T, bounds, nrays=-1, *, normalize_dirs=False,
                near_far=get_near_far_zju):
    """Every ray of the image that hits the AABB (``nrays <= 0``).

    Returns (rgb, ray_o, ray_d, near, far, coord, mask_at_box): the JAX
    package's tuple without the projected-box raster, which the full-image
    path never reads."""
    if nrays > 0:
        raise NotImplementedError(
            "importance pixel sampling (nrays > 0) comes with the training slice"
        )
    H, W = img.shape[:2]
    ray_o_all, ray_d_all = get_rays(H, W, K, R, T, normalize=normalize_dirs)
    rgb = img.reshape(-1, 3).astype(np.float32)
    ray_o = ray_o_all.reshape(-1, 3).astype(np.float32)
    ray_d = ray_d_all.reshape(-1, 3).astype(np.float32)
    near, far, mask_at_box = near_far(bounds, ray_o, ray_d)
    near = near.astype(np.float32)
    far = far.astype(np.float32)
    coord = np.argwhere(mask_at_box.reshape(H, W))
    return (rgb[mask_at_box], ray_o[mask_at_box], ray_d[mask_at_box], near, far,
            coord, mask_at_box)
