"""Dataset API around the synthetic capsule scene.

Items have the schema of the JAX package's `data/synthetic_dataset.py`
(itself the ZJU schema). Ground-truth images are rendered by z-buffered
vertex splatting with colors from the canonical emission field. The train
split importance-samples `nrays` rays per item (`data/rays.py::sample_rays`)
from the dataset's numpy generator, or from a per-(epoch, item) generator
when `deterministic_items` is set, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from .rays import SamplePools, build_sample_pools, sample_rays
from .synthetic import SyntheticScene, emission_color, make_scene


def cache_images_enabled(default: bool = True) -> bool:
    """Epoch-persistent rendered-image cache switch (DSNERF_IMAGE_CACHE,
    '0' or '1'), as in the JAX package's `data/zju.py`."""
    raw = os.environ.get("DSNERF_IMAGE_CACHE")
    if raw is None:
        return default
    if raw not in ("0", "1"):
        raise ValueError(f"DSNERF_IMAGE_CACHE={raw!r} must be '0' or '1'")
    return raw == "1"


def splat_image(scene: SyntheticScene, h: int, w: int, radius: int = 2,
                essence: str = "smooth"):
    """Project verts, z-buffer splat emission colors -> (img, mask)."""
    verts = scene.verts_world
    cam = verts @ scene.R.T + scene.T.ravel()
    z = cam[:, 2]
    pix = cam @ scene.K.T
    pix = (pix[:, :2] / pix[:, 2:]).astype(np.int32)

    img = np.zeros((h, w, 3), np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)
    colors = emission_color(scene.verts_cano, kind=essence).astype(np.float32)
    order = np.argsort(-z)  # far to near: near splats overwrite
    ys = pix[order, 1]
    xs = pix[order, 0]
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            yy = np.clip(ys + dy, 0, h - 1)
            xx = np.clip(xs + dx, 0, w - 1)
            # depth test, so a far vertex of a later offset cannot overwrite
            # a near vertex's pixel
            win = z[order] <= zbuf[yy, xx]
            img[yy[win], xx[win]] = colors[order][win]
            zbuf[yy[win], xx[win]] = z[order][win]
    mask = (zbuf < np.inf).astype(np.uint8)
    img *= mask[..., None]
    return img, mask


class SyntheticDataset:
    """n_frames poses x n_views cameras of the capsule avatar."""

    def __init__(self, split="train", nrays=1024, n_frames=2, n_views=3, h=96, w=96, seed=0,
                 view_offset=0.0, essence="smooth"):
        self.split = split
        self.nrays = nrays if split == "train" else -1
        self.h, self.w = h, w
        self.essence = essence
        self.rng = np.random.default_rng(seed)
        self.item_seed = 0 if seed is None else int(seed)
        self.deterministic_items = False
        self._epoch = 0
        self.items = []
        for f in range(n_frames):
            for v in range(n_views):
                self.items.append(
                    (f, v, make_scene(
                        seed=seed, bend=0.3 + 0.05 * f,
                        cam_angle=2 * np.pi * (v + view_offset) / n_views,
                        h=h, w=w,
                    ))
                )
        self.canonical_vertex = self.items[0][2].verts_cano
        self.faces = self.items[0][2].faces
        self.cache_images = cache_images_enabled()
        self._image_cache: dict[int, tuple] = {}
        self._pools_cache: dict[int, object] = {}

    def __len__(self):
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _item_rng(self, i: int):
        if self.deterministic_items:
            return np.random.default_rng([self.item_seed, self._epoch, int(i)])
        return self.rng

    def _rendered_frame(self, idx):
        hit = self._image_cache.get(idx)
        if hit is not None:
            return hit
        scene = self.items[idx][2]
        out = splat_image(scene, self.h, self.w, essence=self.essence)
        if self.cache_images:
            self._image_cache[idx] = out
        return out

    def __getitem__(self, idx):
        frame, view, scene = self.items[idx]
        img, mask = self._rendered_frame(idx)
        pools = self._pools_cache.get(idx)
        if self.nrays <= 0:
            pools = SamplePools(None, None, None, None)  # the whole image: no raster needed
        elif pools is None:
            pools = build_sample_pools(self.h, self.w, scene.K, scene.R, scene.T, scene.bounds,
                                       mask=mask, face_mask=None, coords=self.nrays > 0)
            if self.cache_images:
                self._pools_cache[idx] = pools
        rgb, ray_o, ray_d, near, far, coord, mask_at_box, _ = sample_rays(
            img, scene.K, scene.R, scene.T, scene.bounds, mask=mask, nrays=self.nrays,
            rng=self._item_rng(idx), pools=pools,
        )
        occupancy = mask[coord[:, 0], coord[:, 1]]
        return {
            "img": img,
            "coord": coord,
            "rgb": rgb,
            "occupancy": occupancy.astype(np.float32),
            "ray_o": ray_o,
            "ray_d": ray_d,
            "near": near,
            "far": far,
            "mask_at_box": mask_at_box,
            "poses": scene.poses,
            "xyz": scene.verts_world,
            "bounds": scene.bounds,
            "Rh": np.eye(3, dtype=np.float32),
            "Th": np.zeros((1, 3), np.float32),
            "R": scene.R,
            "T": scene.T,
            "frame": frame,
            "cam_ind": view,
            "save_name": f"frame{frame:04d}_view{view:04d}",
        }
