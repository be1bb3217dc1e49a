"""Full-image rendering (eval path).

Rays inside the AABB mask are rendered in fixed-size chunks and scattered
back into the H x W canvas, as the JAX package's `evaluation/render_image.py`
does. Every chunk is queued on the device first; the outputs are then
concatenated there and copied to the host once per image. With the fine
pass (settings.n_fine > 0) the fine outputs ride in the same copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.batching import item_to_mesh, iter_ray_chunks
from ..device import resolve_device
from ..renderer import LightState, RenderSettings, render_rays

# per-ray outputs kept, with their channel counts
_KEYS = (("color", 3), ("disp_map", 1), ("acc_map", 1), ("depth_map", 1))


class ImageRenderer:
    """Renders dataset items with ``model`` on ``device`` (CUDA unless the
    caller passes another; raises where there is no card). The model is
    moved to that device."""

    def __init__(self, model, settings: RenderSettings, faces: np.ndarray,
                 verts_cano: np.ndarray, chunk: int = 4096,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.settings = settings
        self.faces = faces
        self.verts_cano = verts_cano
        self.chunk = chunk

    def render_item(self, item: dict, light: LightState | None = None,
                    frame_override: int | None = None) -> dict[str, np.ndarray]:
        """Full-image float32 arrays: coarse_color (H, W, 3) and
        coarse_disp/acc/depth (H, W, 1); with the fine pass fine_color and
        fine_disp/acc/depth too."""
        dev = self.device
        light = LightState.identity(dev) if light is None else LightState(
            *(t.to(dev) for t in light)
        )
        mesh = item_to_mesh(item, self.faces, self.verts_cano, dev)
        passes = ("coarse", "fine") if self.settings.n_fine > 0 else ("coarse",)
        keys = [(("" if p == "coarse" else "fine_") + k, c, p) for p in passes for k, c in _KEYS]
        parts = []
        for rays, valid in iter_ray_chunks(item, self.chunk, dev, frame_override):
            out = render_rays(self.model, rays, mesh, self.settings, light, device=dev)
            parts.append(torch.cat(
                [out[k].reshape(rays.ray_o.shape[0], c)[:valid] for k, c, _ in keys], dim=1
            ))
        H, W = item["img"].shape[:2]
        mask = np.asarray(item["mask_at_box"]).reshape(-1).astype(bool)
        width = sum(c for _, c, _ in keys)
        canvas = np.zeros((H * W, width), np.float32)
        if parts:  # one device-to-host copy per image
            canvas[mask] = torch.cat(parts).cpu().numpy()
        images, col = {}, 0
        for (k, c, p), name in zip(keys, ("color", "disp", "acc", "depth") * len(passes)):
            images[f"{p}_{name}"] = canvas[:, col:col + c].reshape(H, W, c)
            col += c
        return images


def light_state_for_novel_pose(light_center, Th: np.ndarray, code_scale: float = 0.0,
                               device=None) -> LightState:
    """The reference's novel-pose setup: the frame code scaled by
    ``code_scale`` (0 zeroes it) and world coords shifted so the subject sits
    at the trained light_center."""
    base = LightState.identity(device)
    if light_center is not None and len(np.ravel(light_center)) == 3:
        bias = np.asarray(light_center, np.float32) - np.asarray(
            Th, np.float32
        ).reshape(-1, 3).mean(axis=0)
        base = base._replace(light_bias=torch.as_tensor(bias, device=device))
    return base._replace(
        code_scale=torch.tensor(code_scale, dtype=torch.float32, device=device)
    )
