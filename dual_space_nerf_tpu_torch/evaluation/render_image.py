"""Full-image rendering (eval path).

Rays inside the AABB mask are rendered in fixed-size chunks and scattered
back into the H x W canvas, as the JAX package's `evaluation/render_image.py`
does. Every chunk is queued on the device first; the outputs are then
concatenated there and copied to the host once per image. With the fine
pass (settings.n_fine > 0) the fine outputs ride in the same copy.

The copy's precision is `DSNERF_EVAL_PACK` (or the ``pack`` argument), as
in the JAX package: "f16" (the default) casts the outputs to float16 on the
device before the copy, half the bytes (~5e-4 absolute on [0, 1] colors,
above 60 dB); "f32" copies them as they are, for exact comparisons. The
canvas is float32 either way.

With ``devices`` each chunk's rays are split evenly over the devices (one
model replica per device), and the outputs are gathered on the first device
before the copy: the JAX package's ray-sharded eval (`mesh_devices`).

With tracing on (`utils/tracing.py`) an image is the spans ``image.mesh``
(the item's mesh and light on each device), the chunks' ``render.*``
stages, and ``image.pack`` (the concatenation, the cast and the copy,
where the host waits for the card).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..data.batching import item_to_mesh, iter_ray_chunks
from ..device import resolve_device
from ..renderer import LightState, RayBatch, RenderSettings, render_rays
from ..utils import tracing

# per-ray outputs kept, with their channel counts
_KEYS = (("color", 3), ("disp_map", 1), ("acc_map", 1), ("depth_map", 1))
PACKS = ("f16", "f32")


def default_pack() -> str:
    """The device-to-host copy's precision, `DSNERF_EVAL_PACK` ("f16" when
    unset); any other value raises."""
    raw = os.environ.get("DSNERF_EVAL_PACK", "f16")
    if raw not in PACKS:
        raise ValueError(f"DSNERF_EVAL_PACK={raw!r} must be 'f16' or 'f32'")
    return raw


class ImageRenderer:
    """Renders dataset items with ``model`` on ``device`` (CUDA unless the
    caller passes another; raises where there is no card). The model is
    moved to that device.

    ``devices`` (a list, in place of ``device``): each chunk's rays are
    split evenly over them, the chunk rounded up to a multiple of their
    number; the model goes to the first and is copied once to each other
    device. A device may be named twice (its share then runs after the
    other on the same replica). ``pack``: "f16" or "f32", the copy's
    precision; None reads `DSNERF_EVAL_PACK`."""

    def __init__(self, model, settings: RenderSettings, faces: np.ndarray,
                 verts_cano: np.ndarray, chunk: int = 4096,
                 device: str | torch.device | None = None,
                 devices: list | None = None, pack: str | None = None):
        if devices:
            if device is not None:
                raise ValueError("ImageRenderer: pass device or devices, not both")
            self.devices = [resolve_device(d) for d in devices]
            chunk = -(-chunk // len(self.devices)) * len(self.devices)  # even split
        else:
            self.devices = [resolve_device(device)]
        self.device = self.devices[0]
        self.model = model.to(self.device)
        self.replicas = {self.device: self.model}
        for d in self.devices[1:]:
            if d not in self.replicas:
                self.replicas[d] = copy.deepcopy(self.model).to(d)
        self.settings = settings
        self.faces = faces
        self.verts_cano = verts_cano
        self.chunk = chunk
        self.pack = default_pack() if pack is None else pack
        if self.pack not in PACKS:
            raise ValueError(f"ImageRenderer: pack {self.pack!r} must be 'f16' or 'f32'")

    def _render_chunk(self, rays: RayBatch, meshes: dict, lights: dict) -> dict:
        """One chunk's outputs on the first device, its rays split over the
        devices."""
        per = rays.ray_o.shape[0] // len(self.devices)
        outs = []
        for i, d in enumerate(self.devices):
            sl = slice(i * per, (i + 1) * per)
            part = RayBatch(rays.ray_o[sl].to(d), rays.ray_d[sl].to(d), rays.near[sl].to(d),
                            rays.far[sl].to(d), rays.frame, rays.body_pose.to(d))
            outs.append(render_rays(self.replicas[d], part, meshes[d], self.settings, lights[d],
                                    device=d))
        if len(outs) == 1:
            return outs[0]
        return {k: torch.cat([o[k].to(self.device) for o in outs]) for k in outs[0]}

    def render_item(self, item: dict, light: LightState | None = None,
                    frame_override: int | None = None) -> dict[str, np.ndarray]:
        """Full-image float32 arrays: coarse_color (H, W, 3) and
        coarse_disp/acc/depth (H, W, 1); with the fine pass fine_color and
        fine_disp/acc/depth too."""
        light = LightState.identity() if light is None else light
        with tracing.span("image.mesh"):
            meshes = {d: item_to_mesh(item, self.faces, self.verts_cano, d) for d in self.replicas}
            lights = {d: LightState(*(t.to(d) for t in light)) for d in self.replicas}
        passes = ("coarse", "fine") if self.settings.n_fine > 0 else ("coarse",)
        keys = [(("" if p == "coarse" else "fine_") + k, c, p) for p in passes for k, c in _KEYS]
        parts = []
        for rays, valid in iter_ray_chunks(item, self.chunk, self.device, frame_override):
            out = self._render_chunk(rays, meshes, lights)
            parts.append(torch.cat(
                [out[k].reshape(rays.ray_o.shape[0], c)[:valid] for k, c, _ in keys], dim=1
            ))
        H, W = item["img"].shape[:2]
        mask = np.asarray(item["mask_at_box"]).reshape(-1).astype(bool)
        width = sum(c for _, c, _ in keys)
        with tracing.span("image.pack"):  # the host waits for the card here
            canvas = np.zeros((H * W, width), np.float32)
            if parts:  # one device-to-host copy per image, float16 under the f16 pack
                packed = torch.cat(parts)
                if self.pack == "f16":
                    packed = packed.to(torch.float16)
                canvas[mask] = packed.cpu().numpy()
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
