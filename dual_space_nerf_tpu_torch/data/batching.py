"""Host item dict -> tensors on the renderer's device.

Eval images render in fixed-size chunks: `iter_ray_chunks` pads the tail
chunk by repeating its last ray, and the caller keeps the valid prefix.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..renderer import MeshBundle, RayBatch


def item_to_mesh(item: dict, faces: np.ndarray, verts_cano: np.ndarray,
                 device: torch.device) -> MeshBundle:
    """The posed mesh of the item plus the canonical mesh, on ``device``."""
    return MeshBundle(
        faces=torch.as_tensor(np.asarray(faces, np.int64), device=device),
        verts_world=torch.as_tensor(np.asarray(item["xyz"], np.float32), device=device),
        verts_cano=torch.as_tensor(np.asarray(verts_cano, np.float32), device=device),
    )


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
