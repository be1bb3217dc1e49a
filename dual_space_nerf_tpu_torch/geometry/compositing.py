"""Volume-rendering alpha compositing (NeRF `raw2outputs`).

As in the JAX package's `geometry/compositing.py` and the reference:
- rgb is not sigmoid-squashed;
- transmittance is the cumprod of (1 - alpha + 1e-10) with a leading 1;
- the last interval is 1e10 and all intervals are scaled by ||ray_d||.
Noise on sigma comes in as an explicit tensor (or None).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RayOutputs(NamedTuple):
    rgb: torch.Tensor        # (R, 3)
    disp: torch.Tensor       # (R,)
    acc: torch.Tensor        # (R,)
    weights: torch.Tensor    # (R, S)
    depth: torch.Tensor      # (R,)


def composite(
    rgb: torch.Tensor,
    sigma: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise: torch.Tensor | None = None,
) -> RayOutputs:
    """rgb: (R, S, 3); sigma: (R, S); z_vals: (R, S); rays_d: (R, 3);
    noise: optional (R, S) added to sigma (already scaled by the caller)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    if noise is not None:
        sigma = sigma + noise

    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], dim=-1),
        dim=-1,
    )[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    # torch.maximum (not clamp) so a 0/0 ray stays NaN, as in the reference
    disp_map = 1.0 / torch.maximum(
        torch.full_like(depth_map, 1e-10), depth_map / acc_map
    )
    return RayOutputs(rgb_map, disp_map, acc_map, weights, depth_map)
