"""Photometric losses, as the JAX package's `training/loss.py`: MSE or
SmoothL1 on the ray colors, and an optional 0.1-weighted L1 mask loss on the
accumulated opacity, where rays inside the foreground mask count as opaque."""

from __future__ import annotations

import torch


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.SmoothL1Loss with beta=1 (elementwise mean), written out."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).mean()


def make_loss(loss_type: str = "L2", with_mask: bool = False):
    """loss_fn(outputs, rgb (R, 3), occupancy (R,)) -> {"loss_rgb", ["loss_mask"]}."""
    if loss_type not in ("L1", "L2"):
        raise ValueError(f"MODEL.LOSS={loss_type!r}: expected 'L1' or 'L2'")

    def loss_fn(outputs, rgb_gt, occupancy=None):
        color = outputs["color"]
        if loss_type == "L1":
            loss_rgb = smooth_l1(color, rgb_gt)
        else:
            loss_rgb = ((color - rgb_gt) ** 2).mean()
        losses = {"loss_rgb": loss_rgb}
        if with_mask and occupancy is not None:
            occ = occupancy.to(color.dtype)
            acc = torch.where(occ == 1, 1.0, outputs["acc_map"])
            losses["loss_mask"] = 0.1 * (acc - occ).abs().mean()
        return losses

    return loss_fn
