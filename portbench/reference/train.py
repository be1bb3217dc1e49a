"""Training steps in plain PyTorch: the render with its graph, the L2 loss
on the ray colours (with the fine pass, plus the same term on its
colours), the gradient of every weight (through the density normal:
second order), and the published optimizer, Adam (betas 0.9 /
0.999, eps 1e-8, coupled weight decay) at the published learning-rate
schedule (linear warm-up, then 1, then an exponential decay to LR_SCALE).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import networks as nets
from .render import Settings, render
from .scene import tile_order

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def lr_factor(update: int, solver: dict) -> float:
    """The learning rate's factor at update ``update`` (0 for the first)."""
    it = update + 1.0
    if it <= solver["WARMUP_ITERS"]:
        return it / solver["WARMUP_ITERS"]
    if it >= solver["START_ITERS"]:
        scale = solver["LR_SCALE"]
        span = solver["END_ITERS"] - solver["START_ITERS"]
        return (1.0 - scale) * math.exp(-(it - solver["START_ITERS"]) / span) + scale
    return 1.0


def batch_tensors(item: dict, mesh_cano: np.ndarray, faces: np.ndarray, device) -> tuple:
    """(rays, rgb, mesh) of a train item, its rays in tile order (the order
    in which the step's draws are laid out)."""
    order = tile_order(np.asarray(item["coord"]))
    t = lambda x: torch.as_tensor(np.ascontiguousarray(np.asarray(x, np.float32)[order]), device=device)
    rays = {"ray_o": t(item["ray_o"]), "ray_d": t(item["ray_d"]), "near": t(item["near"]),
            "far": t(item["far"]), "frame": int(item["frame"]),
            "body_pose": torch.as_tensor(np.asarray(item["poses"][1:24], np.float32), device=device)}
    mesh = {"faces": torch.as_tensor(np.asarray(faces, np.int64), device=device),
            "verts_world": torch.as_tensor(np.asarray(item["xyz"], np.float32), device=device),
            "verts_cano": torch.as_tensor(np.asarray(mesh_cano, np.float32), device=device)}
    return rays, t(item["rgb"]), mesh


def train_steps(weights: dict, batches: list, randoms: list, settings: Settings,
                solver: dict) -> dict:
    """Run len(batches) steps from ``weights``. batches: (rays, rgb, mesh)
    as `batch_tensors` gives them; randoms: (uniforms, normals) of each
    step, with the fine pass its two more, as `render` takes them. Returns
    the losses, the first step's gradient of every weight, and every
    weight after the last step."""
    nets.check_weights(weights)
    names = sorted(weights)
    params = {k: weights[k].detach().clone().requires_grad_(True) for k in names}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    wd = max(float(solver.get("WEIGHT_DECAY", 0.0)), 0.0)
    losses, first_grads = [], None
    for t, ((rays, rgb, mesh), rnd) in enumerate(zip(batches, randoms), start=1):
        out = render(params, rays, mesh, settings, train=True, randoms=rnd)
        loss = ((out["color"] - rgb) ** 2).mean()
        if settings.n_fine > 0:
            loss = loss + ((out["fine_color"] - rgb) ** 2).mean()
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        lr = float(solver["BASE_LR"]) * lr_factor(t - 1, solver)
        with torch.no_grad():
            for k in names:
                g = grads[k] + wd * params[k] if wd else grads[k]
                m[k].mul_(BETA1).add_(g, alpha=1.0 - BETA1)
                v[k].mul_(BETA2).addcmul_(g, g, value=1.0 - BETA2)
                m_hat = m[k] / (1.0 - BETA1 ** t)
                v_hat = v[k] / (1.0 - BETA2 ** t)
                params[k] -= lr * m_hat / (v_hat.sqrt() + EPS)
        del out, loss, grads
    return {"losses": losses, "first_grads": first_grads,
            "final": {k: p.detach() for k, p in params.items()}}
