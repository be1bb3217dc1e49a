"""The Dual-Space NeRF networks in plain PyTorch, from a dict of weights.

Written from the published architecture (Dual-Space NeRF, arXiv:2208.14851,
and its code at github.com/zyhbili/Dual-Space-NeRF), float32:

- SpaceNet: positional encoding of the canonical point with 10 octaves and
  the input (63); stage 1 = 4 x (Linear + ReLU) on [frame code (8) | pe |
  pose feature (16)] (87 -> 256); stage 2 = 3 x (Linear + ReLU) on [h | pe]
  (319 -> 256); density = Linear(256 -> 1); essence = Linear(256 -> 128),
  ReLU, Linear(128 -> 3).
- The density normal: d(density)/d(canonical point), by autograd.
- LightingMLP: [world normal | world point | unit view direction] (9) ->
  128 -> 128 -> 1 (ReLU between), then (ELU + 1) times the essence.
- Pose MLP: 23 joints x (quaternion - identity) (92) -> 64 -> 64 -> 16.

The first layers of SpaceNet's stages and of the lighting MLP are applied
as separate products over the parts of their input (the per-point
positional encoding, the per-chunk code and pose, the hidden state), which
is the same function: it lets autograd take the density normal through the
encoding alone, and keeps `flops.py`'s counts equal to what runs here.

Weights are keyed by the published state-dict names (``nerf.stage1.0.weight``
...), (out, in) as `torch.nn.Linear` stores them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

PE_FREQS = 10
PE_DIM = 3 * (1 + 2 * PE_FREQS)   # 63
CODE_DIM, POSE_DIM, WIDTH = 8, 16, 256

#: every weight the networks take, with its shape
SHAPES = {
    "nerf.embedding.weight": (500, CODE_DIM),
    **{f"nerf.stage1.{i}.weight": (WIDTH, CODE_DIM + PE_DIM + POSE_DIM if i == 0 else WIDTH)
       for i in (0, 2, 4, 6)},
    **{f"nerf.stage1.{i}.bias": (WIDTH,) for i in (0, 2, 4, 6)},
    **{f"nerf.stage2.{i}.weight": (WIDTH, WIDTH + PE_DIM if i == 0 else WIDTH) for i in (0, 2, 4)},
    **{f"nerf.stage2.{i}.bias": (WIDTH,) for i in (0, 2, 4)},
    "nerf.density_net.0.weight": (1, WIDTH), "nerf.density_net.0.bias": (1,),
    "nerf.rgb_net.1.weight": (128, WIDTH), "nerf.rgb_net.1.bias": (128,),
    "nerf.rgb_net.3.weight": (3, 128), "nerf.rgb_net.3.bias": (3,),
    "lighting_mlp.lights_encoding.0.weight": (128, 9),
    "lighting_mlp.lights_encoding.0.bias": (128,),
    "lighting_mlp.lights_encoding.2.weight": (128, 128),
    "lighting_mlp.lights_encoding.2.bias": (128,),
    "lighting_mlp.lights_encoding.4.weight": (1, 128),
    "lighting_mlp.lights_encoding.4.bias": (1,),
    "pose_mlp.0.weight": (64, 92), "pose_mlp.0.bias": (64,),
    "pose_mlp.2.weight": (64, 64), "pose_mlp.2.bias": (64,),
    "pose_mlp.4.weight": (16, 64), "pose_mlp.4.bias": (16,),
}


def check_weights(w: dict) -> None:
    """Raise unless ``w`` holds exactly the networks' weights, float32."""
    if set(w) != set(SHAPES):
        raise KeyError(f"weights: missing {sorted(set(SHAPES) - set(w))}, "
                       f"unknown {sorted(set(w) - set(SHAPES))}")
    for k, shape in SHAPES.items():
        if tuple(w[k].shape) != shape or w[k].dtype != torch.float32:
            raise ValueError(f"weights: {k} is {tuple(w[k].shape)} {w[k].dtype}, expected {shape} float32")


def posenc(x: torch.Tensor) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^9 x), cos(2^9 x)]: (n, 63)."""
    parts = [x]
    for k in range(PE_FREQS):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, dim=-1)


def _lin(x, w: dict, name: str) -> torch.Tensor:
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def pose_feature(w: dict, body_pose: torch.Tensor) -> torch.Tensor:
    """(23, 3) joint rotation vectors -> (16,): quaternions minus the
    identity (with the published +1e-16 in the angle) through the pose MLP."""
    angle = torch.linalg.norm(body_pose + 1e-16, dim=-1, keepdim=True)
    axis = body_pose / angle
    quat = torch.cat([axis * torch.sin(angle / 2), torch.cos(angle / 2) - 1.0], dim=-1)
    h = torch.relu(_lin(quat.reshape(1, -1), w, "pose_mlp.0"))
    h = torch.relu(_lin(h, w, "pose_mlp.2"))
    return _lin(h, w, "pose_mlp.4")[0]


def backbone(w: dict, pe: torch.Tensor, code: torch.Tensor, pose_feat: torch.Tensor) -> torch.Tensor:
    """SpaceNet's hidden state (n, 256) at the points' encodings (n, 63),
    for one frame code (8,) and pose feature (16,)."""
    n = pe.shape[0]
    w0 = w["nerf.stage1.0.weight"]
    cp = torch.cat([code, pose_feat])[None].expand(n, CODE_DIM + POSE_DIM)
    w_cp = torch.cat([w0[:, :CODE_DIM], w0[:, CODE_DIM + PE_DIM:]], dim=1)
    h = torch.relu(cp @ w_cp.T + pe @ w0[:, CODE_DIM:CODE_DIM + PE_DIM].T + w["nerf.stage1.0.bias"])
    for i in (2, 4, 6):
        h = torch.relu(_lin(h, w, f"nerf.stage1.{i}"))
    w0 = w["nerf.stage2.0.weight"]
    h = torch.relu(h @ w0[:, :WIDTH].T + pe @ w0[:, WIDTH:].T + w["nerf.stage2.0.bias"])
    for i in (2, 4):
        h = torch.relu(_lin(h, w, f"nerf.stage2.{i}"))
    return h


def density(w: dict, h: torch.Tensor) -> torch.Tensor:
    return _lin(h, w, "nerf.density_net.0")[:, 0]


def essence(w: dict, h: torch.Tensor) -> torch.Tensor:
    return _lin(torch.relu(_lin(torch.relu(h), w, "nerf.rgb_net.1")), w, "nerf.rgb_net.3")


def density_pass(w: dict, pts_c: torch.Tensor, code, pose_feat) -> torch.Tensor:
    """Density (n,) alone: the gated path's pass over every sample."""
    return density(w, backbone(w, posenc(pts_c), code, pose_feat))


def color_pass(w: dict, pts_c: torch.Tensor, code, pose_feat, create_graph: bool):
    """(density (n,), essence (n, 3), canonical normal (n, 3)): the normal
    is d(sum density)/d(pts_c); with ``create_graph`` it keeps its graph,
    for the second-order training backward."""
    with torch.enable_grad():
        pc = pts_c.detach().requires_grad_(True)
        h = backbone(w, posenc(pc), code, pose_feat)
        sigma = density(w, h)
        (normal,) = torch.autograd.grad(sigma.sum(), pc, create_graph=create_graph)
    return sigma, essence(w, h), normal


def lighting(w: dict, normal_w, pts_w, view_w, ess) -> torch.Tensor:
    """Colour (n, 3) = (ELU(light) + 1) * essence."""
    view = view_w / torch.linalg.norm(view_w, dim=-1, keepdim=True)
    w0 = w["lighting_mlp.lights_encoding.0.weight"]
    x = normal_w @ w0[:, :3].T + torch.cat([pts_w, view], dim=-1) @ w0[:, 3:].T
    x = torch.relu(x + w["lighting_mlp.lights_encoding.0.bias"])
    x = torch.relu(_lin(x, w, "lighting_mlp.lights_encoding.2"))
    x = _lin(x, w, "lighting_mlp.lights_encoding.4")
    return (F.elu(x) + 1.0) * ess
