"""The Dual-Space NeRF networks as `nn.Module`s.

Same architecture and arithmetic as the JAX package's `models/spacenet.py`:

- ``SpaceNet``: canonical-space density and essence color. PE(L=10, with
  input) -> 63; frame code (8); pose feature (16); stage1 = 4 x
  Linear+ReLU on [code | pe | pose] (87 -> 256); stage2 = 3 x Linear+ReLU on
  [x | pe] (319 -> 256); density head Linear(256 -> 1); essence head
  ReLU -> Linear(256 -> 128) -> ReLU -> Linear(128 -> 3).
- ``LightingMLP``: [normal | xyz_world | unit view dir] (9) -> 128 -> 128 ->
  1, then ELU + 1 multiplies the essence.
- ``PoseMLP``: 23 joints x (quaternion - identity) (92) -> 64 -> 64 -> 16.

Parameters are float32 whatever torch's default dtype is. Module and
parameter names are the reference's state-dict names
(`nerf.stage1.0.weight`, `lighting_mlp.lights_encoding.4.bias`,
`pose_mlp.2.weight`, ...), so reference `.pth` state dicts load as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.posenc import posenc, posenc_dim
from .layers import mlp, torch_default_init_


def rod2quat(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Rotation vectors (J, 3) -> quaternions minus identity (J, 4):
    (qx, qy, qz, qw - 1), zero at rest pose, with the reference's +1e-16."""
    angle = torch.linalg.norm(rot_vecs + 1e-16, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    half = angle / 2.0
    xyz = rot_dir * torch.sin(half)
    qw = torch.cos(half) - 1.0
    return torch.cat([xyz, qw], dim=-1)


class SpaceNet(nn.Module):
    """Canonical-space density + essence-color field."""

    def __init__(self, max_frames: int = 500, code_dim: int = 8, essence_dim: int = 3,
                 backbone_dim: int = 256, pe_freqs: int = 10, pose_dim: int = 16):
        super().__init__()
        self.code_dim = code_dim
        self.pe_freqs = pe_freqs
        pe_dim = posenc_dim(3, pe_freqs)
        if code_dim > 0:
            self.embedding = nn.Embedding(max_frames, code_dim, dtype=torch.float32)
            in_dim = code_dim + pe_dim + pose_dim
        else:
            in_dim = pe_dim
        self.stage1 = mlp(in_dim, [backbone_dim] * 4, activate_final=True)
        self.stage2 = mlp(backbone_dim + pe_dim, [backbone_dim] * 3, activate_final=True)
        self.density_net = nn.Sequential(nn.Linear(backbone_dim, 1, dtype=torch.float32))
        self.rgb_net = nn.Sequential(
            nn.ReLU(),
            nn.Linear(backbone_dim, backbone_dim // 2, dtype=torch.float32),
            nn.ReLU(),
            nn.Linear(backbone_dim // 2, essence_dim, dtype=torch.float32),
        )

    def forward(self, pos: torch.Tensor, code: torch.Tensor, pose_feat: torch.Tensor):
        """pos (N, 3) canonical xyz; code (code_dim,) frame code, already
        scaled; pose_feat (N, 16). Returns (essence (N, 3), density (N, 1))."""
        pe = posenc(pos, self.pe_freqs)
        if self.code_dim > 0:
            code = code.expand(pos.shape[0], self.code_dim)
            x = torch.cat([code, pe, pose_feat], dim=-1)
        else:
            x = pe
        x = self.stage1(x)
        x = self.stage2(torch.cat([x, pe], dim=-1))
        return self.rgb_net(x), self.density_net(x)


class LightingMLP(nn.Module):
    """World-space scalar lighting multiplier."""

    def __init__(self, width: int = 128):
        super().__init__()
        self.lights_encoding = mlp(9, [width, width, 1])

    def forward(self, normal, xyz_world, view_dir_world, essence):
        view = view_dir_world / torch.linalg.norm(view_dir_world, dim=-1, keepdim=True)
        x = self.lights_encoding(torch.cat([normal, xyz_world, view], dim=-1))
        return (F.elu(x) + 1.0) * essence


class DualSpaceNeRF(nn.Module):
    """The three networks. The renderer runs the dual-space pipeline (warp,
    autograd normals, normal transport, light-space transforms); this module
    owns the parameters and the sub-functions it calls."""

    def __init__(self, max_frames: int = 500, code_dim: int = 8, essence_dim: int = 3,
                 backbone_dim: int = 256, generator: torch.Generator | None = None):
        super().__init__()
        self.max_frames = max_frames
        self.code_dim = code_dim
        self.nerf = SpaceNet(max_frames, code_dim, essence_dim, backbone_dim)
        self.lighting_mlp = LightingMLP()
        self.pose_mlp = mlp(92, [64, 64, 16])
        if generator is not None:
            torch_default_init_(self, generator)

    def pose_feature(self, body_pose: torch.Tensor) -> torch.Tensor:
        """body_pose (23, 3) joint rotation vectors -> (16,) feature."""
        return self.pose_mlp(rod2quat(body_pose).reshape(-1))

    def sigma_essence(self, pos_cano, code, pose_feat, code_scale):
        """(essence (N, 3), density (N, 1)); ``code`` is the (code_dim,) frame
        code, scaled here by ``code_scale`` (0 zeroes it for novel poses)."""
        return self.nerf(pos_cano, code * code_scale, pose_feat)

    def frame_code(self, frame: int) -> torch.Tensor:
        """Embedding row of one frame index, clamped to the table; a
        zero-width code for a model without one."""
        if self.code_dim <= 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.pose_mlp[0].weight.device)
        idx = min(max(int(frame), 0), self.max_frames - 1)
        return self.nerf.embedding.weight[idx]

    def lighting(self, normal, xyz_world, view_dir_world, essence):
        return self.lighting_mlp(normal, xyz_world, view_dir_world, essence)
