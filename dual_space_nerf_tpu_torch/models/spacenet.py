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

Parameters are float32 whatever torch's default dtype is. With
``compute_dtype=torch.bfloat16`` (`MODEL.MATMUL_PRECISION: "bf16"`) the
backbone, the essence head's hidden layer and the lighting MLP compute in
bfloat16 (`layers.Linear`), and the density head, the essence output layer
and the lighting's ELU in float32, as the JAX package's modules do. Module
and parameter names are the reference's state-dict names
(`nerf.stage1.0.weight`, `lighting_mlp.lights_encoding.4.bias`,
`pose_mlp.2.weight`, ...), so reference `.pth` state dicts load as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.posenc import posenc, posenc_dim
from .layers import Linear, mlp, torch_default_init_


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
                 backbone_dim: int = 256, pe_freqs: int = 10, pose_dim: int = 16,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.code_dim = code_dim
        self.pe_freqs = pe_freqs
        self.compute_dtype = compute_dtype
        pe_dim = posenc_dim(3, pe_freqs)
        if code_dim > 0:
            self.embedding = nn.Embedding(max_frames, code_dim, dtype=torch.float32)
            in_dim = code_dim + pe_dim + pose_dim
        else:
            in_dim = pe_dim
        self.stage1 = mlp(in_dim, [backbone_dim] * 4, activate_final=True,
                          compute_dtype=compute_dtype)
        self.stage2 = mlp(backbone_dim + pe_dim, [backbone_dim] * 3, activate_final=True,
                          compute_dtype=compute_dtype)
        # the heads' outer layers in float32: the density feeds the
        # second-order normal and the compositing exponent
        self.density_net = nn.Sequential(Linear(backbone_dim, 1))
        self.rgb_net = nn.Sequential(
            nn.ReLU(),
            Linear(backbone_dim, backbone_dim // 2, compute_dtype),
            nn.ReLU(),
            Linear(backbone_dim // 2, essence_dim),
        )

    def forward(self, pos: torch.Tensor, code: torch.Tensor, pose_feat: torch.Tensor,
                density_only: bool = False):
        """pos (N, 3) canonical xyz; code (code_dim,) frame code, already
        scaled; pose_feat (N, 16). Returns (essence (N, 3), density (N, 1));
        density_only skips the essence head and returns (None, density)."""
        pe = posenc(pos, self.pe_freqs)
        if self.code_dim > 0:
            code = code.expand(pos.shape[0], self.code_dim)
            x = torch.cat([code, pe, pose_feat], dim=-1)
        else:
            x = pe
        x = self.stage1(x)
        x = self.stage2(torch.cat([x, pe.to(x.dtype)], dim=-1))
        head = self.density_net[0].weight.dtype  # float32 (float64 in conditioning checks)
        density = self.density_net(x.to(head))
        if density_only:
            return None, density
        return self.rgb_net[3](self.rgb_net[:3](x).to(head)), density


class LightingMLP(nn.Module):
    """World-space scalar lighting multiplier."""

    def __init__(self, width: int = 128, compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.lights_encoding = mlp(9, [width, width, 1], compute_dtype=compute_dtype)

    def forward(self, normal, xyz_world, view_dir_world, essence):
        view = view_dir_world / torch.linalg.norm(view_dir_world, dim=-1, keepdim=True)
        x = self.lights_encoding(torch.cat([normal, xyz_world, view], dim=-1))
        return (F.elu(x.to(essence.dtype)) + 1.0) * essence


def compute_dtype(cfg) -> torch.dtype | None:
    """MODEL.MATMUL_PRECISION, the one place it is read: "bf16" computes
    the networks' products in bfloat16 (float32 parameters and optimizer
    state), "f32" in float32 (None); anything else raises."""
    prec = cfg.MODEL.MATMUL_PRECISION
    if prec not in ("f32", "bf16"):
        raise ValueError(f"MODEL.MATMUL_PRECISION={prec!r}: expected 'f32' or 'bf16'")
    return torch.bfloat16 if prec == "bf16" else None


class DualSpaceNeRF(nn.Module):
    """The three networks. The renderer runs the dual-space pipeline (warp,
    autograd normals, normal transport, light-space transforms); this module
    owns the parameters and the sub-functions it calls."""

    def __init__(self, max_frames: int = 500, code_dim: int = 8, essence_dim: int = 3,
                 backbone_dim: int = 256, generator: torch.Generator | None = None,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.max_frames = max_frames
        self.code_dim = code_dim
        self.compute_dtype = compute_dtype
        self.nerf = SpaceNet(max_frames, code_dim, essence_dim, backbone_dim,
                             compute_dtype=compute_dtype)
        self.lighting_mlp = LightingMLP(compute_dtype=compute_dtype)
        self.pose_mlp = mlp(92, [64, 64, 16])
        if generator is not None:
            torch_default_init_(self, generator)

    def pose_feature(self, body_pose: torch.Tensor) -> torch.Tensor:
        """body_pose (23, 3) joint rotation vectors -> (16,) feature."""
        return self.pose_mlp(rod2quat(body_pose).reshape(-1))

    def sigma_essence(self, pos_cano, code, pose_feat, code_scale, density_only=False):
        """(essence (N, 3), density (N, 1)); ``code`` is the (code_dim,) frame
        code, scaled here by ``code_scale`` (0 zeroes it for novel poses).
        density_only: the gated renderer's density pass, (None, density)."""
        return self.nerf(pos_cano, code * code_scale, pose_feat, density_only)

    def frame_code(self, frame: int) -> torch.Tensor:
        """Embedding row of one frame index, clamped to the table; a
        zero-width code for a model without one."""
        if self.code_dim <= 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.pose_mlp[0].weight.device)
        idx = min(max(int(frame), 0), self.max_frames - 1)
        return self.nerf.embedding.weight[idx]

    def lighting(self, normal, xyz_world, view_dir_world, essence):
        return self.lighting_mlp(normal, xyz_world, view_dir_world, essence)
