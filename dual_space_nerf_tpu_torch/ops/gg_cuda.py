"""GG near/far: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel `dual_space_nerf_tpu/ops/gg_pallas.py:_gg_kernel`
(wrapper `gg_near_far_pallas`). The kernel is `csrc/gg_near_far.cu`; its
plain PyTorch version is `geometry.sampling.gg_near_far`, re-exported here as
`gg_near_far_plain`.

Bound on the H100: operations (5.6e7 ray-vertex pairs of ~8 FP32 ops per
8192-ray launch; under 0.3 MB moved). The design keeps the per-vertex setup
out of the pair loop (a float4 table of v - o and |v - o|^2) and gives each
ray a warp, so one 8192-ray chunk fills the card; see the source's header.
The kernel equals its plain version bit for bit: both round every
operation once, in the same order.
"""

from __future__ import annotations

import ctypes

import torch

from ..geometry.sampling import gg_near_far as gg_near_far_plain
from .cuda_build import CudaKernel, stream_ptr

_P = ctypes.c_void_p
GG_KERNEL = CudaKernel(
    "gg_near_far.cu",
    "gg_near_far_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
)


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"gg_near_far: {name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"gg_near_far: {name} is on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"gg_near_far: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"gg_near_far: {name} must be contiguous")


def gg_near_far_cuda(
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    verts: torch.Tensor,
    gamma: float = 0.05,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(near, far) tightened to the gamma-spheres around ``verts``.

    ray_o/ray_d: (R, 3); near/far: (R,); verts: (V, 3); float32. CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    if ray_d.device.type == "cpu":
        return gg_near_far_plain(ray_o, ray_d, near, far, verts, gamma)
    if ray_d.device.type != "cuda":
        raise ValueError(f"gg_near_far: unsupported device {ray_d.device}")
    dev = ray_d.device
    r = ray_d.shape[0]
    v = verts.shape[0]
    _check("ray_o", ray_o, (r, 3), dev)
    _check("ray_d", ray_d, (r, 3), dev)
    _check("near", near, (r,), dev)
    _check("far", far, (r,), dev)
    _check("verts", verts, (v, 3), dev)
    if r == 0 or v == 0:
        raise ValueError("gg_near_far: needs at least one ray and one vertex")
    rel = torch.empty((v, 4), dtype=torch.float32, device=dev)
    near_out = torch.empty_like(near)
    far_out = torch.empty_like(far)
    with torch.cuda.device(dev):
        GG_KERNEL.launch(
            ray_o.data_ptr(), ray_d.data_ptr(), near.data_ptr(), far.data_ptr(),
            verts.data_ptr(), rel.data_ptr(), near_out.data_ptr(), far_out.data_ptr(),
            r, v, float(gamma) * float(gamma), stream_ptr(dev),
        )
    return near_out, far_out
