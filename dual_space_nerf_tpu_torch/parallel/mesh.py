"""The local devices of ray-axis data parallelism, as the JAX package's
`parallel/mesh.py`.

The model is ~0.5M parameters, so the only parallelism worth having is over
rays: each device takes an equal share of a step's (or an eval chunk's)
rays, parameters and mesh geometry are replicated. In PyTorch a training
run takes one process per card (`parallel/distributed.py`); the eval path
splits each chunk over a list of devices in one process
(`evaluation.ImageRenderer(devices=...)`).
"""

from __future__ import annotations

import torch


def local_ray_devices(n: int | None = None, device_type: str = "cuda") -> list[torch.device] | None:
    """This host's devices of ``device_type`` (the first ``n``), or None when
    there is at most one: one device runs the unsplit path, as the JAX
    package's `local_ray_mesh` returns no mesh for one device. The CPU
    counts as one device."""
    if device_type == "cuda" and torch.cuda.is_available():
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(device_type)]
    if n is not None:
        devs = devs[:n]
    return devs if len(devs) > 1 else None


def pad_rays_for_mesh(nrays: int, world: int | None) -> int:
    """Round nrays up to a multiple of ``world`` devices (None: unchanged)."""
    if not world:
        return nrays
    return -(-nrays // world) * world
