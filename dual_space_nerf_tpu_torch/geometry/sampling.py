"""Along-ray sample placement.

- ``stratified_z`` / ``sample_along_rays``: NeRF stratified sampling.
- ``gg_near_far``: "geometry-guided" per-ray [near, far] tightening to the
  union of gamma-spheres around every mesh vertex. This is the plain PyTorch
  version of the CUDA kernel in `ops/gg_cuda.py`, which holds it against this
  function on the card; it serves CPU tensors.

Same semantics as the JAX package's `geometry/sampling.py`.
"""

from __future__ import annotations

import torch

_BIG = 99999.0
# rays per slice of the plain GG, bounding its (rays, V) temporaries
_GG_RAY_SLICE = 1024


def stratified_z(
    near: torch.Tensor,
    far: torch.Tensor,
    n_samples: int,
    t_rand: torch.Tensor | None = None,
) -> torch.Tensor:
    """z values in [near, far]: a linspace, or stratified when ``t_rand``
    (uniform [0, 1) numbers of shape (..., n_samples), drawn by the caller)
    is given. near/far: (...,) -> (..., n_samples)."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype, device=near.device)
    z = near[..., None] * (1.0 - t) + far[..., None] * t
    if t_rand is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * t_rand
    return z


def sample_along_rays(
    ray_o: torch.Tensor, ray_d: torch.Tensor, z_vals: torch.Tensor
) -> torch.Tensor:
    """pts = o + d * z. ray_o/ray_d: (..., 3), z_vals: (..., S) -> (..., S, 3).
    ray_d is not normalized: z is in units of ||ray_d||."""
    return ray_o[..., None, :] + ray_d[..., None, :] * z_vals[..., None]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """sqrt((x*x + y*y) + z*z) over the last axis of (..., 3), in that
    order: each elementwise op rounds once, which is what the CUDA kernels
    spell out with `__fmul_rn`/`__fadd_rn` to agree bit for bit."""
    x, y, z = v.unbind(-1)
    return torch.sqrt((x * x + y * y) + z * z)


def gg_near_far(
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    verts: torch.Tensor,
    gamma: float = 0.05,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Tighten [near, far] to the union of gamma-spheres around vertices.

    ray_o/ray_d: (R, 3); near/far: (R,); verts: (V, 3). Like the reference,
    every ray is taken to start at ray_o[0] for the sphere test (pinhole
    camera), and sphere-space z is divided by ||ray_d||. Rays that touch no
    sphere keep their near/far.

    The arithmetic order is the CUDA kernel's (`csrc/gg_near_far.cu`):
    z0 = (dx*vx + dy*vy) + dz*vz, d2 = |rel|^2 - z0*z0, one rounding each.
    """
    norm_ray = norm3(ray_d)
    dirs = ray_d / norm_ray[:, None]
    rel = verts - ray_o[0]                                       # (V, 3)
    rx, ry, rz = rel.unbind(-1)
    r2 = (rx * rx + ry * ry) + rz * rz                           # (V,)
    g2 = gamma * gamma

    z_min = torch.empty_like(near)
    z_max = torch.empty_like(near)
    for s in range(0, ray_d.shape[0], _GG_RAY_SLICE):
        d = dirs[s:s + _GG_RAY_SLICE]
        z0 = (d[:, 0:1] * rx + d[:, 1:2] * ry) + d[:, 2:3] * rz    # (r, V)
        d2 = r2 - z0 * z0
        inside = d2 < g2
        delta = torch.sqrt(torch.clamp_min(g2 - d2, 0.0))
        z_min[s:s + _GG_RAY_SLICE] = torch.where(inside, z0 - delta, _BIG).amin(1)
        z_max[s:s + _GG_RAY_SLICE] = torch.where(inside, z0 + delta, -_BIG).amax(1)

    hit_any = z_min < _BIG
    z_min = z_min / norm_ray
    z_max = z_max / norm_ray
    hit = hit_any & (z_min < z_max)
    return torch.where(hit, z_min, near), torch.where(hit, z_max, far)
