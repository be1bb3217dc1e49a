"""Along-ray sample placement.

- ``stratified_z`` / ``sample_along_rays``: NeRF stratified sampling.
- ``sample_pdf``: hierarchical (importance) sampling of the fine pass.
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


def _linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)``'s formula: start (1 -
    i/(num-1)) + stop i/(num-1), the last one stop itself (XLA may round an
    element another way in its last bit; torch.linspace uses another
    formula)."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start_t[None]
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    return torch.cat([start_t * (1 - step) + stop_t * step, stop_t[None]])


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Hierarchical (importance) sampling of z values from coarse weights,
    the JAX package's `geometry/sampling.py::sample_pdf`: inverse-CDF
    sampling of the weights + 1e-5.

    bins: (R, B) sorted z midpoints; weights: (R, B-1). At eval (``u``
    None) the samples are the CDF strata's midpoints; in training ``u``
    (R, n_samples) uniform [0, 1) numbers, drawn by the caller, jitter
    them within their strata. Returns (R, n_samples) z values."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1)  # (R, B)
    if u is None:
        u = _linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples, cdf.device)
        u = u.expand(*cdf.shape[:-1], n_samples)
    else:
        strata = torch.arange(n_samples, dtype=torch.float32, device=cdf.device) / n_samples
        u = strata + u / n_samples
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, cdf.shape[-1] - 2)
    above = torch.clamp(inds, 1, cdf.shape[-1] - 1)
    cdf_below = torch.take_along_dim(cdf, below, dim=-1)
    cdf_above = torch.take_along_dim(cdf, above, dim=-1)
    bins_below = torch.take_along_dim(bins, below, dim=-1)
    bins_above = torch.take_along_dim(bins, above, dim=-1)
    gap = cdf_above - cdf_below
    denom = torch.where(gap < 1e-10, 1.0, gap)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


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
