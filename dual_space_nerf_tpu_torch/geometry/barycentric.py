"""Triangle projection and barycentric re-mapping between spaces.

A world-space sample point is expressed as (barycentric uv, signed height h)
with respect to its nearest posed triangle and rebuilt from the same
triangle of the canonical mesh. Same formulas and edge order as the JAX
package's `geometry/barycentric.py`. Points are (..., 3) and triangles
(..., 3, 3) with matching leading dims.
"""

from __future__ import annotations

import torch

_EPS_NORM = 1e-12


def triangle_normal(tris: torch.Tensor) -> torch.Tensor:
    """Unit normal n = (v1-v0) x (v2-v0) / ||.|| for triangles (..., 3, 3)."""
    v10 = tris[..., 1, :] - tris[..., 0, :]
    v20 = tris[..., 2, :] - tris[..., 0, :]
    n = torch.linalg.cross(v10, v20, dim=-1)
    return n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), _EPS_NORM)


def barycentric_uv(pts_proj: torch.Tensor, tris: torch.Tensor) -> torch.Tensor:
    """In-plane barycentric coords of projected points: u is the coefficient
    of edge v0->v2, v of edge v0->v1. (..., 3), (..., 3, 3) -> (..., 2)."""
    v0 = tris[..., 2, :] - tris[..., 0, :]
    v1 = tris[..., 1, :] - tris[..., 0, :]
    v2 = pts_proj - tris[..., 0, :]

    dot00 = torch.sum(v0 * v0, dim=-1)
    dot01 = torch.sum(v0 * v1, dim=-1)
    dot02 = torch.sum(v0 * v2, dim=-1)
    dot11 = torch.sum(v1 * v1, dim=-1)
    dot12 = torch.sum(v1 * v2, dim=-1)

    inv_deno = 1.0 / (dot00 * dot11 - dot01 * dot01)
    u = (dot11 * dot02 - dot01 * dot12) * inv_deno
    v = (dot00 * dot12 - dot01 * dot02) * inv_deno
    return torch.stack([u, v], dim=-1)


def project_point2mesh(
    pts: torch.Tensor, tris: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project each point onto its (already matched) triangle's plane.

    pts: (..., 3), tris: (..., 3, 3). Returns (uv (..., 2), signed_distance (...,)).
    """
    n = triangle_normal(tris)
    signed_distance = torch.sum((pts - tris[..., 0, :]) * n, dim=-1)
    pts_proj = pts - n * signed_distance[..., None]
    return barycentric_uv(pts_proj, tris), signed_distance


def barycentric_map(
    uv: torch.Tensor, signed_distance: torch.Tensor, tris: torch.Tensor
) -> torch.Tensor:
    """p = v0 + u*(v2-v0) + v*(v1-v0) + h*n: the inverse of
    `project_point2mesh` on the same triangle. -> (..., 3)."""
    v2 = tris[..., 2, :] - tris[..., 0, :]
    v1 = tris[..., 1, :] - tris[..., 0, :]
    n = triangle_normal(tris)
    pts_proj = tris[..., 0, :] + uv[..., 0:1] * v2 + uv[..., 1:2] * v1
    return pts_proj + signed_distance[..., None] * n


def transparent_mask(
    uv: torch.Tensor,
    signed_distance: torch.Tensor,
    floor: float = -4.0,
    ceil: float = 5.0,
    max_dist: float = 0.1,
) -> torch.Tensor:
    """True where a point lies too far outside its triangle (uv outside
    [floor, ceil] or |h| > max_dist); such points get zero density."""
    out_of_range = (uv > ceil) | (uv < floor)
    mask = out_of_range[..., 0] | out_of_range[..., 1]
    return mask | (torch.abs(signed_distance) > max_dist)
