from .barycentric import (
    barycentric_map,
    barycentric_uv,
    project_point2mesh,
    transparent_mask,
    triangle_normal,
)
from .compositing import RayOutputs, composite
from .sampling import gg_near_far, sample_along_rays, stratified_z

__all__ = [
    "barycentric_map",
    "barycentric_uv",
    "project_point2mesh",
    "transparent_mask",
    "triangle_normal",
    "RayOutputs",
    "composite",
    "gg_near_far",
    "sample_along_rays",
    "stratified_z",
]
