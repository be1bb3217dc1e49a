from .pipeline import (
    LightState,
    MeshBundle,
    RayBatch,
    RenderSettings,
    density_grid,
    normal_canonical_to_world,
    render_rays,
    resolve_mlp_chunk,
    sample_z,
    warp_world_to_canonical,
)

__all__ = [
    "LightState",
    "MeshBundle",
    "RayBatch",
    "RenderSettings",
    "density_grid",
    "normal_canonical_to_world",
    "render_rays",
    "resolve_mlp_chunk",
    "sample_z",
    "warp_world_to_canonical",
]
