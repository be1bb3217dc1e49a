from .distributed import (
    all_reduce_mean_,
    broadcast_object,
    broadcast_state,
    global_ray_group,
    is_multiprocess,
    maybe_initialize_distributed,
    rank,
    spawn_ranks,
    world_size,
)
from .mesh import local_ray_devices, pad_rays_for_mesh

__all__ = [
    "all_reduce_mean_",
    "broadcast_object",
    "broadcast_state",
    "global_ray_group",
    "is_multiprocess",
    "local_ray_devices",
    "maybe_initialize_distributed",
    "pad_rays_for_mesh",
    "rank",
    "spawn_ranks",
    "world_size",
]
