from .batching import item_to_mesh, iter_ray_chunks
from .synthetic_dataset import SyntheticDataset

__all__ = ["SyntheticDataset", "item_to_mesh", "iter_ray_chunks"]
