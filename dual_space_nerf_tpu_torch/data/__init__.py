from .batching import item_to_mesh, item_to_train_batch, iter_ray_chunks
from .synthetic_dataset import SyntheticDataset

__all__ = ["SyntheticDataset", "item_to_mesh", "item_to_train_batch", "iter_ray_chunks"]
