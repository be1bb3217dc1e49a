from .batching import item_to_mesh, item_to_train_batch, iter_ray_chunks
from .prefetch import PrefetchLoader
from .select import select_dataset
from .synthetic_dataset import SyntheticDataset

__all__ = [
    "PrefetchLoader",
    "SyntheticDataset",
    "item_to_mesh",
    "item_to_train_batch",
    "iter_ray_chunks",
    "select_dataset",
]
