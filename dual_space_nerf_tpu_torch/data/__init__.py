from .batching import item_to_mesh, item_to_train_batch, iter_ray_chunks
from .prefetch import PrefetchLoader
from .select import load_yml_as_cfg, select_dataset
from .smpl import BodyModel, load_body_model, x_pose
from .synthetic_dataset import SyntheticDataset

__all__ = [
    "BodyModel",
    "PrefetchLoader",
    "SyntheticDataset",
    "item_to_mesh",
    "item_to_train_batch",
    "iter_ray_chunks",
    "load_body_model",
    "load_yml_as_cfg",
    "select_dataset",
    "x_pose",
]
