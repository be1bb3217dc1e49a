from .convert import load_flax_npz, state_dict_from_flax
from .spacenet import DualSpaceNeRF, LightingMLP, SpaceNet, compute_dtype, rod2quat

__all__ = [
    "DualSpaceNeRF",
    "LightingMLP",
    "SpaceNet",
    "compute_dtype",
    "load_flax_npz",
    "rod2quat",
    "state_dict_from_flax",
]
