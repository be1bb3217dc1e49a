from .convert import load_flax_npz, state_dict_from_flax
from .spacenet import DualSpaceNeRF, LightingMLP, SpaceNet, rod2quat

__all__ = [
    "DualSpaceNeRF",
    "LightingMLP",
    "SpaceNet",
    "load_flax_npz",
    "rod2quat",
    "state_dict_from_flax",
]
