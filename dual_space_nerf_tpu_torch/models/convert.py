"""Flax parameter trees -> the port's (reference-named) state dicts.

The JAX package stores Dense kernels as (in, out) under flax paths such as
``params/nerf/Dense_4/Dense_0/kernel``; the port's modules carry the
reference's names with torch's (out, in) weights. The table below is the
port's own copy of `tool/convert_reference_checkpoint.py:_LINEAR_MAP`.
"""

from __future__ import annotations

import numpy as np
import torch

# (reference prefix, flax module, flax Dense indices, reference Linear indices)
LINEAR_MAP = (
    ("nerf.stage1", "nerf", (0, 1, 2, 3), (0, 2, 4, 6)),
    ("nerf.stage2", "nerf", (4, 5, 6), (0, 2, 4)),
    ("nerf.density_net", "nerf", (7,), (0,)),
    ("nerf.rgb_net", "nerf", (8, 9), (1, 3)),
    ("lighting_mlp.lights_encoding", "lighting_mlp", (0, 1, 2), (0, 2, 4)),
    ("pose_mlp", "pose_mlp", (0, 1, 2), (0, 2, 4)),
)
EMBEDDING_KEY = "params/nerf/embedding/embedding"


def state_dict_from_flax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax params ({"params/<module>/Dense_i/Dense_0/kernel": array})
    -> reference-named state dict. Kernels are transposed from (in, out) to
    (out, in); the embedding is copied as it is. Every key must be used."""
    sd: dict[str, torch.Tensor] = {}
    used = set()
    for prefix, module, ours, theirs in LINEAR_MAP:
        for i, j in zip(ours, theirs):
            base = f"params/{module}/Dense_{i}/Dense_0"
            w = np.asarray(flat[f"{base}/kernel"], np.float32)
            b = np.asarray(flat[f"{base}/bias"], np.float32)
            sd[f"{prefix}.{j}.weight"] = torch.from_numpy(np.ascontiguousarray(w.T))
            sd[f"{prefix}.{j}.bias"] = torch.from_numpy(b.copy())
            used.update((f"{base}/kernel", f"{base}/bias"))
    if EMBEDDING_KEY in flat:
        sd["nerf.embedding.weight"] = torch.from_numpy(
            np.asarray(flat[EMBEDDING_KEY], np.float32).copy()
        )
        used.add(EMBEDDING_KEY)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"flax params with no place in the model: {unused}")
    return sd


def load_flax_npz(path: str) -> dict[str, torch.Tensor]:
    """State dict from an .npz of flat flax params (the layout of
    `bench/r5/abhq_exact_s233_params.npz`)."""
    with np.load(path) as data:
        return state_dict_from_flax({k: data[k] for k in data.files})
