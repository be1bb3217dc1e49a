"""Shared set-up of the `test_torch_port_*` files: the trained fixture
loaded into both the JAX package's flax model and the port's torch model,
and the slice's render config."""

from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS_NPZ = os.path.join(REPO, "bench", "r5", "abhq_exact_s233_params.npz")
MAX_FRAMES = 16  # the trained fixture's embedding table


def slice_cfg(get_cfg_defaults, n_samples: int = 64):
    """`configs/zju_mocap/313.yml` semantics for the eval slice: GG
    sampling, full shading, no face reuse, no fine pass."""
    cfg = get_cfg_defaults()
    cfg.MODEL.MAX_FRAMES = MAX_FRAMES
    cfg.MODEL.COARSE_RAY_SAMPLING = n_samples
    cfg.MODEL.FINE_RAY_SAMPLING = -1
    cfg.MODEL.sample_points_mode = "GG"
    cfg.MODEL.SHADE_TOPK = 0
    cfg.MODEL.REUSE_WARP_FACES = False
    return cfg


def jax_model_and_params():
    """The JAX package's DualSpaceNeRF with the trained fixture's params."""
    import jax
    import jax.numpy as jnp

    from dual_space_nerf_tpu.cli.common import build_model
    from dual_space_nerf_tpu.config import get_cfg_defaults

    model = build_model(slice_cfg(get_cfg_defaults))
    params = model.init(
        jax.random.key(3), jnp.zeros((4, 3)), jnp.zeros((4,), jnp.int32),
        jnp.zeros((4, 16)),
    )
    with np.load(PARAMS_NPZ) as data:
        flat = {k: data[k] for k in data.files}

    def restore(path, leaf):
        arr = flat["/".join(str(p.key) for p in path)]
        assert arr.shape == leaf.shape
        return jnp.asarray(arr)

    return model, jax.tree_util.tree_map_with_path(restore, params)


def torch_model():
    """The port's DualSpaceNeRF with the trained fixture's weights."""
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF, load_flax_npz

    model = DualSpaceNeRF(max_frames=MAX_FRAMES)
    model.load_state_dict(load_flax_npz(PARAMS_NPZ))
    return model
