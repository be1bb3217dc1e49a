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


def plan_rows(kind: str, n_tiles: int, plan_p: int, rows: int, seed: int = 3):
    """Visit-plan inputs with planted rows, numpy float32: (tile_c, tile_r)
    of `listed_tables`' layout, (8, 128), and rows x plan_p points, for one
    kind of row:

    - "ties": random boxes with their centres as witnesses, every odd tile
      a copy of the tile before it, so listed keys tie in pairs;
    - "all": boxes that all hold the unit cube, the points inside it, so
      every tile is listed with key 0;
    - "one": boxes 10 apart with their centres as witnesses, each row's
      points at one tile's centre, so that tile alone is listed."""
    rng = np.random.default_rng(seed)
    tile_c = np.full((8, 128), 1e15, np.float32)
    tile_r = np.full((8, 128), 1e15, np.float32)
    n = rows * plan_p
    if kind == "ties":
        mid = 4.0 * rng.random((n_tiles, 3))
        half = 0.1 + 0.2 * rng.random((n_tiles, 3))
        mid[1::2], half[1::2] = mid[0:n_tiles - 1:2], half[0:n_tiles - 1:2]
        pts = mid[rng.integers(0, n_tiles, n)] + 0.3 * rng.standard_normal((n, 3))
    elif kind == "all":
        mid = 0.2 * rng.standard_normal((n_tiles, 3))
        half = 1.5 + rng.random((n_tiles, 3))
        pts = rng.random((n, 3)) - 0.5
    else:
        mid = 10.0 * np.stack([np.arange(n_tiles), np.zeros(n_tiles), np.zeros(n_tiles)], 1)
        half = np.full((n_tiles, 3), 0.5)
        pts = np.repeat(mid[rng.integers(0, n_tiles, rows)], plan_p, axis=0)
    tile_c[0:3, :n_tiles] = (mid - half).T
    tile_c[3:6, :n_tiles] = (mid + half).T
    tile_r[0:3, :n_tiles] = mid.T
    return tile_c, tile_r, pts.astype(np.float32)


PRUNED_TIE_KINDS = ("seed_holds", "cross_lanes", "seed_other_lane", "cancelled")


def pruned_ties(kind: str, seed: int = 5):
    """Pruned-search inputs with planted exact ties, numpy float32: one
    block of 128 points and (4 * 512, 3) centroids in kd order (identity
    face_perm). Each tile is a shell of radius 5 around the origin, tile 2
    of radius 6, so tile 2 is the seed (smallest lower bound) and every
    tile is visited. Point i lies at (0, y_i, z_i) on a 1/32 grid; its
    nearest centroids are planted at (+-1, y_i, z_i) (d2 = 1 exactly) or
    (0.5, y_i, z_i) (d2 = 0.25) in the lanes that ``kind`` names:

    - "seed_holds": tile 0 and the seed at lane i: the seed keeps the lane;
    - "cross_lanes": tile 1 at lane i + 100 and tile 3 at lane i;
    - "seed_other_lane": the seed at lane i + 300 and tile 1 at lane i:
      tile 1's slot is the smaller;
    - "cancelled": tiles 0 and 1 tie at lane i, then tile 3 at lane i + 50
      is strictly nearer.

    Returns (pts, cents, the expected kd-order ids)."""
    rng = np.random.default_rng(seed)
    i = np.arange(128)
    pts = np.stack([np.zeros(128), (i % 16 - 8) / 32.0, (i // 16 - 4) / 32.0], 1).astype(np.float32)
    shell = rng.standard_normal((4, 512, 3))
    shell /= np.linalg.norm(shell, axis=-1, keepdims=True)
    cents = shell * np.array([5.0, 5.0, 6.0, 5.0])[:, None, None]

    def plant(tile, lanes, x):
        cents[tile, lanes] = pts
        cents[tile, lanes, 0] = x

    if kind == "seed_holds":
        plant(0, i, -1.0)
        plant(2, i, 1.0)
        want = 2 * 512 + i
    elif kind == "cross_lanes":
        plant(1, i + 100, -1.0)
        plant(3, i, 1.0)
        want = 512 + i + 100
    elif kind == "seed_other_lane":
        plant(2, i + 300, 1.0)
        plant(1, i, -1.0)
        want = 512 + i
    elif kind == "cancelled":
        plant(0, i, -1.0)
        plant(1, i, 1.0)
        plant(3, i + 50, 0.5)
        want = 3 * 512 + i + 50
    else:
        raise ValueError(kind)
    return pts, cents.reshape(-1, 3).astype(np.float32), want.astype(np.int32)


#: the config of the CLI tests (`test_torch_port_cli.py`): the synthetic
#: scene at 16x16, 2 frames x 2 views, 32 rays x 8 GG samples a step, two
#: epochs; also one of the files the config reader is held to yaml on
TINY_CLI_CFG = """\
# the port's CLI tests: train -> validate -> test on the CPU
MODEL:
  TYPE: "nerf"
  COARSE_RAY_SAMPLING: 8
  FINE_RAY_SAMPLING: -1
  sample_points_mode: "GG"
  MLP_CHUNK: 2048
  MAX_FRAMES: 16
DATASETS:
  TYPE: "synthetic"
  HUMAN: "capsule"
  SYNTHETIC_SIZE: 16
  SYNTHETIC_FRAMES: 2
  SYNTHETIC_VIEWS: 2
DATALOADER:
  NUM_WORKERS: 2
SOLVER:
  MAX_EPOCHS: 3
  BASE_LR: 0.0005
  WEIGHT_DECAY: 0.0
  WARMUP_ITERS: 5
  CHECKPOINT_PERIOD: 1
  LOG_PERIOD: 2
  TRAIN_NRAYS: 32
TEST:
  IMS_PER_BATCH: 1
  RAY_CHUNK: 512
  light_center: []  # no shift of the novel poses' light
"""
