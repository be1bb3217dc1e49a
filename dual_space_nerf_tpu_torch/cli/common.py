"""Shared CLI plumbing: config loading, model construction, asset loading.

The JAX package's `enable_compilation_cache` (XLA's persistent cache) has
no counterpart here: the CUDA kernels are built once per checkout into
`dual_space_nerf_tpu_torch/_build/`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import get_cfg_defaults
from ..models import DualSpaceNeRF
from ..renderer import RenderSettings
from ..training import Checkpointer


def load_cfg(config_path: str):
    """The default tree with the config file merged in, frozen."""
    cfg = get_cfg_defaults()
    if config_path:
        if not os.path.exists(config_path):
            raise FileNotFoundError(f"config does not exist: {config_path}")
        cfg.merge_from_file(config_path)
    cfg.freeze()
    return cfg


def epoch_from_ckpt(ckpt_path: str) -> int:
    """Epoch number from a `model_epoch_%07d.ckpt` filename; 0 for names
    with no numeric tail (e.g. a hand-renamed `best.ckpt`)."""
    tail = os.path.basename(ckpt_path).split(".")[0].split("_")[-1]
    return int(tail) if tail.isdigit() else 0


def build_model(cfg, seed: int = 0) -> DualSpaceNeRF:
    """DualSpaceNeRF at the config's widths, on the CPU, initialised as
    torch's defaults from a generator seeded with ``seed`` (not flax's
    initialisation: parity runs carry weights across with
    `models/convert.py`)."""
    if cfg.MODEL.MATMUL_PRECISION != "f32":
        raise NotImplementedError(
            f"MODEL.MATMUL_PRECISION={cfg.MODEL.MATMUL_PRECISION!r} is not ported yet "
            "(ROADMAP.md queue 1, item 5)"
        )
    return DualSpaceNeRF(
        max_frames=cfg.MODEL.MAX_FRAMES,
        code_dim=cfg.MODEL.CODE_DIM,
        backbone_dim=cfg.MODEL.BACKBONE_DIM,
        generator=torch.Generator().manual_seed(seed),
    )


def load_faces(cfg, dataset=None) -> np.ndarray:
    """The mesh's faces: the synthetic scene's own topology."""
    if cfg.DATASETS.TYPE == "synthetic":
        return np.asarray(dataset.faces, np.int32)
    raise NotImplementedError(
        "the SMPL body-model pickle is not read yet (ROADMAP.md queue 1, item 4); "
        "use DATASETS.TYPE 'synthetic'"
    )


def load_render_state(ckpt_path: str, cfg, model=None) -> DualSpaceNeRF:
    """The eval scripts' model: ``model`` (or a new one at the config's
    widths) carrying the weights of ``ckpt_path`` (a ``.ckpt``, a reference
    ``.pth`` or a flax-params ``.npz``; `Checkpointer.load_params_only`).
    The port's model holds its weights, so this returns the model alone."""
    model = model or build_model(cfg)
    ck = Checkpointer(os.path.dirname(ckpt_path) or ".")
    return ck.load_params_only(ckpt_path, model)


def eval_settings(cfg) -> RenderSettings:
    return RenderSettings.from_cfg(cfg)


def add_device_arg(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: cuda (the default; fails without a "
                             "card) or cpu, the plain PyTorch path")
