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
from ..data.smpl import load_body_model
from ..models import DualSpaceNeRF, compute_dtype
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
    """DualSpaceNeRF at the config's widths and compute dtype, on the CPU,
    initialised as torch's defaults from a generator seeded with ``seed``
    (not flax's initialisation: parity runs carry weights across with
    `models/convert.py`)."""
    return DualSpaceNeRF(
        max_frames=cfg.MODEL.MAX_FRAMES,
        code_dim=cfg.MODEL.CODE_DIM,
        backbone_dim=cfg.MODEL.BACKBONE_DIM,
        generator=torch.Generator().manual_seed(seed),
        compute_dtype=compute_dtype(cfg),
    )


def load_faces(cfg, dataset=None) -> np.ndarray:
    """The mesh's faces: the synthetic scene's own topology, else the SMPL
    body-model pickle's (DSNERF_SMPL_PATH, else DATASETS.SMPL_PATH; a
    directory holds SMPL_NEUTRAL.pkl)."""
    if cfg.DATASETS.TYPE == "synthetic":
        return np.asarray(dataset.faces, np.int32)
    smpl_path = os.environ.get("DSNERF_SMPL_PATH", cfg.DATASETS.SMPL_PATH)
    return load_body_model(smpl_path).faces


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


def renderer_devices(device: str, data_parallel: bool = False) -> dict:
    """`ImageRenderer`'s device keywords for ``--device`` and
    ``--data_parallel``: with the flag and more than one local device of
    that kind (`parallel.local_ray_devices`: the cards), ``devices`` splits
    every chunk over them; else the one ``device``."""
    from ..device import resolve_device
    from ..parallel import local_ray_devices

    dev = resolve_device(device)
    devices = local_ray_devices(device_type=dev.type) if data_parallel else None
    return {"devices": devices} if devices else {"device": dev}


def add_device_arg(parser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: cuda (the default; fails without a "
                             "card) or cpu, the plain PyTorch path")
