"""Relighting-sweep CLI, as the JAX package's `cli/vis_lighting.py`: for
angles 0..360 step 36, rotate the world coordinates that the LightingMLP
sees about a pivot (the head point) in the xy-plane, re-render the same
frame, and assemble an mp4 (`novel_pose_vis.img2vid`, ffmpeg only):

    python -m dual_space_nerf_tpu_torch.cli.vis_lighting -c CFG --exp NAME --ckpt PATH

Frames are written as ``.png`` under the JAX package's ``.jpg`` stems.
Runs on ``cuda:<-g>`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..evaluation import ImageRenderer
from ..renderer import LightState
from ..utils.image_io import write_png
from .common import add_device_arg
from .novel_pose_vis import img2vid

# head point of CoreView_313
DEFAULT_ROT_CENTER = [0.18649693, -0.14180326, 1.7103844]


def angle2rot(angle_deg: float) -> np.ndarray:
    rad = np.pi * angle_deg / 180.0
    return np.array([[np.cos(rad), -np.sin(rad)], [np.sin(rad), np.cos(rad)]], np.float32)


def run_lighting_sweep(dataset, renderer: ImageRenderer, save_dir: str, epoch: int,
                       rot_center=None, angles=range(0, 360, 36)) -> int:
    """Render ``dataset[0]`` once per angle; returns the number of frames."""
    rendering_dir = f"{save_dir}/{epoch}/rendering"
    os.makedirs(rendering_dir, exist_ok=True)
    rot_center = np.asarray(rot_center if rot_center is not None else DEFAULT_ROT_CENTER,
                            np.float32)
    item = dataset[0]
    n = 0
    for angle in angles:
        light = LightState.identity()._replace(rot=torch.from_numpy(angle2rot(angle)),
                                               rot_center=torch.from_numpy(rot_center))
        results = renderer.render_item(item, light=light)
        color = np.clip(results["coarse_color"], 0.0, 1.0) * 255
        write_png(f"{rendering_dir}/{angle:05d}.png", color)
        n += 1
    img2vid(rendering_dir, os.path.join(save_dir, "relight.mp4"))
    return n


def main(argv=None):
    parser = argparse.ArgumentParser(description="relighting sweep")
    parser.add_argument("-c", "--config", default="")
    parser.add_argument("--exp", type=str, default="test")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--rot_center", type=float, nargs=3, default=None)
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard render chunks over all local devices (one model replica per card)")
    parser.add_argument("-g", "--gpu", type=int, default=0,
                        help="CUDA device index (the run uses cuda:<g>)")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..data import select_dataset
    from ..data.zju import MocapView
    from .common import (
        epoch_from_ckpt,
        eval_settings,
        load_cfg,
        load_faces,
        load_render_state,
        renderer_devices,
    )

    device = f"cuda:{args.gpu}" if args.device == "cuda" else args.device
    cfg = load_cfg(args.config)
    epoch = epoch_from_ckpt(args.ckpt)
    save_dir = os.path.join("./vis_lighting", args.exp)

    if cfg.DATASETS.TYPE == "synthetic":
        _, dataset = select_dataset(cfg)
    else:
        zju_dir = os.environ.get("DSNERF_ZJU_PATH", cfg.DATASETS.ZJU_MOCAP_PATH)
        # one frame, one view
        dataset = MocapView(cfg.DATASETS.HUMAN, ratio=0.5, begin=0, end=1, train_views=[],
                            train_max_frame=2000, interval=30, vis_views=[0], data_dir=zju_dir)

    model = load_render_state(args.ckpt, cfg)
    faces = load_faces(cfg, dataset)
    renderer = ImageRenderer(model, eval_settings(cfg), faces, dataset.canonical_vertex,
                             chunk=cfg.TEST.RAY_CHUNK,
                             **renderer_devices(device, args.data_parallel))
    return run_lighting_sweep(dataset, renderer, save_dir, epoch, args.rot_center)


if __name__ == "__main__":
    main()
