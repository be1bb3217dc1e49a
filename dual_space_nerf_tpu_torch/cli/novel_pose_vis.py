"""Novel-pose motion-transfer CLI, as the JAX package's `cli/novel_pose_vis.py`:
drive the trained canonical avatar with a pose sequence (frame code zeroed,
the light_center shift applied), write the frames, and assemble them into
mp4 files:

    python -m dual_space_nerf_tpu_torch.cli.novel_pose_vis -c CFG --exp NAME --ckpt PATH

Two branches: by default the same-subject ZJU sequence (CoreView_313 view
9, poses from ``--pose_dir``); with ``--performer`` and ``--motion_seq``, an
H36M sequence's motion on a (ZJU or H36M) performer's canonical avatar
(`data_configs/novel_poses/{performer}_{motion_seq}.yml`). Frames are
written as ``.png`` under the JAX package's ``.jpg`` stems
(`utils/image_io.py`). The videos need ``ffmpeg`` on PATH; without it
`img2vid` logs that and returns False (there is no OpenCV video writer to
fall back to). Runs on ``cuda:<-g>`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import shutil
import subprocess

import numpy as np

from ..evaluation import ImageRenderer, light_state_for_novel_pose
from ..utils.image_io import write_png
from .common import add_device_arg

logger = logging.getLogger(__name__)


def img2vid(img_dir: str, output_path: str, fps: int = 15) -> bool:
    """Assemble ``img_dir/*.png`` into ``output_path`` with ffmpeg. Returns
    False (and logs why) when there are no frames, no ffmpeg, or ffmpeg
    fails."""
    if not glob.glob(os.path.join(img_dir, "*.png")):
        logger.warning("img2vid: no frames in %s", img_dir)
        return False
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        logger.warning("img2vid: ffmpeg is not on PATH; %s not written (frames are in %s)",
                       output_path, img_dir)
        return False
    proc = subprocess.run(
        [ffmpeg, "-y", "-framerate", str(fps), "-pattern_type", "glob",
         "-i", f"{img_dir}/*.png", output_path],
        capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        logger.warning("img2vid: ffmpeg failed for %s: %s", output_path, proc.stderr[-2000:])
        return False
    return True


def run_motion_transfer(dataset, renderer: ImageRenderer, save_dir: str, epoch: int,
                        light_center, n_frames: int | None = None) -> int:
    """Render ``n_frames`` items (all by default) of ``dataset``; returns the
    number written. The sequence may end early (a missing pose file)."""
    rendering_dir = f"{save_dir}/{epoch}/rendering"
    img_dir = f"{save_dir}/{epoch}/img"
    os.makedirs(rendering_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)

    n = n_frames if n_frames is not None else len(dataset)
    done = 0
    for idx in range(n):
        try:
            item = dataset[idx]
        except (FileNotFoundError, IndexError):
            break  # the pose sequence is exhausted
        light = light_state_for_novel_pose(light_center, item["Th"], code_scale=0.0)
        results = renderer.render_item(item, light=light)
        color = np.clip(results["coarse_color"], 0.0, 1.0) * 255
        write_png(f"{rendering_dir}/{idx:06d}.png", color)
        gt = item["img"] * 255
        write_png(f"{img_dir}/{idx:06d}.png", np.concatenate([color, gt], axis=1))
        done += 1
    img2vid(rendering_dir, os.path.join(save_dir, "rendering.mp4"))
    img2vid(img_dir, os.path.join(save_dir, "video.mp4"))
    return done


def main(argv=None):
    parser = argparse.ArgumentParser(description="novel pose motion transfer")
    parser.add_argument("-c", "--config", default="")
    parser.add_argument("--exp", type=str, default="test")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--pose_dir", type=str, default="novelpose_examples/CoreView_313_op3")
    parser.add_argument("--n_frames", type=int, default=0)
    parser.add_argument("--performer", type=str, default="",
                        help="cross-dataset motion transfer: the trained avatar (e.g. "
                             "CoreView_377); with --motion_seq, configured by "
                             "data_configs/novel_poses/{performer}_{motion_seq}.yml")
    parser.add_argument("--motion_seq", type=str, default="",
                        help="cross-dataset motion transfer: the driving H36M sequence (e.g. S9)")
    parser.add_argument("--vertices_dir", type=str, default="",
                        help="override the driving sequence's posed-vertex dir")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard render chunks over all local devices (one model replica per card)")
    parser.add_argument("-g", "--gpu", type=int, default=0,
                        help="CUDA device index (the run uses cuda:<g>)")
    add_device_arg(parser)
    args = parser.parse_args(argv)

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
    save_dir = os.path.join("./motion_transfer", args.exp)

    zju_dir = os.environ.get("DSNERF_ZJU_PATH", cfg.DATASETS.ZJU_MOCAP_PATH)
    h36m_dir = os.environ.get("DSNERF_H36M_PATH", cfg.DATASETS.H36M_PATH)
    if args.performer and args.motion_seq:
        from ..data.h36m_novel_pose import get_novel_pose_dataset

        dataset = get_novel_pose_dataset(performer=args.performer, motion_seq=args.motion_seq,
                                         zju_data_dir=zju_dir, h36m_data_dir=h36m_dir)
        if args.vertices_dir:
            dataset.cfg.vertices = args.vertices_dir
    else:
        from ..data.zju_novel_pose import MocapNovelPoseView

        dataset = MocapNovelPoseView(
            "CoreView_313", ratio=1, begin=0, end=100000, train_views=[],
            train_max_frame=2000, interval=4, vis_views=[9],
            performer="CoreView_313", zju_data_dir=zju_dir, h36m_data_dir=h36m_dir,
        )
        dataset.set_novel_pose_dirs(os.path.join(args.pose_dir, "new_params"),
                                    os.path.join(args.pose_dir, "new_vertices"))
    print("length:", len(dataset))

    model = load_render_state(args.ckpt, cfg)
    faces = load_faces(cfg, dataset)
    renderer = ImageRenderer(model, eval_settings(cfg), faces, dataset.canonical_vertex,
                             chunk=cfg.TEST.RAY_CHUNK,
                             **renderer_devices(device, args.data_parallel))
    return run_motion_transfer(dataset, renderer, save_dir, epoch,
                               light_center=list(cfg.TEST.light_center) or None,
                               n_frames=args.n_frames or None)


if __name__ == "__main__":
    main()
