"""Validation loop and CLI, as the JAX package's `cli/validate.py`:
full-image renders of the val views with the frame code fixed, masked and
unmasked PSNR, SSIM, and dumps of render | ground truth, acc and depth:

    python -m dual_space_nerf_tpu_torch.cli.validate -c CFG --exp NAME --ckpt PATH

Images are written as ``.png`` under the JAX package's ``.jpg`` stems
(`utils/image_io.py`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..evaluation import ImageRenderer, psnr, ssim_metric
from ..utils.image_io import write_png
from .common import add_device_arg


def mkdir(d):
    os.makedirs(d, exist_ok=True)


def val(
    dataset, renderer: ImageRenderer, save_dir: str, epoch: int = 0,
    fixed_frame: int = 50,
) -> dict:
    psnr_w, psnr_wo, ssims = [], [], []
    img_dir = f"{save_dir}/{epoch}/img"
    acc_dir = f"{save_dir}/{epoch}/acc"
    depth_dir = f"{save_dir}/{epoch}/depth"
    for d in (img_dir, acc_dir, depth_dir):
        mkdir(d)

    for batch_idx in range(len(dataset)):
        item = dataset[batch_idx]
        real_frame = int(item["frame"])
        results = renderer.render_item(item, frame_override=fixed_frame)  # validate.py:48
        color = np.clip(results["coarse_color"], 0.0, 1.0)
        gt = item["img"]
        H, W = gt.shape[:2]
        mask = item["mask_at_box"].reshape(H, W).astype(bool)

        psnr_w.append(psnr(color, gt, np.repeat(mask[..., None], 3, -1)))
        psnr_wo.append(psnr(color, gt))
        ssims.append(ssim_metric(color, gt, mask))

        stem = f"{real_frame:06d}_{batch_idx}.png"
        write_png(f"{img_dir}/{stem}", np.concatenate([color, gt], axis=1) * 255)
        write_png(f"{depth_dir}/{stem}", np.repeat(results["coarse_depth"], 3, axis=2) * 255)
        write_png(f"{acc_dir}/{stem}", np.repeat(results["coarse_acc"], 3, axis=2) * 255)

    out = {
        "psnr_wMask": float(np.mean(psnr_w)),
        "psnr_woMask": float(np.mean(psnr_wo)),
        "ssim": float(np.mean(ssims)),
    }
    print(epoch)
    for k, v in out.items():
        print(f"{k}_mean", v)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="validate")
    parser.add_argument("-c", "--config", default="")
    parser.add_argument("--exp", type=str, default="test")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard eval ray chunks over all local devices (not ported yet)")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel: multi-device eval is not ported yet (ROADMAP.md queue 1, item 7)"
        )

    from ..data import select_dataset
    from .common import epoch_from_ckpt, eval_settings, load_cfg, load_faces, load_render_state

    cfg = load_cfg(args.config)
    _, val_set = select_dataset(cfg, train_nrays=cfg.SOLVER.TRAIN_NRAYS)
    model = load_render_state(args.ckpt, cfg)
    faces = load_faces(cfg, val_set)
    renderer = ImageRenderer(model, eval_settings(cfg), faces, val_set.canonical_vertex,
                             chunk=cfg.TEST.RAY_CHUNK, device=args.device)
    epoch = epoch_from_ckpt(args.ckpt)
    return val(val_set, renderer, f"EXP/{args.exp}/vis", epoch,
               fixed_frame=min(50, cfg.MODEL.MAX_FRAMES - 1))


if __name__ == "__main__":
    main()
