"""Formal test CLI (novel view and novel pose), as the JAX package's
`cli/test.py`: two eval splits, masked and unmasked PSNR and SSIM, PNG
dumps of rendering / ground truth / both / acc / depth, and for the novel
poses the frame code zeroed and the light centre shifted:

    python -m dual_space_nerf_tpu_torch.cli.test -c CFG --exp NAME --ckpt PATH

LPIPS (alex and vgg, `evaluation/lpips.py`) from the weights that
TEST.LPIPS_WEIGHTS names (a converted npz, or a directory holding
``lpips_{alex,vgg}.npz``), on the run's device; without weights the metric
is skipped, as the JAX CLI skips it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..evaluation import ImageRenderer, light_state_for_novel_pose, make_lpips, psnr, ssim_metric
from ..utils.image_io import write_png
from .common import add_device_arg
from .validate import mkdir


def myinfer(
    dataset, renderer: ImageRenderer, save_dir: str, epoch: int = 0,
    light_center=None, zero_frame_code=False,
    lpips_alex=None, lpips_vgg=None,
) -> dict:
    metrics = {k: [] for k in ("psnr_wMask", "psnr_woMask", "ssim", "lpips_alex", "lpips_vgg")}
    dirs = {
        name: f"{save_dir}/{epoch}/{name}"
        for name in ("img", "rendering", "ground_truth", "acc", "depth")
    }
    for d in dirs.values():
        mkdir(d)

    for batch_idx in range(len(dataset)):
        item = dataset[batch_idx]
        save_name = item.get("save_name", f"{batch_idx:06d}")

        light = None
        if zero_frame_code or light_center is not None:
            light = light_state_for_novel_pose(
                light_center, item["Th"], code_scale=0.0 if zero_frame_code else 1.0,
            )
        results = renderer.render_item(item, light=light)
        color = np.clip(results["coarse_color"], 0.0, 1.0)
        gt = item["img"]
        H, W = gt.shape[:2]
        mask = item["mask_at_box"].reshape(H, W).astype(bool)

        metrics["psnr_wMask"].append(psnr(color, gt, np.repeat(mask[..., None], 3, -1)))
        metrics["psnr_woMask"].append(psnr(color, gt))
        metrics["ssim"].append(ssim_metric(color, gt, mask))
        if lpips_alex is not None:
            metrics["lpips_alex"].append(lpips_alex(color, gt))
        if lpips_vgg is not None:
            metrics["lpips_vgg"].append(lpips_vgg(color, gt))

        rendering = color * 255
        gt255 = gt * 255
        write_png(f"{dirs['img']}/{save_name}.png", np.concatenate([rendering, gt255], axis=1))
        write_png(f"{dirs['rendering']}/{save_name}.png", rendering)
        write_png(f"{dirs['ground_truth']}/{save_name}.png", gt255)
        write_png(f"{dirs['depth']}/{save_name}.png",
                  np.repeat(results["coarse_depth"], 3, axis=2) * 255)
        write_png(f"{dirs['acc']}/{save_name}.png",
                  np.repeat(results["coarse_acc"], 3, axis=2) * 255)

    out = {k: float(np.mean(v)) for k, v in metrics.items() if v}
    print("epoch", epoch)
    for k, v in out.items():
        print(f"{k}_mean", v)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="infer")
    parser.add_argument("-c", "--config", default="")
    parser.add_argument("--exp", type=str, default="test")
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard eval ray chunks over all local devices (one model replica per card)")
    add_device_arg(parser)
    args = parser.parse_args(argv)

    from ..data import select_dataset
    from .common import (
        epoch_from_ckpt,
        eval_settings,
        load_cfg,
        load_faces,
        load_render_state,
        renderer_devices,
    )

    cfg = load_cfg(args.config)
    epoch = epoch_from_ckpt(args.ckpt)
    save_dir = os.path.join("./TEST", args.exp)

    novel_view_set, novel_pose_set = select_dataset(cfg, formal_test=True)
    print("novel view length", len(novel_view_set))
    print("novel pose length", len(novel_pose_set))

    model = load_render_state(args.ckpt, cfg)
    faces = load_faces(cfg, novel_view_set)
    renderer = ImageRenderer(model, eval_settings(cfg), faces, novel_view_set.canonical_vertex,
                             chunk=cfg.TEST.RAY_CHUNK,
                             **renderer_devices(args.device, args.data_parallel))
    lpips_alex = make_lpips("alex", cfg.TEST.LPIPS_WEIGHTS, renderer.device)
    lpips_vgg = make_lpips("vgg", cfg.TEST.LPIPS_WEIGHTS, renderer.device)
    if lpips_alex is None:
        print("LPIPS weights unavailable; skipping LPIPS metrics")

    print("novel view:")
    out1 = myinfer(novel_view_set, renderer, save_dir=os.path.join(save_dir, "novel_view"),
                   epoch=epoch, lpips_alex=lpips_alex, lpips_vgg=lpips_vgg)
    print("novel pose:")
    out2 = myinfer(novel_pose_set, renderer, save_dir=os.path.join(save_dir, "novel_pose"),
                   epoch=epoch, light_center=list(cfg.TEST.light_center) or None,
                   zero_frame_code=True, lpips_alex=lpips_alex, lpips_vgg=lpips_vgg)
    return out1, out2


if __name__ == "__main__":
    main()
