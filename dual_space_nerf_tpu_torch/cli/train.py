"""Training CLI, with the flags of the JAX package's `cli/train.py`:

    python -m dual_space_nerf_tpu_torch.cli.train -c configs/synthetic.yml --exp NAME

Outputs go to ``EXP/<exp>/``: ``log.txt``, TensorBoard events,
``model_epoch_%07d.ckpt`` and the ``last_checkpoint`` tag; a run resumes
from the tag when it is there. Runs on ``cuda:<-g>`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import shutil

from .common import add_device_arg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train Dual-Space NeRF (PyTorch)")
    parser.add_argument("-c", "--config", default="", help="config file path")
    parser.add_argument("-g", "--gpu", type=int, default=0,
                        help="CUDA device index (the run uses cuda:<g>)")
    parser.add_argument("-r", "--resume", type=int, default=0,
                        help="checkpoint number to resume (auto-resumes from "
                             "last_checkpoint when present)")
    parser.add_argument("-s", "--psnr_thres", type=float, default=100.0)
    parser.add_argument("-cont", "--cont", action="store_true")
    parser.add_argument("-noise", "--add_noise", type=float, default=0.0)
    parser.add_argument("--exp", type=str, default="test")
    parser.add_argument("--max_epochs", type=int, default=0,
                        help="override SOLVER.MAX_EPOCHS (0 = use config)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of the first epoch "
                             "here (TensorBoard format)")
    parser.add_argument("--debug_nans", action="store_true",
                        help="run under torch.autograd.set_detect_anomaly (the "
                             "reference's commented-out call, main.py:70)")
    add_device_arg(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from ..data import select_dataset
    from ..device import resolve_device
    from ..training.loop import _train_seed, do_train
    from ..utils.logger import make_summary_writer, setup_logger
    from .common import build_model, eval_settings, load_cfg, load_faces

    # refuse a missing card before anything is written
    device = resolve_device(f"cuda:{args.gpu}" if args.device == "cuda" else args.device)
    cfg = load_cfg(args.config)
    output_dir = os.path.join("EXP", args.exp)
    os.makedirs(output_dir, exist_ok=True)
    writer = make_summary_writer(output_dir)
    writer.add_text("OUT_PATH", output_dir, 0)
    logger = setup_logger("NERFRender", output_dir)
    logger.info("Running with config:\n%s", cfg)
    if args.config:
        shutil.copyfile(args.config, os.path.join(output_dir, "config.yml"))

    train_set, val_set = select_dataset(cfg, train_nrays=cfg.SOLVER.TRAIN_NRAYS)
    logger.info("len train: %d, len val: %d", len(train_set), len(val_set))

    model = build_model(cfg, seed=_train_seed())
    faces = load_faces(cfg, train_set)

    def val_fn(state, epoch):
        from ..evaluation import ImageRenderer
        from .validate import val

        renderer = ImageRenderer(state.model, eval_settings(cfg), faces,
                                 val_set.canonical_vertex, chunk=cfg.TEST.RAY_CHUNK,
                                 device=device)
        return val(val_set, renderer, os.path.join(output_dir, "vis"), epoch)

    try:
        with torch.autograd.set_detect_anomaly(args.debug_nans):
            state = do_train(
                cfg, model, train_set, faces, writer, logger,
                output_dir=output_dir, psnr_thres=args.psnr_thres,
                resume=True, val_fn=val_fn,
                max_epochs=args.max_epochs or None,
                device=device, profile_dir=args.profile_dir,
            )
    finally:
        writer.close()
    return state


if __name__ == "__main__":
    main()
