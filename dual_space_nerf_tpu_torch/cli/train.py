"""Training CLI, with the flags of the JAX package's `cli/train.py`:

    python -m dual_space_nerf_tpu_torch.cli.train -c configs/synthetic.yml --exp NAME

Outputs go to ``EXP/<exp>/``: ``log.txt``, TensorBoard events,
``model_epoch_%07d.ckpt`` and the ``last_checkpoint`` tag; a run resumes
from the tag when it is there, or from ``model_epoch_<N>.ckpt`` with
``-r N``. ``EXP/<exp>/`` may be one the JAX package's CLI wrote: its flax
``.ckpt`` files resume here (params, Adam's moments and step, the
schedule's position, the epoch), and the run goes on writing the port's
``.ckpt``. Runs on ``cuda:<-g>`` unless ``--device cpu``.

Data parallel over rays, one process per device (`parallel/`): with the
DSNERF_* env contract set (DSNERF_NUM_PROCESSES > 1, DSNERF_COORD_ADDR,
DSNERF_PROCESS_ID) this process joins the group as that rank (NCCL on the
card, gloo with ``--device cpu``); on a host with more than one card and no
contract, the CLI starts one process per card itself (rank i on cuda:i),
as the JAX CLI's ray mesh takes every local device. TRAIN_NRAYS is rounded
up to a multiple of the process count; rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from .common import add_device_arg


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train Dual-Space NeRF (PyTorch)")
    parser.add_argument("-c", "--config", default="", help="config file path")
    parser.add_argument("-g", "--gpu", type=int, default=0,
                        help="CUDA device index (the run uses cuda:<g>)")
    parser.add_argument("-r", "--resume", type=int, default=0,
                        help="resume from EXP/<exp>/model_epoch_<N>.ckpt (0: "
                             "from last_checkpoint when present)")
    parser.add_argument("-s", "--psnr_thres", type=float, default=100.0)
    parser.add_argument("-cont", "--cont", action="store_true")
    parser.add_argument("-noise", "--add_noise", type=float, default=0.0)
    parser.add_argument("--exp", type=str, default="test")
    parser.add_argument("--max_epochs", type=int, default=0,
                        help="override SOLVER.MAX_EPOCHS (0 = use config)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of the first epoch "
                             "here (TensorBoard format), with the program's "
                             "dsnerf.* stage spans (step.forward/backward/optimizer, "
                             "render.*, loader.*) and the loader's threads")
    parser.add_argument("--debug_nans", action="store_true",
                        help="run under torch.autograd.set_detect_anomaly (the "
                             "reference's commented-out call, main.py:70)")
    add_device_arg(parser)
    return parser.parse_args(argv)


def rank_main(rank: int, argv: list) -> None:
    """A spawned rank of a one-process-per-card run: ``main`` on cuda:<rank>."""
    main(list(argv) + ["-g", str(rank)])


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..device import resolve_device
    from ..parallel import global_ray_group, local_ray_devices, maybe_initialize_distributed, spawn_ranks
    from ..parallel.distributed import ENV_NUM

    if args.device == "cuda" and ENV_NUM not in os.environ:
        cards = local_ray_devices()
        if cards is not None:  # one process per card, each joining the group
            spawn_ranks(rank_main, len(cards), args=(argv,))
            return None
    # refuse a missing card before anything is written
    device = resolve_device(f"cuda:{args.gpu}" if args.device == "cuda" else args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    was_joined = dist.is_initialized()
    joined = maybe_initialize_distributed("nccl" if device.type == "cuda" else "gloo")
    try:
        return _run(args, device, global_ray_group() if joined else None)
    finally:
        if joined and not was_joined:
            dist.destroy_process_group()


def _run(args, device, group):
    """The run of one process (one rank when ``group`` is a process group)."""
    import torch

    from ..data import select_dataset
    from ..parallel import pad_rays_for_mesh, rank, world_size
    from ..training.loop import _train_seed, do_train
    from ..utils.logger import _NullWriter, make_summary_writer, setup_logger
    from .common import build_model, eval_settings, load_cfg, load_faces

    cfg = load_cfg(args.config)
    if group is not None:
        cfg.defrost()
        cfg.SOLVER.TRAIN_NRAYS = pad_rays_for_mesh(cfg.SOLVER.TRAIN_NRAYS, world_size(group))
        cfg.freeze()
    is_main = rank(group) == 0
    output_dir = os.path.join("EXP", args.exp)
    resume_from = ""
    if args.resume:
        resume_from = os.path.join(output_dir, f"model_epoch_{args.resume:07d}.ckpt")
        if not os.path.isfile(resume_from):
            raise FileNotFoundError(f"-r {args.resume}: no checkpoint {resume_from}")
    os.makedirs(output_dir, exist_ok=True)
    # rank 0 writes the events, log.txt and the config copy
    writer = make_summary_writer(output_dir) if is_main else _NullWriter()
    writer.add_text("OUT_PATH", output_dir, 0)
    logger = setup_logger("NERFRender", output_dir if is_main else "")
    logger.info("Running with config:\n%s", cfg)
    if args.config and is_main:
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
                device=device, profile_dir=args.profile_dir, mesh_devices=group,
                resume_from=resume_from,
            )
    finally:
        writer.close()
    return state


if __name__ == "__main__":
    main()
