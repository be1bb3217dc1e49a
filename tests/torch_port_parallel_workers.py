"""Process entry points of `test_torch_port_parallel.py`: spawned processes
import this module by name, and it imports no JAX (each rank starts from a
fresh interpreter)."""

from __future__ import annotations

import os


def step_rank(rank: int, inputs: str, out_dir: str) -> None:
    """One data-parallel training step in a gloo group: every rank loads the
    global batch, mesh, draws and weights that ``inputs`` holds (written
    with `torch.save`) and takes the step on its share, with the optimizer
    of `train_cfg(production=False, fused=False)`; each rank saves its
    loss and gradients to ``out_dir/rank<r>.pt``."""
    import torch

    from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
    from dual_space_nerf_tpu_torch.parallel import global_ray_group, maybe_initialize_distributed
    from dual_space_nerf_tpu_torch.training import create_train_state, make_train_step

    torch.set_num_threads(1)
    assert maybe_initialize_distributed("gloo")
    try:
        d = torch.load(inputs, weights_only=False)
        model = DualSpaceNeRF(max_frames=d["max_frames"])
        model.load_state_dict(d["weights"])
        state = create_train_state(model, train_cfg(production=False, fused=False))
        m = make_train_step(d["settings"], device="cpu", group=global_ray_group())(
            state, d["batch"], d["mesh"], d["randoms"])
        torch.save({"metrics": {k: float(v) for k, v in m.items()},
                    "grads": {n: p.grad for n, p in model.named_parameters()},
                    "params": {n: p.detach() for n, p in model.named_parameters()}},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def train_cli_rank(rank: int, work: str, argv: list) -> None:
    """`cli.train`'s spawned-rank entry in ``work``, on the CPU; ranks other
    than 0 fail if they write a checkpoint."""
    import torch

    from dual_space_nerf_tpu_torch.cli import train
    from dual_space_nerf_tpu_torch.training import Checkpointer

    torch.set_num_threads(1)
    os.chdir(work)
    if rank != 0:
        def refuse(*args, **kwargs):
            raise AssertionError(f"rank {rank} wrote a checkpoint")

        Checkpointer.save = refuse
    train.rank_main(rank, argv)


def fail_or_wait(rank: int) -> None:
    """Rank 1 fails at once; rank 0 would wait two minutes (as a peer waits
    in a collective for a rank that is gone)."""
    import time

    if rank == 1:
        raise SystemExit(3)
    time.sleep(120)


def slow_validation_rank(rank: int, work: str, group_timeout: float, val_sleep: float) -> None:
    """`do_train` of the tiny config in ``work`` (two epochs, validation
    after each, DSNERF_VAL_PERIOD from the parent) as one rank of a gloo
    group whose timeout is ``group_timeout`` seconds; rank 0's first
    validation sleeps ``val_sleep`` seconds. Each rank saves its final
    parameters to ``work/rank<r>.pt``."""
    import datetime
    import logging
    import time

    import torch
    import torch.distributed as dist

    from dual_space_nerf_tpu_torch.cli.common import build_model, load_cfg, load_faces
    from dual_space_nerf_tpu_torch.data import select_dataset
    from dual_space_nerf_tpu_torch.parallel import maybe_initialize_distributed
    from dual_space_nerf_tpu_torch.training.loop import do_train
    from dual_space_nerf_tpu_torch.utils.logger import _NullWriter

    torch.set_num_threads(1)
    os.chdir(work)
    cfg = load_cfg("tiny.yml")
    train_set, _ = select_dataset(cfg, train_nrays=cfg.SOLVER.TRAIN_NRAYS)
    model = build_model(cfg, seed=233)
    faces = load_faces(cfg, train_set)
    slept = []

    def val_fn(state, epoch):
        if not slept:
            time.sleep(val_sleep)
            slept.append(epoch)
        return {"psnr_wMask": 0.0}

    assert maybe_initialize_distributed("gloo")
    try:
        # the group the steps run in, with the short timeout; the default
        # group's (long) one covers the ranks' start
        group = dist.new_group([0, 1], backend="gloo",
                               timeout=datetime.timedelta(seconds=group_timeout))
        state = do_train(cfg, model, train_set, faces, _NullWriter(), logging.getLogger(f"rank{rank}"),
                         os.path.join("EXP", "t"), val_fn=val_fn, mesh_devices=group, max_epochs=3,
                         device="cpu")
        torch.save({n: p.detach() for n, p in state.model.named_parameters()},
                   os.path.join(work, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
