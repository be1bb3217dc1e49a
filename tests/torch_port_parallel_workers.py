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
