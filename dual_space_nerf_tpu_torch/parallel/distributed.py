"""Multi-process data parallelism over rays on `torch.distributed`, with
the JAX package's env contract (`parallel/distributed.py`).

One process per device. Every process builds the same global batch (the
loader's deterministic stream: same dataset, same seed) and the same global
draws, takes its contiguous 1/P share of the rays, and computes its loss
and gradients on it; the gradients are summed over the processes as one
flat buffer and divided by P (every loss term is a mean over rays and the
shares are equal), and every process takes the same Adam step
(`training.make_train_step(group=...)`). Checkpoints, TensorBoard and logs
come from rank 0 (`training.loop.do_train`). NCCL joins CUDA processes,
gloo CPU ones (and takes CUDA tensors too: two processes can share one
card, which NCCL refuses).

Env contract (set per process by the launcher; `spawn_ranks` sets it for
processes it starts on this host):
  DSNERF_COORD_ADDR     host:port of process 0 (e.g. "localhost:9543")
  DSNERF_NUM_PROCESSES  total process count
  DSNERF_PROCESS_ID     this process's rank, 0-based
"""

from __future__ import annotations

import os
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ENV_ADDR, ENV_NUM, ENV_ID = "DSNERF_COORD_ADDR", "DSNERF_NUM_PROCESSES", "DSNERF_PROCESS_ID"


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """Join the process group that the DSNERF_* env contract names.

    Returns True when this process is part of a >1-process group. A no-op
    (False) when the env is unset or names a single process, so single-
    process entry points run unchanged. ``backend``: "nccl" or "gloo"; None
    takes NCCL where there is a card, else gloo."""
    n = int(os.environ.get(ENV_NUM, "1"))
    if n <= 1:
        return False
    if dist.is_initialized():
        return True
    addr = os.environ.get(ENV_ADDR)
    pid_raw = os.environ.get(ENV_ID)
    if addr is None or pid_raw is None:
        raise ValueError(
            "DSNERF_NUM_PROCESSES > 1 requires DSNERF_COORD_ADDR and "
            "DSNERF_PROCESS_ID (see parallel/distributed.py env contract)"
        )
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=n, rank=int(pid_raw))
    return True


def is_multiprocess(group=None) -> bool:
    """True when ``group`` (the default group when None) holds more than one
    process: batches are then split and checkpoints written by rank 0."""
    return world_size(group) > 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    """The processes in ``group``; 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def global_ray_group():
    """The default process group when it spans more than one process, else
    None: what `training.loop.do_train(mesh_devices=...)` takes (the JAX
    package's `global_ray_mesh`)."""
    return dist.group.WORLD if is_multiprocess() else None


def _src(group) -> int:
    return 0 if group is None else dist.get_global_rank(group, 0)


def broadcast_object(obj, group=None):
    """Rank 0's ``obj`` (picklable) on every rank of ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=_src(group), group=group)
    return box[0]


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_state(state, group=None):
    """Rank 0's training state on every rank, in place: the model's
    parameters and buffers, Adam's moments and counts, the schedule's
    position and the step (after a fresh init or a resume; a rank that found
    no checkpoint takes rank 0's). Returns ``state``."""
    src = _src(group)
    with torch.no_grad():
        for t in list(state.model.parameters()) + list(state.model.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    opt, sched, step = broadcast_object(
        (_to_cpu(state.optimizer.state_dict()), state.scheduler.state_dict(), int(state.step)), group)
    if rank(group) != 0:
        state.optimizer.load_state_dict(opt)  # moves Adam's state to the parameters' device
        state.scheduler.load_state_dict(sched)
        state.step = step
    return state


def all_reduce_mean_(flat: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``flat`` over ``group`` in place, then divide by its size."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat.div_(world_size(group))


def free_port() -> int:
    """A TCP port that was free on localhost a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(target, rank_id: int, world: int, addr: str, args: tuple) -> None:
    os.environ[ENV_ADDR] = addr
    os.environ[ENV_NUM] = str(world)
    os.environ[ENV_ID] = str(rank_id)
    target(rank_id, *args)


def spawn_ranks(target, world: int, args: tuple = (), timeout: float | None = None) -> None:
    """Run ``target(rank, *args)`` in ``world`` new processes on this host,
    each with the env contract set (coordinator on localhost), and wait for
    them; ``target`` must be importable by name (spawned processes start
    from a fresh interpreter). Raises as soon as a process fails (its peers
    would wait in a collective until the backend's timeout) or when they
    outlive ``timeout`` seconds; the others are then ended."""
    ctx = mp.get_context("spawn")
    addr = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world, addr, args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(codes) or None not in codes:  # one failed, or all ended
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: the processes outlived {timeout} s")
            procs[codes.index(None)].join(1.0)
        if any(codes):
            raise RuntimeError(f"spawn_ranks: exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
