"""The training loop, with the semantics of the JAX package's
`training/loop.py::do_train` (itself the reference's `trainer.py:12-160`):
epochs ``1 + resume_epoch .. max_epochs - 1`` over the prefetching loader
(one image -> TRAIN_NRAYS rays per step), the per-update schedule,
TensorBoard scalars every 50 iterations, a log line every LOG_PERIOD, a
checkpoint per epoch, validation every 40 epochs, the PSNR-threshold early
stop.

The step's draws come from a `torch.Generator` on the step's device,
seeded by `step_seed(seed, step)`, a pure function as JAX's
``fold_in(key(seed), step)`` is: a resumed run draws what an unbroken run
draws at that step. Metrics are read one step late, so the host never
waits on the step it has just queued.

With ``mesh_devices`` (a `torch.distributed` process group, one process
per device) every rank runs this loop on the same deterministic batch
stream and the same global draws; the step splits the rays over the ranks
and averages the gradients (`training/state.py`). Rank 0's state is
broadcast after init or resume; checkpoints, TensorBoard scalars,
validation and the iteration log lines come from rank 0 only. While rank 0
validates, the other ranks wait for it in a barrier of a gloo group of
their own whose timeout is sized for a validation (`VAL_WAIT_TIMEOUT`),
not in the next step's all-reduce under the process group's timeout.

A run resumes from the ``last_checkpoint`` tag of ``output_dir``, or from
the file ``resume_from`` names; either may be the port's ``.ckpt`` or the
JAX package's (`training/checkpoint.py`), and the epoch comes from it.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import time

import numpy as np
import torch

from ..data.batching import item_to_mesh, item_to_train_batch
from ..data.prefetch import PrefetchLoader
from ..device import resolve_device
from ..parallel.distributed import broadcast_object, broadcast_state, is_multiprocess, rank
from ..renderer import RenderSettings
from ..utils import tracing
from .checkpoint import Checkpointer, PeriodicCheckpointer
from .state import create_train_state, draw_randoms, make_train_step


#: how long the other ranks wait for rank 0's validation, which renders
#: the whole val set on one device (minutes for a real subject); the
#: process group's own timeout is sized for a step's collectives
VAL_WAIT_TIMEOUT = datetime.timedelta(hours=4)

#: the port's additions to the JAX package's iteration log line, since the
#: last line: the network passes by path (`utils/tracing.py::passes`), then
#: the share of the wall time the loop waited on the loader, and the
#: loader's transform time per item (`PrefetchLoader.stats`)
NETWORK_LOG = " Passes: %d fused %d fast %d plain"
LOADER_LOG = " Loader wait: %.1f%% transform: %.1f[ms/item]"


def _train_seed() -> int:
    """The reference seeds everything with 233 (`main.py:22-26`).
    DSNERF_SEED overrides it; a value that is no integer fails at start, and
    an override is logged."""
    raw = os.environ.get("DSNERF_SEED")
    if raw is None:
        return 233
    try:
        seed = int(raw)
    except ValueError:
        raise ValueError(f"DSNERF_SEED={raw!r} is not an integer") from None
    if seed != 233:
        logging.getLogger(__name__).warning("DSNERF_SEED=%d overrides the reference seed 233", seed)
    return seed


def step_seed(seed: int, step: int) -> int:
    """The seed of the generator that draws step ``step``'s randoms."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def _all_threads_config():
    """The profiler setting that records threads the session did not start
    on (the loader's), where the installed torch has it; else None."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def do_train(
    cfg,
    model,
    train_set,
    faces: np.ndarray,
    writer,
    logger,
    output_dir: str,
    psnr_thres: float = 100.0,
    resume: bool = True,
    val_fn=None,
    mesh_devices=None,
    max_epochs: int | None = None,
    device: str | torch.device | None = None,
    profile_dir: str = "",
    resume_from: str = "",
):
    """Train ``model`` (moved to ``device``: CUDA unless the caller passes
    another) and return the final `TrainState`. ``val_fn(state, epoch)``
    returns the validation metrics. ``profile_dir``: write a torch.profiler
    trace of this run's first epoch there (TensorBoard format), with the
    program's ``dsnerf.*`` stage spans on (`utils/tracing.py`) and the
    loader's threads recorded.
    ``mesh_devices``: None, or the process group whose ranks share every
    step's rays (`parallel.global_ray_group()`; TRAIN_NRAYS a multiple of
    its size, `parallel.pad_rays_for_mesh`). ``resume_from``: a checkpoint
    file to resume from instead of the tag (`cli.train -r N`)."""
    group = mesh_devices
    if group is not None and not isinstance(group, torch.distributed.ProcessGroup):
        raise TypeError(f"mesh_devices: expected a torch.distributed process group, got {type(group)}")
    multiproc = group is not None and is_multiprocess(group)
    is_main = group is None or rank(group) == 0
    dev = resolve_device(device)
    settings = RenderSettings.from_cfg(cfg)
    seed = _train_seed()
    state = create_train_state(model.to(dev), cfg)
    lr_at = state.scheduler.lr_lambdas[0]
    base_lr = state.scheduler.base_lrs[0]
    nrays = cfg.SOLVER.TRAIN_NRAYS

    # the effective epoch count first: the periodic checkpointer's
    # final-epoch save must fire at the epoch the run really ends on
    max_epochs = max_epochs or cfg.SOLVER.MAX_EPOCHS
    checkpointer = Checkpointer(output_dir)
    if resume_from:
        state, resume_epoch = checkpointer.load(resume_from, state)
    else:
        state, resume_epoch = checkpointer.resume_or_load("", state, resume=resume)
    if group is not None:  # every rank starts from rank 0's state and epoch
        state = broadcast_state(state, group)
        resume_epoch = broadcast_object(resume_epoch, group)
    periodic = PeriodicCheckpointer(checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD, max_epochs)

    step_fn = make_train_step(settings, loss_type=cfg.MODEL.LOSS,
                              loss_with_mask=cfg.MODEL.LOSSwMask, device=dev, group=group)
    gen = torch.Generator(device=dev)
    verts_cano = train_set.canonical_vertex
    log_period = cfg.SOLVER.LOG_PERIOD

    def to_device(item):
        return (item_to_train_batch(item, nrays, dev), item_to_mesh(item, faces, verts_cano, dev))

    # Ordered yielding and a per-(epoch, item) generator make the batch
    # stream a pure function of (dataset, seed, epoch), whatever the
    # workers' interleaving: required with more than one rank (every rank
    # must take its share of the SAME batch), DSNERF_DETERMINISTIC_DATA=1
    # asks for it in one process
    det_data = multiproc or os.environ.get("DSNERF_DETERMINISTIC_DATA", "0") == "1"
    if det_data:
        if not hasattr(train_set, "deterministic_items"):
            raise ValueError("deterministic data streaming needs a dataset with "
                             "deterministic_items support (data/synthetic_dataset.py)")
        train_set.deterministic_items = True

    loader = PrefetchLoader(
        train_set, shuffle=True, num_workers=cfg.DATALOADER.NUM_WORKERS, seed=seed,
        transform=to_device, backend=cfg.DATALOADER.BACKEND, ordered=det_data,
    )

    # the other ranks wait out rank 0's validation here (a CPU barrier,
    # whatever the step's backend)
    val_wait = (torch.distributed.new_group(torch.distributed.get_process_group_ranks(group),
                                            backend="gloo", timeout=VAL_WAIT_TIMEOUT)
                if multiproc else None)
    prof = None
    spans = contextlib.ExitStack()  # the stage spans, on while the profiler runs
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(profile_dir),
                       experimental_config=_all_threads_config())
        spans.enter_context(tracing.enabled())
        prof.start()
    try:
        # fresh runs start at epoch 1, as the reference's loop
        # `range(1 + resume_epoch, max_epochs)` does
        for epoch in range(1 + resume_epoch, max_epochs):
            logger.info("Training Epoch %d...", epoch)
            psnr_monitor = []
            epoch_start = time.time()
            iters_start = epoch_start
            last_log_bidx = -1  # rays/s counts the true steps since the last log
            loader_at, passes_at = loader.stats, tracing.passes()
            pending = None      # (metrics, step, batch index), read one step late

            for batch_idx, (batch, geom) in enumerate(loader):
                gen.manual_seed(step_seed(seed, state.step))
                randoms = draw_randoms(nrays, settings.n_samples, gen, dev, settings.n_fine)
                metrics = step_fn(state, batch, geom, randoms)

                if pending is not None:
                    m, gstep, bidx = pending
                    psnr_v = float(m["psnr"])
                    psnr_monitor.append(psnr_v)
                    if is_main and bidx % 50 == 0:
                        for key, v in m.items():
                            # the loss terms; the total goes out as Loss/loss_sum
                            if "loss_" in key:
                                writer.add_scalar(f"Loss/{key}", float(v), gstep)
                        writer.add_scalar("Loss/loss_sum", float(m["loss"]), gstep)
                        writer.add_scalar("TrainPsnr", psnr_v, gstep)
                        # the next update's rate, as the reference reads
                        # `scheduler.get_lr()` after `scheduler.step()`
                        writer.add_scalar("LR", base_lr * lr_at(gstep), gstep)
                    if bidx % log_period == 0:
                        dt = time.time() - iters_start
                        iters_start = time.time()
                        steps = bidx - last_log_bidx
                        last_log_bidx = bidx
                        now = loader.stats
                        waited = now["wait_s"] - loader_at["wait_s"]
                        items = max(now["items"] - loader_at["items"], 1)
                        transform_ms = 1e3 * (now["transform_s"] - loader_at["transform_s"]) / items
                        loader_at = now
                        passes = tracing.passes()
                        ran = [passes[k] - passes_at[k] for k in tracing.PATHS]
                        passes_at = passes
                        if is_main:
                            logger.info(
                                "Epoch[%d] Iteration[%d/%d] Loss: %.3e "
                                "Psnr: %.2f Lr: %.2e Speed: %.1f[rays/s]" + NETWORK_LOG + LOADER_LOG,
                                epoch, bidx, len(loader), float(m["loss"]),
                                psnr_v, base_lr * lr_at(gstep), steps * nrays / max(dt, 1e-9),
                                *ran, 100.0 * waited / max(dt, 1e-9), transform_ms,
                            )
                pending = (metrics, state.step, batch_idx)

            if pending is not None:
                psnr_monitor.append(float(pending[0]["psnr"]))

            if is_main:
                periodic.step_by_epoch(epoch, state)
            if prof is not None:  # the first epoch's trace
                prof.stop()
                prof = None
                spans.close()
            # full-val renders every 40 epochs (`trainer.py:121-122`);
            # DSNERF_VAL_PERIOD overrides, 0 disables
            val_period = int(os.environ.get("DSNERF_VAL_PERIOD", "40"))
            val_due = val_period > 0 and epoch % val_period == 0
            if is_main and val_fn is not None and val_due:
                res = val_fn(state, epoch)
                for key, v in res.items():
                    writer.add_scalar(f"Val/{key}", v, epoch)
                logger.info("Validation Results - Epoch: %d psnr_wMask: %.3f",
                            epoch, res.get("psnr_wMask", float("nan")))
            if val_wait is not None and val_due:
                torch.distributed.barrier(group=val_wait)

            epoch_time = time.time() - epoch_start
            logger.info("Epoch %d done. Time: %.3f[s] Speed: %.1f[rays/s]",
                        epoch, epoch_time, len(loader) * nrays / max(epoch_time, 1e-9))

            mean_psnr = float(np.mean(psnr_monitor)) if psnr_monitor else 0.0
            if mean_psnr > psnr_thres:
                logger.info("Mean Psnr %.3f > threshold %.3f, training stopped",
                            mean_psnr, psnr_thres)
                break
    finally:
        if prof is not None:
            prof.stop()
        spans.close()
        if val_wait is not None:
            torch.distributed.destroy_process_group(val_wait)
    return state
