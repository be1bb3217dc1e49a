"""Adam and the reference learning-rate schedule, as the JAX package's
`training/optim.py`.

Adam with eps 1e-8 and coupled weight decay: torch's `Adam(weight_decay=wd)`
adds wd * param to the gradient before the moments, which is optax's
`add_decayed_weights` ahead of `adam`. The schedule is the reference's
LambdaLR multiplier: linear warmup over WARMUP_ITERS, then 1, then from
START_ITERS an exponential decay to LR_SCALE.
"""

from __future__ import annotations

import math

import torch


def reference_schedule(warmup_iters: int, start_iters: int, end_iters: int, scale: float):
    """The multiplier of update ``step`` (0 for the first update), as optax
    calls the JAX package's schedule: it evaluates at it = step + 1."""

    def schedule(step: int) -> float:
        it = float(step) + 1.0
        if it <= warmup_iters:
            return it / warmup_iters
        if it >= start_iters:
            return (1.0 - scale) * math.exp(-(it - start_iters) / (end_iters - start_iters)) + scale
        return 1.0

    return schedule


def make_optimizer(params, cfg):
    """(torch.optim.Adam, LambdaLR) from cfg.SOLVER. The LambdaLR gives
    update k (k = 0, 1, ...) the learning rate BASE_LR * schedule(k): it is
    evaluated at construction (k = 0) and after each `scheduler.step()`."""
    sched = reference_schedule(cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.START_ITERS,
                               cfg.SOLVER.END_ITERS, cfg.SOLVER.LR_SCALE)
    opt = torch.optim.Adam(params, lr=cfg.SOLVER.BASE_LR, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=max(float(cfg.SOLVER.WEIGHT_DECAY), 0.0))
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)
