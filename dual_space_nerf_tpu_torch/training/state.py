"""Train state and one training step, as the JAX package's
`training/state.py::make_train_step`: render (train=True) -> loss ->
backward (through the second-order normal graph) -> Adam update.

The JAX step draws its randomness from `fold_in(rng, step)`; torch cannot
give the same numbers, so the port's step takes the uniforms and normals
themselves: `draw_randoms` makes them from a `torch.Generator`, and the tests
hand in JAX's draws.

With a process group the step is data parallel over rays
(`parallel/distributed.py`): each rank takes its contiguous share of the
global batch and draws, and the gradients and metrics are averaged over the
ranks before the update.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..renderer import LightState, MeshBundle, RayBatch, RenderSettings, render_rays
from ..utils import tracing
from .loss import make_loss
from .optim import make_optimizer


class TrainBatch(NamedTuple):
    """RayBatch and its supervision; per-ray fields lead with R."""

    rays: RayBatch
    rgb: torch.Tensor        # (R, 3)
    occupancy: torch.Tensor  # (R,)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def create_train_state(model, cfg) -> TrainState:
    """Adam with the reference schedule over every parameter of ``model``."""
    opt, sched = make_optimizer(model.parameters(), cfg)
    return TrainState(model, opt, sched, 0)


def draw_randoms(r: int, s: int, generator: torch.Generator, device, n_fine: int = 0) -> tuple:
    """(uniforms (R, S) in [0, 1), standard normals (R, S)) of one step; with
    n_fine > 0 also the fine pass's (uniforms (R, n_fine), normals (R, S +
    n_fine)), as `render_rays` takes them."""
    u = torch.rand((r, s), generator=generator, dtype=torch.float32, device=device)
    z = torch.randn((r, s), generator=generator, dtype=torch.float32, device=device)
    if n_fine <= 0:
        return u, z
    uf = torch.rand((r, n_fine), generator=generator, dtype=torch.float32, device=device)
    zf = torch.randn((r, s + n_fine), generator=generator, dtype=torch.float32, device=device)
    return u, z, uf, zf


def rank_share(batch: TrainBatch, randoms: tuple, rank: int, world: int) -> tuple:
    """Rank ``rank``'s contiguous 1/world share of the rays of a global
    batch and its draws: (batch, randoms)."""
    r = batch.rgb.shape[0]
    if r % world:
        raise ValueError(f"train step: {r} rays do not split over {world} ranks "
                         "(parallel.pad_rays_for_mesh rounds TRAIN_NRAYS up)")
    sl = slice(rank * (r // world), (rank + 1) * (r // world))
    rays = batch.rays
    rays = RayBatch(rays.ray_o[sl], rays.ray_d[sl], rays.near[sl], rays.far[sl], rays.frame,
                    rays.body_pose)
    return (TrainBatch(rays, batch.rgb[sl], batch.occupancy[sl]),
            tuple(t[sl] for t in randoms))


def make_train_step(settings: RenderSettings, loss_type: str = "L2", loss_with_mask: bool = False,
                    device: str | torch.device | None = None, group=None):
    """step(state, batch, mesh, randoms) -> metrics.

    One update on ``device`` (CUDA unless asked otherwise; the model, batch
    and mesh must be there). ``randoms`` = (uniforms, normals) of shape
    (R, S), and with settings.n_fine > 0 the fine pass's two, as
    `draw_randoms` makes them. With the fine pass its loss terms join the
    coarse ones as ``fine_<term>`` (`fine_loss_rgb`), as in the JAX
    package. Every parameter that the loss does not reach gets a zero
    gradient, so that Adam steps every parameter with one count, as optax
    does. After the step each parameter's ``.grad`` holds its gradient.
    Metrics: loss, psnr (of the coarse colors) and each loss term, as 0-d
    tensors.

    ``group`` (a `torch.distributed` process group, e.g.
    `parallel.global_ray_group()`): the step takes the global batch and
    draws, computes on this rank's share (`rank_share`), and averages the
    gradients and the metrics over the group in one all-reduce of a flat
    buffer before the update, so every rank takes the same step.

    With tracing on (`utils/tracing.py`) the step's three parts are the
    spans ``step.forward`` (render and loss), ``step.backward`` (the
    backward and the zero gradients) and ``step.optimizer`` (the metrics,
    the all-reduce, Adam and the schedule)."""
    loss_fn = make_loss(loss_type, loss_with_mask)
    dev = resolve_device(device)
    if group is not None:
        from ..parallel.distributed import all_reduce_mean_, rank, world_size

        share = (rank(group), world_size(group))

    def step(state: TrainState, batch: TrainBatch, mesh: MeshBundle, randoms: tuple) -> dict:
        model = state.model
        if group is not None:
            batch, randoms = rank_share(batch, randoms, *share)
        state.optimizer.zero_grad(set_to_none=True)
        with tracing.span("step.forward"):
            dtype = next(model.parameters()).dtype  # float32; float64 for conditioning checks
            light = LightState(*(t.to(dtype) for t in LightState.identity(dev)))
            out = render_rays(model, batch.rays, mesh, settings, light, device=dev, train=True,
                              randoms=randoms)
            losses = loss_fn(out, batch.rgb, batch.occupancy)
            if settings.n_fine > 0:
                fine = {k[len("fine_"):]: v for k, v in out.items() if k.startswith("fine_")}
                losses.update({f"fine_{k}": v
                               for k, v in loss_fn(fine, batch.rgb, batch.occupancy).items()})
            total = sum(losses.values())
        with tracing.span("step.backward"):
            total.backward()
            params = list(model.parameters())
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        with tracing.span("step.optimizer"):
            with torch.no_grad():
                mse = ((out["color"] - batch.rgb) ** 2).mean()
                scalars = [total.detach(), *(v.detach() for v in losses.values()), mse]
                if group is not None:
                    # one all-reduce: every gradient, then the metrics
                    flat = torch.cat([p.grad.reshape(-1) for p in params]
                                     + [v.reshape(1).to(params[0].grad.dtype) for v in scalars])
                    all_reduce_mean_(flat, group)
                    at = 0
                    for p in params:
                        p.grad.copy_(flat[at:at + p.numel()].view_as(p))
                        at += p.numel()
                    scalars = [flat[at + i].to(v.dtype) for i, v in enumerate(scalars)]
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        total, *terms, mse = scalars
        return {"loss": total, "psnr": -10.0 * torch.log10(mse), **dict(zip(losses, terms))}

    return step
