"""Train state and one training step, as the JAX package's
`training/state.py::make_train_step`: render (train=True) -> loss ->
backward (through the second-order normal graph) -> Adam update.

The JAX step draws its randomness from `fold_in(rng, step)`; torch cannot
give the same numbers, so the port's step takes the uniforms and normals
themselves: `draw_randoms` makes them from a `torch.Generator`, and the tests
hand in JAX's draws.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..renderer import LightState, MeshBundle, RayBatch, RenderSettings, render_rays
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


def make_train_step(settings: RenderSettings, loss_type: str = "L2", loss_with_mask: bool = False,
                    device: str | torch.device | None = None):
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
    tensors."""
    loss_fn = make_loss(loss_type, loss_with_mask)
    dev = resolve_device(device)

    def step(state: TrainState, batch: TrainBatch, mesh: MeshBundle, randoms: tuple) -> dict:
        model = state.model
        state.optimizer.zero_grad(set_to_none=True)
        dtype = next(model.parameters()).dtype  # float32; float64 for conditioning checks
        light = LightState(*(t.to(dtype) for t in LightState.identity(dev)))
        out = render_rays(model, batch.rays, mesh, settings, light, device=dev, train=True,
                          randoms=randoms)
        losses = loss_fn(out, batch.rgb, batch.occupancy)
        if settings.n_fine > 0:
            fine = {k[len("fine_"):]: v for k, v in out.items() if k.startswith("fine_")}
            losses.update({f"fine_{k}": v for k, v in loss_fn(fine, batch.rgb, batch.occupancy).items()})
        total = sum(losses.values())
        total.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            mse = ((out["color"] - batch.rgb) ** 2).mean()
        return {"loss": total.detach(), "psnr": -10.0 * torch.log10(mse),
                **{k: v.detach() for k, v in losses.items()}}

    return step
