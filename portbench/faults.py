"""Faults planted under the timed path, to show that the comparison that
decides ``correct`` catches them (the tests, and `calibrate.py`'s readings
of the upper limits). Each wraps the program's step or image call.

- ``unchanged``: the step leaves the weights and Adam's state as they were;
- ``half``: half of the step's rays (or of each render chunk's) left out,
  the mean taken over the rest (a chunk's missing half copies the other);
- ``altered``: the colour a ray renders shifted where it is produced.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _shifted(render_rays, shift: float):
    def render(*args, **kwargs):
        out = dict(render_rays(*args, **kwargs))
        out["color"] = out["color"] + shift
        return out

    return render


def train_fault(kind: str):
    """A ``wrap_step`` hook that plants ``kind`` in every step."""
    from dual_space_nerf_tpu_torch.renderer import RayBatch
    from dual_space_nerf_tpu_torch.training import TrainBatch
    from dual_space_nerf_tpu_torch.training import state as state_mod

    def wrap(step):
        def faulty(state, batch, mesh, randoms):
            if kind == "unchanged":
                with _patched(state.optimizer, "step", lambda *a, **k: None):
                    return step(state, batch, mesh, randoms)
            if kind == "half":
                h = batch.rgb.shape[0] // 2
                r = batch.rays
                rays = RayBatch(r.ray_o[:h], r.ray_d[:h], r.near[:h], r.far[:h], r.frame, r.body_pose)
                return step(state, TrainBatch(rays, batch.rgb[:h], batch.occupancy[:h]), mesh,
                            tuple(t[:h] for t in randoms))
            if kind == "altered":
                with _patched(state_mod, "render_rays", _shifted(state_mod.render_rays, 1e-2)):
                    return step(state, batch, mesh, randoms)
            raise ValueError(f"unknown fault {kind!r}")

        return faulty

    return wrap


def render_fault(kind: str):
    """A ``wrap_render`` hook that plants ``kind`` in every chunk."""
    from dual_space_nerf_tpu_torch.evaluation import render_image as ri
    from dual_space_nerf_tpu_torch.renderer import RayBatch

    def half(render_rays):
        def render(model, rays, *args, **kwargs):
            h = rays.ray_o.shape[0] // 2
            part = RayBatch(rays.ray_o[:h], rays.ray_d[:h], rays.near[:h], rays.far[:h],
                            rays.frame, rays.body_pose)
            out = render_rays(model, part, *args, **kwargs)
            rest = rays.ray_o.shape[0] - h
            return {k: torch.cat([v, v[:rest]]) for k, v in out.items()}

        return render

    def wrap(render_item):
        if kind == "half":
            fake = half(ri.render_rays)
        elif kind == "altered":
            fake = _shifted(ri.render_rays, 1e-3)
        else:
            raise ValueError(f"unknown fault {kind!r}")

        def faulty(*args, **kwargs):
            with _patched(ri, "render_rays", fake):
                return render_item(*args, **kwargs)

        return faulty

    return wrap
