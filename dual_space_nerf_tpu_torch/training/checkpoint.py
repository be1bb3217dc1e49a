"""Checkpoint save and resume, with the JAX package's surface
(`training/checkpoint.py`): epoch-named ``model_epoch_%07d.ckpt`` files, a
``last_checkpoint`` tag file naming the newest, `resume_or_load`, and a
`PeriodicCheckpointer` stepped once per epoch.

A ``.ckpt`` is written with `torch.save` and read with
``torch.load(weights_only=True)``: {"model": the model's state dict,
"optimizer": Adam's, "scheduler": LambdaLR's, "step", "epoch"}. The JAX
package's msgpack ``.ckpt`` needs flax to read and is not read here.
"""

from __future__ import annotations

import os

import torch

from ..models.convert import load_flax_npz
from .state import TrainState

_TAG_FILE = "last_checkpoint"


class Checkpointer:
    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    # -- paths --------------------------------------------------------------
    def _tag_path(self) -> str:
        return os.path.join(self.save_dir, _TAG_FILE)

    def has_checkpoint(self) -> bool:
        return os.path.exists(self._tag_path())

    def get_checkpoint_file(self) -> str:
        with open(self._tag_path(), "r", encoding="utf-8") as f:
            name = f.read().strip()
        return os.path.join(self.save_dir, name)

    # -- save/load ----------------------------------------------------------
    def save(self, name: str, state: TrainState, epoch: int) -> str:
        """Save the state under `<name>.ckpt` and update the tag file."""
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
            "step": int(state.step),
            "epoch": int(epoch),
        }
        fname = f"{name}.ckpt"
        path = os.path.join(self.save_dir, fname)
        torch.save(payload, path)
        with open(self._tag_path(), "w", encoding="utf-8") as f:
            f.write(fname)
        return path

    def load(self, path: str, template: TrainState) -> tuple[TrainState, int]:
        """Load into the (already built) state ``template``, in place: the
        model's parameters, Adam's moments and step counts, the schedule's
        position and the step. Returns (state, epoch)."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        template.model.load_state_dict(payload["model"])
        template.optimizer.load_state_dict(payload["optimizer"])
        template.scheduler.load_state_dict(payload["scheduler"])
        template.step = int(payload["step"])
        return template, int(payload["epoch"])

    def resume_or_load(self, path: str, template: TrainState,
                       resume: bool = True) -> tuple[TrainState, int]:
        """Resume from the tag file if present, else load ``path`` if given;
        else the template as it is, at epoch 0."""
        if resume and self.has_checkpoint():
            return self.load(self.get_checkpoint_file(), template)
        if path and os.path.exists(path):
            return self.load(path, template)
        return template, 0

    def load_params_only(self, path: str, model: torch.nn.Module) -> torch.nn.Module:
        """The eval scripts' path: load the weights alone into ``model``.

        ``path`` is the port's ``.ckpt``, a reference ``.pth`` (its state
        dict, or {"model": state dict, ...} as the reference's trainer saves
        it; the port's modules carry its names), or an ``.npz`` of flat flax
        params (`models/convert.py::load_flax_npz`)."""
        if path.endswith(".npz"):
            sd = load_flax_npz(path)
        else:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(sd.get("model"), dict):
                sd = sd["model"]
        model.load_state_dict(sd)
        return model


class PeriodicCheckpointer:
    """Per-epoch checkpoint with `model_epoch_%07d` naming: every ``period``
    epochs and at every epoch from ``max_epoch - 1`` on."""

    def __init__(self, checkpointer: Checkpointer, period: int, max_epoch: int):
        self.checkpointer = checkpointer
        self.period = max(int(period), 1)
        self.max_epoch = max_epoch

    def step_by_epoch(self, epoch: int, state: TrainState) -> None:
        if epoch % self.period == 0 or epoch >= self.max_epoch - 1:
            self.checkpointer.save(f"model_epoch_{epoch:07d}", state, epoch)
