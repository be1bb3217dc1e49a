"""Checkpoint save and resume, with the JAX package's surface
(`training/checkpoint.py`): epoch-named ``model_epoch_%07d.ckpt`` files, a
``last_checkpoint`` tag file naming the newest, `resume_or_load`, and a
`PeriodicCheckpointer` stepped once per epoch.

A ``.ckpt`` is written with `torch.save` and read with
``torch.load(weights_only=True)``: {"model": the model's state dict,
"optimizer": Adam's, "scheduler": LambdaLR's, "step", "epoch"}.

`load` and `load_params_only` also read the JAX package's ``.ckpt`` (flax
msgpack of {params, opt_state, step, epoch}, `flax_ckpt.py`), so a run the
JAX package trained can be evaluated and resumed here. The format is taken
from the file's first bytes (`checkpoint_format`), never from a failed
parse. A resumed JAX run goes on in the port's format: the next save
writes `torch.save`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.convert import load_flax_npz, state_dict_from_flax
from .flax_ckpt import FlaxCheckpointError, flatten, is_flax_msgpack, read_flax_checkpoint
from .state import TrainState

#: a zip archive: `torch.save` since torch 1.6 (and numpy's .npz)
_ZIP_MAGIC = b"PK\x03\x04"
#: the fields of optax's ScaleByAdamState
_ADAM_FIELDS = frozenset({"count", "mu", "nu"})


def checkpoint_format(path: str) -> str:
    """"torch" or "flax", from the first bytes of the file at ``path``: a
    zip archive or a pickle (the legacy `torch.save`, 0x80 then its
    protocol) is torch's; a non-empty msgpack map is the JAX package's.
    Anything else raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == _ZIP_MAGIC or (len(head) > 1 and head[0] == 0x80 and 2 <= head[1] <= 5):
        return "torch"
    if is_flax_msgpack(head):
        return "flax"
    raise ValueError(f"{path}: neither a torch checkpoint nor a flax msgpack one (starts {head!r})")


def _adam_node(tree, path: str):
    """optax's ScaleByAdamState in ``tree``, found by its fields wherever
    the chain put it (``adam``: node "0"; ``chain(add_decayed_weights,
    adam)``: node "1/0"). Exactly one must be there."""
    found = []

    def walk(node, at):
        if isinstance(node, dict):
            if set(node) == _ADAM_FIELDS:
                found.append((at, node))
                return
            for key, value in node.items():
                walk(value, f"{at}/{key}" if at else key)

    walk(tree, "")
    if len(found) != 1:
        raise FlaxCheckpointError(
            f"{path}: opt_state holds {len(found)} Adam states (count, mu, nu) "
            f"{[at for at, _ in found]}; resuming needs exactly one")
    return found[0][1]


def _moments(tree, what: str, path: str, params: dict) -> dict:
    """Adam's ``mu`` or ``nu`` tree mapped onto the model's parameter names
    with the params' names and transposes; every parameter once, in its
    shape."""
    if not isinstance(tree, dict):
        raise FlaxCheckpointError(f"{path}: Adam's {what} is a {type(tree).__name__}, not a tree")
    flat = flatten(tree)
    try:
        sd = state_dict_from_flax(flat)
    except KeyError as exc:
        raise FlaxCheckpointError(f"{path}: Adam's {what} does not match the params: {exc}") from None
    if set(sd) != set(params):
        raise FlaxCheckpointError(f"{path}: Adam's {what} holds {sorted(set(sd) ^ set(params))} "
                                  "where the model's parameters differ")
    for name, value in sd.items():
        if tuple(value.shape) != tuple(params[name].shape):
            raise FlaxCheckpointError(f"{path}: Adam's {what} for {name} has shape "
                                      f"{tuple(value.shape)}, the parameter {tuple(params[name].shape)}")
    return sd


def load_flax_state(path: str, template: TrainState) -> tuple[TrainState, int]:
    """Load a JAX package ``.ckpt`` into ``template``, in place: the params
    through `models/convert.py::state_dict_from_flax`, optax's Adam ``mu`` /
    ``nu`` into each parameter's ``exp_avg`` / ``exp_avg_sq`` (the same names
    and transposes) with Adam's step from ``count``, the step from the
    payload's ``step``, and the LambdaLR's position so that the next update
    takes BASE_LR * schedule(step). A missing Adam state, leaf or shape
    raises. Returns (state, epoch)."""
    ckpt = read_flax_checkpoint(path)
    model, opt, sched = template.model, template.optimizer, template.scheduler
    params = dict(model.named_parameters())
    adam = _adam_node(ckpt.opt_state, path)
    count = adam["count"]
    if not (isinstance(count, (np.ndarray, np.integer)) and np.ndim(count) == 0
            and np.issubdtype(np.asarray(count).dtype, np.integer)):
        raise FlaxCheckpointError(f"{path}: Adam's count is {count!r}, not an integer scalar")
    mu = _moments(adam["mu"], "mu", path, params)
    nu = _moments(adam["nu"], "nu", path, params)
    model.load_state_dict(state_dict_from_flax(ckpt.params))

    sd = opt.state_dict()
    if len(sd["param_groups"]) != 1 or len(sd["param_groups"][0]["params"]) != len(params):
        raise ValueError("load_flax_state: the optimizer must hold every model parameter in one group")
    step = ckpt.step
    lr_at = sched.lr_lambdas[0]
    lrs = [base * lr_at(step) for base in sched.base_lrs]
    # `create_train_state` gives Adam model.parameters(), in named_parameters' order
    sd["state"] = {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                       "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                   for i, name in enumerate(params)}
    for group, lr in zip(sd["param_groups"], lrs):
        group["lr"] = lr
    opt.load_state_dict(sd)  # moves the moments to the parameters' device and dtype
    ssd = sched.state_dict()
    ssd.update(last_epoch=step, _step_count=step + 1, _last_lr=lrs)
    sched.load_state_dict(ssd)
    template.step = step
    return template, ckpt.epoch

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
        position and the step. ``path`` is the port's ``.ckpt`` or the JAX
        package's (`load_flax_state`). Returns (state, epoch)."""
        if checkpoint_format(path) == "flax":
            return load_flax_state(path, template)
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

        ``path`` is the port's ``.ckpt``, the JAX package's ``.ckpt`` (its
        params, `flax_ckpt.py`), a reference ``.pth`` (its state dict, or
        {"model": state dict, ...} as the reference's trainer saves it; the
        port's modules carry its names), or an ``.npz`` of flat flax params
        (`models/convert.py::load_flax_npz`)."""
        if path.endswith(".npz"):
            sd = load_flax_npz(path)
        elif checkpoint_format(path) == "flax":
            sd = state_dict_from_flax(read_flax_checkpoint(path).params)
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
