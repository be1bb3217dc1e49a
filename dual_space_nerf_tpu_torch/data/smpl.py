"""SMPL body-model asset loading, as the JAX package's `data/smpl.py`: the
model pickle (official downloads with chumpy arrays, through a stub, or
all-numpy pickles), its faces, blend weights and kinematic tree, and the
canonical X-pose. The SMPL pickle is licensed and not in the repository;
`cli/common.py::load_faces` reads it from DSNERF_SMPL_PATH, then
DATASETS.SMPL_PATH.
"""

from __future__ import annotations

import os
import pickle
from typing import NamedTuple

import numpy as np


class BodyModel(NamedTuple):
    faces: np.ndarray          # (F, 3) int32
    blend_weights: np.ndarray  # (V, 24) float32
    parents: np.ndarray        # (24,) int64, parents[0] = -1
    x_pose: np.ndarray         # (24, 3): zero pose with legs spread +-0.6 rad


class _ChumpyStub:
    """Stand-in for chumpy.Ch objects inside official SMPL pickles.

    The basicModel_* downloads store v_template/shapedirs/posedirs as
    chumpy arrays; chumpy is an abandoned dependency we refuse to require.
    A Ch object's pickled state keeps its numpy payload in the 'x' slot,
    so a stub that captures the state dict is enough to recover it."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _SMPLUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "chumpy":
            return _ChumpyStub
        return super().find_class(module, name)


def _to_numpy(v):
    if isinstance(v, _ChumpyStub):
        return np.asarray(v.__dict__["x"])
    if hasattr(v, "toarray"):  # scipy.sparse J_regressor
        return np.asarray(v.toarray())
    return v


def load_bodydata(
    model_path: str, model_type: str = "smpl", gender: str = "neutral"
) -> dict:
    """Unpickle the SMPL model dict (kintree_table, weights, f, ...).

    Accepts both pre-converted all-numpy pickles and the OFFICIAL SMPL
    downloads, whose chumpy arrays load through a stub (chumpy itself is
    not a dependency) and whose sparse J_regressor is densified."""
    if os.path.isdir(model_path):
        fn = f"{model_type.upper()}_{gender.upper()}.pkl"
        model_path = os.path.join(model_path, fn)
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"SMPL model not found: {model_path}")
    with open(model_path, "rb") as f:
        data = _SMPLUnpickler(f, encoding="latin1").load()
    return {k: _to_numpy(v) for k, v in data.items()}


def x_pose() -> np.ndarray:
    """The canonical X-pose: rest pose with legs rotated +-0.6 rad about z
    (`can_render.py:397-399`). The ZJU loader applies the inverse offsets
    to per-frame poses (data/zju.py prepare_input) — the two must stay
    negations of each other."""
    pose = np.zeros((24, 3), np.float32)
    pose[1, 2] += 0.6
    pose[2, 2] -= 0.6
    return pose


def load_body_model(model_path: str, gender: str = "neutral") -> BodyModel:
    data = load_bodydata(model_path, gender=gender)
    parents = np.asarray(data["kintree_table"][0], np.int64).copy()
    parents[0] = -1
    return BodyModel(
        faces=np.asarray(data["f"], np.int32),
        blend_weights=np.asarray(data["weights"], np.float32),
        parents=parents,
        x_pose=x_pose(),
    )



def write_body_model(path: str, faces: np.ndarray, n_verts: int) -> None:
    """A stand-in SMPL pickle with the fields `load_body_model` reads: the
    given faces, uniform blend weights over the 24 joints and a chain
    kinematic tree. For trees without the licensed model, as the synthetic
    scene's topology (V=6890 / F=13776) stands in for SMPL's."""
    kintree = np.stack([np.arange(-1, 23), np.arange(24)]).astype(np.int64)
    with open(path, "wb") as fh:
        pickle.dump({"f": np.asarray(faces, np.int32),
                     "weights": np.full((n_verts, 24), 1.0 / 24, np.float32),
                     "kintree_table": kintree}, fh)
