"""Dataset selection from the config, as the JAX package's
`data/select.py::select_dataset`: (train, val) datasets, or with
``formal_test`` the (novel view, novel pose) pair, for the three dataset
types:

- "zju_mocap": `data_configs/zju_mocap/{HUMAN}.yml` picks the views,
  frames and ratio of `Mocap` / `MocapView` / `MocapInfer`; the data root
  is DSNERF_ZJU_PATH, else DATASETS.ZJU_MOCAP_PATH;
- "h36m": `data_configs/h36m/{HUMAN}.yml` configures `H36M`; the data root
  is DSNERF_H36M_PATH, else DATASETS.H36M_PATH;
- "synthetic": the asset-free capsule, sized by DATASETS.SYNTHETIC_*, its
  essence field picked by DATASETS.HUMAN.

Data configs are read by the port's yaml-free reader
(`config/node.py::parse_config_text`), relative to the working directory
first, then to the repository root (`resolve_data_config`).
"""

from __future__ import annotations

import os

from ..config.node import parse_config_text
from .h36m import H36M
from .synthetic_dataset import SyntheticDataset
from .zju import Mocap, MocapInfer, MocapView


class MyCfg:
    pass


def set_my_cfg(mycfg: MyCfg, data_config: dict) -> MyCfg:
    for key, value in data_config.items():
        if isinstance(value, dict):
            sub = MyCfg()
            set_my_cfg(sub, value)
            setattr(mycfg, key, sub)
        else:
            setattr(mycfg, key, value)
    return mycfg


def _read_data_config(yml_path: str) -> dict:
    with open(yml_path, "r", encoding="utf-8") as f:
        return parse_config_text(f.read(), yml_path)


def load_yml_as_cfg(yml_path: str) -> MyCfg:
    return set_my_cfg(MyCfg(), _read_data_config(yml_path))


def resolve_data_config(rel: str) -> str:
    """A data_configs/... path: relative to the working directory first,
    then to the repository root."""
    if os.path.exists(rel):
        return rel
    here = os.path.join(os.path.dirname(__file__), "..", "..", rel)
    return os.path.normpath(here)


def _data_config_path(cfg) -> str:
    return resolve_data_config(f"data_configs/{cfg.DATASETS.TYPE}/{cfg.DATASETS.HUMAN}.yml")


def _synthetic(cfg, train_nrays, formal_test):
    ds = cfg.DATASETS
    size = dict(
        n_frames=ds.SYNTHETIC_FRAMES,
        n_views=ds.SYNTHETIC_VIEWS,
        h=ds.SYNTHETIC_SIZE,
        w=ds.SYNTHETIC_SIZE,
        # "capsule" = the smooth essence field, "capsule_hf" the textured one
        essence="textured" if ds.HUMAN in ("capsule_hf", "textured") else "smooth",
    )
    val_offset = ds.SYNTHETIC_VAL_VIEW_OFFSET
    if formal_test:
        return (
            SyntheticDataset(split="val", view_offset=val_offset, **size),
            SyntheticDataset(split="val", view_offset=val_offset, **size),
        )
    train = SyntheticDataset(split="train", nrays=train_nrays, **size)
    val = SyntheticDataset(split="val", view_offset=val_offset, **size)
    return train, val


def select_dataset(cfg, train_nrays=2000, formal_test=False):
    if cfg.DATASETS.TYPE == "synthetic":
        return _synthetic(cfg, train_nrays, formal_test)
    if cfg.DATASETS.TYPE not in ("zju_mocap", "h36m"):
        raise ValueError(f"Unknown dataset type: {cfg.DATASETS.TYPE}")

    data_config = _read_data_config(_data_config_path(cfg))

    if cfg.DATASETS.TYPE == "zju_mocap":
        data_dir = os.environ.get("DSNERF_ZJU_PATH", cfg.DATASETS.ZJU_MOCAP_PATH)
        tr = data_config["Train"]
        train_max_frame = tr["end"] - tr["begin"] + 1
        if formal_test:
            te = data_config["Test"]
            common = dict(
                human=cfg.DATASETS.HUMAN, ratio=te["ratio"], begin=te["begin"],
                end=te["end"], train_views=tr["views"],
                train_max_frame=train_max_frame, interval=te["intv"],
                eval_begin_frame=te["novel_pose_begin"], data_dir=data_dir,
            )
            return (
                MocapInfer(novel_pose=False, **common),
                MocapInfer(novel_pose=True, **common),
            )
        train_set = Mocap(
            cfg.DATASETS.HUMAN, tr["ratio"], train_nrays, tr["begin"],
            tr["end"], tr["views"], data_dir=data_dir,
        )
        va = data_config["Val"]
        val_set = MocapView(
            cfg.DATASETS.HUMAN, va["ratio"], va["begin"], va["end"],
            tr["views"], train_max_frame, interval=va["intv"],
            data_dir=data_dir,
        )
        return train_set, val_set

    mycfg = set_my_cfg(MyCfg(), data_config)
    data_dir = os.environ.get("DSNERF_H36M_PATH", cfg.DATASETS.H36M_PATH)
    data_root = f"{data_dir}/{cfg.DATASETS.HUMAN}/Posing"
    ann_file = f"{data_root}/annots.npy"
    if formal_test:
        return (
            H36M(mycfg, data_root, cfg.DATASETS.HUMAN, ann_file, "test",
                 train_nrays, test_novel_pose=False, is_eval=True, is_formal=True),
            H36M(mycfg, data_root, cfg.DATASETS.HUMAN, ann_file, "test",
                 train_nrays, test_novel_pose=True, is_eval=True, is_formal=True),
        )
    train_set = H36M(
        mycfg, data_root, cfg.DATASETS.HUMAN, ann_file, "train",
        train_nrays, test_novel_pose=False, is_eval=False,
    )
    val_set = H36M(
        mycfg, data_root, cfg.DATASETS.HUMAN, ann_file, "test",
        train_nrays, test_novel_pose=True, is_eval=True, is_formal=False,
    )
    return train_set, val_set
