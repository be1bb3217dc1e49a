"""Dataset selection from the config, as the JAX package's
`data/select.py::select_dataset`: (train, val) datasets, or with
``formal_test`` the (novel view, novel pose) pair. Only the asset-free
"synthetic" type is ported; its datasets take their size from
DATASETS.SYNTHETIC_* and their essence field from DATASETS.HUMAN.
"""

from __future__ import annotations

from .synthetic_dataset import SyntheticDataset


def select_dataset(cfg, train_nrays=2000, formal_test=False):
    ds = cfg.DATASETS
    if ds.TYPE in ("zju_mocap", "h36m"):
        raise NotImplementedError(
            f"DATASETS.TYPE {ds.TYPE!r}: the real-data datasets are not ported yet "
            "(ROADMAP.md queue 1, item 4); use 'synthetic'"
        )
    if ds.TYPE != "synthetic":
        raise ValueError(f"Unknown dataset type: {ds.TYPE}")
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
