"""The golden render: the port's render of fixed rays against the JAX
package's, on the CPU (tests) and on the card (`chip_smoke.py`).

`tests/fixtures/torch_port_render_golden.npz` (written by
`tests/test_torch_port_golden.py`) holds 2048 rays of the synthetic 512x512
val image and the JAX package's CPU renders of them with the trained
fixture `bench/r5/abhq_exact_s233_params.npz`, in two legs:
``gg`` (the slice end to end) and ``fixed`` (near/far held at the JAX GG
result, uniform sampling). `check_golden` holds a render to the bands that
`tests/test_torch_port_golden.py` states and explains.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_NPZ = os.path.join(_REPO, "tests", "fixtures", "torch_port_render_golden.npz")
TRAINED_NPZ = os.path.join(_REPO, "bench", "r5", "abhq_exact_s233_params.npz")

#: per-output bands; depth is relative to max(1, |depth|)
BANDS = {"color": 5e-4, "acc": 1e-4, "depth": 1e-4, "disp": 1e-4}
#: per leg: the share of rays that must sit within the bands; every ray
#: must sit within FACTOR times them (see tests/test_torch_port_golden.py)
SHARE = {"fixed": 0.99, "gg": 0.97}
FACTOR = 50.0


def slice_cfg():
    """The eval slice's config: `configs/zju_mocap/313.yml` semantics (64 GG
    samples, full shading, no face reuse, no fine pass), the brute-force
    search, and the trained fixture's 16-frame embedding."""
    from ..config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.MODEL.COARSE_RAY_SAMPLING = 64
    cfg.MODEL.FINE_RAY_SAMPLING = -1
    cfg.MODEL.sample_points_mode = "GG"
    cfg.MODEL.SHADE_TOPK = 0
    cfg.MODEL.REUSE_WARP_FACES = False
    cfg.MODEL.KNN_IMPL = "pallas"
    cfg.MODEL.MAX_FRAMES = 16
    cfg.TEST.RAY_CHUNK = 8192
    return cfg


def trained_model(max_frames: int = 16):
    """DualSpaceNeRF carrying the trained fixture's weights (on the CPU)."""
    from ..models import DualSpaceNeRF, load_flax_npz

    model = DualSpaceNeRF(max_frames=max_frames)
    model.load_state_dict(load_flax_npz(TRAINED_NPZ))
    return model


def golden_items(rays: dict) -> dict:
    """The two legs' items: every golden ray in a 1 x n "image"."""
    n = rays["ray_o"].shape[0]
    base = {
        "img": np.zeros((1, n, 3), np.float32),
        "mask_at_box": np.ones(n, bool),
        "ray_o": rays["ray_o"],
        "ray_d": rays["ray_d"],
        "xyz": rays["xyz"],
        "poses": rays["poses"],
        "frame": 0,
    }
    return {
        "gg": {**base, "near": rays["near"], "far": rays["far"]},
        "fixed": {**base, "near": rays["gg_near"], "far": rays["gg_far"]},
    }


def render_golden(rays: dict, device, chunk: int = 8192, model=None) -> dict:
    """The port's render of the golden rays, both legs: {"<leg>/<output>":
    (n, c) float32}."""
    from ..data import SyntheticDataset
    from ..renderer import RenderSettings
    from .render_image import ImageRenderer

    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=8, w=8)
    settings = RenderSettings.from_cfg(slice_cfg())
    model = trained_model() if model is None else model
    out = {}
    for leg, item in golden_items(rays).items():
        s = settings if leg == "gg" else dataclasses.replace(settings, sample_mode="uniform")
        img = ImageRenderer(model, s, np.asarray(ds.faces), ds.canonical_vertex,
                            chunk=chunk, device=device).render_item(item)
        for k in BANDS:
            out[f"{leg}/{k}"] = img[f"coarse_{k}"].reshape(len(item["ray_o"]), -1)
    return out


def _ray_errors(out: dict, ref: dict, leg: str) -> dict:
    """Per-ray error over its band, for each output (<= 1 is inside)."""
    acc = ref[f"{leg}/acc"].reshape(-1)
    errs = {}
    for k, band in BANDS.items():
        a, b = out[f"{leg}/{k}"], ref[f"{leg}/{k}"]
        err = np.abs(a - b).max(axis=1)
        if k == "depth":
            err = err / np.maximum(1.0, np.abs(b).max(axis=1))
        if k == "disp":
            err = np.where(acc > 1e-3, err, 0.0)
        errs[k] = err / band
    return errs


def check_golden(out: dict, ref: dict) -> dict:
    """Hold a render of the golden rays to the bands. Returns a report with
    ``ok`` and, per leg and output, the worst error over its band and the
    share of rays within it."""
    report = {"ok": True}
    for leg in ("fixed", "gg"):
        finite = all(
            np.isfinite(out[f"{leg}/{k}"]).all() for k in BANDS if k != "disp"
        )
        report[f"{leg}/finite"] = bool(finite)
        report["ok"] &= bool(finite)
        for k, err in _ray_errors(out, ref, leg).items():
            share, worst = float((err <= 1.0).mean()), float(err.max())
            report[f"{leg}/{k}"] = {"worst_over_band": worst, "share_within": share}
            report["ok"] &= share >= SHARE[leg] and worst <= FACTOR
    return report
