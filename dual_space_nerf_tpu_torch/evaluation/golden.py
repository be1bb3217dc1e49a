"""The golden render: the port's render of fixed rays against the JAX
package's, on the CPU (tests) and on the card (`chip_smoke.py`).

`tests/fixtures/torch_port_render_golden.npz` (written by
`tests/test_torch_port_golden.py`) holds 2048 rays of the synthetic 512x512
val image and the JAX package's CPU renders of them with the trained
fixture `bench/r5/abhq_exact_s233_params.npz`, in three legs:
``gg`` (the exact slice end to end), ``fixed`` (near/far held at the JAX GG
result, uniform sampling) and ``prod`` (the production path: the fixed leg's
z with SHADE_TOPK 16 and REUSE_WARP_FACES). `check_golden` holds a render to
the bands that `tests/test_torch_port_golden.py` states and explains.
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
SHARE = {"fixed": 0.99, "gg": 0.97, "prod": 0.99}
FACTOR = 50.0
LEGS = ("fixed", "gg", "prod")


def slice_cfg():
    """The eval slice's config: `configs/zju_mocap/313.yml` semantics (64 GG
    samples, full shading, no face reuse, no fine pass), the brute-force
    search, the plain network chain (`MODEL.FUSED_MLP` "off", which "auto"
    resolves to on the CPU only), and the trained fixture's 16-frame
    embedding."""
    from ..config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.MODEL.COARSE_RAY_SAMPLING = 64
    cfg.MODEL.FINE_RAY_SAMPLING = -1
    cfg.MODEL.sample_points_mode = "GG"
    cfg.MODEL.SHADE_TOPK = 0
    cfg.MODEL.REUSE_WARP_FACES = False
    cfg.MODEL.KNN_IMPL = "pallas"
    cfg.MODEL.FUSED_MLP = "off"
    cfg.MODEL.MAX_FRAMES = 16
    cfg.TEST.RAY_CHUNK = 8192
    return cfg


def production_cfg():
    """The production serving config: `configs/zju_mocap/313_tpu.yml`
    semantics (`slice_cfg` plus SHADE_TOPK 16 and REUSE_WARP_FACES) with the
    list-driven exact search."""
    cfg = slice_cfg()
    cfg.MODEL.SHADE_TOPK = 16
    cfg.MODEL.REUSE_WARP_FACES = True
    cfg.MODEL.KNN_IMPL = "listed"
    return cfg


def train_cfg(production: bool, fused: bool):
    """One training step's config, as `bench.py`'s train workload runs it:
    `production_cfg` (313_tpu.yml semantics, the listed search) or
    `slice_cfg` (313.yml, brute force), with 313.yml's SOLVER block (Adam at
    5e-4, no weight decay, the reference schedule), 5500 rays per step, L2
    loss, and `MODEL.FUSED_MLP` "on" or "off"."""
    cfg = production_cfg() if production else slice_cfg()
    cfg.MODEL.FUSED_MLP = "on" if fused else "off"
    cfg.MODEL.LOSS = "L2"
    cfg.MODEL.LOSSwMask = False
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    cfg.SOLVER.BASE_LR = 0.0005
    cfg.SOLVER.WEIGHT_DECAY = 0.0
    cfg.SOLVER.START_ITERS = 3000
    cfg.SOLVER.END_ITERS = 60000
    cfg.SOLVER.LR_SCALE = 0.09
    cfg.SOLVER.WARMUP_ITERS = 1000
    cfg.SOLVER.TRAIN_NRAYS = 5500
    return cfg


def trained_model(max_frames: int = 16, compute_dtype=None):
    """DualSpaceNeRF carrying the trained fixture's weights (on the CPU), at
    ``compute_dtype`` (`models/spacenet.py`; None: float32)."""
    from ..models import DualSpaceNeRF, load_flax_npz

    model = DualSpaceNeRF(max_frames=max_frames, compute_dtype=compute_dtype)
    model.load_state_dict(load_flax_npz(TRAINED_NPZ))
    return model


def golden_items(rays: dict) -> dict:
    """The legs' items: every golden ray in a 1 x n "image"."""
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
        "prod": {**base, "near": rays["gg_near"], "far": rays["gg_far"]},
    }


def leg_settings(leg: str, exact, production):
    """A leg's settings from the exact and the production `RenderSettings`
    (of either package): ``gg`` is the exact path as it is, ``fixed`` and
    ``prod`` sample uniformly between the item's near/far."""
    if leg == "gg":
        return exact
    return dataclasses.replace(production if leg == "prod" else exact, sample_mode="uniform")


def render_golden(rays: dict, device, chunk: int = 8192, model=None,
                  legs: tuple = LEGS, knn_impl: str | None = None) -> dict:
    """The port's render of the golden rays, leg by leg: {"<leg>/<output>":
    (n, c) float32, copied to the host as float32 whatever
    DSNERF_EVAL_PACK says}. knn_impl: the search of every leg; None keeps
    the configs' (brute force on the exact legs, "listed" on ``prod``)."""
    from ..data import SyntheticDataset
    from ..renderer import RenderSettings
    from .render_image import ImageRenderer

    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=8, w=8)
    exact = RenderSettings.from_cfg(slice_cfg())
    production = RenderSettings.from_cfg(production_cfg())
    model = trained_model() if model is None else model
    items = golden_items(rays)
    out = {}
    for leg in legs:
        s = leg_settings(leg, exact, production)
        if knn_impl is not None:
            s = dataclasses.replace(s, knn_impl=knn_impl)
        img = ImageRenderer(model, s, np.asarray(ds.faces), ds.canonical_vertex,
                            chunk=chunk, device=device, pack="f32").render_item(items[leg])
        for k in BANDS:
            out[f"{leg}/{k}"] = img[f"coarse_{k}"].reshape(len(items[leg]["ray_o"]), -1)
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
    ``ok`` and, per leg of ``out`` and output, the worst error over its band
    and the share of rays within it."""
    report = {"ok": True}
    for leg in (leg for leg in LEGS if f"{leg}/color" in out):
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
