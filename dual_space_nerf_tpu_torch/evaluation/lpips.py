"""LPIPS, the reference's perceptual metric (`test.py:18-23, 77-85`), as a
functional torch network on the JAX package's weights npz (the port of
`evaluation/lpips_jax.py` and `evaluation/lpips.py`).

A frozen AlexNet or VGG16 feature stack (torchvision's `.features` layout),
the `lpips.ScalingLayer` on the input, channel unit-normalisation of each
stage's activations (eps 1e-10), squared differences weighted by the 1x1
"lin" heads, a spatial mean, summed over the five stages. Plain library
convolutions (`F.conv2d`, cuDNN on the card): the JAX package runs them in
XLA, with no kernel of its own. They run in IEEE float32 (TF32 off inside
the call), so the card's score is the CPU's to float32 rounding.

Input protocol of the reference: HxWx3 images in [0, 1], BGR (cv2 order),
flipped to RGB and scaled to (-1, 1).

npz schema (float32 arrays; `tool/convert_lpips_weights.py` writes it from
the `lpips` package's pretrained weights on a machine that has them):
  meta/net            "alex" | "vgg"
  convN/kernel        (H, W, Cin, Cout)   feature convs, HWIO
  convN/bias          (Cout,)
  linN/kernel         (1, 1, C, 1)        LPIPS heads, N = 0..4
"""

from __future__ import annotations

import os
import zipfile
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device, true_fp32

# lpips.ScalingLayer constants (RGB order)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (kernel, stride, pad, pool_before) per conv, torchvision .features layout
_ALEX = [
    (11, 4, 2, False),  # conv1 -> relu        (64)
    (5, 1, 2, True),    # pool, conv2 -> relu  (192)
    (3, 1, 1, True),    # pool, conv3 -> relu  (384)
    (3, 1, 1, False),   # conv4 -> relu        (256)
    (3, 1, 1, False),   # conv5 -> relu        (256)
]
# vgg16: conv count per slice (all k3 s1 p1), pool between slices
_VGG_SLICES = [2, 2, 3, 3, 3]
_ALEX_CH = [64, 192, 384, 256, 256]
_VGG_CH = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
_VGG_HEADS = [64, 128, 256, 512, 512]


def _conv(params: dict, i: int, x: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    return F.relu(F.conv2d(x, params[f"conv{i}/kernel"], params[f"conv{i}/bias"],
                           stride=stride, padding=pad))


def lpips_features(params: dict, x: torch.Tensor, net: str) -> list:
    """x (1, 3, H, W) scaled RGB -> the five stages' activations, NCHW.
    ``params`` holds the convs as OIHW (`load_lpips_params`)."""
    feats = []
    if net == "alex":
        for i, (_, s, p, pool) in enumerate(_ALEX):
            if pool:
                x = F.max_pool2d(x, 3, 2)
            x = _conv(params, i, x, s, p)
            feats.append(x)
    elif net == "vgg":
        ci = 0
        for si, n_convs in enumerate(_VGG_SLICES):
            if si > 0:
                x = F.max_pool2d(x, 2, 2)
            for _ in range(n_convs):
                x = _conv(params, ci, x, 1, 1)
                ci += 1
            feats.append(x)
    else:
        raise ValueError(f"unknown lpips net {net!r}")
    return feats


def scale_input(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB in (-1, 1) -> (1, 3, H, W) after the scaling layer."""
    shift = torch.tensor(_SHIFT, dtype=img.dtype, device=img.device)
    scale = torch.tensor(_SCALE, dtype=img.dtype, device=img.device)
    return ((img - shift) / scale).permute(2, 0, 1)[None]


def lpips_distance(params: dict, img0: torch.Tensor, img1: torch.Tensor, net: str = "alex") -> torch.Tensor:
    """img0 / img1 (H, W, 3) RGB in (-1, 1) -> the 0-d LPIPS distance, on
    the images' device (``params`` there too)."""
    with torch.no_grad(), true_fp32():
        f0 = lpips_features(params, scale_input(img0), net)
        f1 = lpips_features(params, scale_input(img1), net)
        total = img0.new_zeros(())
        for i, (a, b) in enumerate(zip(f0, f1)):
            na = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
            nb = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
            w = params[f"lin{i}/kernel"].reshape(1, -1, 1, 1)
            total = total + (((na - nb) ** 2) * w).sum(1).mean()
    return total


def load_lpips_params(npz_path: str, device=None) -> tuple[dict, str]:
    """The weights npz -> (params on ``device`` with the convs as OIHW, net
    name; "alex" when the file names none)."""
    with np.load(npz_path, allow_pickle=False) as data:
        net = str(data["meta/net"]) if "meta/net" in data.files else "alex"
        params = {}
        for k in data.files:
            if k.startswith("meta"):
                continue
            v = torch.as_tensor(np.asarray(data[k], np.float32))
            if k.startswith("conv") and k.endswith("/kernel"):
                v = v.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            params[k] = v.to(device)
    return params, net


def random_lpips_params(net: str, rng: np.random.Generator) -> dict:
    """Seeded random weights in the npz layout (HWIO convs, lin heads), as
    the JAX package's LPIPS tests draw them: for checks of the arithmetic
    where the pretrained weights are not at hand."""
    if net == "alex":
        specs = [(3, _ALEX_CH[0], 11)] + [
            (_ALEX_CH[i - 1], _ALEX_CH[i], _ALEX[i][0]) for i in range(1, 5)]
        heads = _ALEX_CH
    elif net == "vgg":
        specs, cin = [], 3
        for cout in _VGG_CH:
            specs.append((cin, cout, 3))
            cin = cout
        heads = _VGG_HEADS
    else:
        raise ValueError(f"unknown lpips net {net!r}")
    params = {}
    for i, (ci, co, k) in enumerate(specs):
        params[f"conv{i}/kernel"] = (rng.standard_normal((k, k, ci, co)) * 0.05).astype(np.float32)
        params[f"conv{i}/bias"] = (rng.standard_normal(co) * 0.01).astype(np.float32)
    for i, c in enumerate(heads):
        params[f"lin{i}/kernel"] = np.abs(rng.standard_normal((1, 1, c, 1)) * 0.1).astype(np.float32)
    return params


def _to_model_input(img_hw3: np.ndarray, device) -> torch.Tensor:
    """[0, 1] BGR (H, W, 3) -> (-1, 1) RGB (H, W, 3) float32 on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(2.0 * img_hw3[..., ::-1] - 1.0, np.float32),
                           device=device)


def make_lpips_npz(net: str = "alex", weights_path: str = "", device=None) -> Callable | None:
    """fn(pred_hw3, gt_hw3) -> float (images in [0, 1], BGR) from a weights
    npz, or None. ``weights_path`` is a file (its meta/net must be ``net``)
    or a directory holding ``lpips_{net}.npz``."""
    path = weights_path
    if path and os.path.isdir(path):
        path = os.path.join(path, f"lpips_{net}.npz")
    if not path or not os.path.exists(path):
        return None
    dev = resolve_device(device)
    params, stored_net = load_lpips_params(path, dev)
    if stored_net != net:
        return None

    def run(pred: np.ndarray, gt: np.ndarray) -> float:
        return float(lpips_distance(params, _to_model_input(pred, dev), _to_model_input(gt, dev), net))

    return run


def make_lpips(net: str = "alex", weights_path: str = "", device=None) -> Callable | None:
    """fn(pred_hw3, gt_hw3) -> float (images in [0, 1], BGR), or None when
    no weights resolve. The JAX package's routes in its order: the weights
    npz at ``weights_path`` (`make_lpips_npz`, on ``device``: the card unless
    the caller passes another), else the `lpips` package if it imports and
    its weights load, else a TorchScript module at ``weights_path``
    (these two on the CPU, as in the JAX package)."""
    if weights_path:
        try:
            fn = make_lpips_npz(net, weights_path, device)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):  # not an npz
            fn = None
        if fn is not None:
            return fn
    try:
        import lpips as _lpips  # optional package
        model = _lpips.LPIPS(net=net).eval()
    except Exception:  # absent, or its weights do not load (no network)
        model = None
    if model is None and weights_path and os.path.isfile(weights_path):
        try:
            model = torch.jit.load(weights_path, map_location="cpu").eval()
        except (RuntimeError, ValueError, OSError):
            return None
    if model is None:
        return None

    def run(pred: np.ndarray, gt: np.ndarray) -> float:
        with torch.no_grad():
            p = _to_model_input(pred, "cpu").permute(2, 0, 1)[None]
            g = _to_model_input(gt, "cpu").permute(2, 0, 1)[None]
            return float(model(p, g).squeeze())

    return run
