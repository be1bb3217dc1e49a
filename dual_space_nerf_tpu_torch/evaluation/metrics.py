"""Image quality metrics: PSNR = -10 log10(MSE), with an optional mask.
SSIM, which the JAX package computes through cv2, is not ported yet."""

from __future__ import annotations

import numpy as np


def mse(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray | None = None) -> float:
    err = (np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2
    if mask is not None:
        err = err[np.asarray(mask, bool)]
    return float(err.mean())


def psnr(pred, gt, mask=None) -> float:
    return float(-10.0 * np.log10(mse(pred, gt, mask)))
