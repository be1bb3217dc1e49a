"""Image quality metrics, as the JAX package's `evaluation/metrics.py`:
PSNR = -10 log10(MSE) with an optional mask, and SSIM on the masked images
cropped to the mask's bounding box (the reference's protocol), without cv2.

SSIM has the defaults of skimage<=0.16's `compare_ssim(multichannel=True)`:
a 7x7 uniform window, K1 = 0.01, K2 = 0.03, the sample covariance, averaged
over channels. The window is `cv2.blur` with ``BORDER_REFLECT`` in the JAX
package, which is numpy's ``np.pad(mode="symmetric")`` (edge pixel
repeated), not ``"reflect"`` (cv2's ``BORDER_REFLECT_101``).
"""

from __future__ import annotations

import numpy as np


def mse(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray | None = None) -> float:
    err = (np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2
    if mask is not None:
        err = err[np.asarray(mask, bool)]
    return float(err.mean())


def psnr(pred, gt, mask=None) -> float:
    return float(-10.0 * np.log10(mse(pred, gt, mask)))


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """Mean over the size x size window centred on each pixel of a 2-D
    float64 image, the border mirrored with its edge pixel repeated."""
    h, w = img.shape
    p = size // 2
    padded = np.pad(img, p, mode="symmetric")
    rows = sum(padded[:, j:j + w] for j in range(size))
    return sum(rows[i:i + h] for i in range(size)) / (size * size)


def ssim(
    img1: np.ndarray,
    img2: np.ndarray,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean structural similarity, skimage-compatible (uniform window,
    sample covariance normalization), per-channel averaged."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1 = img1[..., None]
        img2 = img2[..., None]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    nw = win_size**2
    cov_norm = nw / (nw - 1)  # sample covariance (skimage default)

    vals = []
    for c in range(img1.shape[-1]):
        x = img1[..., c]
        y = img2[..., c]
        ux = _uniform_filter(x, win_size)
        uy = _uniform_filter(y, win_size)
        uxx = _uniform_filter(x * x, win_size)
        uyy = _uniform_filter(y * y, win_size)
        uxy = _uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1 = 2 * ux * uy + c1
        a2 = 2 * vxy + c2
        b1 = ux**2 + uy**2 + c1
        b2 = vx + vy + c2
        s = (a1 * a2) / (b1 * b2)
        # skimage crops the filter's edge effects before averaging
        pad = (win_size - 1) // 2
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def ssim_metric(rgb_pred: np.ndarray, rgb_gt: np.ndarray, mask_at_box: np.ndarray) -> float:
    """The reference protocol (`metrics.py:23-38`): zero outside the mask,
    crop to the mask's bounding box, then SSIM.

    data_range=2.0 reproduces the reference's numbers: it calls skimage's
    old `compare_ssim` on float64 images with no data_range, and skimage's
    range for floats is (-1, 1). An empty mask scores 1.0 (two all-zero
    images; the reference crashes there)."""
    H, W = rgb_gt.shape[:2]
    mask = np.asarray(mask_at_box).reshape(H, W).astype(bool)
    if not mask.any():
        return 1.0
    img_pred = np.zeros((H, W, 3))
    img_pred[mask] = np.asarray(rgb_pred)[mask]
    img_gt = np.zeros((H, W, 3))
    img_gt[mask] = np.asarray(rgb_gt)[mask]
    ys, xs = np.nonzero(mask)
    x, y = int(xs.min()), int(ys.min())
    w, h = int(xs.max()) - x + 1, int(ys.max()) - y + 1
    # a box narrower than the 7x7 window (subject clipped at the frame edge
    # or far away) leaves no interior pixel after the edge crop and the mean
    # would be NaN: widen it within the image
    win = 7
    if w < win:
        x = max(0, min(x - (win - w) // 2, W - win))
        w = min(win, W)
    if h < win:
        y = max(0, min(y - (win - h) // 2, H - win))
        h = min(win, H)
    return ssim(
        img_pred[y : y + h, x : x + w],
        img_gt[y : y + h, x : x + w],
        data_range=2.0,
    )
