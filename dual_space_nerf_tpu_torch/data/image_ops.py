"""The cv2 image operations of the real-data datasets, in numpy, each with
cv2's arithmetic so that its output equals cv2's (OpenCV 5.0) on the same
input (`tests/test_torch_port_data.py`):

- `resize_area`: ``cv2.resize(..., interpolation=cv2.INTER_AREA)`` for an
  integral down-scale (cv2's "fast area" path), uint8 and float32;
- `resize_nearest`: ``cv2.resize(..., interpolation=cv2.INTER_NEAREST)``;
- `dilate` / `erode` with a square kernel of ones, cv2's default anchor
  (the kernel's centre, ``k // 2``) and border (pixels outside the image
  never win);
- `rodrigues`: ``cv2.Rodrigues(rvec)[0]``, rotation vector to matrix.

Output sizes follow cv2: ``size`` is (width, height), as cv2's ``dsize``;
without it, ``fx`` and ``fy`` scale the input size, rounded half to even.
Shapes follow cv2 too: an (H, W, 1) input comes back as (h, w).
"""

from __future__ import annotations

import numpy as np


def cv_shape(out: np.ndarray) -> np.ndarray:
    """cv2 hands a one-channel result back as a 2-D array."""
    return out[..., 0] if out.ndim == 3 and out.shape[2] == 1 else out


def _out_size(shape, size, fx, fy) -> tuple[int, int]:
    """cv2.resize's destination (height, width)."""
    h, w = shape[:2]
    if size is not None and tuple(size) != (0, 0):
        return int(size[1]), int(size[0])
    if not fx or not fy:
        raise ValueError("resize: give size=(width, height) or both fx and fy")
    return int(np.rint(h * fy)), int(np.rint(w * fx))


def resize_area(img: np.ndarray, size=None, fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(img, size, fx=fx, fy=fy, interpolation=cv2.INTER_AREA)``
    where the source is an integral multiple of the destination in each
    axis (cv2's `resizeAreaFast`): the mean of each k_y x k_x cell.

    uint8: ``(sum + area / 2) >> log2(area)`` for a 2 x 2 cell, the sum
    times ``1/area`` in float32, rounded half to even, for other cells.
    float32: the cell's sum in float32 in cv2's order, times ``1/area``.
    A destination row or column that runs past the source (an odd size
    rounded up) averages the source pixels it covers."""
    src = np.asarray(img)
    oh, ow = _out_size(src.shape, size, fx, fy)
    h, w = src.shape[:2]
    if fx and fy and (size is None or tuple(size) == (0, 0)):
        sx, sy = 1.0 / fx, 1.0 / fy
    else:
        sx, sy = w / ow, h / oh
    kx, ky = int(round(sx)), int(round(sy))
    if abs(sx - kx) >= np.finfo(np.float64).eps or abs(sy - ky) >= np.finfo(np.float64).eps \
            or kx < 1 or ky < 1:
        raise NotImplementedError(
            f"resize_area: only integral down-scales are ported, got {w}x{h} -> {ow}x{oh}")
    if src.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_area: uint8 or float32 images, got {src.dtype}")
    x3 = src.reshape(h, w, -1)
    fh, fw = min(oh, h // ky), min(ow, w // kx)  # cells wholly inside the source
    # the cell's pixels in row-major order, as strided views of the source
    px = [x3[yy:fh * ky:ky, xx:fw * kx:kx] for yy in range(ky) for xx in range(kx)]
    out = np.zeros((oh, ow, x3.shape[2]), src.dtype)
    if src.dtype == np.uint8:
        acc = px[0].astype(np.int32)
        for p in px[1:]:
            acc += p
        if kx == 2 and ky == 2:
            out[:fh, :fw] = ((acc + 2) >> 2).astype(np.uint8)
        else:
            v = acc.astype(np.float32) * np.float32(1.0 / (kx * ky))
            out[:fh, :fw] = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    else:
        # cv2's loop: four at a time (sum += ((a + b) + c) + d), then one at a time
        acc = np.zeros(px[0].shape, np.float32)
        n4 = len(px) // 4 * 4
        for i in range(0, n4, 4):
            acc = acc + (((px[i] + px[i + 1]) + px[i + 2]) + px[i + 3])
        for i in range(n4, len(px)):
            acc = acc + px[i]
        out[:fh, :fw] = acc * np.float32(1.0 / (kx * ky))
    # destination pixels whose cell runs past the source: the mean of what is inside
    edge = [(oy, ox) for oy in range(fh, oh) for ox in range(ow)]
    edge += [(oy, ox) for oy in range(fh) for ox in range(fw, ow)]
    for oy, ox in edge:
        y0, x0 = oy * ky, ox * kx
        patch = x3[y0:min(y0 + ky, h), x0:min(x0 + kx, w)]
        if patch.size == 0:
            continue
        mean = patch.astype(np.float32).sum(axis=(0, 1)) / np.float32(
            patch.shape[0] * patch.shape[1])
        out[oy, ox] = (np.clip(np.rint(mean), 0, 255).astype(np.uint8)
                       if src.dtype == np.uint8 else mean)
    return cv_shape(out.reshape((oh, ow) + src.shape[2:]))


def resize_nearest(img: np.ndarray, size=None, fx: float = 0.0, fy: float = 0.0) -> np.ndarray:
    """``cv2.resize(img, size, fx=fx, fy=fy, interpolation=cv2.INTER_NEAREST)``:
    destination pixel (x, y) takes source (floor(x * w / ow), floor(y * h /
    oh)), clamped to the image, with the scale taken as cv2 takes it (1/fx
    when fx is given)."""
    src = np.asarray(img)
    oh, ow = _out_size(src.shape, size, fx, fy)
    h, w = src.shape[:2]
    if fx and fy and (size is None or tuple(size) == (0, 0)):
        ifx, ify = 1.0 / fx, 1.0 / fy
    else:
        ifx, ify = w / ow, h / oh
    xs = np.minimum(np.floor(np.arange(ow) * ifx).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(oh) * ify).astype(np.int64), h - 1)
    return cv_shape(np.ascontiguousarray(src[ys][:, xs]))


def _morph(img: np.ndarray, k: int, reduce, fill) -> np.ndarray:
    """Separable rank filter over a k x k square anchored at (k//2, k//2):
    out[y, x] = reduce over src[y - a : y - a + k, x - a : x - a + k]."""
    src = np.asarray(img)
    a = k // 2
    pad = [(a, k - 1 - a), (a, k - 1 - a)] + [(0, 0)] * (src.ndim - 2)
    p = np.pad(src, pad, constant_values=fill)
    h, w = src.shape[:2]
    rows = p[0:h]
    for i in range(1, k):
        rows = reduce(rows, p[i:i + h])
    out = rows[:, 0:w]
    for j in range(1, k):
        out = reduce(out, rows[:, j:j + w])
    return cv_shape(np.ascontiguousarray(out))


def _kernel_size(kernel) -> int:
    kern = np.asarray(kernel)
    if kern.ndim != 2 or kern.shape[0] != kern.shape[1] or not np.all(kern == 1):
        raise NotImplementedError("dilate/erode: only square kernels of ones are ported")
    return int(kern.shape[0])


def _extreme(dtype, high: bool):
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return info.max if high else info.min
    return np.inf if high else -np.inf


def dilate(img: np.ndarray, kernel) -> np.ndarray:
    """``cv2.dilate(img, kernel)`` for a square kernel of ones."""
    src = np.asarray(img)
    return _morph(src, _kernel_size(kernel), np.maximum, _extreme(src.dtype, high=False))


def erode(img: np.ndarray, kernel) -> np.ndarray:
    """``cv2.erode(img, kernel)`` for a square kernel of ones."""
    src = np.asarray(img)
    return _morph(src, _kernel_size(kernel), np.minimum, _extreme(src.dtype, high=True))


def rodrigues(rvec) -> np.ndarray:
    """``cv2.Rodrigues(rvec)[0]``: R = cos(t) I + (1 - cos(t)) r r^T +
    sin(t) [r]_x with r = rvec / t, t = |rvec|, in float64 in cv2's order,
    returned in the input's float type (identity below DBL_EPSILON)."""
    v = np.asarray(rvec)
    if v.size != 3:
        raise NotImplementedError("rodrigues: only rotation vectors (3 values) are ported")
    out_dtype = v.dtype if v.dtype in (np.float32, np.float64) else np.float64
    x, y, z = (float(c) for c in v.astype(np.float64).ravel())
    theta = np.sqrt(x * x + y * y + z * z)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3, dtype=out_dtype)
    c, s = np.cos(theta), np.sin(theta)
    c1 = 1.0 - c
    it = 1.0 / theta
    x, y, z = x * it, y * it, z * it
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z], [x * z, y * z, z * z]])
    r_x = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    R = (c * np.eye(3) + c1 * rrt) + s * r_x
    return R.astype(out_dtype)
