"""PNG output without cv2, for the eval CLIs' image dumps.

`write_png(path, img)` writes what ``cv2.imwrite(path, img)`` writes for a
``.png`` path, pixel for pixel, with the same arithmetic:

- the last axis is taken as BGR, as cv2 takes the RGB arrays the CLIs hand
  it (so the file's red channel is ``img[..., 2]``); (H, W, 1) is grey;
- float values are rounded to nearest (ties to even) and saturated to
  uint8; NaN, infinities and values beyond the int32 range become 0, as
  cv2's conversion to 8 bits makes them.

The JAX package's `validate.py` writes ``.jpg``; the port writes ``.png``
under the same stems, because the card's machine has no JPEG encoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """cv2's conversion of an image to 8 bits: rint, saturate."""
    a = np.asarray(img)
    if a.dtype == np.uint8:
        return a
    if a.dtype.kind != "f":
        raise TypeError(f"write_png: expected a float or uint8 image, got {a.dtype}")
    with np.errstate(invalid="ignore"):
        r = np.rint(a.astype(np.float64))
        ok = np.isfinite(r) & (r >= -2.0**31) & (r < 2.0**31)
    return np.where(ok, np.clip(np.where(ok, r, 0.0), 0, 255), 0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) BGR or (H, W, 1) grey image as an 8-bit PNG."""
    a = np.asarray(img)
    if a.ndim != 3 or a.shape[2] not in (1, 3) or 0 in a.shape[:2]:
        raise ValueError(f"write_png: expected (H, W, 1) or (H, W, 3), got {a.shape}")
    px = _to_uint8(a)
    h, w, c = px.shape
    if c == 3:
        px = px[..., ::-1]  # BGR -> the file's RGB
    rows = np.concatenate([np.zeros((h, 1), np.uint8), px.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(np.ascontiguousarray(rows).tobytes(), 6))
                + _chunk(b"IEND", b""))
