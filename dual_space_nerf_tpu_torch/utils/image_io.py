"""Image files without cv2: the readers of the real-data datasets and the
PNG writer of the eval CLIs.

`imread(path)` returns what ``cv2.imread(path)`` returns, pixel for pixel:
BGR uint8, (H, W, 3), a grey file replicated into the three channels.

- JPEG: baseline (sequential Huffman) files, decoded by
  `csrc/jpeg_decode.c`, which follows libjpeg's default decode path (the
  integer "islow" IDCT, fancy chroma upsampling, the fixed-point YCbCr
  tables, restart markers). Progressive and arithmetic-coded files are
  refused, naming the marker. The library is built with the system C
  compiler at first use into `_build/` (`ops/cuda_build.py::HostLibrary`);
  a failed build is an error, as there is nothing to fall back to.
- PNG: zlib inflates the IDAT stream and `csrc/png_unfilter.c` undoes the
  row filters. Bit depth 8, not interlaced: grey, grey + alpha, RGB, RGBA
  and palette; the alpha channel is dropped, as cv2's colour read drops
  it. Anything else is refused, naming what.

The decoders run in native code called through ctypes, which releases the
GIL, so the loader's threads decode in parallel; they start no threads of
their own, so a forked loader worker needs no setting (the JAX package pins
cv2's thread pool there, `data/prefetch.py:46`).

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

import ctypes
import struct
import zlib

import numpy as np

from ..ops.cuda_build import HostLibrary

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOI = b"\xff\xd8"

_JPEG = HostLibrary("jpeg_decode.c")
_PNG = HostLibrary("png_unfilter.c")
_ERR_LEN = 256


def _jpeg_functions():
    buf = ctypes.c_void_p
    header = _JPEG.function("dsn_jpeg_header", [buf, ctypes.c_int64, buf, ctypes.c_char_p,
                                                 ctypes.c_int])
    decode = _JPEG.function("dsn_jpeg_decode", [buf, ctypes.c_int64, buf, ctypes.c_char_p,
                                                 ctypes.c_int])
    return header, decode


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A baseline JPEG's pixels as cv2 decodes them: BGR uint8 (H, W, 3)."""
    header, decode = _jpeg_functions()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    dims = np.zeros(3, np.int32)
    if header(src.ctypes.data, src.size, dims.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((int(dims[0]), int(dims[1]), 3), np.uint8)
    if decode(src.ctypes.data, src.size, out.ctypes.data, err, _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def _png_chunks(data: bytes, name: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: PNG ends without IEND")


# colour type -> samples per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An 8-bit PNG's pixels as cv2's colour read gives them: BGR uint8
    (H, W, 3); grey replicated, alpha dropped, a palette looked up."""
    header, idat, palette = None, [], None
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype} is not supported")
    if depth != 8:
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported (8 only)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    channels = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = np.empty((h, w * channels), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    buf = ctypes.c_void_p
    unfilter = _PNG.function("dsn_png_unfilter", [buf, ctypes.c_int64, buf, ctypes.c_int32,
                                                   ctypes.c_int32, ctypes.c_int32,
                                                   ctypes.c_char_p, ctypes.c_int])
    if unfilter(raw.ctypes.data, raw.size, px.ctypes.data, h, w * channels, channels, err,
                _ERR_LEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    px = px.reshape(h, w, channels)
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{name}: palette index beyond PLTE")
        rgb = palette[px[..., 0]]
    elif ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` for JPEG and PNG files: BGR uint8 (H, W, 3).
    Unlike cv2, a file that cannot be read raises (FileNotFoundError, or
    ValueError naming what is not supported) instead of returning None."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, path)
    if data.startswith(JPEG_SOI):
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


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
