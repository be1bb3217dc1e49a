"""Camera parameters and undistortion for ZJU-MoCap and Human3.6M, without
cv2, as the JAX package's `data/cameras.py`:

- `read_opencv_yaml`: the OpenCV-YAML files that ``cv2.FileStorage`` reads
  (intri.yml / extri.yml): ``%YAML:1.0``, ``!!opencv-matrix`` nodes with
  rows, cols, dt and data, and sequences such as ``names``. Anything else
  raises with file:line.
- `read_camera` / `load_cameras` (intri/extri.yml subjects) and `load_cam`
  (annots.npy for CoreView_313/315: T / 1000, cameras 20/21 named 22/23).
- `Undistorter`: ``cv2.initUndistortRectifyMap`` in the fixed-point
  CV_16SC2 encoding (5 fraction bits, numpy) and ``cv2.remap`` with
  bilinear weights of 15 bits (uint8) or float32 (C,
  `csrc/remap_linear.c`), bit for bit as cv2 computes them; an all-zero
  distortion is a no-op.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re

import numpy as np

from ..ops.cuda_build import HostLibrary
from .image_ops import cv_shape, rodrigues

INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
INTER_REMAP_COEF_BITS = 15


def _bilinear_tables() -> tuple[np.ndarray, np.ndarray]:
    """cv2's `initInterTab2D` for INTER_LINEAR: for each of the 32 x 32
    fractional offsets, the four weights (y0x0, y0x1, y1x0, y1x1) as float32
    products and as 15-bit integers. The integer weights of the zero offset
    saturate 32768 to 32767; cv2 then adds the missing 1 to its y1x1
    weight, and so does this table."""
    t = np.arange(INTER_TAB_SIZE, dtype=np.float32) * np.float32(1.0 / INTER_TAB_SIZE)
    c = np.stack([np.float32(1.0) - t, t], axis=1)
    v = c[:, None, :, None] * c[None, :, None, :]  # [ay, ax, k_y, k_x]
    iv = np.clip(np.rint(v.astype(np.float64) * (1 << INTER_REMAP_COEF_BITS)),
                 -32768, 32767).astype(np.int64)
    iv[..., 1, 1] += (1 << INTER_REMAP_COEF_BITS) - iv.sum(axis=(2, 3))
    n = INTER_TAB_SIZE * INTER_TAB_SIZE
    return v.reshape(n, 4), iv.reshape(n, 4)


_TAB_F, _TAB_I = _bilinear_tables()
_TAB_I32 = np.ascontiguousarray(_TAB_I, np.int32)
_REMAP = HostLibrary("remap_linear.c")


def _inv3(a: np.ndarray) -> np.ndarray:
    """cv2's closed-form 3 x 3 inverse (`invert` with DECOMP_LU, n = 3)."""
    d = (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
         - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
         + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))
    if d == 0.0:
        raise np.linalg.LinAlgError("camera matrix is singular")
    d = 1.0 / d
    t = np.empty((3, 3))
    t[0, 0] = (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]) * d
    t[0, 1] = (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * d
    t[0, 2] = (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * d
    t[1, 0] = (a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]) * d
    t[1, 1] = (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * d
    t[1, 2] = (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * d
    t[2, 0] = (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]) * d
    t[2, 1] = (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * d
    t[2, 2] = (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * d
    return t


def _matmul3(a, b) -> np.ndarray:
    """cv2's Matx33d product: each entry ((0 + a0 b0) + a1 b1) + a2 b2 in
    float64."""
    out = np.empty((3, 3))
    for i in range(3):
        for j in range(3):
            acc = 0.0
            for k in range(3):
                acc += float(a[i][k]) * float(b[k][j])
            out[i, j] = acc
    return out


def tilt_matrix(tau_x: float, tau_y: float) -> np.ndarray:
    """cv2's `computeTiltProjectionMatrix`: the trapezoidal projection of a
    sensor tilted by tauX about x and tauY about y, projZ(Ry Rx) @ (Ry Rx),
    with libm's cos and sin (math.cos / math.sin); the identity at 0, 0."""
    ctx, stx = math.cos(tau_x), math.sin(tau_x)
    cty, sty = math.cos(tau_y), math.sin(tau_y)
    rot_x = ((1.0, 0.0, 0.0), (0.0, ctx, stx), (0.0, -stx, ctx))
    rot_y = ((cty, 0.0, -sty), (0.0, 1.0, 0.0), (sty, 0.0, cty))
    rot_xy = _matmul3(rot_y, rot_x)
    proj_z = ((rot_xy[2, 2], 0.0, -rot_xy[0, 2]), (0.0, rot_xy[2, 2], -rot_xy[1, 2]), (0.0, 0.0, 1.0))
    return _matmul3(proj_z, rot_xy)


def undistort_maps(K, D, w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    """``cv2.initUndistortRectifyMap(K, D, None, K, (w, h), cv2.CV_16SC2)``:
    (map1 (h, w, 2) int16 integer source pixels, map2 (h, w) uint16
    fraction indices), for 4, 5, 8, 12 or 14 coefficients (k1 k2 p1 p2 [k3
    [k4 k5 k6 [s1 s2 s3 s4 [tauX tauY]]]]). Per row, the homogeneous
    coordinate starts at row * iK[:, 1] + iK[:, 2] and adds iK[:, 0] once
    per column, as cv2's loop does; the distorted point goes through the
    tilted sensor's projection (`tilt_matrix`, the identity without tau) and
    its projective divide; the rest is cv2's float64 arithmetic in its
    order."""
    K = np.asarray(K, np.float64)
    ir = _inv3(K).ravel()
    d = np.zeros(14)
    dv = np.asarray(D, np.float64).ravel()
    if dv.size not in (4, 5, 8, 12, 14):
        raise ValueError(f"distortion coefficients: 4, 5, 8, 12 or 14 values, got {dv.size}")
    d[:dv.size] = dv
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = d[:12]
    tilt = tilt_matrix(d[12], d[13])
    u0, v0, fx, fy = K[0, 2], K[1, 2], K[0, 0], K[1, 1]
    rows = np.arange(h, dtype=np.float64)[:, None]

    def walk(start, step):
        grid = np.empty((h, w))
        grid[:, :1] = start
        grid[:, 1:] = step
        return np.add.accumulate(grid, axis=1)  # sequential, as cv2's += step

    X = walk(rows * ir[1] + ir[2], ir[0])
    Y = walk(rows * ir[4] + ir[5], ir[3])
    Wh = walk(rows * ir[7] + ir[8], ir[6])
    iw = 1.0 / Wh
    x, y = X * iw, Y * iw
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2) + s1 * r2 + s2 * r2 * r2
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy + s3 * r2 + s4 * r2 * r2
    # vecTilt = tilt @ (xd, yd, 1), each entry ((0 + t0 xd) + t1 yd) + t2
    vec = [((0.0 + tilt[i, 0] * xd) + tilt[i, 1] * yd) + tilt[i, 2] for i in range(3)]
    nonzero = vec[2] != 0.0
    inv_proj = np.where(nonzero, 1.0 / np.where(nonzero, vec[2], 1.0), 1.0)
    u = fx * inv_proj * vec[0] + u0
    v = fy * inv_proj * vec[1] + v0
    lim = np.iinfo(np.int32)
    iu = np.clip(np.rint(u * INTER_TAB_SIZE), lim.min, lim.max).astype(np.int64)
    iv = np.clip(np.rint(v * INTER_TAB_SIZE), lim.min, lim.max).astype(np.int64)
    map1 = np.stack([iu >> INTER_BITS, iv >> INTER_BITS], axis=-1).astype(np.int16)
    mask = INTER_TAB_SIZE - 1
    map2 = ((iv & mask) * INTER_TAB_SIZE + (iu & mask)).astype(np.uint16)
    return map1, map2


def remap_linear(img: np.ndarray, map1: np.ndarray, map2: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map1, map2, cv2.INTER_LINEAR)`` with CV_16SC2 maps
    and the default constant border of 0, in C (`csrc/remap_linear.c`):
    uint8 with the 15-bit weights, rounded and shifted; float32 with the
    float weights, summed in order."""
    src = np.ascontiguousarray(img)
    if src.dtype not in (np.uint8, np.float32):
        raise TypeError(f"remap_linear: uint8 or float32 images, got {src.dtype}")
    H, W = src.shape[:2]
    c = 1 if src.ndim == 2 else int(src.shape[2])
    oh, ow = map2.shape
    m1 = np.ascontiguousarray(map1, np.int16)
    m2 = np.ascontiguousarray(map2, np.uint16)
    if m1.shape != (oh, ow, 2):
        raise ValueError(f"remap_linear: map1 {m1.shape} against map2 {m2.shape}")
    u8 = src.dtype == np.uint8
    tab = _TAB_I32 if u8 else _TAB_F
    out = np.empty((oh, ow) + src.shape[2:], src.dtype)
    buf, i32 = ctypes.c_void_p, ctypes.c_int32
    fn = _REMAP.function("dsn_remap_linear_u8" if u8 else "dsn_remap_linear_f32",
                         [buf, i32, i32, i32, buf, buf, buf, buf, i32, i32])
    fn(src.ctypes.data, H, W, c, m1.ctypes.data, m2.ctypes.data, tab.ctypes.data,
       out.ctypes.data, oh, ow)
    return cv_shape(out)


class Undistorter:
    """``cv2.undistort(img, K, D)`` with the maps cached per (K, D, size):
    per camera they are constant across a sequence. All-zero distortion is
    a no-op (the map is the identity). Entries are immutable once inserted,
    so the loader's threads share one instance; a lost race recomputes a
    map."""

    def __init__(self) -> None:
        self._maps: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}

    def __call__(self, img: np.ndarray, K, D) -> np.ndarray:
        D = np.asarray(D, np.float64).ravel()
        if not D.any():
            return img
        K = np.asarray(K, np.float64)
        h, w = img.shape[:2]
        key = (K.tobytes(), D.tobytes(), w, h)
        maps = self._maps.get(key)
        if maps is None:
            maps = undistort_maps(K, D, w, h)
            self._maps[key] = maps
        return remap_linear(img, *maps)


#: process-wide map cache shared by every dataset instance
undistort = Undistorter()


# ---------------------------------------------------------------------------
# OpenCV-YAML (cv2.FileStorage) files
# ---------------------------------------------------------------------------
_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16, "i": np.int32,
       "f": np.float32, "d": np.float64}
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)$")
_PLAIN = re.compile(r"^[A-Za-z_][A-Za-z0-9_.()+\- ]*$")
_SPECIAL = {".nan": float("nan"), ".inf": float("inf"), "-.inf": float("-inf"),
            "+.inf": float("inf")}


def _scalar(text: str, where: str):
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    if t.lower() in _SPECIAL:
        return _SPECIAL[t.lower()]
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    if _PLAIN.match(t):
        return t  # a plain (unquoted) string, as FileStorage writes "none"
    raise ValueError(f"{where}: not a number, a quoted or a plain string: {t!r}")


def _split_flow(body: str) -> list[str]:
    """The items of a flow sequence's body (no nesting), quotes kept."""
    items, cur, quote = [], "", ""
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = ""
        elif ch in "\"'":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    return [i for i in (s.strip() for s in items) if i]


def read_opencv_yaml(path: str) -> dict:
    """The top-level nodes of an OpenCV-YAML file: ``!!opencv-matrix`` ->
    ndarray (rows x cols, of dt), a sequence -> list, a scalar -> str / int
    / float. Raises ValueError naming file:line for anything else."""
    with open(path, "r", encoding="utf-8") as f:
        lines = f.read().split("\n")
    out: dict = {}
    i, n = 0, len(lines)

    def where(k):
        return f"{path}:{k + 1}"

    def flow(start_k, text):
        """A flow sequence ``[ ... ]`` starting in ``text``, maybe over lines."""
        k, body = start_k, text.strip()
        if not body.startswith("["):
            raise ValueError(f"{where(k)}: expected a '[' sequence")
        while "]" not in body:
            k += 1
            if k >= n:
                raise ValueError(f"{where(start_k)}: unterminated '[' sequence")
            body += " " + lines[k].strip()
        inner, rest = body[1:].split("]", 1)
        if rest.strip():
            raise ValueError(f"{where(k)}: text after ']': {rest.strip()!r}")
        return [_scalar(t, where(k)) for t in _split_flow(inner)], k

    while i < n:
        raw = lines[i]
        line = raw.rstrip()
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            i += 1
            continue
        if stripped.startswith("%YAML"):
            if i != 0 or stripped not in ("%YAML:1.0", "%YAML 1.0", "%YAML:1.2", "%YAML 1.2"):
                raise ValueError(f"{where(i)}: unsupported directive {stripped!r}")
            i += 1
            continue
        if stripped == "---":
            i += 1
            continue
        if line[0] in " \t":
            raise ValueError(f"{where(i)}: unexpected indented line {stripped!r}")
        m = _KEY.match(stripped)
        if not m:
            raise ValueError(f"{where(i)}: not a 'key: value' line: {stripped!r}")
        key, value = m.group(1), m.group(2).strip()
        if value == "!!opencv-matrix":
            fields: dict = {}
            i += 1
            while i < n and lines[i][:1] in (" ", "\t") and lines[i].strip():
                fm = _KEY.match(lines[i].strip())
                if not fm:
                    raise ValueError(f"{where(i)}: not a matrix field: {lines[i].strip()!r}")
                fkey, fval = fm.group(1), fm.group(2)
                if fkey == "data":
                    fields["data"], i = flow(i, fval)
                elif fkey in ("rows", "cols"):
                    fields[fkey] = int(fval)
                elif fkey == "dt":
                    fields["dt"] = fval.strip().strip("\"'")
                else:
                    raise ValueError(f"{where(i)}: unknown matrix field {fkey!r}")
                i += 1
            missing = {"rows", "cols", "dt", "data"} - set(fields)
            if missing:
                raise ValueError(f"{where(i - 1)}: matrix {key!r} lacks {sorted(missing)}")
            if fields["dt"] not in _DT:
                raise ValueError(f"{where(i - 1)}: matrix {key!r}: unsupported dt "
                                 f"{fields['dt']!r} (one channel only)")
            arr = np.array(fields["data"], dtype=_DT[fields["dt"]])
            if arr.size != fields["rows"] * fields["cols"]:
                raise ValueError(f"{where(i - 1)}: matrix {key!r} has {arr.size} values, "
                                 f"{fields['rows']}x{fields['cols']} expected")
            out[key] = arr.reshape(fields["rows"], fields["cols"])
            continue
        if value == "":
            seq = []
            i += 1
            while i < n and lines[i][:1] in (" ", "\t", "-") and lines[i].strip().startswith("-"):
                seq.append(_scalar(lines[i].strip()[1:], where(i)))
                i += 1
            out[key] = seq
            continue
        if value.startswith("!!") or value.startswith("{") or value.startswith("|") \
                or value.startswith(">"):
            raise ValueError(f"{where(i)}: unsupported node {value!r}")
        if value.startswith("["):
            out[key], i = flow(i, value)
        else:
            out[key] = _scalar(value, where(i))
        i += 1
    return out


def _read_string_list(nodes: dict, key: str) -> list[str]:
    """FileStorage's string sequence, as the JAX package reads it: numbers
    become their integer text, and "none" entries are dropped."""
    out = []
    for v in nodes.get(key, []):
        val = v if isinstance(v, str) else str(int(v))
        if val != "none":
            out.append(val)
    return out


def read_camera(intri_name: str, extri_name: str) -> dict:
    """{cam_name: {K, invK, R, T, RT, P, dist}} from OpenCV yml files."""
    for p in (intri_name, extri_name):
        if not os.path.exists(p):
            raise FileNotFoundError(p)
    intri = read_opencv_yaml(intri_name)
    extri = read_opencv_yaml(extri_name)
    cam_names = _read_string_list(intri, "names")
    cams: dict = {}
    for cam in cam_names:
        K = intri.get(f"K_{cam}")
        Rvec = extri.get(f"R_{cam}")
        Tvec = extri.get(f"T_{cam}")
        R = rodrigues(Rvec)
        RT = np.hstack((R, Tvec))
        cams[cam] = {
            "K": K,
            "invK": np.linalg.inv(K),
            "R": R,
            "T": Tvec,
            "RT": RT,
            "P": K @ RT,
            "dist": intri.get(f"dist_{cam}"),
        }
    cams["basenames"] = cam_names
    return cams


def load_cameras(path: str) -> dict:
    intri_name = os.path.join(path, "intri.yml")
    extri_name = os.path.join(path, "extri.yml")
    if os.path.exists(intri_name) and os.path.exists(extri_name):
        cameras = read_camera(intri_name, extri_name)
        cameras.pop("basenames")
        return cameras
    raise FileNotFoundError(f"no camera parameters under {path}")


def load_cam(ann_file: str) -> dict:
    """annots.npy/json camera table for CoreView_313/315: T in millimetres
    -> /1000; physical cameras 20/21 are named "Camera (22)"/"Camera (23)"."""
    if ann_file.endswith(".json"):
        with open(ann_file, "r", encoding="utf-8") as f:
            cams = json.load(f)["cams"]["20190823"]
    else:
        cams = np.load(ann_file, allow_pickle=True).item()["cams"]
    ret = {}
    for i in range(len(cams["K"])):
        t = i + 1
        if t in (20, 21):
            t += 2
        k = np.array(cams["K"][i])
        r = np.array(cams["R"][i])
        tv = np.array(cams["T"][i]) / 1000.0
        rt = np.concatenate([r, tv], 1)
        ret[f"Camera ({t})"] = {
            "K": k,
            "invK": np.linalg.inv(k),
            "R": r,
            "T": tv,
            "RT": rt,
            "P": k @ rt,
            "dist": np.array(cams["D"][i]).reshape(1, 5),
        }
    return ret
