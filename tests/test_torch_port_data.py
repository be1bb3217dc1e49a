"""The port's real-data pipeline against cv2 and the JAX package, on the CPU.

- `utils/image_io.py::imread` against ``cv2.imread``, bit for bit: every
  image of the committed `.bench_cold_tree/` (and a checksum of its decoded
  JPEGs, which the card test holds the card's build to), JPEGs that cv2
  writes at qualities 75 and 95 with 4:2:0, 4:2:2 and 4:4:4 sampling, odd
  sizes and restart intervals, grey JPEGs, and grey, grey + alpha, RGB,
  RGBA and palette PNGs. Refusals name what they refuse.
- `data/image_ops.py`, the `Undistorter` (nonzero distortion) and the
  OpenCV-YAML reader against cv2, bit for bit.
- Every item of `Mocap`, `MocapView`, `MocapInfer`, `MocapNovelPoseView`,
  `H36M` and `H36MNovelPoses` against the JAX package's on trees written
  here with cv2 (313-style annots.npy cameras, 377-style intri/extri.yml,
  H36M), all with nonzero distortion: the same keys, every array bit for
  bit (the float band is 0), the same sampled rays.
- `select_dataset` on both real types, in train and formal-test mode;
  `SMPLModel` and the SMPL faces of `cli/common.py::load_faces`.
"""

import glob
import hashlib
import os
import pickle
import struct
import zlib

import cv2
import numpy as np
import pytest
import yaml

from dual_space_nerf_tpu.data import cameras as jax_cameras
from dual_space_nerf_tpu.data import h36m as jax_h36m
from dual_space_nerf_tpu.data import h36m_novel_pose as jax_h36m_np
from dual_space_nerf_tpu.data import select as jax_select
from dual_space_nerf_tpu.data import smpl_numpy as jax_smpl_numpy
from dual_space_nerf_tpu.data import zju as jax_zju
from dual_space_nerf_tpu.data import zju_novel_pose as jax_zju_np
from dual_space_nerf_tpu.data.synthetic import look_at_camera, make_scene
from dual_space_nerf_tpu.data.synthetic_dataset import splat_image
from dual_space_nerf_tpu_torch.config.node import parse_config_text
from dual_space_nerf_tpu_torch.data import cameras, h36m, h36m_novel_pose, image_ops
from dual_space_nerf_tpu_torch.data import select, smpl_numpy, zju, zju_novel_pose
from dual_space_nerf_tpu_torch.utils.image_io import decode_jpeg, imread
from torch_port_common import COLD_TREE, COLD_TREE_JPEG_SHA256, REPO

H = W = 64
N_FRAMES = 4
DIST = np.array([[-0.08], [0.02], [0.0015], [-0.001], [0.004]])  # k1 k2 p1 p2 k3


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([np.sin(x / 7.0) * 100 + 120, np.cos(y / 5.0) * 90 + 120,
                     (x * 3 + y * 5) % 255], -1)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# imread against cv2.imread
# ---------------------------------------------------------------------------
def test_imread_equals_cv2_on_the_committed_tree():
    """Every JPEG and PNG of the committed ZJU-shaped tree (1024 x 1024,
    48 of each), bit for bit; the decoded JPEGs' checksum is the one the
    card test holds the card's build of the decoder to."""
    jpgs = sorted(glob.glob(os.path.join(COLD_TREE, "**", "*.jpg"), recursive=True))
    pngs = sorted(glob.glob(os.path.join(COLD_TREE, "**", "*.png"), recursive=True))
    assert len(jpgs) == 48 and len(pngs) == 48
    digest = hashlib.sha256()
    for path in jpgs + pngs:
        ours, want = imread(path), cv2.imread(path)
        assert ours.dtype == want.dtype and ours.shape == want.shape, path
        assert np.array_equal(ours, want), path
        if path.endswith(".jpg"):
            digest.update(ours.tobytes())
    assert digest.hexdigest() == COLD_TREE_JPEG_SHA256


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("sampling", ["420", "422", "444"])
def test_imread_jpeg_equals_cv2(quality, sampling):
    """Baseline JPEGs as cv2 writes them, at odd sizes, with and without
    restart intervals: bit for bit (no band)."""
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for h, w in ((1, 1), (2, 3), (7, 9), (17, 23), (64, 48), (101, 77)):
        img = _image(h, w, seed=h * w)
        for rst in (0, 1, 5):
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                                 cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
                                                 cv2.IMWRITE_JPEG_RST_INTERVAL, rst])
            assert ok
            want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
            ours = decode_jpeg(buf.tobytes())
            assert ours.shape == want.shape and np.array_equal(ours, want), (h, w, rst)


def _png(body_rows: np.ndarray, ctype: int, palette=None, depth=8, interlace=0) -> bytes:
    """A PNG file by hand (filter type 0 on every row)."""
    h = body_rows.shape[0]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), body_rows.reshape(h, -1)], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    w = body_rows.shape[1]
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                             0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b"")


def test_imread_grey_alpha_and_palette_files_equal_cv2(tmp_path):
    img = _image(37, 29, seed=4)
    grey = img[..., 1]
    cases = {"grey.jpg": grey, "grey.png": grey, "rgb.png": img, "rgba.png": np.dstack([img, grey])}
    for name, arr in cases.items():
        path = str(tmp_path / name)
        cv2.imwrite(path, arr)
        assert np.array_equal(imread(path), cv2.imread(path)), name
    # written by hand: grey + alpha, and a palette (cv2 writes neither)
    palette = np.random.default_rng(1).integers(0, 256, (7, 3))
    idx = (np.arange(37 * 29) % 7).astype(np.uint8).reshape(37, 29)
    for name, data in (("greya.png", _png(np.dstack([grey, img[..., 0]]), 4)),
                       ("palette.png", _png(idx, 3, palette))):
        path = tmp_path / name
        path.write_bytes(data)
        want = cv2.imread(str(path))
        assert want is not None and np.array_equal(imread(str(path)), want), name


def _refused(kind, tmp_path) -> bytes:
    img = _image(16, 16)
    if kind == "progressive":
        return cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    if kind == "arithmetic":
        data = bytearray(cv2.imencode(".jpg", img)[1].tobytes())
        data[data.index(b"\xff\xc0") + 1] = 0xC9  # SOF0 -> SOF9
        return bytes(data)
    if kind == "16-bit":
        return cv2.imencode(".png", img.astype(np.uint16) * 257)[1].tobytes()
    return _png(img[..., 0], 0, interlace=1)


@pytest.mark.parametrize("kind,message", [
    ("progressive", "progressive JPEG (SOF2, marker 0xFFC2)"),
    ("arithmetic", "arithmetic-coded JPEG (SOF9, marker 0xFFC9)"),
    ("16-bit", "PNG bit depth 16"),
    ("interlaced", "interlaced (Adam7) PNG"),
])
def test_imread_refuses_what_it_does_not_decode(tmp_path, kind, message):
    path = tmp_path / "x.img"
    path.write_bytes(_refused(kind, tmp_path))
    with pytest.raises(ValueError, match=message.replace("(", r"\(").replace(")", r"\)")):
        imread(str(path))


# ---------------------------------------------------------------------------
# cv2 operations
# ---------------------------------------------------------------------------
def test_image_ops_equal_cv2():
    rng = np.random.default_rng(2)
    for h, w in ((64, 64), (33, 47), (102, 100)):
        u8 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        f32 = rng.random((h, w, 3), dtype=np.float32)
        mask = (rng.random((h, w, 1)) > 0.5).astype(np.uint8)
        for fac in (0.5, 0.25):
            for x in (u8, f32, mask):
                want = cv2.resize(x, (0, 0), fx=fac, fy=fac, interpolation=cv2.INTER_AREA)
                got = image_ops.resize_area(x, fx=fac, fy=fac)
                assert got.dtype == want.dtype and np.array_equal(got, want), (h, w, fac, x.dtype)
                want = cv2.resize(x, (0, 0), fx=fac, fy=fac, interpolation=cv2.INTER_NEAREST)
                assert np.array_equal(image_ops.resize_nearest(x, fx=fac, fy=fac), want)
        size = (w // 2, h // 2)
        if w % 2 == 0 and h % 2 == 0:  # H36M's explicit sizes
            want = cv2.resize(f32, size, interpolation=cv2.INTER_AREA)
            assert np.array_equal(image_ops.resize_area(f32, size), want)
        want = cv2.resize(mask, size, interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(image_ops.resize_nearest(mask, size), want)
        for k in (5, 10):
            kernel = np.ones((k, k), np.uint8)
            for x in (mask[..., 0], u8[..., 0]):
                assert np.array_equal(image_ops.dilate(x, kernel), cv2.dilate(x, kernel))
                assert np.array_equal(image_ops.erode(x, kernel), cv2.erode(x, kernel))
    for _ in range(300):
        v = rng.normal(size=(1, 3)) * rng.choice([1e-9, 1e-3, 1.0, 3.0])
        for dtype in (np.float32, np.float64):
            want = cv2.Rodrigues(v.astype(dtype))[0]
            got = image_ops.rodrigues(v.astype(dtype))
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_undistorter_equals_cv2_with_nonzero_distortion():
    rng = np.random.default_rng(3)
    und = cameras.Undistorter()
    for h, w in ((64, 64), (96, 80)):
        K = np.array([[w * 1.07, 0.3, w / 2 + 3.3], [0.0, w * 1.05, h / 2 - 2.1], [0, 0, 1.0]])
        D = np.array([[-0.21, 0.09, 0.0012, -0.0007, -0.02]])
        imgs = (rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                (rng.random((h, w)) > 0.5).astype(np.uint8),
                rng.random((h, w, 3), dtype=np.float32))
        for img in imgs:
            want = cv2.undistort(img, K, D)
            got = und(img, K, D)
            assert got.dtype == want.dtype and np.array_equal(got, want), img.dtype
            assert np.array_equal(got, jax_cameras.Undistorter()(img, K, D))
        assert und(imgs[0], K, np.zeros(5)) is imgs[0]  # zero distortion: a no-op


@pytest.mark.parametrize("ratio", [0.3, 0.4, 2 / 3, 0.75])
def test_resize_area_at_non_integral_down_scales_equals_cv2(ratio):
    """cv2's general INTER_AREA path (`computeResizeAreaTab`, float32 sums
    in its order, its rounding) on odd sizes, uint8 and float32, one and
    three channels, by fx/fy and by an explicit size; an up-scale (cv2's
    bilinear path) is refused."""
    rng = np.random.default_rng(int(ratio * 1000))
    for h, w in ((33, 47), (101, 77), (255, 129)):
        imgs = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), rng.integers(0, 256, (h, w), dtype=np.uint8),
                rng.random((h, w, 3), dtype=np.float32), rng.random((h, w), dtype=np.float32))
        size = (int(w * ratio), int(h * ratio))  # H36M's explicit sizes
        for x in imgs:
            want = cv2.resize(x, (0, 0), fx=ratio, fy=ratio, interpolation=cv2.INTER_AREA)
            got = image_ops.resize_area(x, fx=ratio, fy=ratio)
            assert got.dtype == want.dtype and np.array_equal(got, want), (h, w, x.dtype, x.shape)
            want = cv2.resize(x, size, interpolation=cv2.INTER_AREA)
            got = image_ops.resize_area(x, size)
            assert got.dtype == want.dtype and np.array_equal(got, want), (h, w, x.dtype, size)
    with pytest.raises(NotImplementedError, match="only down-scales"):
        image_ops.resize_area(imgs[0], fx=1.0 / ratio, fy=1.0 / ratio)


@pytest.mark.parametrize("h,w", [(64, 64), (37, 53)])
def test_undistort_maps_with_a_tilted_sensor_equal_cv2(h, w):
    """14 coefficients (tauX, tauY: cv2's tilt projection and its projective
    divide): map1 and map2 against ``cv2.initUndistortRectifyMap(...,
    CV_16SC2)`` bit for bit, and the undistorted images against
    ``cv2.undistort`` and the JAX package's `Undistorter`."""
    rng = np.random.default_rng(h * w)
    K = np.array([[w * 1.07, 0.3, w / 2 + 3.3], [0.0, w * 1.05, h / 2 - 2.1], [0, 0, 1.0]])
    for tau in ((0.03, -0.05), (-0.1, 0.0), (0.0, 0.07)):
        D = np.array([-0.21, 0.09, 0.0012, -0.0007, -0.02, 0.01, -0.003, 0.002,
                      0.001, -0.0005, 0.0007, 0.0002, *tau])
        want = cv2.initUndistortRectifyMap(K, D, None, K, (w, h), cv2.CV_16SC2)
        got = cameras.undistort_maps(K, D, w, h)
        assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want)), tau
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        out = cameras.Undistorter()(img, K, D)
        assert np.array_equal(out, cv2.undistort(img, K, D))
        assert np.array_equal(out, jax_cameras.Undistorter()(img, K, D))


def test_opencv_yaml_reader_equals_filestorage(tmp_path):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "intri.yml")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    fs.write("names", ["1", "22", "none", "B3"])
    mats = {"K_1": rng.normal(size=(3, 3)), "dist_1": rng.normal(size=(1, 5)),
            "F_1": rng.normal(size=(4, 7)).astype(np.float32),
            "I_1": rng.integers(0, 100, (2, 3)).astype(np.int32)}
    for key, m in mats.items():
        fs.write(key, m)
    fs.release()
    nodes = cameras.read_opencv_yaml(path)
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    for key in mats:
        want = fs.getNode(key).mat()
        assert nodes[key].dtype == want.dtype and np.array_equal(nodes[key], want), key
    assert cameras._read_string_list(nodes, "names") == jax_cameras._read_string_list(fs, "names")
    fs.release()
    with open(path, "a") as f:
        f.write("bad: {a: 1}\n")
    n_lines = sum(1 for _ in open(path))
    with pytest.raises(ValueError, match=f"intri.yml:{n_lines}: unsupported node"):
        cameras.read_opencv_yaml(path)


def test_every_data_config_reads_as_yaml_reads_it():
    paths = sorted(glob.glob(os.path.join(REPO, "data_configs", "**", "*.yml"), recursive=True))
    assert len(paths) >= 24
    for path in paths:
        with open(path) as f:
            text = f.read()
        assert parse_config_text(text, path) == yaml.safe_load(text), path


# ---------------------------------------------------------------------------
# the datasets, item for item
# ---------------------------------------------------------------------------
def _assert_same_item(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        got = ours[key]
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype, key
            assert got.shape == want.shape, key
            assert np.array_equal(got, want, equal_nan=want.dtype.kind == "f"), key
        else:
            assert type(got) is type(want) and got == want, (key, got, want)


def _assert_same_items(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for i in range(len(theirs)):
        _assert_same_item(ours[i], theirs[i])


def _scene():
    return make_scene(n_theta=14, n_phi=12, h=H, w=W)


def _ring(n, radius=2.0):
    out = []
    for c in range(n):
        ang = 2 * np.pi * c / n
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 0.3])
        out.append(look_at_camera(eye, np.zeros(3), H, W, focal=80.0))
    return out


def _write_frame(img_path, msk_path, scene):
    """A frame's JPEG and its cihp label PNG: 1 on the body, 2 (face) on
    the body's top rows."""
    img, mask = splat_image(scene, H, W)
    os.makedirs(os.path.dirname(img_path), exist_ok=True)
    os.makedirs(os.path.dirname(msk_path), exist_ok=True)
    cv2.imwrite(str(img_path), (img * 255).astype(np.uint8))
    labels = mask.astype(np.uint8)
    rows = np.nonzero(labels.any(axis=1))[0]
    if len(rows):
        labels[rows[0]:rows[0] + 4][labels[rows[0]:rows[0] + 4] > 0] = 2
    cv2.imwrite(str(msk_path), labels)


def _write_smpl_assets(root, scene, names, rng):
    os.makedirs(root / "new_params", exist_ok=True)
    os.makedirs(root / "new_vertices", exist_ok=True)
    for name in names:
        np.save(root / "new_params" / f"{name}.npy", {
            "Rh": (0.1 * rng.standard_normal((1, 3))).astype(np.float32),
            "Th": (0.05 * rng.standard_normal((1, 3))).astype(np.float32),
            "poses": (0.05 * rng.standard_normal((1, 72))).astype(np.float32),
            "shapes": np.zeros((1, 10), np.float32),
        })
        np.save(root / "new_vertices" / f"{name}.npy", scene.verts_world)
    np.save(root / "X_smpl_vertices.npy", scene.verts_cano[None])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{"zju": data dir with CoreView_313 (annots.npy, 21 cameras) and
    CoreView_377 (intri/extri.yml, 4 cameras), "h36m": data dir with
    S9/Posing}, every camera with nonzero distortion."""
    scene = _scene()
    rng = np.random.default_rng(0)
    zju_dir = tmp_path_factory.mktemp("zjuroot") / "zju_mocap"

    root = zju_dir / "CoreView_313"
    ring = _ring(21)
    os.makedirs(root)
    np.save(root / "annots.npy", {"cams": {
        "K": [k for k, _, _ in ring], "R": [r for _, r, _ in ring],
        "T": [t * 1000.0 for _, _, t in ring], "D": [DIST for _ in ring]}, "ims": []})
    for cam_dir in ("Camera (1)", "Camera (2)", "Camera (22)", "Camera (23)"):
        for f in range(1, N_FRAMES + 1):
            name = f"CoreView_313_Camera_(x)_{f:04d}_2019-08-23"
            _write_frame(root / cam_dir / f"{name}.jpg",
                         root / "mask_cihp" / cam_dir / f"{name}.png", scene)
    _write_smpl_assets(root, scene, [str(f) for f in range(1, N_FRAMES + 1)], rng)

    root = zju_dir / "CoreView_377"
    ring = _ring(4)
    names = [f"Camera_B{c + 1}" for c in range(4)]
    os.makedirs(root)
    intri = cv2.FileStorage(str(root / "intri.yml"), cv2.FILE_STORAGE_WRITE)
    extri = cv2.FileStorage(str(root / "extri.yml"), cv2.FILE_STORAGE_WRITE)
    intri.write("names", names)
    extri.write("names", names)
    for (K, R, T), nm in zip(ring, names):
        intri.write(f"K_{nm}", K)
        intri.write(f"dist_{nm}", DIST.reshape(1, 5))
        extri.write(f"R_{nm}", cv2.Rodrigues(R)[0])
        extri.write(f"T_{nm}", T.reshape(3, 1))
    intri.release()
    extri.release()
    for nm in names:
        for f in range(N_FRAMES):
            _write_frame(root / nm / f"{f}.jpg", root / "mask_cihp" / nm / f"{f}.png", scene)
    _write_smpl_assets(root, scene, [str(f) for f in range(N_FRAMES)], rng)

    h36m_dir = tmp_path_factory.mktemp("h36mroot")
    root = h36m_dir / "S9" / "Posing"
    cams = {"K": [], "R": [], "T": [], "D": []}
    for K, R, T in _ring(3):
        cams["K"].append(K)
        cams["R"].append(R)
        cams["T"].append(T * 1000.0)
        cams["D"].append(DIST)
    ims = []
    for f in range(N_FRAMES):
        rels = [f"images/Camera{c}/{f}.jpg" for c in range(3)]
        for rel in rels:
            _write_frame(root / rel, root / "mask_cihp" / (rel[:-4] + ".png"), scene)
        ims.append({"ims": rels})
    np.save(root / "annots.npy", {"cams": cams, "ims": ims})
    os.makedirs(root / "lbs")
    np.save(root / "lbs" / "X_smpl_joints.npy", rng.normal(size=(1, 24, 3)))
    np.save(root / "lbs" / "parents.npy", np.concatenate([[-1], np.arange(23)]))
    np.save(root / "lbs" / "X_smpl_vertices.npy", scene.verts_cano[None])
    _write_smpl_assets(root, scene, [str(f) for f in range(N_FRAMES)], rng)
    return {"zju": str(zju_dir), "h36m": str(h36m_dir)}


def test_camera_tables_equal_jax(trees):
    ann = os.path.join(trees["zju"], "CoreView_313", "annots.npy")
    ours, theirs = cameras.load_cam(ann), jax_cameras.load_cam(ann)
    assert sorted(ours) == sorted(theirs) and "Camera (22)" in ours and "Camera (20)" not in ours
    ours377 = cameras.load_cameras(os.path.join(trees["zju"], "CoreView_377"))
    theirs377 = jax_cameras.load_cameras(os.path.join(trees["zju"], "CoreView_377"))
    assert sorted(ours377) == sorted(theirs377) == [f"Camera_B{c}" for c in range(1, 5)]
    for a, b in ((ours, theirs), (ours377, theirs377)):
        for cam in b:
            for key in b[cam]:
                assert np.array_equal(a[cam][key], b[cam][key]), (cam, key)
                assert a[cam][key].dtype == b[cam][key].dtype, (cam, key)


def _zju_pair(kind, data_dir):
    """(port dataset, JAX dataset) of one ZJU split on the test trees."""
    human = "CoreView_377" if kind.startswith("377") else "CoreView_313"
    split = kind.split("-", 1)[1]
    pair = []
    for mod, np_mod in ((zju, zju_novel_pose), (jax_zju, jax_zju_np)):
        if split == "train":
            ds = mod.Mocap(human, 0.5, 96, 0, N_FRAMES, (0, 1), data_dir=data_dir)
        elif split == "train_ratio075":  # cv2's general INTER_AREA path
            ds = mod.Mocap(human, 0.75, 96, 0, N_FRAMES, (0, 1), data_dir=data_dir)
        elif split == "train_deterministic":
            ds = mod.Mocap(human, 0.5, 96, 0, N_FRAMES, (0, 1), data_dir=data_dir, seed=7)
            ds.deterministic_items = True
            ds.set_epoch(3)
        elif split == "view":
            ds = mod.MocapView(human, 0.5, 0, N_FRAMES, (0, 1), train_max_frame=4, interval=2,
                               data_dir=data_dir)
        elif split == "vis_views":
            ds = mod.MocapView(human, 0.5, 0, N_FRAMES, (), train_max_frame=4, interval=1,
                               vis_views=[1], data_dir=data_dir)
        elif split in ("novel_view", "novel_pose"):
            ds = mod.MocapInfer(human, 0.5, 0, N_FRAMES, (0, 1), train_max_frame=4, interval=1,
                                eval_begin_frame=2, novel_pose=split == "novel_pose",
                                data_dir=data_dir)
        else:  # the motion-transfer view: fixed image, poses from the tree
            ds = np_mod.MocapNovelPoseView(human, 1, 0, 100000, [], 2000, 4, vis_views=[0],
                                           performer=human, zju_data_dir=data_dir)
            root = os.path.join(data_dir, human)
            ds.set_novel_pose_dirs(os.path.join(root, "new_params"),
                                   os.path.join(root, "new_vertices"))
        pair.append(ds)
    return pair


@pytest.mark.parametrize("kind", [
    "313-train", "313-train_deterministic", "313-view", "313-novel_view", "313-novel_pose",
    "377-train", "377-view", "377-vis_views", "377-motion", "313-train_ratio075",
])
def test_zju_items_equal_jax(trees, kind):
    """Every item, every key, bit for bit, in the same order: the decoded
    and undistorted images, masks, the sampled rays (the same numpy
    generator draws), poses and bounds. Drawn twice, to cover the cached
    decode."""
    ours, theirs = _zju_pair(kind, trees["zju"])
    if kind.endswith("motion"):
        # the pose advances 4 frames per item and the tree holds frames 0..3
        assert len(ours) == len(theirs)
        ours, theirs = [ours[0]], [theirs[0]]
    for _ in range(2):
        _assert_same_items(ours, theirs)


def _h36m_cfg(mod, ratio=0.5):
    return mod.set_my_cfg(mod.MyCfg(), {
        "ratio": ratio, "training_view": [0, 1], "test_view": [], "num_train_frame": 2,
        "num_eval_frame": 2, "my_num_eval_frame": 1, "begin_ith_frame": 0,
        "frame_interval": 1, "vertices": "new_vertices", "params": "new_params",
    })


@pytest.mark.parametrize("split", ["train", "val", "novel_view", "novel_pose", "train_ratio075"])
def test_h36m_items_equal_jax(trees, split):
    """``train_ratio075``: ratio 0.75, cv2's general INTER_AREA path on the
    float32 images."""
    root = os.path.join(trees["h36m"], "S9", "Posing")
    ann = os.path.join(root, "annots.npy")
    kw = {"train": dict(split="train"), "train_ratio075": dict(split="train"),
          "val": dict(split="test", test_novel_pose=True, is_eval=True, is_formal=False),
          "novel_view": dict(split="test", is_eval=True),
          "novel_pose": dict(split="test", test_novel_pose=True, is_eval=True)}[split]
    ratio = 0.75 if split == "train_ratio075" else 0.5
    ours = h36m.H36M(_h36m_cfg(select, ratio), root, "S9", ann, nrays=96, **kw)
    theirs = jax_h36m.H36M(_h36m_cfg(jax_select, ratio), root, "S9", ann, nrays=96, **kw)
    for _ in range(2):
        _assert_same_items(ours, theirs)


def test_h36m_motion_transfer_items_equal_jax(trees, tmp_path, monkeypatch):
    """`get_novel_pose_dataset`: the H36M motion on the CoreView_377
    performer, configured by data_configs/novel_poses/ in the working
    directory, read without yaml."""
    cfg_dir = tmp_path / "data_configs" / "novel_poses"
    os.makedirs(cfg_dir)
    (cfg_dir / "CoreView_377_S9.yml").write_text(
        "ratio: 0.5\ntraining_view: [0, 1]\ntest_view: []\nbegin_ith_frame: 0\n"
        "frame_interval: 2\nnum_train_frame: 2\nvertices: 'new_vertices'\n"
        "params: 'new_params'\n")
    monkeypatch.chdir(tmp_path)
    kw = dict(performer="CoreView_377", motion_seq="S9", zju_data_dir=trees["zju"],
              h36m_data_dir=trees["h36m"])
    ours = h36m_novel_pose.get_novel_pose_dataset(**kw)
    theirs = jax_h36m_np.get_novel_pose_dataset(**kw)
    assert np.array_equal(ours.canonical_vertex, theirs.canonical_vertex)
    _assert_same_items(ours, theirs)


@pytest.mark.parametrize("kind", ["zju_mocap", "h36m"])
@pytest.mark.parametrize("formal_test", [False, True])
def test_select_dataset_equals_jax(trees, tmp_path, monkeypatch, kind, formal_test):
    """The real-data branches of `select_dataset`, with the data roots from
    DSNERF_ZJU_PATH / DSNERF_H36M_PATH and the data configs from the working
    directory: the same two datasets, their first items equal."""
    from dual_space_nerf_tpu.config import get_cfg_defaults as jax_defaults
    from dual_space_nerf_tpu_torch.config import get_cfg_defaults

    human = "CoreView_313" if kind == "zju_mocap" else "S9"
    cfg_dir = tmp_path / "data_configs" / kind
    os.makedirs(cfg_dir)
    if kind == "zju_mocap":
        text = ("Train:\n  views: [0, 1]\n  ratio: 0.5\n  begin: 0\n  end: 3\n"
                "Val:\n  ratio: 0.5\n  begin: 0\n  end: 3\n  intv: 2\n"
                "Test:\n  ratio: 0.5\n  begin: 0\n  end: 3\n  intv: 1\n  novel_pose_begin: 2\n")
    else:
        text = ("ratio: 0.5\ntraining_view: [0, 1]\ntest_view: []\nnum_train_frame: 2\n"
                "num_eval_frame: 2\nmy_num_eval_frame: 1\nbegin_ith_frame: 0\n"
                "frame_interval: 1\nvertices: 'new_vertices'\nparams: 'new_params'\n")
    (cfg_dir / f"{human}.yml").write_text(text)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DSNERF_ZJU_PATH", trees["zju"])
    monkeypatch.setenv("DSNERF_H36M_PATH", trees["h36m"])
    pairs = []
    for defaults, sel in ((get_cfg_defaults, select), (jax_defaults, jax_select)):
        cfg = defaults()
        cfg.DATASETS.TYPE = kind
        cfg.DATASETS.HUMAN = human
        pairs.append(sel.select_dataset(cfg, train_nrays=64, formal_test=formal_test))
    for ours, theirs in zip(*pairs):
        assert type(ours).__name__ == type(theirs).__name__
        assert len(ours) == len(theirs) > 0
        _assert_same_item(ours[0], theirs[0])


# ---------------------------------------------------------------------------
# SMPL
# ---------------------------------------------------------------------------
@pytest.fixture
def fake_smpl(tmp_path):
    """`tests/test_smpl_numpy.py`'s model pickle."""
    rng = np.random.default_rng(0)
    V = 60
    J = np.abs(rng.normal(size=(24, V)))
    weights = np.abs(rng.normal(size=(V, 24)))
    kintree = np.zeros((2, 24), np.int64)
    kintree[0] = np.concatenate([[0], np.arange(23)])
    data = {
        "v_template": rng.normal(size=(V, 3)) * 0.3,
        "shapedirs": rng.normal(size=(V, 3, 10)) * 0.01,
        "posedirs": rng.normal(size=(V, 3, 207)) * 0.001,
        "J_regressor": J / J.sum(1, keepdims=True),
        "weights": weights / weights.sum(1, keepdims=True),
        "kintree_table": kintree,
        "f": rng.integers(0, V, (40, 3)).astype(np.int32),
    }
    path = tmp_path / "SMPL_NEUTRAL.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return str(path)


def test_smpl_model_equals_jax(fake_smpl):
    ours, theirs = smpl_numpy.SMPLModel(fake_smpl), jax_smpl_numpy.SMPLModel(fake_smpl)
    rng = np.random.default_rng(1)
    for _ in range(3):
        pose = 0.3 * rng.standard_normal((24, 3))
        betas = rng.standard_normal(10)
        Rh, Th = 0.5 * rng.standard_normal(3), rng.standard_normal(3)
        for a, b in zip(ours.forward(pose, betas, Rh, Th), theirs.forward(pose, betas, Rh, Th)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(ours.joints(betas), theirs.joints(betas))


def test_load_faces_reads_the_smpl_pickle(fake_smpl, monkeypatch):
    """`cli/common.py::load_faces` on a real-data config: DSNERF_SMPL_PATH,
    else DATASETS.SMPL_PATH (a file, or a directory holding
    SMPL_NEUTRAL.pkl); the JAX package's faces."""
    from dual_space_nerf_tpu.cli import common as jax_common
    from dual_space_nerf_tpu_torch.cli import common

    cfg = common.load_cfg("")
    monkeypatch.setenv("DSNERF_SMPL_PATH", fake_smpl)
    faces = common.load_faces(cfg)
    assert faces.dtype == np.int32 and np.array_equal(faces, jax_common.load_faces(cfg))
    monkeypatch.delenv("DSNERF_SMPL_PATH")
    cfg.defrost()
    cfg.DATASETS.SMPL_PATH = os.path.dirname(fake_smpl)
    assert np.array_equal(common.load_faces(cfg), faces)
    cfg.DATASETS.SMPL_PATH = os.path.join(os.path.dirname(fake_smpl), "missing.pkl")
    with pytest.raises(FileNotFoundError, match="SMPL model not found"):
        common.load_faces(cfg)
