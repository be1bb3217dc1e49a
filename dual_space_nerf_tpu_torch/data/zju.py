"""ZJU-MoCap datasets (host-side numpy, no cv2), as the JAX package's
`data/zju.py`: `MocapBase`, the `Mocap` train split, `MocapView`
validation and the `MocapInfer` formal-test splits, item for item. The
images are read by `utils/image_io.py::imread` and the cv2 operations are
`data/image_ops.py`'s and `data/cameras.py`'s, each equal to cv2's output,
so an item equals the JAX package's (`tests/test_torch_port_data.py`). The
ray draws use numpy generators seeded as the JAX package seeds them, so both
packages draw the same rays. All the dataset quirks are kept:

- CoreView_313/315 use annots.npy cameras and "Camera (N)" dirs with
  1-indexed frame numbers parsed from the filename; other subjects use
  intri/extri.yml and "Camera_BN" dirs (:38-44, 87-92).
- masks come from the mask_cihp sibling dir, foreground = nonzero, dilated
  by 5px; images are undistorted, foreground-multiplied, and x ratio resized
  (:97-123, 192-213).
- per-frame SMPL: new_params/{i}.npy (Rh/Th/poses with X-pose leg offsets
  applied, :76-78) and posed vertices new_vertices/{i}.npy; canonical X-pose
  vertices X_smpl_vertices.npy (:48-50).
- eval cameras skip ids 19/20 -> physical 21/22 (:275-280).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from ..utils.image_io import imread
from . import cameras as camera_utils
from .image_ops import dilate, resize_area, resize_nearest, rodrigues
from .rays import build_sample_pools, sample_rays

_ANNOT_SUBJECTS = ("CoreView_313", "CoreView_315")


def cache_images_enabled(default: bool = True) -> bool:
    """Epoch-persistent decoded-image cache switch (DSNERF_IMAGE_CACHE).

    The reference re-decodes every image every epoch (its Dataset has no
    cache and torch DataLoader workers restart per epoch); here the posed
    SMPL assets + images of a training split are a few hundred MB decoded,
    so items after the first epoch reduce to the pixel-sampling loop —
    the host-side fix that lets the loader feed the TPU step rate
    (BENCH `sustained`). '0' disables for memory-constrained hosts."""
    raw = os.environ.get("DSNERF_IMAGE_CACHE")
    if raw is None:
        return default
    if raw not in ("0", "1"):
        raise ValueError(f"DSNERF_IMAGE_CACHE={raw!r} must be '0' or '1'")
    return raw == "1"


class MocapBase:
    def __init__(
        self, human="CoreView_377", ratio=0.5, nrays=500, data_dir=None,
        seed: int | None = 233, cache_images: bool = True,
    ):
        self.human = human
        self.data_root = f"{data_dir}/{human}"
        self.smpl_dir = os.path.join(self.data_root, "new_params")
        self.vertices_dir = os.path.join(self.data_root, "new_vertices")
        self.use_x_pose = True
        self.ratio = ratio
        self.nrays = nrays
        self.mode = "train"
        # Seeded like the reference, which seeds np.random globally with 233
        # (`main.py:22-26`) so Mocap_infer's random frame codes — and hence
        # test.py/validate.py metrics — are reproducible across runs.
        self.rng = np.random.default_rng(seed)
        # Multi-host mode (training/loop.py): per-(epoch, item) rng makes
        # ray draws a pure function of (seed, epoch, index) so every
        # process of a jax.distributed cluster samples the IDENTICAL rays
        # regardless of worker interleaving. Default off: single-host draws
        # keep the shared-rng semantics existing tests pin.
        self.item_seed = 0 if seed is None else int(seed)
        self.deterministic_items = False
        self._epoch = 0
        # Epoch-persistent caches: decoded frames (post-undistort,
        # fg-multiplied, resized uint8 image + masks; ~1 MB per image at
        # ratio 0.5 -> ~250 MB for a ZJU-313 train split) and per-frame SMPL
        # inputs. After epoch 1, __getitem__ is only the sampling loop.
        self.cache_images = cache_images_enabled(cache_images)
        self._image_cache: dict[str, tuple] = {}
        self._input_cache: dict[int, tuple] = {}
        # static sampler inputs per frame (data/rays.py::SamplePools)
        self._pools_cache: dict[str, object] = {}

        if human in _ANNOT_SUBJECTS:
            ann_file = os.path.join(self.data_root, "annots.npy")
            self.cams = camera_utils.load_cam(ann_file)
        else:
            self.cams = camera_utils.load_cameras(self.data_root)

        canon_path = os.path.join(self.data_root, "X_smpl_vertices.npy")
        # Novel-pose variants substitute the performer's canonical vertices.
        self.canonical_vertex = (
            np.load(canon_path).squeeze() if os.path.exists(canon_path) else None
        )

    # -- helpers -------------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        """Advance the deterministic-items epoch (called by PrefetchLoader
        at each `__iter__`; no effect unless `deterministic_items`)."""
        self._epoch = int(epoch)

    def _item_rng(self, i: int):
        """The rng for item i's ray draws (see `deterministic_items`).
        getattr-defensive: novel-pose subclasses bypass this __init__."""
        if getattr(self, "deterministic_items", False):
            return np.random.default_rng([
                getattr(self, "item_seed", 0),
                getattr(self, "_epoch", 0),
                int(i),
            ])
        return self.rng

    def _cam_dir_name(self, view: int) -> str:
        if self.human in _ANNOT_SUBJECTS:
            return f"Camera ({view + 1})"
        return f"Camera_B{view + 1}"

    def _frame_of(self, img_path: str) -> int:
        base = os.path.basename(img_path)
        if self.human in _ANNOT_SUBJECTS:
            return int(base.split("_")[4]) - 1
        return int(base[:-4])

    def _raw_frame_name(self, img_path: str) -> int:
        base = os.path.basename(img_path)
        if self.human in _ANNOT_SUBJECTS:
            return int(base.split("_")[4])
        return int(base[:-4])

    def get_mask(self, img_path: str):
        parts = img_path.split("/")
        parts.insert(-2, "mask_cihp")
        cam_view = parts[-2]
        msk_path = "/".join(parts)[:-4] + ".png"
        msk_cihp = imread(msk_path)
        if msk_cihp.ndim == 3:
            msk_cihp = msk_cihp[..., 0]
        msk_fg = (msk_cihp != 0).astype(np.uint8)
        msk_fg = camera_utils.undistort(
            msk_fg, self.cams[cam_view]["K"], self.cams[cam_view]["dist"]
        )
        kernel = np.ones((5, 5), np.uint8)
        msk_fg = dilate(msk_fg, kernel)
        # msk_cihp is deliberately NOT undistorted — the reference returns
        # it raw (`zju_mocap_dataset.py:196-213`) and samples body/face
        # pixels from it while reading rgb from the undistorted image; its
        # shipped checkpoints were trained with exactly this mismatch.
        return msk_fg[..., None], msk_cihp[..., None]

    def prepare_input(self, i: int):
        if self.cache_images:
            hit = self._input_cache.get(i)
            if hit is not None:
                poses, xyz, world_bounds, Rh, Th = hit
                # small arrays copied: consumers may hold/modify them; xyz
                # (the one large array) is read-only by every consumer
                return (
                    poses.copy(), xyz, world_bounds.copy(), Rh.copy(),
                    Th.copy(),
                )
        out = self._prepare_input_uncached(i)
        if self.cache_images:
            self._input_cache[i] = out
            poses, xyz, world_bounds, Rh, Th = out
            return poses.copy(), xyz, world_bounds.copy(), Rh.copy(), Th.copy()
        return out

    def _prepare_input_uncached(self, i: int):
        xyz = np.load(os.path.join(self.vertices_dir, f"{i}.npy")).astype(
            np.float32
        )
        min_xyz = xyz.min(axis=0)
        max_xyz = xyz.max(axis=0)
        if self.mode == "train":
            min_xyz -= 0.1
            max_xyz += 0.1
        else:
            min_xyz[2] -= 0.05
            max_xyz[2] += 0.05
        world_bounds = np.stack([min_xyz, max_xyz], axis=0)

        params = np.load(
            os.path.join(self.smpl_dir, f"{i}.npy"), allow_pickle=True
        ).item()
        Rh = rodrigues(params["Rh"])
        Th = params["Th"]
        poses = params["poses"].reshape(-1, 3).copy()
        if self.use_x_pose:
            # inverse of smpl.x_pose()'s +-0.6 rad leg spread — keep the
            # two in sync or canonical assets and training poses diverge
            poses[1, 2] -= 0.6
            poses[2, 2] += 0.6
        return poses, xyz, world_bounds, Rh, Th

    def _decode_frame(self, img_path: str):
        """Decoded frame products: (uint8 image — undistorted, fg-multiplied,
        resized — plus resized fg/cihp masks). Cached per path: these are
        constant across epochs, and the uint8 image is bit-identical to the
        uncached pipeline (the /255 float conversion happens per item)."""
        if self.cache_images:
            hit = self._image_cache.get(img_path)
            if hit is not None:
                return hit

        img = imread(img_path)
        cam_name = img_path.split("/")[-2]
        K = np.array(self.cams[cam_name]["K"], np.float64)
        D = np.array(self.cams[cam_name]["dist"])
        img = camera_utils.undistort(img, K, D)

        msk_fg, msk_cihp = self.get_mask(img_path)
        img = img * msk_fg

        if self.ratio != 1:
            img = resize_area(img, fx=self.ratio, fy=self.ratio)
            msk_fg = resize_nearest(msk_fg, fx=self.ratio, fy=self.ratio)
            msk_cihp = resize_nearest(msk_cihp, fx=self.ratio, fy=self.ratio)
        out = (img, msk_fg, msk_cihp)
        if self.cache_images:
            self._image_cache[img_path] = out
        return out

    # -- item ----------------------------------------------------------------
    def __getitem__(self, idx: int) -> dict:
        img_path = self.all_img_path[idx]
        raw_frame = self._raw_frame_name(img_path)
        cam_name = img_path.split("/")[-2]

        img, msk_fg, msk_cihp = self._decode_frame(img_path)
        K = np.array(self.cams[cam_name]["K"], np.float64).copy()
        if self.ratio != 1:
            K[:2] = K[:2] * self.ratio
        img = img / 255.0
        R = np.array(self.cams[cam_name]["R"])
        T = np.array(self.cams[cam_name]["T"])

        poses, xyz, world_bounds, Rh, Th = self.prepare_input(raw_frame)

        msk_cihp2d = msk_cihp.squeeze()
        # the sampler's static per-frame inputs (projected-AABB mask +
        # pixel-coordinate pools) cache alongside the decoded frames: after
        # epoch 1 __getitem__ is only the draw-and-gather loop
        pools = None
        if self.cache_images:
            # lazy: subclasses (novel-pose loaders) bypass this __init__
            if not hasattr(self, "_pools_cache"):
                self._pools_cache = {}
            pools = self._pools_cache.get(img_path)
        if pools is None:
            pools = build_sample_pools(
                img.shape[0], img.shape[1], K, R, T, world_bounds,
                mask=msk_cihp2d, face_mask=msk_cihp2d,
            )
            if self.cache_images:
                self._pools_cache[img_path] = pools
        rgb, ray_o, ray_d, near, far, coord, mask_at_box, bound_mask = sample_rays(
            img, K, R, T, world_bounds,
            mask=msk_cihp2d, face_mask=msk_cihp2d, nrays=self.nrays,
            rng=self._item_rng(idx), pools=pools,
        )
        if msk_fg.ndim == 2:
            msk_fg = msk_fg[..., None]
        occupancy = msk_fg[coord[:, 0], coord[:, 1], 0]

        if self.human in _ANNOT_SUBJECTS:
            cam_idx = int(cam_name.split(" ")[1].strip("()")) - 1
            frame = raw_frame - 1
        else:
            cam_idx = int(cam_name.split("_")[1][1:]) - 1
            frame = raw_frame

        return {
            "img": img.astype(np.float32),
            "coord": coord,
            "rgb": rgb,
            "occupancy": occupancy.astype(np.float32),
            "ray_o": ray_o,
            "ray_d": ray_d,
            "near": near,
            "far": far,
            "mask_at_box": mask_at_box,
            "poses": poses.astype(np.float32),
            "xyz": xyz,
            "bounds": world_bounds,
            "mybound_mask": bound_mask,
            "Rh": Rh,
            "Th": Th,
            "R": R,
            "T": T,
            "frame": frame,
            "cam_ind": cam_idx,
            "save_name": f"frame{frame:04d}_view{cam_idx:04d}",
        }

    def __len__(self) -> int:
        return len(self.all_img_path)

    def _frames_in(self, view_dir: str, begin: int, end: int) -> list[str]:
        paths = glob.glob(os.path.join(self.data_root, view_dir, "*.jpg"))
        return [p for p in paths if begin <= self._frame_of(p) <= end]

    def _sorted_by_frame(self, paths: list[str]) -> list[str]:
        # frame-ascending order. The reference sorts by underscore-token 6
        # of the FULL path (`zju_mocap_dataset.py:290`), which is the frame
        # field only when its data root contains exactly one underscore;
        # parsing the basename (like _raw_frame_name) keeps the same order
        # for any data_dir.
        return sorted(paths, key=self._raw_frame_name)


class Mocap(MocapBase):
    """Training split: train views x frame range, random pixel sampling."""

    def __init__(
        self, human="CoreView_377", ratio=0.5, nrays=500, begin=0, end=300,
        train_views=(0, 6, 12, 18), data_dir=None, seed=233,
        cache_images=True,
    ):
        super().__init__(
            human, ratio, nrays, data_dir, seed=seed,
            cache_images=cache_images,
        )
        all_img = []
        for view in train_views:
            all_img += self._frames_in(self._cam_dir_name(view), begin, end)
        self.all_img_path = all_img
        self.mode = "train"


class MocapView(MocapBase):
    """Validation: held-out cameras, whole-image rays, every `interval`th
    frame; frame code randomized unless vis_views given (:322-326)."""

    def __init__(
        self, human="CoreView_377", ratio=0.5, begin=0, end=300,
        train_views=(0, 6, 12, 18), train_max_frame=300, interval=30,
        vis_views=None, data_dir=None, seed=233, cache_images=True,
    ):
        super().__init__(
            human, ratio, nrays=-1, data_dir=data_dir, seed=seed,
            cache_images=cache_images,
        )
        self.vis_views = vis_views
        views = []
        if vis_views is None:
            for view in range(len(self.cams.keys())):
                if view not in train_views:
                    if self.human in _ANNOT_SUBJECTS and view in (19, 20):
                        view += 2
                    views.append(self._cam_dir_name(view))
        else:
            for view in vis_views:
                if self.human in _ANNOT_SUBJECTS and view in (19, 20):
                    view += 2
                views.append(self._cam_dir_name(view))

        all_img = []
        for view in views:
            img_view = self._sorted_by_frame(self._frames_in(view, begin, end))
            all_img += img_view[::interval]
        self.all_img_path = all_img
        self.train_max_frame = train_max_frame
        self.mode = "infer"

    def __getitem__(self, idx):
        item = super().__getitem__(idx)
        if self.vis_views is None:
            item["frame"] = int(self.rng.integers(0, self.train_max_frame))
        return item


class MocapInfer(MocapBase):
    """Formal test: novel-view (train-range frames, held-out cams) or
    novel-pose (frames >= eval_begin_frame) split (:329-398)."""

    def __init__(
        self, human="CoreView_377", ratio=0.5, begin=0, end=300,
        train_views=(0, 6, 12, 18), train_max_frame=300, interval=30,
        eval_begin_frame=60, novel_pose=False, data_dir=None, seed=233,
        cache_images=True,
    ):
        super().__init__(
            human, ratio, nrays=-1, data_dir=data_dir, seed=seed,
            cache_images=cache_images,
        )
        views = []
        for view in range(len(self.cams.keys())):
            if view not in train_views:
                if self.human in _ANNOT_SUBJECTS and view in (19, 20):
                    view += 2
                views.append(self._cam_dir_name(view))

        all_img_train, all_img_val = [], []
        for view in views:
            img_train, img_val = [], []
            for p in glob.glob(os.path.join(self.data_root, view, "*.jpg")):
                fi = self._frame_of(p)
                if begin <= fi < eval_begin_frame:
                    img_train.append(p)
                elif eval_begin_frame <= fi <= end:
                    img_val.append(p)
            all_img_train += self._sorted_by_frame(img_train)[::interval]
            all_img_val += self._sorted_by_frame(img_val)[::interval]

        self.all_img_path = all_img_val if novel_pose else all_img_train
        self.train_max_frame = train_max_frame
        self.mode = "infer"
        self.novel_pose = novel_pose

    def __getitem__(self, idx):
        item = super().__getitem__(idx)
        if self.novel_pose:
            item["frame"] = int(self.rng.integers(0, self.train_max_frame))
        return item
