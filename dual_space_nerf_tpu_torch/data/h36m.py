"""Human3.6M dataset (host-side numpy, no cv2), as the JAX package's
`data/h36m.py`, item for item: ray sampling with NORMALIZED directions,
slab-test near/far, rigid transforms. The images are read by
`utils/image_io.py::imread` and the cv2 operations are `data/image_ops.py`'s
and `data/cameras.py`'s, each equal to cv2's output.

Differences from the original implementation, kept from the JAX package:
- The reference has a latent bug — `joints` is used before assignment
  because its loading lines are commented out (`h36m_dataset.py:62-67`), so
  the shipped H36M path crashes. Here the X-pose joints ARE loaded
  (`lbs/X_smpl_joints.npy`, falling back to `lbs/joints.npy`), which is what
  those commented lines did.
- No torch: plain numpy item dicts.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.image_io import imread
from . import cameras as camera_utils
from .image_ops import dilate, erode, resize_area, resize_nearest, rodrigues
from .rays import build_sample_pools, get_near_far_h36m, sample_rays


def get_bounds(xyz: np.ndarray, delta: float = 0.05) -> np.ndarray:
    min_xyz = np.min(xyz, axis=0) - delta
    max_xyz = np.max(xyz, axis=0) + delta
    return np.stack([min_xyz, max_xyz], axis=0).astype(np.float32)


def batch_rodrigues(poses: np.ndarray) -> np.ndarray:
    """Rotation vectors (N, 3) -> matrices (N, 3, 3) (`h36m_utils.py:208-226`)."""
    angle = np.linalg.norm(poses + 1e-8, axis=1, keepdims=True)
    rot_dir = poses / angle
    cos = np.cos(angle)[:, None]
    sin = np.sin(angle)[:, None]
    rx, ry, rz = np.split(rot_dir, 3, axis=1)
    zeros = np.zeros([poses.shape[0], 1])
    K = np.concatenate(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx], axis=1
    )
    K = np.concatenate([K, zeros], axis=1).reshape(-1, 3, 3)
    return np.eye(3)[None] + sin * K + (1 - cos) * np.matmul(K, K)


def get_rigid_transformation(
    poses: np.ndarray, joints: np.ndarray, parents: np.ndarray
) -> np.ndarray:
    """Forward-kinematics per-joint 3x4 world transforms
    (`h36m_utils.py:229-261`)."""
    rot_mats = batch_rodrigues(poses)
    rel_joints = joints.copy()
    rel_joints[1:] -= joints[parents[1:]]
    transforms_mat = np.concatenate([rot_mats, rel_joints[..., None]], axis=2)
    padding = np.zeros([len(joints), 1, 4])
    padding[..., 3] = 1
    transforms_mat = np.concatenate([transforms_mat, padding], axis=1)

    chain = [transforms_mat[0]]
    for i in range(1, parents.shape[0]):
        chain.append(chain[parents[i]] @ transforms_mat[i])
    transforms = np.stack(chain, axis=0)

    joints_homogen = np.concatenate([joints, np.zeros([len(joints), 1])], axis=1)
    rel = np.sum(transforms * joints_homogen[:, None], axis=2)
    transforms[..., 3] = transforms[..., 3] - rel
    return transforms.astype(np.float32)


def crop_mask_edge(msk: np.ndarray, border: int = 10) -> np.ndarray:
    """Zero out the eroded/dilated boundary band of a mask."""
    kernel = np.ones((border, border), np.uint8)
    msk_erode = erode(msk.copy(), kernel)
    msk_dilate = dilate(msk.copy(), kernel)
    out = msk.copy()
    out[(msk_dilate - msk_erode) == 1] = 100
    return out


class H36M:
    def __init__(
        self, cfg, data_root, human, ann_file, split, nrays=2000,
        test_novel_pose=False, is_eval=False, is_formal=True,
        seed: int | None = 233,
    ):
        self.cfg = cfg
        self.data_root = data_root
        self.human = human
        self.split = split
        self.is_eval = is_eval
        self.test_novel_pose = test_novel_pose
        self.nrays = nrays
        # seeded like the reference's global np.random.seed(233)
        # (`main.py:22-26`): eval frame codes reproduce across runs
        self.rng = np.random.default_rng(seed)
        # multi-host contract (same as data/zju.py::MocapBase): per-(epoch,
        # item) rng so every process samples identical rays
        self.item_seed = 0 if seed is None else int(seed)
        self.deterministic_items = False
        self._epoch = 0
        # epoch-persistent decoded-frame cache (see data/zju.py; H36M
        # frames cache as float32 post-undistort — the reference undistorts
        # the /255 float image, so a uint8 cache would not be bit-identical)
        from .zju import cache_images_enabled

        self.cache_images = cache_images_enabled()
        self._image_cache: dict[int, tuple] = {}
        self._input_cache: dict[int, tuple] = {}
        # static sampler inputs per item (data/rays.py::SamplePools)
        self._pools_cache: dict[int, object] = {}

        annots = np.load(ann_file, allow_pickle=True).item()
        self.cams = annots["cams"]
        num_cams = len(self.cams["K"])
        if len(cfg.test_view) == 0:
            test_view = [i for i in range(num_cams) if i not in cfg.training_view]
            if not test_view:
                test_view = [0]
        else:
            test_view = cfg.test_view
        view = cfg.training_view if split == "train" else test_view

        i = cfg.begin_ith_frame
        i_intv = cfg.frame_interval
        ni = cfg.num_train_frame
        self.i_intv = i_intv
        if test_novel_pose:
            i = cfg.begin_ith_frame + cfg.num_train_frame * i_intv
            ni = cfg.num_eval_frame if is_formal else cfg.my_num_eval_frame

        self.ims = np.array(
            [
                np.array(ims_data["ims"])[view]
                for ims_data in annots["ims"][i : i + ni * i_intv][::i_intv]
            ]
        ).ravel()
        self.cam_inds = np.array(
            [
                np.arange(len(ims_data["ims"]))[view]
                for ims_data in annots["ims"][i : i + ni * i_intv][::i_intv]
            ]
        ).ravel()
        self.num_cams = len(view)

        self.lbs_root = os.path.join(data_root, "lbs")
        # Reference bug fixed: actually load the canonical joints
        # (h36m_dataset.py:62-67 leaves `joints` unbound).
        joints_path = os.path.join(self.lbs_root, "X_smpl_joints.npy")
        if not os.path.exists(joints_path):
            joints_path = os.path.join(self.lbs_root, "joints.npy")
        joints = np.load(joints_path)
        self.joints = joints.squeeze().astype(np.float32)
        self.parents = np.load(os.path.join(self.lbs_root, "parents.npy"))
        self.canonical_vertex = np.load(
            os.path.join(self.lbs_root, "X_smpl_vertices.npy")
        ).squeeze()

    def get_mask(self, index):
        msk_path = os.path.join(
            self.data_root, "mask_cihp", self.ims[index]
        )[:-4] + ".png"
        if not os.path.exists(msk_path):
            msk_path = os.path.join(
                self.data_root, self.ims[index].replace("images", "mask")
            )[:-4] + ".png"
        if not os.path.exists(msk_path):
            raise FileNotFoundError(msk_path)
        msk_cihp = imread(msk_path)
        if msk_cihp.ndim == 3:
            msk_cihp = msk_cihp[..., 0]
        msk_cihp_binary = (msk_cihp != 0).astype(np.uint8)
        msk = msk_cihp_binary.copy()
        orig_msk = msk.copy()
        if not self.is_eval:
            msk = crop_mask_edge(msk, border=5)
        return msk, orig_msk, msk_cihp

    def prepare_input(self, i):
        if self.cache_images:
            hit = self._input_cache.get(i)
            if hit is None:
                hit = self._prepare_input_uncached(i)
                self._input_cache[i] = hit
            # all consumers treat these as read-only (poses goes through
            # .astype copies before leaving __getitem__)
            return hit
        return self._prepare_input_uncached(i)

    def _prepare_input_uncached(self, i):
        wxyz = np.load(
            os.path.join(self.data_root, self.cfg.vertices, f"{i}.npy")
        ).astype(np.float32)
        params = np.load(
            os.path.join(self.data_root, self.cfg.params, f"{i}.npy"),
            allow_pickle=True,
        ).item()
        Rh = params["Rh"].astype(np.float32)
        Th = params["Th"].astype(np.float32)
        R = rodrigues(Rh).astype(np.float32)
        pxyz = np.dot(wxyz - Th, R).astype(np.float32)
        poses = params["poses"].reshape(-1, 3)
        A = get_rigid_transformation(poses, self.joints, self.parents)
        return wxyz, pxyz, A, R, Th, poses

    def _decode_frame(self, index: int):
        """Decoded frame products (img f32, msk, orig_msk, eroded cihp, H, W)
        — everything per-index that is constant across epochs; cached."""
        if self.cache_images:
            hit = self._image_cache.get(index)
            if hit is not None:
                return hit

        img_path = os.path.join(self.data_root, self.ims[index])
        img = imread(img_path).astype(np.float32) / 255.0
        msk, orig_msk, msk_cihp = self.get_mask(index)

        H, W = img.shape[:2]
        msk = resize_nearest(msk, (W, H))
        orig_msk = resize_nearest(orig_msk, (W, H))

        cam_ind = self.cam_inds[index]
        K = np.array(self.cams["K"][cam_ind])
        D = np.array(self.cams["D"][cam_ind])
        img = camera_utils.undistort(img, K, D)
        msk = camera_utils.undistort(msk, K, D)
        orig_msk = camera_utils.undistort(orig_msk, K, D)
        msk_cihp = camera_utils.undistort(msk_cihp, K, D)

        H, W = int(H * self.cfg.ratio), int(W * self.cfg.ratio)
        img = resize_area(img, (W, H))
        msk = resize_nearest(msk, (W, H))
        orig_msk = resize_nearest(orig_msk, (W, H))
        img[orig_msk == 0] = 0

        kernel = np.ones((10, 10), np.uint8)
        msk_cihp_eroded = erode(msk_cihp.copy(), kernel)
        msk_cihp_eroded = resize_nearest(msk_cihp_eroded, (W, H))
        out = (img, msk, orig_msk, msk_cihp_eroded, H, W)
        if self.cache_images:
            self._image_cache[index] = out
        return out

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def _item_rng(self, i: int):
        # getattr-defensive: novel-pose subclasses bypass this __init__
        # (same contract as data/zju.py::MocapBase._item_rng)
        if getattr(self, "deterministic_items", False):
            return np.random.default_rng([
                getattr(self, "item_seed", 0),
                getattr(self, "_epoch", 0),
                int(i),
            ])
        return self.rng

    def __getitem__(self, index):
        img_path = os.path.join(self.data_root, self.ims[index])
        img, msk, orig_msk, msk_cihp_eroded, H, W = self._decode_frame(index)

        cam_ind = self.cam_inds[index]
        K = np.array(self.cams["K"][cam_ind]).copy()
        K[:2] = K[:2] * self.cfg.ratio
        R = np.array(self.cams["R"][cam_ind])
        T = np.array(self.cams["T"][cam_ind]) / 1000.0

        i = int(os.path.basename(img_path)[:-4])
        frame_index = i

        wpts, ppts, A, Rh, Th, poses = self.prepare_input(i)
        wbounds = get_bounds(wpts)
        pbounds = get_bounds(ppts)

        nrays = self.nrays if self.split == "train" else -1
        pools = None
        if self.cache_images:
            # lazy: subclasses (novel-pose loaders) bypass this __init__
            if not hasattr(self, "_pools_cache"):
                self._pools_cache = {}
            pools = self._pools_cache.get(index)
        if pools is None:
            pools = build_sample_pools(
                H, W, K, R, T, wbounds,
                mask=(msk == 1).astype(np.uint8), face_mask=msk_cihp_eroded,
            )
            if self.cache_images:
                self._pools_cache[index] = pools
        rgb, ray_o, ray_d, near, far, coord, mask_at_box, _ = sample_rays(
            img, K, R, T, wbounds,
            mask=(msk == 1).astype(np.uint8), face_mask=msk_cihp_eroded,
            nrays=nrays, rng=self._item_rng(index), normalize_dirs=True,
            near_far=get_near_far_h36m, pools=pools,
        )

        orig_msk_c = crop_mask_edge(orig_msk)
        occupancy = (orig_msk_c != 0).astype(np.uint8)[coord[:, 0], coord[:, 1]]

        n_train_frame = getattr(self.cfg, "num_train_frame", 1)
        # the reference's frame-embedding index for EVERY split is
        # latent_index = index // num_cams, clamped to the last trained row
        # for novel pose (`h36m_dataset.py:234-236`,
        # `h36m_dataset_test.py:224-226`) — NOT frame_index/i_intv, which
        # would skip embedding rows whenever begin_ith_frame > 0
        latent_index = index // self.num_cams
        if self.test_novel_pose:
            latent_index = n_train_frame - 1
        frame = latent_index

        return {
            "img": img,
            "coord": coord,
            "rgb": rgb,
            "occupancy": occupancy.astype(np.float32),
            "ray_o": ray_o,
            "ray_d": ray_d,
            "near": near,
            "far": far,
            "mask_at_box": mask_at_box,
            "A": A,
            "poses": poses.astype(np.float32),
            "xyz": wpts,
            "bounds": wbounds,
            "pbounds": pbounds,
            "Rh": Rh,
            "Th": Th,
            "R": R,
            "T": T,
            "H": H,
            "W": W,
            "latent_index": latent_index,
            "frame_index": frame_index,
            "cam_ind": cam_ind,
            "frame": frame,
            "save_name": f"frame{frame_index:04d}_view{cam_ind:04d}",
        }

    def __len__(self):
        return len(self.ims)
