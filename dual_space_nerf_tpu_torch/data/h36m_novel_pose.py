"""Cross-dataset motion transfer: H36M motion driving a ZJU performer, as
the JAX package's `data/h36m_novel_pose.py` (`H36MNovelPoses` and
`get_novel_pose_dataset`), with the data config read by the port's
yaml-free reader (`config/node.py::parse_config_text`). It iterates an H36M sequence's
images/poses (ni=1000 frames, :41) but takes the CANONICAL vertices from a
(possibly ZJU) performer (:58-62), so a trained avatar is animated by the
other dataset's motion. Unlike the base H36M class it loads no joints/blend
weights (:107-110 commented in reference) and keeps the target frame index
(`frame = frame_index // i_intv`, no randomization).
"""

from __future__ import annotations

import os

import numpy as np

from .h36m import H36M
from .image_ops import rodrigues
from .select import load_yml_as_cfg


class H36MNovelPoses(H36M):
    def __init__(
        self, cfg, data_root, human, ann_file, split, nrays=2000,
        test_novel_pose=False, is_eval=False, performer="CoreView_377",
        zju_data_dir="", h36m_data_dir="",
    ):
        self.cfg = cfg
        self.data_root = data_root
        self.human = human
        self.split = split
        self.is_eval = is_eval
        self.test_novel_pose = test_novel_pose
        self.nrays = nrays
        # seeded like the reference's global np.random.seed(233)
        self.rng = np.random.default_rng(233)
        from .zju import cache_images_enabled

        self.cache_images = cache_images_enabled()
        self._image_cache = {}
        self._input_cache = {}

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
        ni = 1000  # whole sequence (reference :41)
        self.i_intv = i_intv
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

        # canonical avatar comes from the PERFORMER, not this sequence
        if "CoreView" in performer:
            canon = os.path.join(zju_data_dir, performer, "X_smpl_vertices.npy")
        else:
            canon = os.path.join(
                h36m_data_dir, performer, "Posing", "lbs", "X_smpl_vertices.npy"
            )
        self.canonical_vertex = np.load(canon).squeeze()
        # joints unused in this path; keep base-class attrs harmless
        self.joints = np.zeros((24, 3), np.float32)
        self.parents = np.concatenate([[-1], np.zeros(23, np.int64)])

    def prepare_input(self, i):
        wxyz = np.load(
            os.path.join(self.data_root, self.cfg.vertices, f"{i}.npy")
        ).astype(np.float32).squeeze()
        params = np.load(
            os.path.join(self.data_root, self.cfg.params, f"{i}.npy"),
            allow_pickle=True,
        ).item()
        Rh = params["Rh"].astype(np.float32)
        Th = params["Th"].astype(np.float32)
        R = rodrigues(Rh).astype(np.float32)
        pxyz = np.dot(wxyz - Th, R).astype(np.float32)
        poses = params["poses"].reshape(-1, 3)
        # no rigid transforms / blend weights in the motion-transfer path
        return wxyz, pxyz, np.zeros((24, 4, 4), np.float32), R, Th, poses

    def __getitem__(self, index):
        item = super().__getitem__(index)
        # keep the sequence's own frame code timeline (reference disables the
        # randomization of the base class, :226-227)
        item["frame"] = item["frame_index"] // self.i_intv
        return item


def get_novel_pose_dataset(performer, motion_seq, zju_data_dir, h36m_data_dir):
    """`utils`-style factory (reference :232-246): data_configs/novel_poses/
    {performer}_{motion_seq}.yml configures the pairing."""
    from .select import resolve_data_config

    yaml_path = resolve_data_config(
        f"data_configs/novel_poses/{performer}_{motion_seq}.yml"
    )
    mycfg = load_yml_as_cfg(yaml_path)
    data_root = f"{h36m_data_dir}/{motion_seq}/Posing"
    ann_file = f"{data_root}/annots.npy"
    return H36MNovelPoses(
        mycfg, data_root, motion_seq, ann_file, "test", nrays=2000,
        test_novel_pose=True, is_eval=True, performer=performer,
        zju_data_dir=zju_data_dir, h36m_data_dir=h36m_data_dir,
    )
