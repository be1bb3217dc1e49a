"""Novel-pose (motion-transfer) datasets, as the JAX package's
`data/zju_novel_pose.py`: drive a trained canonical avatar with unseen SMPL
vertex sequences:

- the image/camera is FIXED (first image of the view list; `__getitem__`
  always reads `all_img_path[0]`, :87) — only SMPL params/vertices advance;
- frame index advances as idx*4 through the novel-pose sequence (:92);
- `smpl_dir`/`vertices_dir` are re-pointed at a `novelpose_examples/...`
  directory by the caller (`novel_pose_vis.py:116-117`);
- the canonical vertices come from the PERFORMER (possibly another subject
  or an H36M performer, :41-48), giving cross-dataset motion transfer;
- dataset length is inflated x10 over the image list (:276).
"""

from __future__ import annotations

import os

import numpy as np

from .zju import MocapBase, MocapView


class NovelPoseMixin:
    """Overrides that decouple the (fixed) camera image from the (advancing)
    pose sequence."""

    def load_performer_canonical(
        self, performer: str, zju_data_dir: str, h36m_data_dir: str
    ):
        if "CoreView" in performer:
            path = os.path.join(zju_data_dir, performer, "X_smpl_vertices.npy")
        else:
            path = os.path.join(
                h36m_data_dir, performer, "Posing", "lbs", "X_smpl_vertices.npy"
            )
        self.canonical_vertex = np.load(path).squeeze()

    def set_novel_pose_dirs(self, smpl_dir: str, vertices_dir: str):
        """Re-point pose/vertex sources at a novel-pose example sequence."""
        self.smpl_dir = smpl_dir
        self.vertices_dir = vertices_dir
        # the per-frame SMPL-input cache is keyed by frame index only; a
        # dir re-point invalidates it
        self._input_cache.clear()

    def __getitem__(self, idx: int) -> dict:
        # fixed camera/image; pose advances 4 frames per item
        frame_name = idx * 4
        item = self._render_fixed_image(frame_name)
        return item

    def _render_fixed_image(self, frame_name: int) -> dict:
        orig_paths = self.all_img_path
        try:
            # reuse the base pipeline on the fixed first image, then override
            # the pose-dependent fields for `frame_name`
            self.all_img_path = [orig_paths[0]]
            self._forced_frame_name = frame_name
            item = MocapBase.__getitem__(self, 0)
        finally:
            self.all_img_path = orig_paths
        item["frame"] = frame_name
        item["save_name"] = f"pose{frame_name:06d}"
        return item

    def _raw_frame_name(self, img_path: str) -> int:
        # pose files are indexed by the forced novel-pose frame, not the image
        return getattr(self, "_forced_frame_name", 0)


class MocapNovelPoseView(NovelPoseMixin, MocapView):
    """Fixed-view novel-pose rendering dataset (zju_novel_pose Mocap_view)."""

    def __init__(
        self, human="CoreView_377", ratio=0.5, begin=0, end=300,
        train_views=(0, 6, 12, 18), train_max_frame=300, interval=30,
        vis_views=None, performer="S8", zju_data_dir="", h36m_data_dir="",
    ):
        MocapView.__init__(
            self, human, ratio, begin, end, train_views, train_max_frame,
            interval, vis_views, data_dir=zju_data_dir,
        )
        self.load_performer_canonical(performer, zju_data_dir, h36m_data_dir)
        self._len = len(self.all_img_path) * 10  # reference :276

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        return NovelPoseMixin.__getitem__(self, idx)
