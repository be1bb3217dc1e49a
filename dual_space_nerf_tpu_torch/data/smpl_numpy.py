"""Pure-numpy SMPL forward (linear blend skinning), as the JAX package's
`data/smpl_numpy.py`, from the model pickle:

    verts = LBS(v_template + shapedirs.betas + posedirs.pose_feat,
                J(beta), pose, weights)

Conventions follow the SMPL reference implementation: 24 joints,
axis-angle pose (24, 3), shape betas (10,), optional global Rh/Th applied
afterward (the ZJU convention stores Rh/Th separately:
`dataloader/zju_mocap_dataset.py:70-74`).
"""

from __future__ import annotations

import numpy as np

from .h36m import batch_rodrigues
from .smpl import load_bodydata


class SMPLModel:
    def __init__(self, model_path: str, gender: str = "neutral"):
        data = load_bodydata(model_path, gender=gender)
        self.v_template = np.asarray(data["v_template"], np.float64)   # (V, 3)
        self.shapedirs = np.asarray(data["shapedirs"], np.float64)     # (V, 3, 10)
        self.posedirs = np.asarray(data["posedirs"], np.float64)       # (V, 3, 207)
        jr = data["J_regressor"]
        self.J_regressor = np.asarray(
            jr.toarray() if hasattr(jr, "toarray") else jr, np.float64
        )                                                              # (24, V)
        self.weights = np.asarray(data["weights"], np.float64)         # (V, 24)
        self.parents = np.asarray(data["kintree_table"][0], np.int64).copy()
        self.parents[0] = -1
        self.faces = np.asarray(data["f"], np.int32)

    def joints(self, betas: np.ndarray | None = None) -> np.ndarray:
        v = self.v_template
        if betas is not None:
            v = v + self.shapedirs @ np.asarray(betas, np.float64)
        return self.J_regressor @ v                                    # (24, 3)

    def forward(
        self,
        poses: np.ndarray,
        betas: np.ndarray | None = None,
        Rh: np.ndarray | None = None,
        Th: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """poses (24, 3) axis-angle; betas (10,). Returns (verts (V, 3),
        joints_posed (24, 3)) in model space, then rigidly transformed by
        (Rh, Th) when given."""
        poses = np.asarray(poses, np.float64).reshape(24, 3)
        v_shaped = self.v_template
        if betas is not None:
            v_shaped = v_shaped + self.shapedirs @ np.asarray(betas, np.float64)
        j = self.J_regressor @ v_shaped                                # (24, 3)

        rot_mats = batch_rodrigues(poses)                              # (24,3,3)
        # pose blendshapes from the 23 non-root joint rotations
        ident = np.eye(3)
        pose_feat = (rot_mats[1:] - ident).reshape(-1)                 # (207,)
        v_posed = v_shaped + self.posedirs @ pose_feat

        # forward kinematics
        transforms = np.zeros((24, 4, 4))
        rel_j = j.copy()
        rel_j[1:] -= j[self.parents[1:]]
        for i in range(24):
            local = np.eye(4)
            local[:3, :3] = rot_mats[i]
            local[:3, 3] = rel_j[i]
            if i == 0:
                transforms[i] = local
            else:
                transforms[i] = transforms[self.parents[i]] @ local
        j_posed = transforms[:, :3, 3].copy()
        # remove the rest-pose joint location (relative skinning transform)
        for i in range(24):
            transforms[i, :3, 3] -= transforms[i, :3, :3] @ j[i]

        # linear blend skinning
        T = np.einsum("vj,jab->vab", self.weights, transforms)         # (V,4,4)
        v_h = np.concatenate([v_posed, np.ones((len(v_posed), 1))], 1)
        verts = np.einsum("vab,vb->va", T, v_h)[:, :3]

        if Rh is not None:
            R = (
                batch_rodrigues(np.asarray(Rh, np.float64).reshape(1, 3))[0]
                if np.asarray(Rh).size == 3
                else np.asarray(Rh, np.float64)
            )
            verts = verts @ R.T
            j_posed = j_posed @ R.T
        if Th is not None:
            verts = verts + np.asarray(Th, np.float64).reshape(1, 3)
            j_posed = j_posed + np.asarray(Th, np.float64).reshape(1, 3)
        return verts.astype(np.float32), j_posed.astype(np.float32)
