"""The dual-space volume-rendering pipeline: exact full shading, eval path.

  GG near/far -> z -> world nearest-face search -> warp (world -> canonical)
  -> canonical nearest-face search -> SpaceNet (+ autograd density normal)
  -> normal (canonical -> world) -> LightingMLP -> transparent mask
  -> composite

The same math as the JAX package's `renderer/pipeline.py` on its
materialized dataflow (the route the JAX package takes on the CPU): the warp
and the triangle gathers are computed for the whole chunk, then the
networks run over point slices of `mlp_chunk`. Both nearest-face searches
are the brute-force search (`ops.nearest_face`), a CUDA kernel on the card.

Not ported yet, and refused when asked for: importance-gated shading
(SHADE_TOPK), face reuse (REUSE_WARP_FACES), the fused SpaceNet kernels
(FUSED_MLP), hierarchical sampling (FINE_RAY_SAMPLING), the listed, pruned,
grouped and clustered searches, and the face-id dataflow.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..geometry import (
    barycentric_map,
    composite,
    project_point2mesh,
    sample_along_rays,
    stratified_z,
    transparent_mask,
)
from ..ops import face_centroids, gg_near_far_cuda, nearest_face
from ..ops.nearest_face import check_knn_impl

# The renderer is float32 throughout and is held against a float32 reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class MeshBundle(NamedTuple):
    """Posed mesh of one frame + canonical mesh of the sequence.
    faces: (F, 3) int64; verts_world, verts_cano: (V, 3) float32."""

    faces: torch.Tensor
    verts_world: torch.Tensor
    verts_cano: torch.Tensor


class RayBatch(NamedTuple):
    """One chunk of rays of one image."""

    ray_o: torch.Tensor      # (R, 3)
    ray_d: torch.Tensor      # (R, 3), not normalized
    near: torch.Tensor       # (R,)
    far: torch.Tensor        # (R,)
    frame: int               # frame-embedding index
    body_pose: torch.Tensor  # (23, 3) joint rotation vectors (poses[1:])


class LightState(NamedTuple):
    """Inference-time lighting manipulation (identity by default).

    rot: (2, 2) rotation of world xy about rot_center; light_bias: (3,)
    translation of the world coordinates the LightingMLP sees; code_scale:
    scales the frame code (0 zeroes it, as for novel poses)."""

    rot: torch.Tensor
    rot_center: torch.Tensor
    light_bias: torch.Tensor
    code_scale: torch.Tensor

    @staticmethod
    def identity(device=None) -> "LightState":
        return LightState(
            rot=torch.eye(2, dtype=torch.float32, device=device),
            rot_center=torch.zeros((3,), dtype=torch.float32, device=device),
            light_bias=torch.zeros((3,), dtype=torch.float32, device=device),
            code_scale=torch.ones((), dtype=torch.float32, device=device),
        )


def resolve_mlp_chunk(cfg_value: int, shade_topk: int) -> int:
    """MODEL.MLP_CHUNK: a positive value as it is; <= 0 is "auto", the JAX
    package's policy (16384 for lightly gated shading, else 8192)."""
    if cfg_value and int(cfg_value) > 0:
        return int(cfg_value)
    return 16384 if 0 < shade_topk <= 8 else 8192


def _fused_requested(cfg_value) -> bool:
    """MODEL.FUSED_MLP as the JAX package resolves it ("auto" is off)."""
    if isinstance(cfg_value, str):
        v = cfg_value.lower()
        if v in ("auto", "off", "false", "0"):
            return False
        if v in ("on", "true", "1"):
            return True
        raise ValueError(f"MODEL.FUSED_MLP={cfg_value!r}: expected auto/on/off")
    return bool(cfg_value)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Settings of the exact eval path, with the fields it reads."""

    n_samples: int = 64
    sample_mode: str = "GG"          # "GG" | "uniform"
    gg_gamma: float = 0.05
    mlp_chunk: int = 8192            # points per network call
    knn_impl: str = "auto"

    def __post_init__(self):
        if self.mlp_chunk < 1:
            raise ValueError(
                f"RenderSettings.mlp_chunk={self.mlp_chunk}: pass a positive "
                "chunk, or resolve the config's auto sentinel with resolve_mlp_chunk"
            )
        if self.sample_mode not in ("GG", "uniform"):
            raise ValueError(f"sample_mode {self.sample_mode!r}: expected 'GG' or 'uniform'")
        check_knn_impl(self.knn_impl)

    @classmethod
    def from_cfg(cls, cfg) -> "RenderSettings":
        """Settings from a config tree. Raises NotImplementedError for the
        options whose code paths are not ported yet (see ROADMAP.md)."""
        shade_topk = max(cfg.MODEL.SHADE_TOPK, 0)
        if shade_topk > 0:
            raise NotImplementedError("MODEL.SHADE_TOPK > 0 (gated shading) is not ported yet")
        if cfg.MODEL.REUSE_WARP_FACES:
            raise NotImplementedError("MODEL.REUSE_WARP_FACES is not ported yet")
        if _fused_requested(cfg.MODEL.FUSED_MLP):
            raise NotImplementedError("MODEL.FUSED_MLP (fused SpaceNet kernels) is not ported yet")
        if cfg.MODEL.FINE_RAY_SAMPLING > 0:
            raise NotImplementedError("MODEL.FINE_RAY_SAMPLING > 0 (hierarchical pass) is not ported yet")
        if cfg.MODEL.MATMUL_PRECISION != "f32":
            raise NotImplementedError("MODEL.MATMUL_PRECISION other than 'f32' is not ported yet")
        return cls(
            n_samples=cfg.MODEL.COARSE_RAY_SAMPLING,
            sample_mode=cfg.MODEL.sample_points_mode,
            mlp_chunk=resolve_mlp_chunk(cfg.MODEL.MLP_CHUNK, shade_topk),
            knn_impl=cfg.MODEL.KNN_IMPL,
        )


def _safe_unit(v: torch.Tensor) -> torch.Tensor:
    """v / sqrt(sum v^2 + 1e-24): unit vectors whose backward is 0, not NaN,
    at v == 0 (the JAX package's `_safe_unit`)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)


def _faces_table(mesh: MeshBundle) -> torch.Tensor:
    """(F, 18) rows of [world triangle (9) | canonical triangle (9)] per face:
    one row gather per point serves both spaces."""
    return torch.cat(
        [
            mesh.verts_world[mesh.faces].reshape(-1, 9),
            mesh.verts_cano[mesh.faces].reshape(-1, 9),
        ],
        dim=-1,
    )


def warp_world_to_canonical(
    pts_w: torch.Tensor,
    mesh: MeshBundle,
    centroids_w: torch.Tensor,
    settings: RenderSettings,
    fidx: torch.Tensor | None = None,
):
    """Barycentric-project points onto their nearest posed triangle and
    rebuild them on the same canonical triangle.

    pts_w: (N, 3). Returns (pts_cano (N, 3), tmask (N,), face_idx (N,)).
    fidx: optional precomputed nearest-face ids."""
    if fidx is None:
        fidx = nearest_face(pts_w, centroids_w, settings.knn_impl)
    tris_wc = _faces_table(mesh)[fidx]                              # (N, 18)
    tris_w = tris_wc[:, :9].reshape(-1, 3, 3)
    tris_c = tris_wc[:, 9:].reshape(-1, 3, 3)
    uv, h = project_point2mesh(pts_w, tris_w)
    return barycentric_map(uv, h, tris_c), transparent_mask(uv, h), fidx


def _transport_normal(pts_c, normal_local, tris_c, tris_w) -> torch.Tensor:
    """Carry a canonical point and its offset along the density gradient
    through the same triangle to the posed mesh; the unit difference."""
    uv, h = project_point2mesh(pts_c, tris_c)
    start_w = barycentric_map(uv, h, tris_w)
    uv2, h2 = project_point2mesh(pts_c + normal_local, tris_c)
    end_w = barycentric_map(uv2, h2, tris_w)
    return _safe_unit(end_w - start_w)


def normal_canonical_to_world(
    pts_c: torch.Tensor,
    normal_local: torch.Tensor,
    mesh: MeshBundle,
    centroids_c: torch.Tensor,
    settings: RenderSettings,
) -> torch.Tensor:
    """World-space unit normals from canonical density gradients, through a
    second nearest-face search in canonical space (as the reference does)."""
    cidx = nearest_face(pts_c, centroids_c, settings.knn_impl)
    tri_vidx = mesh.faces[cidx]
    return _transport_normal(
        pts_c, normal_local, mesh.verts_cano[tri_vidx], mesh.verts_world[tri_vidx]
    )


def _point_network(model, pts_w, pts_c, dir_w, code, pose_feat, code_scale,
                   tris_c2, tris_w2):
    """color (n, 3), sigma (n,) for one slice of points.

    The normal is d(sum sigma)/d(pts_c), one autograd backward over the
    slice; at eval it builds no second-order graph."""
    with torch.enable_grad():
        pc = pts_c.detach().requires_grad_(True)
        essence, density = model.sigma_essence(pc, code, pose_feat, code_scale)
        (normal_local,) = torch.autograd.grad(density.sum(), pc)
    essence = essence.detach()
    normal_w = _transport_normal(pts_c, normal_local, tris_c2, tris_w2)
    color = model.lighting(normal_w, pts_w, dir_w, essence)
    return color, density.detach()[:, 0]


def _check_devices(device: torch.device, model, *tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"render_rays: an input is on {t.device}, expected {device}")
    p = next(model.parameters())
    if p.device != device:
        raise ValueError(f"render_rays: the model is on {p.device}, expected {device}")


@torch.no_grad()
def render_rays(
    model,
    batch: RayBatch,
    mesh: MeshBundle,
    settings: RenderSettings,
    light: LightState,
    device: str | torch.device | None = None,
) -> dict[str, torch.Tensor]:
    """Render one chunk of rays (eval: no perturbation, no noise).

    Runs on CUDA unless ``device`` says otherwise; every input and the model
    must already be on that device. Returns color (R, 3), disp_map/acc_map/
    depth_map (R,), weights/z_vals (R, S)."""
    dev = resolve_device(device)
    _check_devices(dev, model, batch.ray_o, batch.ray_d, batch.near, batch.far,
                   batch.body_pose, mesh.verts_world, mesh.verts_cano, mesh.faces,
                   light.rot)
    near, far = batch.near, batch.far
    if settings.sample_mode == "GG":
        near, far = gg_near_far_cuda(
            batch.ray_o, batch.ray_d, near, far, mesh.verts_world, settings.gg_gamma
        )
    z_vals = stratified_z(near, far, settings.n_samples)
    return _render_with_z(model, batch, mesh, settings, light, z_vals)


def _render_with_z(model, batch: RayBatch, mesh: MeshBundle,
                   settings: RenderSettings, light: LightState,
                   z_vals: torch.Tensor) -> dict[str, torch.Tensor]:
    """warp + networks + composite for given per-ray z values (R, S)."""
    r, s = z_vals.shape
    n = r * s
    pts_w = sample_along_rays(batch.ray_o, batch.ray_d, z_vals).reshape(n, 3)
    dir_w = batch.ray_d[:, None, :].expand(r, s, 3).reshape(n, 3)

    centroids_w = face_centroids(mesh.verts_world, mesh.faces)
    centroids_c = face_centroids(mesh.verts_cano, mesh.faces)

    # both searches depend on geometry only; each runs once per chunk
    fidx_w = nearest_face(pts_w, centroids_w, settings.knn_impl)
    pts_c, tmask, _ = warp_world_to_canonical(
        pts_w, mesh, centroids_w, settings, fidx=fidx_w
    )
    cidx = nearest_face(pts_c, centroids_c, settings.knn_impl)
    tris_wc2 = _faces_table(mesh)[cidx]                              # (N, 18)
    tris_w2 = tris_wc2[:, :9].reshape(-1, 3, 3)
    tris_c2 = tris_wc2[:, 9:].reshape(-1, 3, 3)

    pose_feat = model.pose_feature(batch.body_pose)                  # (16,)
    code = model.frame_code(batch.frame)

    # light-space manipulation of the world coords the LightingMLP sees
    xy = (pts_w[:, :2] - light.rot_center[:2]) @ light.rot + light.rot_center[:2]
    pts_w_light = torch.cat([xy, pts_w[:, 2:]], dim=-1) + light.light_bias

    color = torch.empty((n, 3), dtype=pts_w.dtype, device=pts_w.device)
    sigma = torch.empty((n,), dtype=pts_w.dtype, device=pts_w.device)
    for a in range(0, n, settings.mlp_chunk):
        sl = slice(a, a + settings.mlp_chunk)
        m = pts_w[sl].shape[0]
        c, sg = _point_network(
            model, pts_w_light[sl], pts_c[sl], dir_w[sl], code,
            pose_feat.expand(m, pose_feat.shape[-1]), light.code_scale,
            tris_c2[sl], tris_w2[sl],
        )
        color[sl] = c
        sigma[sl] = torch.where(tmask[sl], 0.0, sg)

    out = composite(color.reshape(r, s, 3), sigma.reshape(r, s), z_vals, batch.ray_d)
    return {
        "color": out.rgb,
        "disp_map": out.disp,
        "acc_map": out.acc,
        "depth_map": out.depth,
        "weights": out.weights,
        "z_vals": z_vals,
    }
