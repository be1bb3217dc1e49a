"""The dual-space volume-rendering pipeline, eval path.

Exact full shading (`configs/zju_mocap/313.yml`):

  GG near/far -> z -> world nearest-face search -> warp (world -> canonical)
  -> canonical nearest-face search -> SpaceNet (+ autograd density normal)
  -> normal (canonical -> world) -> LightingMLP -> transparent mask
  -> composite

Importance-gated shading (`configs/zju_mocap/313_tpu.yml`: SHADE_TOPK 16,
REUSE_WARP_FACES): the density of every sample from a forward pass that
builds no autograd graph, then the color chain (canonical search, normal,
transport, LightingMLP) only on the K samples per ray with the largest
compositing weights; the other samples take the color of the nearest
selected sample of their ray. With face reuse the normal is transported
through the face the world search found, and the canonical search is gone.

The same math as the JAX package's `renderer/pipeline.py`. The searches are
`MODEL.KNN_IMPL`: the brute-force kernel ("auto", "pallas"), or the
list-driven ("listed") and sphere-pruned ("pruned") kernels of
`ops/pruned_knn.py`, which take the points in the block-coherent layout
(`_block_layout`). "listed" exchanges tile-slot ids between the stages and
gathers from a slot-ordered face table. "grouped" searches the ray-major
points in sub-groups of 4, 2 or 1 consecutive samples of a ray (the largest
that divides the samples per ray) that share one candidate set of face
clusters, on the world search and the full path's canonical search; the
fused path's canonical search, the gated path's selected samples and
`normal_canonical_to_world` take groups of one, as in the JAX package.
"clustered" (per-point candidate clusters) and "xla" (the expanded-form
argmin, which misranks near-ties) run through `ops.nearest_face`. The three
are torch ops and need `MeshBundle.cluster_table` ("clustered", "grouped").

`MODEL.FUSED_MLP: "on"` runs SpaceNet's density, essence and normal chain
through the fused kernels of `ops/fused_mlp.py` (hand-derived second-order
backward): the density pass over all samples in one call, the color pass in
one call. "auto" is off, as in the JAX package. `MODEL.FUSED_FAST` feeds
their products bfloat16 operands (float32 sums); without `FUSED_MLP` it
changes nothing, as in the JAX package. `MODEL.MATMUL_PRECISION: "bf16"` is
the model's compute dtype (`models/spacenet.py`), not a render setting.

`MODEL.FINE_RAY_SAMPLING > 0` adds the hierarchical pass: `sample_pdf`
draws n_fine more z values from the coarse pass's weights, and the whole
chain runs again on the sorted S + n_fine values of each ray; its outputs
come back as `fine_*` beside the coarse ones.

Training (`render_rays(train=True, randoms=...)`) builds the autograd graph:
z is stratified with the passed-in uniforms, the passed-in normal noise
(scaled by raw_noise_std) is added to sigma before compositing, the normal
keeps its graph (second order), and the selection weights of the gated path
are detached. The fine pass takes its own uniforms and noise.

The JAX package's REMAT (rematerialization) and FUSED_BLOCK (the
TPU kernels' grid block) change no number; the port does not read them: it
keeps the whole graph, and its fused kernels tile by 64 points.
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
    sample_pdf,
    stratified_z,
    transparent_mask,
)
from ..models import compute_dtype
from ..ops import (
    face_centroids,
    nearest_face_grouped,
    gg_near_far_cuda,
    fused_sigma,
    fused_sigma_essence_normal,
    nearest_face,
    nerf_params,
    posenc,
    pruned_search_listed,
    slot_perm_from_tiles,
)
from ..ops.nearest_face import check_knn_impl

# The renderer is float32 throughout and is held against a float32 reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class MeshBundle(NamedTuple):
    """Posed mesh of one frame + canonical mesh of the sequence.
    faces: (F, 3) int64; verts_world, verts_cano: (V, 3) float32.

    For the pruned searches (`data.batching.item_to_mesh` fills them):
    face_perm (F,) the kd order of the faces ("pruned"); tile_table (T, 128)
    int32 kd-leaf face tiles, -1 padded ("listed"); cano_tables and
    world_tables, optional `listed_tables(centroids, tile_table)` of the
    canonical and the posed mesh, derived per search when None;
    cluster_table (C, cap) int32 kd-leaf face clusters, -1 padded
    ("clustered", "grouped")."""

    faces: torch.Tensor
    verts_world: torch.Tensor
    verts_cano: torch.Tensor
    face_perm: torch.Tensor | None = None
    tile_table: torch.Tensor | None = None
    cano_tables: tuple | None = None
    world_tables: tuple | None = None
    cluster_table: torch.Tensor | None = None


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


def resolve_fused(cfg_value) -> bool:
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
    """Settings of the eval path, with the fields it reads."""

    n_samples: int = 64
    sample_mode: str = "GG"          # "GG" | "uniform"
    gg_gamma: float = 0.05
    mlp_chunk: int = 8192            # points per network call
    knn_impl: str = "auto"
    # importance-gated shading: density at every sample, the color chain on
    # the shade_topk samples per ray with the largest weights; 0 = full
    # shading of every sample (reference-exact)
    shade_topk: int = 0
    # transport the normal through the world search's face instead of
    # searching again in canonical space (an approximation, off by default)
    reuse_warp_faces: bool = False
    # consecutive samples of a ray kept adjacent in the block-coherent point
    # layout of the listed and pruned searches
    block_sc: int = 32
    # training: stratified z (perturb > 0) and sigma noise of this standard
    # deviation; both draw on the randoms passed to render_rays
    perturb: float = 1.0
    raw_noise_std: float = 1.0
    # SpaceNet through the fused kernels (ops/fused_mlp.py); fused_fast:
    # their bfloat16-fed variants (read only with fused_mlp)
    fused_mlp: bool = False
    fused_fast: bool = False
    # hierarchical samples per ray of the fine pass (FINE_RAY_SAMPLING); 0: none
    n_fine: int = 0

    def __post_init__(self):
        if self.mlp_chunk < 1:
            raise ValueError(
                f"RenderSettings.mlp_chunk={self.mlp_chunk}: pass a positive "
                "chunk, or resolve the config's auto sentinel with resolve_mlp_chunk"
            )
        if self.sample_mode not in ("GG", "uniform"):
            raise ValueError(f"sample_mode {self.sample_mode!r}: expected 'GG' or 'uniform'")
        if self.shade_topk < 0:
            raise ValueError(f"RenderSettings.shade_topk={self.shade_topk}: expected >= 0")
        if self.block_sc < 1:
            raise ValueError(f"RenderSettings.block_sc={self.block_sc}: expected >= 1")
        if self.n_fine < 0:
            raise ValueError(f"RenderSettings.n_fine={self.n_fine}: expected >= 0")
        check_knn_impl(self.knn_impl)

    @classmethod
    def from_cfg(cls, cfg) -> "RenderSettings":
        """Settings from a config tree. Raises ValueError for an unknown
        KNN_IMPL and for a MATMUL_PRECISION that `models.compute_dtype`
        refuses (the model reads it: `cli/common.py::build_model`)."""
        shade_topk = max(cfg.MODEL.SHADE_TOPK, 0)
        compute_dtype(cfg)
        return cls(
            n_samples=cfg.MODEL.COARSE_RAY_SAMPLING,
            sample_mode=cfg.MODEL.sample_points_mode,
            mlp_chunk=resolve_mlp_chunk(cfg.MODEL.MLP_CHUNK, shade_topk),
            knn_impl=cfg.MODEL.KNN_IMPL,
            shade_topk=shade_topk,
            reuse_warp_faces=bool(cfg.MODEL.REUSE_WARP_FACES),
            perturb=float(cfg.MODEL.perturb),
            raw_noise_std=float(cfg.MODEL.raw_noise_std),
            fused_mlp=resolve_fused(cfg.MODEL.FUSED_MLP),
            fused_fast=bool(cfg.MODEL.FUSED_FAST),
            n_fine=max(cfg.MODEL.FINE_RAY_SAMPLING, 0),
        )


def _safe_unit(v: torch.Tensor) -> torch.Tensor:
    """v / sqrt(sum v^2 + 1e-24): unit vectors whose backward is 0, not NaN,
    at v == 0 (the JAX package's `_safe_unit`)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)


def _faces_table(mesh: MeshBundle, slot_perm: torch.Tensor | None = None) -> torch.Tensor:
    """(F, 18) rows of [world triangle (9) | canonical triangle (9)] per face:
    one row gather per point serves both spaces. With ``slot_perm`` ((T*128,)
    tile slot -> face id) the table is slot-ordered, (T*128, 18), matching
    the listed search's `return_slots=True` ids: one small permutation here
    replaces a translation gather per search."""
    table = torch.cat(
        [
            mesh.verts_world[mesh.faces].reshape(-1, 9),
            mesh.verts_cano[mesh.faces].reshape(-1, 9),
        ],
        dim=-1,
    )
    return table if slot_perm is None else table[slot_perm]


def _warp_chunk(pts_w: torch.Tensor, fidx: torch.Tensor, faces_wc: torch.Tensor):
    """Gather + barycentric transport for points with known face (or slot)
    ids: (pts_c, tmask, tris_w, tris_c). The stages exchange world points
    and ids and replay this wherever canonical coordinates are needed."""
    tris_wc = faces_wc[fidx]                                        # (n, 18)
    tris_w = tris_wc[:, :9].reshape(-1, 3, 3)
    tris_c = tris_wc[:, 9:].reshape(-1, 3, 3)
    uv, h = project_point2mesh(pts_w, tris_w)
    return barycentric_map(uv, h, tris_c), transparent_mask(uv, h), tris_w, tris_c


def _search(pts: torch.Tensor, centroids: torch.Tensor, mesh: MeshBundle,
            settings: RenderSettings, tables: tuple | None,
            return_slots: bool, group: int = 1) -> torch.Tensor:
    """Nearest face of (N, 3) points by the settings' search. The listed and
    pruned searches want block-coherent points; ``tables`` are the mesh's
    precomputed listed-search tables for these centroids, if any.
    return_slots (listed only): tile-slot ids for a slot-ordered table.
    group ("grouped" only): consecutive points that share one candidate set
    (samples of one ray, in ray-major order)."""
    if settings.knn_impl == "listed":
        if mesh.tile_table is None:
            raise ValueError("knn_impl 'listed' needs MeshBundle.tile_table (item_to_mesh builds it)")
        return pruned_search_listed(pts, centroids, mesh.tile_table,
                                    return_slots=return_slots, tables=tables)
    if settings.knn_impl == "grouped":
        if mesh.cluster_table is None:
            raise ValueError("knn_impl 'grouped' needs MeshBundle.cluster_table (item_to_mesh builds it)")
        n = pts.shape[0]
        return nearest_face_grouped(pts.reshape(n // group, group, 3), centroids,
                                    mesh.cluster_table).reshape(n)
    return nearest_face(pts, centroids, settings.knn_impl, mesh.cluster_table,
                        face_perm=mesh.face_perm)


def _search_canonical(pts_c: torch.Tensor, centroids_c: torch.Tensor, mesh: MeshBundle,
                      settings: RenderSettings, return_slots: bool = False,
                      group: int = 1) -> torch.Tensor:
    """Canonical-space nearest face with the settings' search. Warped points
    inherit the world layout's block coherence."""
    return _search(pts_c, centroids_c, mesh, settings, mesh.cano_tables, return_slots, group)


def ray_group(s: int) -> int:
    """The "grouped" search's sub-group of consecutive samples of a ray: 4,
    2 or 1, the largest that divides the s samples (the JAX package's
    `gsz`)."""
    return next(g for g in (4, 2, 1) if s % g == 0)


def warp_world_to_canonical(
    pts_w: torch.Tensor,
    mesh: MeshBundle,
    centroids_w: torch.Tensor,
    settings: RenderSettings,
    fidx: torch.Tensor | None = None,
    ray_d_w: torch.Tensor | None = None,
):
    """Barycentric-project points onto their nearest posed triangle and
    rebuild them on the same canonical triangle.

    pts_w: (N, 3). Returns (pts_cano (N, 3), tmask (N,), face_idx (N,)),
    and with ``ray_d_w`` (N, 3) world directions a fourth, their canonical
    unit directions: pts_w + ray_d_w carried through the same triangle,
    minus pts_cano, normalised (the JAX package's ray_d_cano; the render
    path does not use it). fidx: optional precomputed nearest-face ids."""
    if fidx is None:
        fidx = _search(pts_w, centroids_w, mesh, settings, mesh.world_tables, False)
    pts_c, tmask, tris_w, tris_c = _warp_chunk(pts_w, fidx, _faces_table(mesh))
    if ray_d_w is None:
        return pts_c, tmask, fidx
    uv2, h2 = project_point2mesh(pts_w + ray_d_w, tris_w)
    return pts_c, tmask, fidx, _safe_unit(barycentric_map(uv2, h2, tris_c) - pts_c)


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
    cidx = _search_canonical(pts_c, centroids_c, mesh, settings)
    tri_vidx = mesh.faces[cidx]
    return _transport_normal(
        pts_c, normal_local, mesh.verts_cano[tri_vidx], mesh.verts_world[tri_vidx]
    )


def _use_fused(settings: RenderSettings, model) -> bool:
    """The fused kernels serve exactly the default SpaceNet (code 8, width
    256, essence 3, 10 posenc frequencies); other models take the plain
    chain, as in the JAX package."""
    nerf = model.nerf
    return (settings.fused_mlp and model.code_dim == 8 and nerf.pe_freqs == 10
            and nerf.stage1[0].out_features == 256 and nerf.rgb_net[3].out_features == 3)


def _fused_inputs(pts_c, code, pose_feat, code_scale):
    """pe (n, 63) and cp (n, 24) = [code * code_scale | pose feature]."""
    n = pts_c.shape[0]
    cp = torch.cat([(code * code_scale).expand(n, 8), pose_feat.expand(n, pose_feat.shape[-1])],
                   dim=-1)
    return posenc(pts_c, 10), cp


def _point_network(model, settings, pts_w, pts_c, dir_w, code, pose_feat, code_scale,
                   tris_c2, tris_w2):
    """color (n, 3), sigma (n,) for one slice of points.

    The normal is d(sum sigma)/d(pts_c): one autograd backward over the
    slice (with its graph when gradients are on, for the second-order
    training backward), or the fused kernels' gpe."""
    if _use_fused(settings, model):
        pe, cp = _fused_inputs(pts_c, code, pose_feat, code_scale)
        sigma, essence, normal_local = fused_sigma_essence_normal(nerf_params(model.nerf), pe, cp,
                                                                  fast=settings.fused_fast)
    else:
        train = torch.is_grad_enabled()
        with torch.enable_grad():
            pc = pts_c.detach().requires_grad_(True)
            essence, density = model.sigma_essence(pc, code, pose_feat, code_scale)
            (normal_local,) = torch.autograd.grad(density.sum(), pc, create_graph=train)
        sigma = density[:, 0]
        if not train:
            essence, sigma = essence.detach(), sigma.detach()
    normal_w = _transport_normal(pts_c, normal_local, tris_c2, tris_w2)
    color = model.lighting(normal_w, pts_w, dir_w, essence)
    return color, sigma


def _light_space(pts_w: torch.Tensor, light: LightState) -> torch.Tensor:
    """The world coordinates the LightingMLP sees: xy rotated about
    rot_center, then shifted by light_bias."""
    xy = (pts_w[:, :2] - light.rot_center[:2]) @ light.rot + light.rot_center[:2]
    return torch.cat([xy, pts_w[:, 2:]], dim=-1) + light.light_bias


def _color_pass(model, settings: RenderSettings, light: LightState, pts_w, pts_c, dir_w,
                code, pose_feat, tris_c2, tris_w2):
    """`_point_network` over slices of mlp_chunk points (one call under the
    fused kernels, which hold no activation of the slice in device memory):
    color (n, 3), sigma (n,) (before the transparent mask)."""
    n = pts_w.shape[0]
    chunk = max(n, 1) if _use_fused(settings, model) else settings.mlp_chunk
    pts_w_light = _light_space(pts_w, light)
    colors, sigmas = [], []
    for a in range(0, n, chunk):
        sl = slice(a, a + chunk)
        m = pts_w[sl].shape[0]
        c, s = _point_network(
            model, settings, pts_w_light[sl], pts_c[sl], dir_w[sl], code,
            pose_feat.expand(m, pose_feat.shape[-1]), light.code_scale,
            tris_c2[sl], tris_w2[sl],
        )
        colors.append(c)
        sigmas.append(s)
    return torch.cat(colors), torch.cat(sigmas)


def _block_layout(r: int, s: int, block_sc: int):
    """The block-coherent point layout of the listed and pruned searches,
    without a sort: (sample-chunk, ray, sample-within), so that consecutive
    points are adjacent rays' runs of ``sc`` consecutive samples (sc is
    block_sc, halved until it divides s). Rays of an eval chunk are in
    scanline order already. Returns (to_blocked, from_blocked):
    (R, S, ...) -> (N, ...) and (N, ...) blocked -> (N, ...) ray-major."""
    sc = block_sc
    while s % sc:
        sc //= 2
    n_sc = s // sc

    def to_blocked(x):
        y = x.reshape(r, n_sc, sc, *x.shape[2:]).transpose(0, 1)
        return y.reshape(r * s, *x.shape[2:])

    def from_blocked(x):
        y = x.reshape(n_sc, r, sc, *x.shape[1:]).transpose(0, 1)
        return y.reshape(r * s, *x.shape[1:])

    return to_blocked, from_blocked


def topk_first(w: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (R, k) of the k largest entries of each row of w (R, S), in
    descending order, equal entries by increasing index: `jax.lax.top_k`'s
    order, which `torch.topk` does not promise. A stable descending sort
    gives it on every device (rays that miss the body have S equal zero
    weights)."""
    return torch.sort(w, dim=-1, descending=True, stable=True).indices[..., :k]


def nearest_selected(top_idx: torch.Tensor, s: int) -> torch.Tensor:
    """For each of the s samples of a ray the position (R, s), in 0..K-1,
    of the selected sample (top_idx (R, K)) nearest to it along the ray;
    among equally near ones the first of the K, as `jnp.argmin` decides.
    The rule is explicit: the key dist * K + position has no ties."""
    k = top_idx.shape[-1]
    samples = torch.arange(s, device=top_idx.device)[None, :, None]
    dist = (samples - top_idx[:, None, :]).abs()                    # (R, s, K)
    key = dist * k + torch.arange(k, device=top_idx.device)
    return key.argmin(dim=-1)


class _TakeSelected(torch.autograd.Function):
    """``take_along_dim(sel, nearest[..., None], dim=1)`` for sel (R, K, C)
    and nearest (R, S), with a backward that is the same on every run:
    take_along_dim's own backward scatter-adds each sample's gradient into
    its selected sample with atomics, whose order on the card changes the
    sum's last bits from one run to the next. Here each selected sample
    sums its samples' gradients in one reduction over S."""

    @staticmethod
    def forward(ctx, sel: torch.Tensor, nearest: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(nearest)
        ctx.k = sel.shape[1]
        return torch.take_along_dim(sel, nearest[..., None], dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: torch.Tensor):
        (nearest,) = ctx.saved_tensors
        onehot = nearest[..., None] == torch.arange(ctx.k, device=nearest.device)  # (R, S, K)
        return torch.where(onehot[..., None], grad[:, :, None, :], 0.0).sum(dim=1), None


def _check_devices(device: torch.device, model, *tensors) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"render_rays: an input is on {t.device}, expected {device}")
    p = next(model.parameters())
    if p.device != device:
        raise ValueError(f"render_rays: the model is on {p.device}, expected {device}")


def render_rays(
    model,
    batch: RayBatch,
    mesh: MeshBundle,
    settings: RenderSettings,
    light: LightState,
    device: str | torch.device | None = None,
    train: bool = False,
    randoms: tuple[torch.Tensor, ...] | None = None,
) -> dict[str, torch.Tensor]:
    """Render one chunk of rays.

    Eval (the default) builds no autograd graph: no perturbation, no noise.
    ``train=True`` builds the graph of the loss and takes ``randoms`` =
    (uniforms (R, S) in [0, 1), standard normals (R, S)): the uniforms
    stratify z when settings.perturb > 0, the normals times
    settings.raw_noise_std are added to sigma when raw_noise_std > 0 (the JAX
    package draws them from `fold_in(rng, step)`, `pipeline.py:573-594`).
    With settings.n_fine > 0 two more follow: uniforms (R, n_fine) that
    jitter the fine samples within their CDF strata in every training step,
    perturb or not (the JAX package's `fold_in(rng, 1)`), and the fine
    pass's normals (R, S + n_fine) (its rng_noise at the fine pass's shape).

    Runs on CUDA unless ``device`` says otherwise; every input and the model
    must already be on that device. Returns color (R, 3), disp_map/acc_map/
    depth_map (R,), weights/z_vals (R, S); with n_fine > 0 the fine pass's
    as fine_color, ..., fine_z_vals (R, S + n_fine)."""
    dev = resolve_device(device)
    _check_devices(dev, model, batch.ray_o, batch.ray_d, batch.near, batch.far,
                   batch.body_pose, mesh.verts_world, mesh.verts_cano, mesh.faces,
                   light.rot)
    r, s, nf = batch.ray_o.shape[0], settings.n_samples, settings.n_fine
    t_rand = noise = u_fine = noise_fine = None
    if train:
        shapes = [(r, s), (r, s)] + ([(r, nf), (r, s + nf)] if nf > 0 else [])
        if randoms is None or len(randoms) != len(shapes):
            raise ValueError(f"render_rays(train=True) needs {len(shapes)} randoms: uniforms and "
                             "normals (and the fine pass's, with n_fine > 0)")
        for t, shape in zip(randoms, shapes):
            if tuple(t.shape) != shape or t.device != dev:
                raise ValueError(f"render_rays: randoms must be {shapes} on {dev}")
        if settings.perturb > 0:
            t_rand = randoms[0]
        if nf > 0:  # the JAX package jitters the fine samples whatever perturb is
            u_fine = randoms[2]
        if settings.raw_noise_std > 0:
            noise = randoms[1] * settings.raw_noise_std
            noise_fine = randoms[3] * settings.raw_noise_std if nf > 0 else None
    with torch.set_grad_enabled(train):
        z_vals = sample_z(batch, mesh, settings, t_rand)
        out = _render_with_z(model, batch, mesh, settings, light, z_vals, noise)
        if nf > 0:
            # the hierarchical pass (the JAX package's `render_rays`, its
            # `:599-618`): n_fine z values from the coarse weights, the
            # whole chain again on the sorted union
            mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_fine = sample_pdf(mids.detach(), out["weights"][..., 1:-1].detach(), nf, u_fine)
            z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
            fine = _render_with_z(model, batch, mesh, settings, light, z_all, noise_fine)
            out.update({f"fine_{k}": v for k, v in fine.items()})
        return out


def sample_z(batch: RayBatch, mesh: MeshBundle, settings: RenderSettings,
             t_rand: torch.Tensor | None = None) -> torch.Tensor:
    """z (R, S) of a chunk: between the GG near/far of the posed mesh
    (sample_mode "GG") or the batch's own, evenly spaced, or stratified by
    the uniforms t_rand (R, S) when given."""
    near, far = batch.near, batch.far
    if settings.sample_mode == "GG":
        near, far = gg_near_far_cuda(
            batch.ray_o, batch.ray_d, near, far, mesh.verts_world, settings.gg_gamma
        )
    return stratified_z(near, far, settings.n_samples, t_rand)


def _render_with_z(model, batch: RayBatch, mesh: MeshBundle,
                   settings: RenderSettings, light: LightState,
                   z_vals: torch.Tensor, noise: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """warp + networks + composite for given per-ray z values (R, S) and
    the sigma noise (R, S) of a training step, if any."""
    r, s = z_vals.shape
    n = r * s
    pts_w = sample_along_rays(batch.ray_o, batch.ray_d, z_vals)     # (R, S, 3)
    dir_w = batch.ray_d[:, None, :].expand(r, s, 3)

    centroids_w = face_centroids(mesh.verts_world, mesh.faces)
    centroids_c = face_centroids(mesh.verts_cano, mesh.faces)

    # The listed and pruned searches run in the block-coherent point order;
    # the networks do not care about the order, so it is undone only on the
    # per-point results. The listed search returns tile-slot ids, and every
    # stage gathers from the slot-ordered face table: the ids stay consistent
    # across the world search, the canonical search and face reuse, and
    # nothing outside this function sees them.
    blocked = settings.knn_impl in ("listed", "pruned")
    use_slots = settings.knn_impl == "listed"
    from_blocked = None
    if blocked:
        to_blocked, from_blocked = _block_layout(r, s, settings.block_sc)
        pts_w_flat = to_blocked(pts_w).contiguous()
        dir_w_flat = to_blocked(dir_w)
    else:
        pts_w_flat = pts_w.reshape(n, 3)
        dir_w_flat = dir_w.reshape(n, 3)

    # the searches depend on geometry only; each runs once per chunk
    gsz = ray_group(s)
    fidx_w = _search(pts_w_flat, centroids_w, mesh, settings, mesh.world_tables, use_slots, gsz)
    faces_wc = _faces_table(mesh, slot_perm_from_tiles(mesh.tile_table) if use_slots else None)
    pose_feat = model.pose_feature(batch.body_pose)                  # (16,)
    code = model.frame_code(batch.frame)

    if 0 < settings.shade_topk < s:
        return _gated_shading(model, batch, mesh, settings, light, z_vals, pts_w,
                              pts_w_flat, fidx_w, faces_wc, centroids_c, code, pose_feat,
                              from_blocked, use_slots, noise)

    pts_c, tmask, _, _ = _warp_chunk(pts_w_flat, fidx_w, faces_wc)
    if settings.reuse_warp_faces:
        cidx = fidx_w
    else:
        # "grouped": the fused path searches single points, as the JAX
        # package's `_full_shading_fused` does
        cidx = _search_canonical(pts_c, centroids_c, mesh, settings, use_slots,
                                 1 if _use_fused(settings, model) else gsz)
    tris_wc2 = faces_wc[cidx]                                        # (N, 18)
    color, sigma = _color_pass(
        model, settings, light, pts_w_flat, pts_c, dir_w_flat, code, pose_feat,
        tris_wc2[:, 9:].reshape(-1, 3, 3), tris_wc2[:, :9].reshape(-1, 3, 3),
    )
    sigma = torch.where(tmask, 0.0, sigma)
    if blocked:
        color, sigma = from_blocked(color), from_blocked(sigma)
    return _outputs(composite(color.reshape(r, s, 3), sigma.reshape(r, s), z_vals, batch.ray_d,
                              noise), z_vals)


def _outputs(out, z_vals: torch.Tensor) -> dict[str, torch.Tensor]:
    return {
        "color": out.rgb,
        "disp_map": out.disp,
        "acc_map": out.acc,
        "depth_map": out.depth,
        "weights": out.weights,
        "z_vals": z_vals,
    }


def _gated_shading(model, batch: RayBatch, mesh: MeshBundle, settings: RenderSettings,
                   light: LightState, z_vals, pts_w, pts_w_flat, fidx_flat, faces_wc,
                   centroids_c, code, pose_feat, from_blocked, use_slots: bool,
                   noise: torch.Tensor | None = None):
    """Importance-gated shading: density everywhere, color on the top-K
    samples of each ray.

    Per-ray rgb = sum_i w_i c_i; a sample outside the top K by weight adds at
    most its near-zero weight times a bounded color, so with K covering the
    weight mass the image matches full shading to the weights' tail. Density
    (hence weights, acc, depth) is computed at every sample.

    pts_w (R, S, 3) ray-major; pts_w_flat (N, 3) and fidx_flat (N,) in the
    searches' order (blocked iff from_blocked is given); faces_wc the face
    table that fidx_flat indexes (slot-ordered iff use_slots)."""
    r, s = z_vals.shape
    n = r * s
    k = settings.shade_topk
    pf_dim = pose_feat.shape[-1]

    # ---- density pass over all samples (density only: no normal) ----
    # Under the fused kernels it is one call; otherwise slices of mlp_chunk
    # points. At eval it builds no autograd graph; in training its graph
    # carries the density gradient of every sample.
    fused = _use_fused(settings, model)
    chunk = max(n, 1) if fused else settings.mlp_chunk
    sigmas = []
    for a in range(0, n, chunk):
        sl = slice(a, a + chunk)
        pc, tmask, _, _ = _warp_chunk(pts_w_flat[sl], fidx_flat[sl], faces_wc)
        pf = pose_feat.expand(pc.shape[0], pf_dim)
        if fused:
            density = fused_sigma(nerf_params(model.nerf),
                                  *_fused_inputs(pc, code, pf, light.code_scale),
                                  fast=settings.fused_fast)
        else:
            density = model.sigma_essence(pc, code, pf, light.code_scale, density_only=True)[1][:, 0]
        sigmas.append(torch.where(tmask, 0.0, density))
    sigma_flat = torch.cat(sigmas)
    if from_blocked is not None:
        sigma_flat = from_blocked(sigma_flat)
        fidx_flat = from_blocked(fidx_flat)
    sigma = sigma_flat.reshape(r, s)

    # ---- the K samples per ray that carry the weight mass ----
    # selection and the final composite go through the one `composite`, so
    # they see the same weights (and, in training, the same noise); the
    # selection weights are detached, as the JAX package's stop_gradient does
    zero_rgb = torch.zeros((r, s, 3), dtype=sigma.dtype, device=sigma.device)
    w_sel = composite(zero_rgb, sigma.detach(), z_vals, batch.ray_d, noise).weights
    top_idx = topk_first(w_sel, k)                                   # (R, K)
    pw_sel = torch.take_along_dim(pts_w, top_idx[..., None], dim=1).reshape(r * k, 3)
    fi_sel = torch.take_along_dim(fidx_flat.reshape(r, s), top_idx, dim=1).reshape(r * k)
    dw_sel = batch.ray_d[:, None, :].expand(r, k, 3).reshape(r * k, 3)

    # canonical coordinates of the selected points, from the face ids again
    pc_sel, _, _, _ = _warp_chunk(pw_sel, fi_sel, faces_wc)
    if settings.reuse_warp_faces:
        cidx = fi_sel
    else:
        # ray-major selected points are surface-concentrated and locally
        # coherent: the listed and pruned searches take them as blocks; the
        # grouped search takes groups of one (they arrive in weight order,
        # so neighbours in the list can lie on different surfaces)
        cidx = _search_canonical(pc_sel, centroids_c, mesh, settings, use_slots)

    # ---- the full color chain on the selected samples ----
    tris_wc2 = faces_wc[cidx]
    color_sel, _ = _color_pass(
        model, settings, light, pw_sel, pc_sel, dw_sel, code, pose_feat,
        tris_wc2[:, 9:].reshape(-1, 3, 3), tris_wc2[:, :9].reshape(-1, 3, 3),
    )

    # tail completion: an unselected sample takes the color of the nearest
    # selected sample of its ray (colors vary smoothly along a ray), so the
    # weight tail adds about its true color and not black
    nearest = nearest_selected(top_idx, s)                           # (R, S)
    color = _TakeSelected.apply(color_sel.reshape(r, k, 3), nearest)
    return _outputs(composite(color, sigma, z_vals, batch.ray_d, noise), z_vals)


def density_grid(model, pts_c: torch.Tensor, frame: int, body_pose: torch.Tensor,
                 settings: RenderSettings, code_scale: float = 1.0) -> torch.Tensor:
    """Density-only query of canonical points (mesh extraction), the JAX
    package's `density_grid`: pts_c (N, 3) -> sigma (N,) in slices of
    settings.mlp_chunk points, with the frame's code and the pose feature
    of ``body_pose`` (23, 3). Builds no autograd graph; runs where the model
    and the points are."""
    with torch.no_grad():
        code = model.frame_code(frame)
        pose_feat = model.pose_feature(body_pose)
        scale = torch.tensor(code_scale, dtype=pts_c.dtype, device=pts_c.device)
        out = []
        for a in range(0, pts_c.shape[0], settings.mlp_chunk):
            pc = pts_c[a:a + settings.mlp_chunk]
            pf = pose_feat.expand(pc.shape[0], pose_feat.shape[-1])
            out.append(model.sigma_essence(pc, code, pf, scale, density_only=True)[1][:, 0])
        return torch.cat(out) if out else pts_c.new_zeros((0,))
