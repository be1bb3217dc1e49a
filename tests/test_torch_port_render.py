"""The whole slice: the JAX package's `ImageRenderer.render_item` against
the port's on the CPU, on a small val item of the synthetic scene with the
full SMPL-sized mesh (V=6890, F=13,776) and the trained fixture.

The JAX side runs KNN_IMPL "auto", which on the CPU is its XLA brute search;
the port runs its brute-force search's plain version. Bands from the JAX
package's own TPU-vs-CPU evidence (bench/r5/NOTES.md, "On-DEVICE parity"):
color <= 5e-4, acc <= 1e-4, depth <= 1e-4 relative (depth is ~3 here, and
one ulp of z is 2.4e-7), disp only where acc > 1e-3 (1/max(1e-10,
depth/acc) amplifies ulp noise on empty rays).

Two legs:
- near/far held at the JAX package's GG result and uniform sampling, so both
  sides sample the same z to an ulp: every ray within the bands;
- the slice end to end, GG on both sides. The JAX package's jitted GG and
  the port's round z0 differently, so the near/far of nearly every ray that
  touches the mesh differ by an ulp or more (up to ~1e-5 near a sphere's
  tangent, see test_torch_port_gg.py), and the trained field's sharp density
  turns such a shift of a sample into up to ~1e-3 of its weight (measured:
  2.4e-3 of depth on one ray of 574). So: at least 97% of rays within the
  bands, and every ray within fifty times them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.config import get_cfg_defaults as jax_defaults
from dual_space_nerf_tpu.data import SyntheticDataset as JaxDataset
from dual_space_nerf_tpu.evaluation import ImageRenderer as JaxRenderer
from dual_space_nerf_tpu.evaluation.render_image import (
    light_state_for_novel_pose as jax_novel_light,
)
from dual_space_nerf_tpu.data.batching import item_to_mesh as jax_item_to_mesh
from dual_space_nerf_tpu.geometry import gg_near_far as jax_gg
from dual_space_nerf_tpu.renderer import LightState as JaxLight
from dual_space_nerf_tpu.renderer import RayBatch as JaxRays
from dual_space_nerf_tpu.renderer import RenderSettings as JaxSettings
from dual_space_nerf_tpu.renderer import render_rays as jax_render_rays
from dual_space_nerf_tpu_torch.config import get_cfg_defaults
from dual_space_nerf_tpu_torch.data import SyntheticDataset
from dual_space_nerf_tpu_torch.evaluation import (
    ImageRenderer,
    light_state_for_novel_pose,
    psnr,
)
from dual_space_nerf_tpu_torch.data import item_to_mesh
from dual_space_nerf_tpu_torch.renderer import LightState, RayBatch, RenderSettings, render_rays
from torch_port_common import jax_model_and_params, slice_cfg, torch_model

H = W = 32
N_SAMPLES = 16
CHUNK = 256  # 574 rays in the box: three chunks, the last one padded
LIGHT_CENTER = [0.21903692, -0.17755836, 1.1463718]  # configs/zju_mocap/313.yml

BANDS = {"color": 5e-4, "acc": 1e-4, "depth": 1e-4, "disp": 1e-4}


@pytest.fixture(scope="module")
def item():
    jitem = JaxDataset(split="val", n_frames=1, n_views=1, h=H, w=W)[0]
    titem = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)[0]
    return jitem, titem


@pytest.fixture(scope="module")
def renderers():
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    jm, jp = jax_model_and_params()
    jr = JaxRenderer(jm, jp, JaxSettings.from_cfg(slice_cfg(jax_defaults, N_SAMPLES)),
                     np.asarray(ds.faces), ds.canonical_vertex, chunk=CHUNK, pack="f32")
    tr = ImageRenderer(torch_model(), RenderSettings.from_cfg(slice_cfg(get_cfg_defaults, N_SAMPLES)),
                       np.asarray(ds.faces), ds.canonical_vertex, chunk=CHUNK, device="cpu")
    return jr, tr


def test_val_item_matches_jax_dataset(item):
    jitem, titem = item
    for k in ("img", "ray_o", "ray_d", "near", "far", "mask_at_box", "coord", "poses", "xyz"):
        np.testing.assert_array_equal(np.asarray(titem[k]), np.asarray(jitem[k]), err_msg=k)
    assert titem["ray_o"].shape[0] == 574


def _ray_errors(out_t, out_j, mask):
    """Per-ray error over band for each output: <= 1 is inside the band.
    out_*: {"color": (..., 3), "acc"/"depth"/"disp": (...,) or (..., 1)}."""
    acc = out_j["acc"].reshape(-1)[mask]
    scaled = {}
    for k, band in BANDS.items():
        a = out_t[k].reshape(mask.shape[0], -1)[mask]
        b = out_j[k].reshape(mask.shape[0], -1)[mask]
        if k != "disp":
            assert np.isfinite(a).all(), k
        err = np.abs(a - b).max(axis=1)
        if k == "depth":
            err = err / np.maximum(1.0, np.abs(b).max(axis=1))
        if k == "disp":
            err = np.where(acc > 1e-3, err, 0.0)
        scaled[k] = err / band
    return scaled


def _images(out):
    return {k: out[f"coarse_{k}"] for k in BANDS}


def _assert_end_to_end(out_t, out_j, item):
    assert set(out_t) == set(out_j)
    for k, err in _ray_errors(_images(out_t), _images(out_j), item["mask_at_box"]).items():
        assert (err <= 1.0).mean() >= 0.97, (k, (err <= 1.0).mean())
        assert err.max() <= 50.0, (k, err.max())


@pytest.fixture(scope="module")
def identity_renders(item, renderers):
    (jitem, titem), (jr, tr) = item, renderers
    return tr.render_item(titem), jr.render_item(jitem)


def test_render_item_matches_jax(item, identity_renders):
    out_t, out_j = identity_renders
    titem = item[1]
    _assert_end_to_end(out_t, out_j, titem)
    mask = titem["mask_at_box"].reshape(H, W)
    assert out_t["coarse_acc"][mask].max() > 0.5  # the trained field is not empty
    # 32x32 splatted ground truth is coarse; the metric only has to be finite
    assert np.isfinite(psnr(out_t["coarse_color"], titem["img"]))


def test_render_item_novel_pose_light_matches_jax(item, renderers, identity_renders):
    (jitem, titem), (jr, tr) = item, renderers
    out_j = jr.render_item(jitem, jax_novel_light(LIGHT_CENTER, jitem["Th"], 0.0))
    out_t = tr.render_item(titem, light_state_for_novel_pose(LIGHT_CENTER, titem["Th"], 0.0))
    _assert_end_to_end(out_t, out_j, titem)
    # the light really changed: not the identity light's image
    assert np.abs(out_t["coarse_color"] - identity_renders[0]["coarse_color"]).max() > 1e-3


def test_unported_settings_raise():
    """Every KNN_IMPL of the JAX package is accepted (the grouped, clustered
    and xla searches are ported); an unknown one and an unknown
    MATMUL_PRECISION raise."""
    cfg = slice_cfg(get_cfg_defaults)
    for value in ("grouped", "clustered", "xla"):
        ok = cfg.clone()
        ok.MODEL.KNN_IMPL = value
        assert RenderSettings.from_cfg(ok).knn_impl == value
    bad = cfg.clone()
    bad.MODEL.KNN_IMPL = "kdtree"
    with pytest.raises(ValueError):
        RenderSettings.from_cfg(bad)
    bad = cfg.clone()
    bad.MODEL.MATMUL_PRECISION = "f16"  # neither of the two the JAX package documents
    with pytest.raises(ValueError):
        RenderSettings.from_cfg(bad)


@pytest.mark.parametrize("key,value,field", [
    ("SHADE_TOPK", 16, "shade_topk"), ("REUSE_WARP_FACES", True, "reuse_warp_faces"),
    ("KNN_IMPL", "listed", "knn_impl"), ("KNN_IMPL", "pruned", "knn_impl"),
    ("FUSED_MLP", "on", "fused_mlp"), ("FUSED_FAST", True, "fused_fast"),
    ("FINE_RAY_SAMPLING", 8, "n_fine"), ("MATMUL_PRECISION", "bf16", None),
])
def test_ported_settings_are_accepted(key, value, field):
    """Each option reaches its setting; MATMUL_PRECISION is the model's
    compute dtype (`cli/common.py::build_model`), which the settings accept."""
    from dual_space_nerf_tpu_torch.cli.common import compute_dtype

    cfg = slice_cfg(get_cfg_defaults)
    cfg.MODEL[key] = value
    settings = RenderSettings.from_cfg(cfg)
    if field is None:
        assert compute_dtype(cfg) is torch.bfloat16
        return
    want = True if (key, value) == ("FUSED_MLP", "on") else value
    assert getattr(settings, field) == want


@pytest.mark.parametrize("fused_fast", [False, True], ids=["f32", "fast-set"])
@pytest.mark.parametrize("default_shape", [True, False], ids=["default", "other-width"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("fused_mlp", ["auto", "on", "off"])
def test_fused_mlp_resolves_from_what_the_model_shows(fused_mlp, device_type, dtype,
                                                      default_shape, fused_fast):
    """`network_path` over every setting and every model it can observe:
    "off" and other widths take the plain chain; "on" the fused pair, fast
    with FUSED_FAST; "auto" the float32 pair on a CUDA device in float32
    and the plain chain elsewhere, FUSED_FAST engaging nothing."""
    from dual_space_nerf_tpu_torch.renderer.pipeline import network_path

    cfg = slice_cfg(get_cfg_defaults)
    cfg.MODEL.FUSED_MLP = fused_mlp
    cfg.MODEL.FUSED_FAST = fused_fast
    settings = RenderSettings.from_cfg(cfg)
    assert settings.fused_mlp is {"auto": None, "on": True, "off": False}[fused_mlp]
    got = network_path(settings.fused_mlp, settings.fused_fast, device_type, dtype, default_shape)
    if not default_shape or fused_mlp == "off":
        want = "plain"
    elif fused_mlp == "on":
        want = "fast" if fused_fast else "fused"
    else:
        want = "fused" if device_type == "cuda" and dtype == torch.float32 else "plain"
    assert got == want


@pytest.mark.parametrize("fused_mlp", ["auto", "on", "off"])
def test_network_path_reads_the_models_shape_and_dtype(fused_mlp):
    """What `_network_path` observes of a model on the CPU: the default
    SpaceNet in float32, in bfloat16 (MATMUL_PRECISION) and in float64
    (its parameters), and a narrower SpaceNet. "auto" is the plain chain on
    the CPU for all of them; "on" takes the pair for the default shape
    whatever the dtype, as before."""
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
    from dual_space_nerf_tpu_torch.renderer.pipeline import _network_path

    cfg = slice_cfg(get_cfg_defaults)
    cfg.MODEL.FUSED_MLP = fused_mlp
    settings = RenderSettings.from_cfg(cfg)
    models = {"f32": DualSpaceNeRF(max_frames=4),
              "bf16": DualSpaceNeRF(max_frames=4, compute_dtype=torch.bfloat16),
              "f64": DualSpaceNeRF(max_frames=4).to(torch.float64),
              "narrow": DualSpaceNeRF(max_frames=4, backbone_dim=128)}
    got = {name: _network_path(settings, m) for name, m in models.items()}
    on = "fused" if fused_mlp == "on" else "plain"
    assert got == {"f32": on, "bf16": on, "f64": on, "narrow": "plain"}


@pytest.mark.parametrize("novel", [False, True])
def test_render_rays_with_fixed_near_far_matches_jax(item, novel):
    """Both sides sample z from the same near/far (the JAX GG result): every
    ray within the bands."""
    jitem, titem = item
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    jm, jp = jax_model_and_params()
    tm = torch_model()
    jmesh = jax_item_to_mesh(jitem, np.asarray(ds.faces), ds.canonical_vertex)
    tmesh = item_to_mesh(titem, ds.faces, ds.canonical_vertex, torch.device("cpu"))
    near, far = jax_gg(*(jnp.asarray(jitem[k]) for k in ("ray_o", "ray_d", "near", "far")),
                       jmesh.verts_world, 0.05)
    jrays = JaxRays(jnp.asarray(jitem["ray_o"]), jnp.asarray(jitem["ray_d"]), near, far,
                    jnp.asarray(0, jnp.int32), jnp.asarray(jitem["poses"][1:24]))
    trays = RayBatch(torch.from_numpy(titem["ray_o"]), torch.from_numpy(titem["ray_d"]),
                     torch.from_numpy(np.array(near)), torch.from_numpy(np.array(far)),
                     0, torch.from_numpy(titem["poses"][1:24]))
    js = dataclasses.replace(JaxSettings.from_cfg(slice_cfg(jax_defaults, N_SAMPLES)),
                             sample_mode="uniform")
    ts = dataclasses.replace(RenderSettings.from_cfg(slice_cfg(get_cfg_defaults, N_SAMPLES)),
                             sample_mode="uniform")
    if novel:
        lj = jax_novel_light(LIGHT_CENTER, jitem["Th"], 0.0)
        lt = light_state_for_novel_pose(LIGHT_CENTER, titem["Th"], 0.0)
    else:
        lj, lt = JaxLight.identity(), LightState.identity()
    oj = jax.device_get(jax_render_rays(jp, jm, jrays, jmesh, js, lj, None, train=False))
    ot = render_rays(tm, trays, tmesh, ts, lt, device="cpu")
    names = {"color": "color", "acc": "acc_map", "depth": "depth_map", "disp": "disp_map"}
    err = _ray_errors({k: ot[v].numpy() for k, v in names.items()},
                      {k: np.asarray(oj[v]) for k, v in names.items()},
                      np.ones(trays.ray_o.shape[0], bool))
    for k, e in err.items():
        assert e.max() <= 1.0, (k, e.max())


def test_warp_and_normal_transport_match_jax(item):
    """`warp_world_to_canonical` and `normal_canonical_to_world` on the
    item's mesh, near-surface points, the same face ids on both sides."""
    from dual_space_nerf_tpu.renderer.pipeline import (
        normal_canonical_to_world as jax_normal,
        warp_world_to_canonical as jax_warp,
    )
    from dual_space_nerf_tpu_torch.ops import face_centroids
    from dual_space_nerf_tpu_torch.renderer import (
        normal_canonical_to_world,
        warp_world_to_canonical,
    )

    jitem, titem = item
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    jmesh = jax_item_to_mesh(jitem, np.asarray(ds.faces), ds.canonical_vertex)
    tmesh = item_to_mesh(titem, ds.faces, ds.canonical_vertex, torch.device("cpu"))
    rng = np.random.default_rng(5)
    cw = face_centroids(tmesh.verts_world, tmesh.faces)
    cc = face_centroids(tmesh.verts_cano, tmesh.faces)
    pts = (cw.numpy()[rng.integers(0, len(cw), 2000)]
           + 0.03 * rng.standard_normal((2000, 3))).astype(np.float32)
    ts, js = RenderSettings(), JaxSettings(knn_impl="auto")
    pc_t, tm_t, fid = warp_world_to_canonical(torch.from_numpy(pts), tmesh, cw, ts)
    pc_j, tm_j, _, _ = jax_warp(jnp.asarray(pts), jmesh, jnp.asarray(cw.numpy()), js,
                                fidx=jnp.asarray(fid.numpy()))
    np.testing.assert_allclose(pc_t.numpy(), np.asarray(pc_j), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm_t.numpy(), np.asarray(tm_j))
    grad = rng.standard_normal((2000, 3)).astype(np.float32)
    n_t = normal_canonical_to_world(pc_t, torch.from_numpy(grad), tmesh, cc, ts)
    n_j = jax_normal(jnp.asarray(pc_t.numpy()), jnp.asarray(grad), jmesh,
                     jnp.asarray(cc.numpy()), js)
    # unit normals; the two searches may pick different faces at a
    # float32 near-tie, so hold 99% of points to 1e-4 and all to unit norm
    close = np.abs(n_t.numpy() - np.asarray(n_j)).max(1) <= 1e-4
    assert close.mean() >= 0.99, close.mean()
    np.testing.assert_allclose(np.linalg.norm(n_t.numpy(), axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("production", [False, True], ids=["exact", "production"])
def test_fused_render_matches_jax_fused_render(item, production):
    """`MODEL.FUSED_MLP: "on"` on both sides (the JAX package's Pallas pair in
    interpret mode, the port's fused functions' plain versions), the same z
    from the JAX GG near/far: every ray within the bands, on the exact path
    and on the gated path (K=8, face reuse)."""
    jitem, titem = item
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    jm, jp = jax_model_and_params()
    jmesh = jax_item_to_mesh(jitem, np.asarray(ds.faces), ds.canonical_vertex)
    tmesh = item_to_mesh(titem, ds.faces, ds.canonical_vertex, torch.device("cpu"))
    near, far = jax_gg(*(jnp.asarray(jitem[k]) for k in ("ray_o", "ray_d", "near", "far")),
                       jmesh.verts_world, 0.05)
    jrays = JaxRays(jnp.asarray(jitem["ray_o"]), jnp.asarray(jitem["ray_d"]), near, far,
                    jnp.asarray(0, jnp.int32), jnp.asarray(jitem["poses"][1:24]))
    trays = RayBatch(torch.from_numpy(titem["ray_o"]), torch.from_numpy(titem["ray_d"]),
                     torch.from_numpy(np.array(near)), torch.from_numpy(np.array(far)),
                     0, torch.from_numpy(titem["poses"][1:24]))
    extra = dict(shade_topk=8, reuse_warp_faces=True) if production else {}
    js = dataclasses.replace(JaxSettings.from_cfg(slice_cfg(jax_defaults, N_SAMPLES)),
                             sample_mode="uniform", fused_mlp=True, **extra)
    ts = dataclasses.replace(RenderSettings.from_cfg(slice_cfg(get_cfg_defaults, N_SAMPLES)),
                             sample_mode="uniform", fused_mlp=True, **extra)
    oj = jax.device_get(jax_render_rays(jp, jm, jrays, jmesh, js, JaxLight.identity(), None,
                                        train=False))
    ot = render_rays(torch_model(), trays, tmesh, ts, LightState.identity(), device="cpu")
    names = {"color": "color", "acc": "acc_map", "depth": "depth_map", "disp": "disp_map"}
    err = _ray_errors({k: ot[v].numpy() for k, v in names.items()},
                      {k: np.asarray(oj[v]) for k, v in names.items()},
                      np.ones(trays.ray_o.shape[0], bool))
    for k, e in err.items():
        assert e.max() <= 1.0, (k, e.max())
