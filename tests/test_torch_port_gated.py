"""Importance-gated shading and face reuse (`configs/zju_mocap/313_tpu.yml`
semantics): the port's `render_rays` against the JAX package's
`render_rays(train=False)` on the same numpy inputs and converted weights.

A small val item of the synthetic scene with the full SMPL-sized mesh and the
trained fixture, 32 uniform samples between the JAX package's GG near/far
(both sides sample the same z; GG's own ill-conditioning is pinned in
test_torch_port_gg.py). The JAX side runs its search of the same name
("pallas" is its "auto" here: the XLA brute search on the CPU; "listed" runs
its Pallas kernel in interpret mode).

Bands as in test_torch_port_render.py: color <= 5e-4, acc and depth <= 1e-4
(depth relative), disp only where acc > 1e-3. acc and depth do not depend on
the selection, and every ray sits within their bands. The color does: the
K-th and (K+1)-th largest weights of a ray can differ by less than the two
frameworks' rounding of the density, the two sides then shade different
samples, and the ray's color moves by up to the weight of the swapped
samples. So the color holds on at least 97% of the rays and every ray sits
within fifty times the band (measured shares are far higher; see the
assertion messages when it fails).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.config import get_cfg_defaults as jax_defaults
from dual_space_nerf_tpu.data import SyntheticDataset as JaxDataset
from dual_space_nerf_tpu.data.batching import item_to_mesh as jax_item_to_mesh
from dual_space_nerf_tpu.geometry import gg_near_far as jax_gg
from dual_space_nerf_tpu.renderer import LightState as JaxLight
from dual_space_nerf_tpu.renderer import RayBatch as JaxRays
from dual_space_nerf_tpu.renderer import RenderSettings as JaxSettings
from dual_space_nerf_tpu.renderer import render_rays as jax_render_rays
from dual_space_nerf_tpu_torch.config import get_cfg_defaults
from dual_space_nerf_tpu_torch.data import SyntheticDataset, item_to_mesh
from dual_space_nerf_tpu_torch.renderer import LightState, RayBatch, RenderSettings, render_rays
from dual_space_nerf_tpu_torch.renderer.pipeline import (
    _block_layout,
    nearest_selected,
    topk_first,
)
from torch_port_common import jax_model_and_params, slice_cfg, torch_model

H = W = 32
N_SAMPLES = 32
BANDS = {"color": 5e-4, "acc_map": 1e-4, "depth_map": 1e-4, "disp_map": 1e-4}
# (shade_topk, reuse_warp_faces, knn_impl) rendered by both packages
VS_JAX = [(topk, reuse, knn) for knn in ("pallas", "listed") for topk in (16, 8)
          for reuse in (True, False)]


@pytest.fixture(scope="module")
def scene():
    """Rays, meshes and models of both packages for one 32x32 val item."""
    jitem = JaxDataset(split="val", n_frames=1, n_views=1, h=H, w=W)[0]
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    titem = ds[0]
    jmesh = jax_item_to_mesh(jitem, np.asarray(ds.faces), ds.canonical_vertex)
    tmesh = item_to_mesh(titem, ds.faces, ds.canonical_vertex, torch.device("cpu"))
    near, far = jax_gg(*(jnp.asarray(jitem[k]) for k in ("ray_o", "ray_d", "near", "far")),
                       jmesh.verts_world, 0.05)
    jrays = JaxRays(jnp.asarray(jitem["ray_o"]), jnp.asarray(jitem["ray_d"]), near, far,
                    jnp.asarray(0, jnp.int32), jnp.asarray(jitem["poses"][1:24]))
    trays = RayBatch(torch.from_numpy(titem["ray_o"]), torch.from_numpy(titem["ray_d"]),
                     torch.from_numpy(np.array(near)), torch.from_numpy(np.array(far)),
                     0, torch.from_numpy(titem["poses"][1:24]))
    return {"jax": (*jax_model_and_params(), jrays, jmesh),
            "torch": (torch_model(), trays, tmesh)}


def _settings(cls, defaults, topk, reuse, knn):
    base = cls.from_cfg(slice_cfg(defaults, N_SAMPLES))
    return dataclasses.replace(base, sample_mode="uniform", shade_topk=topk,
                               reuse_warp_faces=reuse, knn_impl=knn)


@pytest.fixture(scope="module")
def port_render(scene):
    """The port's render for a (topk, reuse, knn) triple, each made once."""
    model, rays, mesh = scene["torch"]
    done = {}

    def render(topk, reuse, knn):
        if (topk, reuse, knn) not in done:
            s = _settings(RenderSettings, get_cfg_defaults, topk, reuse, knn)
            out = render_rays(model, rays, mesh, s, LightState.identity(), device="cpu")
            done[topk, reuse, knn] = {k: v.numpy() for k, v in out.items()}
        return done[topk, reuse, knn]

    return render


def _scaled_errors(a, b):
    """Per-ray error over its band for each output (<= 1 is inside)."""
    acc = b["acc_map"].reshape(-1)
    errs = {}
    for k, band in BANDS.items():
        x, y = a[k].reshape(len(acc), -1), np.asarray(b[k]).reshape(len(acc), -1)
        err = np.abs(x - y).max(axis=1)
        if k == "depth_map":
            err = err / np.maximum(1.0, np.abs(y).max(axis=1))
        if k == "disp_map":
            err = np.where(acc > 1e-3, err, 0.0)
        errs[k] = err / band
    return errs


@pytest.mark.parametrize("topk,reuse,knn", VS_JAX)
def test_gated_render_matches_jax(scene, port_render, topk, reuse, knn):
    jm, jp, jrays, jmesh = scene["jax"]
    js = _settings(JaxSettings, jax_defaults, topk, reuse, "auto" if knn == "pallas" else knn)
    oj = jax.device_get(jax_render_rays(jp, jm, jrays, jmesh, js, JaxLight.identity(), None,
                                        train=False))
    ot = port_render(topk, reuse, knn)
    assert np.isfinite(ot["color"]).all()
    assert ot["acc_map"].max() > 0.5  # the trained field is not empty
    errs = _scaled_errors(ot, oj)
    for k in ("acc_map", "depth_map", "disp_map"):
        assert errs[k].max() <= 1.0, (k, errs[k].max())
    share = (errs["color"] <= 1.0).mean()
    assert share >= 0.97 and errs["color"].max() <= 50.0, (share, errs["color"].max())


@pytest.mark.parametrize("topk", [8, 16])
@pytest.mark.parametrize("reuse", [True, False])
def test_listed_render_equals_brute_force_render(port_render, topk, reuse):
    """Slot ids end to end: a face-id / slot-id mix-up renders plausible
    garbage, so the listed render is held against the brute-force render.
    Both searches are exact and differ only at float32 near-ties of two
    centroids, where the warp of one sample changes."""
    a, b = port_render(topk, reuse, "listed"), port_render(topk, reuse, "pallas")
    errs = _scaled_errors(a, b)
    for k, e in errs.items():
        assert (e <= 1.0).mean() >= 0.99 and e.max() <= 50.0, (k, (e <= 1.0).mean(), e.max())


@pytest.mark.parametrize("knn", ["pallas", "listed", "pruned"])
def test_gated_density_outputs_equal_the_exact_renders(port_render, knn):
    """Density is computed at every sample whatever is shaded: acc, depth and
    the weights of the gated render are the exact render's."""
    exact = port_render(0, False, knn)
    for topk, reuse in ((16, True), (8, False)):
        gated = port_render(topk, reuse, knn)
        for k in ("acc_map", "depth_map", "weights"):
            np.testing.assert_allclose(gated[k], exact[k], rtol=0, atol=1e-5, err_msg=k)
        # K covers the weight mass: the colors agree to the weights' tail
        assert np.abs(gated["color"] - exact["color"]).max() < 0.05


def test_exact_render_with_tile_pruned_searches_equals_brute_force(port_render):
    """KNN_IMPL "listed" and "pruned" serve the exact path too, through the
    blocked layout and back."""
    brute = port_render(0, False, "pallas")
    for knn in ("listed", "pruned"):
        errs = _scaled_errors(port_render(0, False, knn), brute)
        for k, e in errs.items():
            assert (e <= 1.0).mean() >= 0.99 and e.max() <= 50.0, (knn, k, e.max())
    # face reuse on the exact path: the same ids in slot and in face space
    a, b = port_render(0, True, "listed"), port_render(0, True, "pallas")
    for k, e in _scaled_errors(a, b).items():
        assert (e <= 1.0).mean() >= 0.99 and e.max() <= 50.0, (k, e.max())


def test_topk_first_is_lax_top_k_on_ties(rng_np):
    """Equal weights go by increasing index, as `jax.lax.top_k` orders them."""
    w = rng_np.random((40, 32)).astype(np.float32)
    w[:, ::3] = 0.25          # many exact ties inside a row
    w[0] = 0.0                # a ray that misses the body: all weights equal
    w[1, 5:20] = w[1].max()   # ties at the top
    for k in (1, 8, 16):
        want = np.asarray(jax.lax.top_k(jnp.asarray(w), k)[1])
        got = topk_first(torch.from_numpy(w), k).numpy()
        np.testing.assert_array_equal(got, want)
    assert topk_first(torch.zeros(2, 8), 3).tolist() == [[0, 1, 2], [0, 1, 2]]


def test_nearest_selected_is_first_occurrence_argmin(rng_np):
    """A sample midway between two selected ones takes the earlier of the K,
    as `jnp.argmin(|s - top_idx|)` decides."""
    s, k = 32, 8
    top = np.stack([rng_np.permutation(s)[:k] for _ in range(50)])
    top[0] = [10, 4, 20, 22, 0, 31, 16, 12]  # sample 7: 4 and 10 tie, 10 comes first
    want = np.asarray(jnp.argmin(jnp.abs(jnp.arange(s)[None, :, None] - top[:, None, :]), axis=-1))
    got = nearest_selected(torch.from_numpy(top), s).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 7] == 0 and got[0, 21] == 2  # 20 before 22


@pytest.mark.parametrize("r,s,block_sc", [(6, 64, 32), (5, 16, 32), (3, 24, 32), (4, 7, 4)])
def test_block_layout_round_trips(r, s, block_sc):
    """(sample-chunk, ray, sample-within) and back, also where block_sc does
    not divide the sample count (it is halved until it does)."""
    to_blocked, from_blocked = _block_layout(r, s, block_sc)
    x = torch.arange(r * s * 3, dtype=torch.float32).reshape(r, s, 3)
    b = to_blocked(x)
    assert b.shape == (r * s, 3)
    assert torch.equal(from_blocked(b).reshape(r, s, 3), x)
    sc = block_sc
    while s % sc:
        sc //= 2
    # the first sc points are ray 0's first sc samples, the next sc ray 1's
    assert torch.equal(b[:sc], x[0, :sc])
    if r > 1:
        assert torch.equal(b[sc:2 * sc], x[1, :sc])
