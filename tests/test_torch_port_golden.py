"""Golden render of the 512x512 val item, for the port on the CPU and the card.

`tests/fixtures/torch_port_render_golden.npz` holds 2048 rays of the
synthetic scene's 512x512 val image (every 71st ray inside the box) and
what the JAX package renders for them on the CPU with the trained fixture
at 64 samples. Three legs:

- ``gg/*``: the exact slice (full shading) end to end, GG near/far on each
  side;
- ``fixed/*``: the exact slice with near/far held at the JAX package's GG
  result (``gg_near``, ``gg_far``) and uniform sampling, so both sides sample
  the same z;
- ``prod/*``: the production path (`configs/zju_mocap/313_tpu.yml`:
  SHADE_TOPK 16, REUSE_WARP_FACES) on the fixed leg's z. The JAX package
  renders it with its CPU search, the port with `KNN_IMPL: "listed"`.

Bands (bench/r5/NOTES.md, "On-DEVICE parity"): color <= 5e-4, acc <= 1e-4,
depth <= 1e-4 relative, disp only where acc > 1e-3. The transparent mask
(|h| <= 0.1, uv in [-4, 5]) and face near-ties are discontinuities: an
ulp's shift of a sample can flip one, and the sample's weight jumps. The
JAX package is not self-consistent there either: on golden ray 1307 its
chunked `ImageRenderer` gives acc 0.0038 and its `render_rays` on the same
inputs 0.0056. So in the fixed leg 99% of rays sit within the bands (3 of
2048 do not, on the CPU and on the card) and every ray within fifty times
them. In the gg leg the two sides' GG near/far also differ by ulps on most
rays (see test_torch_port_render.py): 97% within the bands, every ray
within fifty times them. The prod leg adds the selection of the 16 shaded
samples as a discontinuity (two weights closer than the frameworks'
rounding swap places, see test_torch_port_gated.py) and drops the second
search's near-ties: 99% within the bands, every ray within fifty times them.
`chip_smoke.py` holds the card's render of all
2048 rays to the same checks (`check_golden`).

Regenerate the file with ``python tests/test_torch_port_golden.py``; with
``--add-missing-legs`` the legs already in the file stay as they are and
only new ones are rendered.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dual_space_nerf_tpu_torch.evaluation.golden import (  # noqa: E402
    GOLDEN_NPZ,
    LEGS,
    check_golden,
    golden_items,
    leg_settings,
    render_golden,
)

N_RAYS = 2048
FAST_STRIDE = 8  # the fast CPU test renders every 8th golden ray (256 rays)
CHUNK = 256


def _jax_render_golden(rays: dict, legs: tuple = LEGS) -> dict:
    """The JAX package's render of the golden rays, leg by leg."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_port_common import jax_model_and_params, slice_cfg

    from dual_space_nerf_tpu.config import get_cfg_defaults
    from dual_space_nerf_tpu.data import SyntheticDataset
    from dual_space_nerf_tpu.evaluation import ImageRenderer
    from dual_space_nerf_tpu.renderer import RenderSettings

    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=512, w=512)
    model, params = jax_model_and_params()
    exact = RenderSettings.from_cfg(slice_cfg(get_cfg_defaults, 64))
    production = dataclasses.replace(exact, shade_topk=16, reuse_warp_faces=True)
    items = golden_items(rays)
    out = {}
    for leg in legs:
        item, s = items[leg], leg_settings(leg, exact, production)
        r = ImageRenderer(model, params, s, np.asarray(ds.faces), ds.canonical_vertex,
                          chunk=CHUNK, pack="f32")
        img = r.render_item(item)
        for k in ("color", "acc", "depth", "disp"):
            out[f"{leg}/{k}"] = img[f"coarse_{k}"].reshape(len(item["ray_o"]), -1)
    return out


def make_golden() -> dict:
    """Rays of the 512x512 val item + the JAX package's renders of them."""
    import jax.numpy as jnp

    from dual_space_nerf_tpu.data import SyntheticDataset
    from dual_space_nerf_tpu.geometry import gg_near_far

    item = SyntheticDataset(split="val", n_frames=1, n_views=1, h=512, w=512)[0]
    n_box = item["ray_o"].shape[0]
    stride = n_box // N_RAYS
    idx = np.arange(N_RAYS) * stride
    rays = {"ray_index": idx.astype(np.int64)}
    for k in ("ray_o", "ray_d", "near", "far"):
        rays[k] = np.asarray(item[k][idx], np.float32)
    rays["xyz"] = np.asarray(item["xyz"], np.float32)
    rays["poses"] = np.asarray(item["poses"], np.float32)
    near, far = gg_near_far(*(jnp.asarray(rays[k]) for k in ("ray_o", "ray_d", "near", "far")),
                            jnp.asarray(rays["xyz"]), 0.05)
    rays["gg_near"], rays["gg_far"] = np.asarray(near), np.asarray(far)
    rays.update(_jax_render_golden(rays))
    return rays


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN_NPZ) as data:
        return {k: data[k] for k in data.files}


def test_golden_rays_are_the_ports_val_item(golden):
    from dual_space_nerf_tpu_torch.data import SyntheticDataset

    item = SyntheticDataset(split="val", n_frames=1, n_views=1, h=512, w=512)[0]
    assert item["ray_o"].shape[0] == 146_749
    idx = golden["ray_index"]
    for k in ("ray_o", "ray_d", "near", "far"):
        np.testing.assert_array_equal(item[k][idx], golden[k], err_msg=k)
    np.testing.assert_array_equal(item["xyz"], golden["xyz"])
    np.testing.assert_array_equal(item["poses"], golden["poses"])


def test_port_cpu_render_matches_golden(golden):
    sub = {k: (v[::FAST_STRIDE] if v.shape[0] == N_RAYS else v) for k, v in golden.items()}
    out = render_golden(sub, device="cpu", chunk=CHUNK)
    report = check_golden(out, sub)
    assert report["ok"], report


@pytest.mark.slow
def test_golden_file_is_what_jax_renders(golden):
    fresh = make_golden()
    assert set(fresh) == set(golden)
    for k, v in fresh.items():
        # same code, same CPU: equal up to XLA's own run-to-run reordering
        np.testing.assert_allclose(v, golden[k], rtol=1e-6, atol=1e-6, err_msg=k)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if "--add-missing-legs" in sys.argv:
        with np.load(GOLDEN_NPZ) as old:
            data = {k: old[k] for k in old.files}
        missing = tuple(leg for leg in LEGS if f"{leg}/color" not in data)
        data.update(_jax_render_golden(data, missing))
    else:
        data = make_golden()
    np.savez_compressed(GOLDEN_NPZ, **data)
    print(f"wrote {GOLDEN_NPZ}: {len(data['ray_o'])} rays")
