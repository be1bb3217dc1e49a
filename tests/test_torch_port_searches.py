"""The cluster-pruned and expanded-form searches (`KNN_IMPL` "grouped",
"clustered", "xla") against the JAX package's on the CPU: the searches
alone on the SMPL-sized synthetic mesh (V=6890, F=13,776), a render and a
training step with "grouped".

Ids. The port computes the same float32 expressions as the JAX package but
its sums may round in another order (torch's and XLA's reductions and
matmuls), so a point's id may part from JAX's only where two faces' float64
squared distances tie within float32 rounding: |d_a - d_b| <= 1e-6 *
min(d_a, d_b) (`_near_ties_only`; measured at most 1.9e-7). A cluster
boundary moved by rounding would show as a larger gap. The expanded form
(`nearest_face_xla`) rounds |p|^2 - 2 p.c + |c|^2, whose error is ~|p|^2
float32 ulps, not ~d: where it parts from JAX's the two faces' expanded
values must tie within 8 ulps of |p|^2 + |c|^2.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.config import get_cfg_defaults as jax_defaults
from dual_space_nerf_tpu.data import SyntheticDataset as JaxDataset
from dual_space_nerf_tpu.data.batching import item_to_mesh as jax_item_to_mesh
from dual_space_nerf_tpu.data.batching import item_to_train_batch as jax_item_to_train_batch
from dual_space_nerf_tpu.geometry import gg_near_far as jax_gg
from dual_space_nerf_tpu.geometry import sample_along_rays as jax_samples
from dual_space_nerf_tpu.geometry import stratified_z as jax_z
from dual_space_nerf_tpu.ops import nearest_face as jax_nearest_face
from dual_space_nerf_tpu.ops import nearest_face_xla as jax_xla
from dual_space_nerf_tpu.ops.clustered_knn import nearest_face_clustered as jax_clustered
from dual_space_nerf_tpu.ops.clustered_knn import nearest_face_grouped as jax_grouped
from dual_space_nerf_tpu.renderer import LightState as JaxLight
from dual_space_nerf_tpu.renderer import RayBatch as JaxRays
from dual_space_nerf_tpu.renderer import RenderSettings as JaxSettings
from dual_space_nerf_tpu.renderer import render_rays as jax_render_rays
from dual_space_nerf_tpu.training.loss import make_loss as jax_make_loss
from dual_space_nerf_tpu_torch.config import get_cfg_defaults
from dual_space_nerf_tpu_torch.data import SyntheticDataset, item_to_mesh, item_to_train_batch
from dual_space_nerf_tpu_torch.data.synthetic import make_scene
from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg
from dual_space_nerf_tpu_torch.models import state_dict_from_flax
from dual_space_nerf_tpu_torch.ops import (
    build_face_clusters,
    cluster_geometry,
    face_centroids,
    nearest_face,
    nearest_face_clustered,
    nearest_face_grouped,
    nearest_face_xla,
)
from dual_space_nerf_tpu_torch.renderer import LightState, RayBatch, RenderSettings, render_rays
from dual_space_nerf_tpu_torch.renderer.pipeline import ray_group
from dual_space_nerf_tpu_torch.training import TrainBatch, create_train_state, make_train_step
from torch_port_common import jax_model_and_params, slice_cfg, torch_model

CPU = torch.device("cpu")
TIE_REL = 1e-6


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs (restored after):
    the suite runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """The SMPL-sized scene's posed centroids (float32, both packages'
    `face_centroids` agree bit for bit), its cluster table, and ray
    samples: 300 camera rays aimed at the mesh, GG near/far, 16 stratified
    samples each (`tests/test_clustered_knn.py`'s workload), (R, S, 3)."""
    rng = np.random.default_rng(0)
    scene = make_scene()
    cents = face_centroids(torch.from_numpy(scene.verts_world),
                           torch.from_numpy(scene.faces.astype(np.int64))).numpy()
    eye = (-scene.R.T @ scene.T).ravel()
    r, s = 300, 16
    targets = scene.verts_world[rng.integers(0, len(scene.verts_world), r)]
    d = jnp.asarray((targets + 0.03 * rng.standard_normal((r, 3)) - eye).astype(np.float32))
    ro = jnp.asarray(np.broadcast_to(eye, (r, 3)), jnp.float32)
    near, far = jax_gg(ro, d, jnp.full((r,), 0.5), jnp.full((r,), 3.0),
                       jnp.asarray(scene.verts_world))
    rays = np.array(jax_samples(ro, d, jax_z(near, far, s)))
    # near-surface, in-box and far points (the real workload is the first)
    cloud = np.concatenate([
        cents[rng.integers(0, len(cents), 2000)] + 0.05 * rng.standard_normal((2000, 3)),
        rng.uniform(-1.2, 1.2, (1000, 3)), rng.uniform(-4, 4, (500, 3)),
    ]).astype(np.float32)
    return cents, build_face_clusters(cents), rays, cloud


def _nearest64(pts, cents, step: int = 256):
    """Float64 nearest face and distance of each point, ``step`` points at a
    time."""
    c = torch.from_numpy(cents.astype(np.float64))
    ids, dist = [], []
    for a in range(0, len(pts), step):
        d2 = ((torch.from_numpy(pts[a:a + step].astype(np.float64))[:, None] - c) ** 2).sum(-1)
        m = d2.min(1)
        ids.append(m.indices.numpy())
        dist.append(np.sqrt(m.values.numpy()))
    return np.concatenate(ids), np.concatenate(dist)


def _near_ties_only(pts, cents, got, want) -> int:
    """Points where the ids part, all of them float64 near-ties; returns
    their number."""
    off = np.nonzero(got != want)[0]
    p, c = pts[off].astype(np.float64), cents.astype(np.float64)
    da = ((p - c[got[off]]) ** 2).sum(-1)
    db = ((p - c[want[off]]) ** 2).sum(-1)
    gap = np.abs(da - db) / np.minimum(da, db)
    assert (gap <= TIE_REL).all(), (off[gap > TIE_REL], gap.max())
    return off.size


def test_cluster_geometry_matches_jax(mesh):
    """Centers and radii of the clusters within float32 rounding of the
    sums (1e-6 of the mesh's extent); member tables equal."""
    from dual_space_nerf_tpu.ops.clustered_knn import _cluster_geometry as jax_geometry

    cents, table, _, _ = mesh
    got = cluster_geometry(torch.from_numpy(cents), torch.from_numpy(table))
    want = jax_geometry(jnp.asarray(cents), jnp.asarray(table))
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("group", [4, 1])
def test_grouped_matches_jax_on_ray_samples(mesh, group):
    """Sub-groups of 4 consecutive samples of a ray, as the renderer forms
    them, and groups of one: the JAX package's ids but at float64
    near-ties; and every near-surface sample (float64 nearest distance <
    0.12, the ones the renderer keeps) on its float64 nearest face or a
    near-tie of it."""
    cents, table, rays, _ = mesh
    pts = rays.reshape(-1, group, 3)
    got = nearest_face_grouped(torch.from_numpy(pts), torch.from_numpy(cents),
                               torch.from_numpy(table)).numpy().reshape(-1)
    want = np.asarray(jax_grouped(jnp.asarray(pts), jnp.asarray(cents), jnp.asarray(table))).reshape(-1)
    flat = rays.reshape(-1, 3)
    assert _near_ties_only(flat, cents, got, want) <= 0.001 * flat.shape[0]
    truth, dist = _nearest64(flat, cents)
    near = dist < 0.12
    assert near.sum() > 3000
    _near_ties_only(flat[near], cents, got[near], truth[near])


def test_clustered_matches_jax(mesh):
    """Near-surface, in-box, far and ray-sample points, in chunks of 1000
    (the ids do not depend on the chunk): the JAX package's ids but at
    float64 near-ties."""
    cents, table, rays, cloud = mesh
    pts = np.concatenate([cloud, rays.reshape(-1, 3)])
    got = nearest_face_clustered(torch.from_numpy(pts), torch.from_numpy(cents),
                                 torch.from_numpy(table), chunk=1000).numpy()
    want = np.asarray(jax_clustered(jnp.asarray(pts), jnp.asarray(cents), jnp.asarray(table)))
    assert _near_ties_only(pts, cents, got, want) <= 0.001 * pts.shape[0]


def test_xla_matches_jax(mesh, monkeypatch):
    """The expanded form, sliced over points (slices of 500 points here): the
    JAX package's ids but where the two faces' expanded values tie within
    8 float32 ulps of |p|^2 + |c|^2."""
    nf = sys.modules["dual_space_nerf_tpu_torch.ops.nearest_face"]
    cents, _, rays, cloud = mesh
    pts = np.concatenate([cloud, rays.reshape(-1, 3)[::4]])
    want = np.asarray(jax_xla(jnp.asarray(pts), jnp.asarray(cents)))
    monkeypatch.setattr(nf, "_XLA_PAIRS", 500 * cents.shape[0])
    got = nearest_face_xla(torch.from_numpy(pts), torch.from_numpy(cents)).numpy()
    off = np.nonzero(got != want)[0]
    p, c = pts[off].astype(np.float64), cents.astype(np.float64)
    da = ((p - c[got[off]]) ** 2).sum(-1)
    db = ((p - c[want[off]]) ** 2).sum(-1)
    scale = (p * p).sum(-1) + np.maximum((c[got[off]] ** 2).sum(-1), (c[want[off]] ** 2).sum(-1))
    assert (np.abs(da - db) <= 8 * np.finfo(np.float32).eps * scale).all()
    assert off.size <= 0.001 * pts.shape[0]


@pytest.mark.parametrize("impl", ["grouped", "clustered", "xla"])
def test_dispatch_matches_jax_dispatch(mesh, impl):
    """`nearest_face` with each value and the cluster table against the JAX
    package's dispatch (grouped: groups of one point)."""
    cents, table, rays, _ = mesh
    pts = rays.reshape(-1, 3)[::3]
    got = nearest_face(torch.from_numpy(pts), torch.from_numpy(cents), impl,
                       torch.from_numpy(table)).numpy()
    want = np.asarray(jax_nearest_face(jnp.asarray(pts), jnp.asarray(cents), impl, jnp.asarray(table)))
    if impl == "xla":
        assert (got == want).mean() >= 0.999
    else:
        _near_ties_only(pts, cents, got, want)


@pytest.mark.parametrize("impl", ["grouped", "clustered"])
def test_dispatch_refuses_a_missing_cluster_table(impl):
    """No table, no search: the port raises where the JAX package's
    "grouped" falls through to its XLA argmin (ROADMAP section 3)."""
    with pytest.raises(ValueError, match="cluster_table"):
        nearest_face(torch.zeros((2, 3)), torch.zeros((4, 3)), impl)


def test_ray_group_is_the_jax_sub_group():
    assert [ray_group(s) for s in (64, 16, 6, 10, 3, 1)] == [4, 4, 2, 2, 1, 1]


# ---------------------------------------------------------------------------
# "grouped" through the renderer and the training step
# ---------------------------------------------------------------------------
H = W = 32
N_SAMPLES = 16
NRAYS = 64
BANDS = {"color": 5e-4, "acc_map": 1e-4, "depth_map": 1e-4}


@pytest.fixture(scope="module")
def val_item():
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    jitem = JaxDataset(split="val", n_frames=1, n_views=1, h=H, w=W)[0]
    jmesh = jax_item_to_mesh(jitem, np.asarray(ds.faces), ds.canonical_vertex)
    tmesh = item_to_mesh(ds[0], ds.faces, ds.canonical_vertex, CPU)
    return ds, jitem, jmesh, tmesh


def _grouped(settings, impl="grouped"):
    return dataclasses.replace(settings, sample_mode="uniform", knn_impl=impl)


@pytest.mark.parametrize("production", [False, True], ids=["exact", "production"])
def test_grouped_render_matches_jax(val_item, production):
    """The item's 574 rays with near/far held at the JAX package's GG result
    (so both sample the same z) and `KNN_IMPL: "grouped"` on both sides, on
    the exact path (world and canonical searches in sub-groups of 4) and
    the gated path (K=4, canonical search on single selected samples):
    every ray within the golden bands (color 5e-4, acc 1e-4, depth 1e-4
    relative to max(1, depth))."""
    ds, jitem, jmesh, tmesh = val_item
    assert tmesh.cluster_table is not None
    np.testing.assert_array_equal(tmesh.cluster_table.numpy(), np.asarray(jmesh.cluster_table))
    near, far = jax_gg(*(jnp.asarray(jitem[k]) for k in ("ray_o", "ray_d", "near", "far")),
                       jmesh.verts_world, 0.05)
    jrays = JaxRays(jnp.asarray(jitem["ray_o"]), jnp.asarray(jitem["ray_d"]), near, far,
                    jnp.asarray(0, jnp.int32), jnp.asarray(jitem["poses"][1:24]))
    trays = RayBatch(torch.from_numpy(jitem["ray_o"]), torch.from_numpy(jitem["ray_d"]),
                     torch.from_numpy(np.array(near)), torch.from_numpy(np.array(far)),
                     0, torch.from_numpy(np.asarray(jitem["poses"][1:24])))
    jcfg, tcfg = slice_cfg(jax_defaults, N_SAMPLES), slice_cfg(get_cfg_defaults, N_SAMPLES)
    for cfg in (jcfg, tcfg):
        if production:
            cfg.MODEL.SHADE_TOPK = 4
    js, ts = _grouped(JaxSettings.from_cfg(jcfg)), _grouped(RenderSettings.from_cfg(tcfg))
    jm, jp = jax_model_and_params()
    oj = jax.device_get(jax_render_rays(jp, jm, jrays, jmesh, js, JaxLight.identity(), None, train=False))
    ot = render_rays(torch_model(), trays, tmesh, ts, LightState.identity(), device="cpu")
    for k, band in BANDS.items():
        a, b = ot[k].numpy().reshape(574, -1), np.asarray(oj[k]).reshape(574, -1)
        err = np.abs(a - b).max(1)
        if k == "depth_map":
            err = err / np.maximum(1.0, np.abs(b).max(1))
        assert err.max() <= band, (k, err.max())


def _flat_grads(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_grouped_train_step_matches_jax(val_item):
    """One exact training step (64 rays x 16 samples, no draws, near/far at
    the JAX package's GG result) with `KNN_IMPL: "grouped"` against
    `jax.value_and_grad` of the JAX package's step loss: loss within 1e-6
    relative, every gradient within 2e-3 of its largest entry, the bands of
    `test_torch_port_train.py`'s step without draws."""
    ds, _, _, _ = val_item
    jitem = JaxDataset(split="train", nrays=NRAYS, n_frames=1, n_views=1, h=H, w=W)[0]
    titem = SyntheticDataset(split="train", nrays=NRAYS, n_frames=1, n_views=1, h=H, w=W)[0]
    jb = jax_item_to_train_batch(jitem, NRAYS)
    jmesh = jax_item_to_mesh(jitem, np.asarray(ds.faces), ds.canonical_vertex)
    near, far = jax_gg(jb.rays.ray_o, jb.rays.ray_d, jb.rays.near, jb.rays.far, jmesh.verts_world, 0.05)
    jb = jb._replace(rays=jb.rays._replace(near=near, far=far))
    tb = item_to_train_batch(titem, NRAYS, CPU)
    tb = TrainBatch(tb.rays._replace(near=torch.from_numpy(np.array(near)),
                                     far=torch.from_numpy(np.array(far))), tb.rgb, tb.occupancy)
    tmesh = item_to_mesh(titem, ds.faces, ds.canonical_vertex, CPU)
    cfg = train_cfg(production=False, fused=False)
    cfg.MODEL.COARSE_RAY_SAMPLING = N_SAMPLES
    cfg.MODEL.KNN_IMPL = "grouped"
    cfg.MODEL.perturb = 0.0
    cfg.MODEL.raw_noise_std = 0.0
    js = dataclasses.replace(JaxSettings.from_cfg(cfg), sample_mode="uniform")
    ts = dataclasses.replace(RenderSettings.from_cfg(cfg), sample_mode="uniform")
    jm, jp = jax_model_and_params()
    loss_fn = jax_make_loss("L2", False)
    rng = jax.random.key(5)

    def compute_loss(params):
        out = jax_render_rays(params, jm, jb.rays, jmesh, js, JaxLight.identity(), rng, train=True)
        return sum(loss_fn(out, jb.rgb, jb.occupancy).values())

    loss_j, grads_j = jax.jit(jax.value_and_grad(compute_loss))(jp)
    want = state_dict_from_flax(_flat_grads(grads_j))
    model = torch_model()
    state = create_train_state(model, cfg)
    zeros = torch.zeros((NRAYS, N_SAMPLES))
    metrics = make_train_step(ts, device="cpu")(state, tb, tmesh, randoms=(zeros, zeros))
    assert abs(float(metrics["loss"]) - float(loss_j)) <= 1e-6 * abs(float(loss_j))
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert np.abs(p.grad.numpy() - w).max() <= 2e-3 * max(np.abs(w).max(), 1e-30), name
