"""Nearest face: the port's plain version (the CUDA kernel's CPU path) vs a
float64 numpy argmin and vs the JAX package's Pallas kernel in interpret
mode; the KNN_IMPL dispatch."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.ops.nearest_face import face_centroids as jax_centroids
from dual_space_nerf_tpu.ops.nearest_face import nearest_face_pallas
from dual_space_nerf_tpu_torch.data.synthetic import make_scene
from dual_space_nerf_tpu_torch.ops import (
    face_centroids,
    nearest_face,
    nearest_face_cuda,
    nearest_face_plain,
)
from dual_space_nerf_tpu_torch.ops.nearest_face import face_splits


@pytest.fixture(scope="module")
def mesh():
    scene = make_scene()  # F = 13,776
    return scene.verts_world, scene.faces


def _near_surface_points(rng, cents, n):
    idx = rng.integers(0, len(cents), n)
    return (cents[idx] + 0.03 * rng.standard_normal((n, 3))).astype(np.float32)


def test_face_centroids_match_jax(mesh):
    verts, faces = mesh
    t = face_centroids(torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)))
    j = jax_centroids(jnp.asarray(verts), jnp.asarray(faces))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-7)


def test_plain_matches_float64_argmin(mesh, rng_np):
    verts, faces = mesh
    cents = face_centroids(torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64))).numpy()
    pts = _near_surface_points(rng_np, cents, 3000)
    ids = nearest_face_plain(torch.from_numpy(pts), torch.from_numpy(cents)).numpy()
    d2 = ((pts[:, None, :].astype(np.float64) - cents[None].astype(np.float64)) ** 2).sum(-1)
    truth = d2.argmin(1)
    off = ids != truth
    # an id other than the float64 argmin is allowed only at a float32
    # near-tie: its float64 d2 within 1e-6 relative of the true minimum
    picked = d2[np.arange(len(pts)), ids]
    best = d2[np.arange(len(pts)), truth]
    assert np.all(picked[off] - best[off] <= 1e-6 * best[off])
    assert off.sum() <= 3  # and rare (none or a few in 3000)


def test_plain_matches_pallas_interpret(mesh, rng_np):
    verts, faces = mesh
    cents = face_centroids(torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64))).numpy()
    pts = _near_surface_points(rng_np, cents, 700)  # two 512-point blocks, one ragged
    ids_t = nearest_face_plain(torch.from_numpy(pts), torch.from_numpy(cents)).numpy()
    ids_p = np.asarray(nearest_face_pallas(jnp.asarray(pts), jnp.asarray(cents), interpret=True))
    np.testing.assert_array_equal(ids_t, ids_p)  # same direct-difference form: equal ids


def test_plain_slices_and_ties(monkeypatch):
    # exact ties take the smallest index; slicing over points changes nothing
    cents = torch.tensor([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]])
    pts = torch.zeros((5, 3))
    pts[1] = torch.tensor([0.9, 0, 0])
    assert nearest_face_plain(pts, cents).tolist() == [0, 0, 0, 0, 0]
    big = torch.randn(4000, 3, generator=torch.Generator().manual_seed(0))
    full = nearest_face_plain(big, cents)
    module = sys.modules["dual_space_nerf_tpu_torch.ops.nearest_face"]
    monkeypatch.setattr(module, "_PLAIN_PAIRS", 7)  # slices of one point
    assert torch.equal(nearest_face_plain(big, cents), full)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_dispatch_runs_the_brute_force_search(impl, rng_np):
    cents = torch.from_numpy(rng_np.standard_normal((50, 3)).astype(np.float32))
    pts = torch.from_numpy(rng_np.standard_normal((20, 3)).astype(np.float32))
    assert torch.equal(nearest_face(pts, cents, impl), nearest_face_cuda(pts, cents))


@pytest.mark.parametrize("impl", ["grouped", "clustered", "xla"])
def test_dispatch_refuses_unported_searches(impl, mesh, rng_np):
    """The three searches that were refused are ported: with the cluster
    table the dispatch returns the JAX package's dispatch's ids (on
    near-surface points of the SMPL-sized mesh, where no float32 near-tie
    parts them)."""
    from dual_space_nerf_tpu.ops import build_face_clusters as jax_clusters
    from dual_space_nerf_tpu.ops import nearest_face as jax_nearest_face
    from dual_space_nerf_tpu_torch.ops import build_face_clusters

    verts, faces = mesh
    cents = face_centroids(torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64))).numpy()
    pts = _near_surface_points(rng_np, cents, 300)
    table = build_face_clusters(cents)
    want = np.asarray(jax_nearest_face(jnp.asarray(pts), jnp.asarray(cents), impl,
                                       jax_clusters(cents).table))
    got = nearest_face(torch.from_numpy(pts), torch.from_numpy(cents), impl, torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["listed", "pruned"])
def test_dispatch_runs_the_tile_pruned_searches(impl, mesh, rng_np):
    """ "listed" and "pruned" need their mesh table and then agree with the
    brute-force search; without it they raise and run no other search."""
    from dual_space_nerf_tpu_torch.ops import build_face_clusters, build_face_tiles

    verts, faces = mesh
    cents = face_centroids(torch.from_numpy(verts), torch.from_numpy(faces.astype(np.int64)))
    pts = torch.from_numpy(_near_surface_points(rng_np, cents.numpy(), 300))
    with pytest.raises(ValueError, match="needs the mesh"):
        nearest_face(pts, cents, impl)
    clusters = build_face_clusters(cents.numpy())
    ids = nearest_face(
        pts, cents, impl,
        tile_table=torch.from_numpy(build_face_tiles(cents.numpy())),
        face_perm=torch.from_numpy(clusters[clusters >= 0].astype(np.int64)),
    )
    brute = nearest_face_plain(pts, cents)
    d2 = ((pts[:, None].double() - cents[None].double()) ** 2).sum(-1)
    rows = torch.arange(len(pts))
    gap = d2[rows, ids.long()] - d2[rows, brute.long()]
    assert ids.dtype == torch.int32
    assert bool((gap.abs() <= 1e-6 * d2[rows, brute.long()]).all())  # equal but for f32 near-ties
    assert int((ids != brute).sum()) <= 1


def test_dispatch_rejects_unknown_impl():
    with pytest.raises(ValueError):
        nearest_face(torch.zeros((1, 3)), torch.zeros((1, 3)), "fastest")


@pytest.mark.parametrize("n,f,want", [
    (524_288, 13_776, 1),  # the render chunk: 512 blocks, 4 rounds whatever the split
    (352_000, 13_776, 3),  # the training step: 344 blocks, 3 ranges even the rounds
    (1, 13_776, 8),        # one block: every range on an SM of its own
    (352_000, 2_047, 1),   # too few faces for two ranges of 1024
    (352_000, 3_072, 3),
    (528 * 1024, 13_776, 1),  # exactly four rounds
])
def test_face_splits_even_the_rounds(n, f, want):
    """The brute-force kernel's face split (blocks of 1024 points on 132
    SMs): taken only where it shortens the modelled rounds by 5%."""
    assert face_splits(n, f, 132, 1024) == want
