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


@pytest.mark.parametrize("impl", ["listed", "pruned", "grouped", "clustered", "xla"])
def test_dispatch_refuses_unported_searches(impl):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        nearest_face(torch.zeros((1, 3)), torch.zeros((1, 3)), impl)


def test_dispatch_rejects_unknown_impl():
    with pytest.raises(ValueError):
        nearest_face(torch.zeros((1, 3)), torch.zeros((1, 3)), "fastest")
