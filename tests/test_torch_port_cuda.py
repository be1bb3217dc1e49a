"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips where `torch.cuda.is_available()` is false.
This file imports neither JAX nor the JAX package, so it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from dual_space_nerf_tpu_torch.data.synthetic import make_scene
from dual_space_nerf_tpu_torch.ops import (
    face_centroids,
    gg_near_far_cuda,
    gg_near_far_plain,
    nearest_face_cuda,
    nearest_face_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def scene():
    return make_scene()  # V = 6890, F = 13,776


def _rays(scene, r, dev):
    rng = np.random.default_rng(1)
    eye = (-scene.R.T @ scene.T).ravel()
    tgt = scene.verts_world[rng.integers(0, len(scene.verts_world), r)]
    tgt = tgt + 0.05 * rng.standard_normal((r, 3))
    tgt[: r // 4] += 50.0  # misses keep their near/far
    d = (tgt - eye).astype(np.float32)
    o = np.broadcast_to(eye, (r, 3)).astype(np.float32)
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in (
        o, d, np.full(r, 0.5, np.float32), np.full(r, 4.0, np.float32), scene.verts_world)]


@pytest.mark.parametrize("r", [1, 8191, 8192])
def test_gg_kernel_equals_plain(dev, scene, r):
    args = _rays(scene, r, dev)
    n_k, f_k = gg_near_far_cuda(*args)
    n_p, f_p = gg_near_far_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(n_k, n_p) and torch.equal(f_k, f_p)  # the same roundings


@pytest.mark.parametrize("n", [1, 1000, 524_288])
def test_nearest_face_kernel_equals_plain(dev, scene, n):
    verts = torch.as_tensor(scene.verts_world, device=dev)
    cents = face_centroids(verts, torch.as_tensor(scene.faces.astype(np.int64), device=dev))
    g = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, cents.shape[0], (n,), device=dev, generator=g)
    pts = cents[idx] + 0.05 * torch.randn(n, 3, dtype=torch.float32, device=dev, generator=g)
    ids_k = nearest_face_cuda(pts, cents)
    ids_p = nearest_face_plain(pts, cents)
    torch.cuda.synchronize()
    assert torch.equal(ids_k, ids_p)


def test_kernels_reject_what_they_do_not_take(dev, scene):
    args = _rays(scene, 16, dev)
    with pytest.raises(TypeError):
        gg_near_far_cuda(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        gg_near_far_cuda(args[0], args[1].t().contiguous().t(), *args[2:])
    with pytest.raises(ValueError):
        gg_near_far_cuda(args[0], args[1], args[2], args[3], args[4].cpu())
    pts = torch.zeros(4, 3, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        nearest_face_cuda(pts, torch.zeros(0, 3, dtype=torch.float32, device=dev))
    with pytest.raises(TypeError):
        nearest_face_cuda(pts.half(), torch.zeros(2, 3, dtype=torch.float32, device=dev))
