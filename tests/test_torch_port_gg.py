"""GG near/far: the port's plain version (the CUDA kernel's CPU path) vs the
JAX package's `geometry.sampling.gg_near_far` and its Pallas kernel in
interpret mode, at the full SMPL-sized vertex count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.geometry import gg_near_far as jax_gg
from dual_space_nerf_tpu.ops.gg_pallas import gg_near_far_pallas
from dual_space_nerf_tpu_torch.data.synthetic import make_scene
from dual_space_nerf_tpu_torch.ops import gg_near_far_cuda, gg_near_far_plain

# Tolerance. z = z0 -+ sqrt(gamma^2 - d2) with d2 = |v - o|^2 - z0^2, a
# difference of two numbers near 9 (one float32 ulp ~ 1e-6). The frameworks
# round the dot product z0 differently (XLA's einsum vs the port's spelled-out
# order), and near a sphere's tangent the sqrt amplifies that one-ulp
# difference of d2: measured up to 6.3e-5 relative on 1500 rays, on rays
# where the float64 result sits equally far from both. So: every ray within
# 1e-4 relative, and at least 95% of rays within 1e-5.
RTOL_ALL = 1e-4
RTOL_MOST = 1e-5


def _assert_close(port, ref):
    port, ref = port.numpy(), np.asarray(ref)
    rel = np.abs(port - ref) / np.abs(ref)
    assert rel.max() <= RTOL_ALL, rel.max()
    assert (rel <= RTOL_MOST).mean() >= 0.95, (rel <= RTOL_MOST).mean()


def _rays(rng, scene, r, miss_frac=0.25):
    eye = (-scene.R.T @ scene.T).ravel()
    targets = scene.verts_world[rng.integers(0, len(scene.verts_world), r)]
    targets = targets + 0.05 * rng.standard_normal((r, 3))
    targets[: int(r * miss_frac)] = scene.verts_world.max(0) + 50.0  # misses
    d = (targets - eye).astype(np.float32)
    o = np.broadcast_to(eye, (r, 3)).astype(np.float32)
    near = np.full((r,), 0.5, np.float32)
    far = np.full((r,), 4.0, np.float32)
    return o, d, near, far


@pytest.fixture(scope="module")
def scene():
    return make_scene()  # V = 6890


def test_plain_matches_jax(scene, rng_np):
    args = _rays(rng_np, scene, 1500) + (scene.verts_world,)
    n_t, f_t = gg_near_far_cuda(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    n_j, f_j = jax_gg(*(jnp.asarray(a) for a in args))
    _assert_close(n_t, n_j)
    _assert_close(f_t, f_j)
    hit = n_t.numpy() != 0.5
    assert 500 < hit.sum() < 1500  # both hits and misses are exercised


def test_plain_matches_pallas_interpret(scene, rng_np):
    args = _rays(rng_np, scene, 300) + (scene.verts_world,)
    n_t, f_t = gg_near_far_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    n_p, f_p = gg_near_far_pallas(*(jnp.asarray(a) for a in args), gamma=0.05, interpret=True)
    _assert_close(n_t, n_p)
    _assert_close(f_t, f_p)


def test_wrapper_takes_the_plain_version_on_cpu(scene, rng_np):
    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in _rays(rng_np, scene, 64) + (scene.verts_world,)]
    a = gg_near_far_cuda(*args, gamma=0.05)
    b = gg_near_far_plain(*args, gamma=0.05)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
