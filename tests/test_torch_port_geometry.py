"""Port geometry, positional encoding and compositing vs the JAX package,
on the same numpy inputs. Tolerance: 1e-6 absolute (both float32; the two
frameworks' CPU kernels may round a reduction or a transcendental one ulp
apart), looser only where stated."""

import jax.numpy as jnp
import numpy as np
import torch

from dual_space_nerf_tpu import geometry as jg
from dual_space_nerf_tpu.ops.posenc import gaussian_fourier_features as jax_gff
from dual_space_nerf_tpu.ops.posenc import posenc as jax_posenc
from dual_space_nerf_tpu_torch import geometry as tg
from dual_space_nerf_tpu_torch.ops.posenc import gaussian_fourier_features as torch_gff
from dual_space_nerf_tpu_torch.ops.posenc import posenc as torch_posenc

ATOL = 1e-6


def _tris(rng, n):
    base = rng.standard_normal((n, 1, 3)).astype(np.float32)
    return (base + 0.1 * rng.standard_normal((n, 3, 3))).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_barycentric_functions_match_jax(rng_np):
    n = 512
    tris = _tris(rng_np, n)
    pts = (tris.mean(1) + 0.05 * rng_np.standard_normal((n, 3))).astype(np.float32)
    tt, tp = torch.from_numpy(tris), torch.from_numpy(pts)
    _close(tg.triangle_normal(tt), jg.triangle_normal(jnp.asarray(tris)))
    _close(tg.barycentric_uv(tp, tt), jg.barycentric_uv(jnp.asarray(pts), jnp.asarray(tris)),
           atol=1e-5)  # uv divides by a small determinant: relative 1e-6 of |uv| ~ 10
    uv_t, h_t = tg.project_point2mesh(tp, tt)
    uv_j, h_j = jg.project_point2mesh(jnp.asarray(pts), jnp.asarray(tris))
    _close(uv_t, uv_j, atol=1e-5)
    _close(h_t, h_j)
    tris2 = _tris(rng_np, n)
    _close(tg.barycentric_map(uv_t, h_t, torch.from_numpy(tris2)),
           jg.barycentric_map(uv_j, h_j, jnp.asarray(tris2)), atol=1e-5)
    uv = (6 * rng_np.standard_normal((n, 2))).astype(np.float32)
    h = (0.2 * rng_np.standard_normal(n)).astype(np.float32)
    np.testing.assert_array_equal(
        tg.transparent_mask(torch.from_numpy(uv), torch.from_numpy(h)).numpy(),
        np.asarray(jg.transparent_mask(jnp.asarray(uv), jnp.asarray(h))),
    )


def test_posenc_matches_jax(rng_np):
    x = rng_np.uniform(-1.5, 1.5, (256, 3)).astype(np.float32)
    # sin/cos of 512*x: 1 ulp of the argument (~1e-4) bounds the difference
    _close(torch_posenc(torch.from_numpy(x), 10), jax_posenc(jnp.asarray(x), 10), atol=2e-4)


def test_gaussian_fourier_features_match_jax(rng_np):
    """[sin(x B^T), cos(x B^T)] with B ~ N(0, 4^2), (16, 3), as the JAX
    package's test draws it: the shape, and the values within the file's
    1e-6 (measured: 6.0e-8 over five seeds)."""
    b = (4.0 * rng_np.standard_normal((16, 3))).astype(np.float32)
    x = rng_np.standard_normal((4096, 3)).astype(np.float32)
    got = torch_gff(torch.from_numpy(x), torch.from_numpy(b))
    assert got.shape == (4096, 32)
    _close(got, jax_gff(jnp.asarray(x), jnp.asarray(b)))


def test_sampling_matches_jax(rng_np):
    r, s = 64, 16
    near = rng_np.uniform(0.5, 1.5, r).astype(np.float32)
    far = (near + rng_np.uniform(0.5, 2.0, r)).astype(np.float32)
    z_t = tg.stratified_z(torch.from_numpy(near), torch.from_numpy(far), s)
    z_j = jg.stratified_z(jnp.asarray(near), jnp.asarray(far), s)
    _close(z_t, z_j)
    o = rng_np.standard_normal((r, 3)).astype(np.float32)
    d = rng_np.standard_normal((r, 3)).astype(np.float32)
    _close(tg.sample_along_rays(torch.from_numpy(o), torch.from_numpy(d), z_t),
           jg.sample_along_rays(jnp.asarray(o), jnp.asarray(d), z_j), atol=1e-5)


def test_stratified_z_with_uniforms_stays_in_strata(rng_np):
    near = torch.tensor([1.0, 2.0])
    far = torch.tensor([3.0, 2.5])
    t_rand = torch.from_numpy(rng_np.uniform(size=(2, 8)).astype(np.float32))
    z = tg.stratified_z(near, far, 8, t_rand)
    lin = tg.stratified_z(near, far, 8)
    assert torch.all(z[:, 1:] >= z[:, :-1])
    assert torch.all((z >= near[:, None]) & (z <= far[:, None]))
    assert not torch.equal(z, lin)


def test_composite_matches_jax(rng_np):
    r, s = 128, 32
    rgb = rng_np.uniform(0, 1, (r, s, 3)).astype(np.float32)
    sigma = (5 * rng_np.standard_normal((r, s))).astype(np.float32)
    z = np.sort(rng_np.uniform(1, 3, (r, s)), axis=1).astype(np.float32)
    d = rng_np.standard_normal((r, 3)).astype(np.float32)
    sigma[:4] = -1.0  # empty rays: acc 0, disp NaN on both sides
    t = tg.composite(*(torch.from_numpy(a) for a in (rgb, sigma, z, d)))
    j = jg.composite(*(jnp.asarray(a) for a in (rgb, sigma, z, d)))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=ATOL)
    assert np.isnan(t.disp[:4].numpy()).all()


def test_composite_noise_is_added_to_sigma(rng_np):
    r, s = 8, 4
    rgb = torch.rand(r, s, 3)
    sigma = torch.zeros(r, s)
    z = torch.linspace(1, 2, s).expand(r, s)
    d = torch.ones(r, 3)
    noise = torch.full((r, s), 3.0)
    a = tg.composite(rgb, sigma, z, d, noise=noise)
    b = tg.composite(rgb, sigma + 3.0, z, d)
    torch.testing.assert_close(a.rgb, b.rgb, rtol=0, atol=0)
