"""Port models vs the JAX package's flax models, both carrying the trained
fixture (`bench/r5/abhq_exact_s233_params.npz`) through
`models/convert.py`. Same numpy inputs on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.models import rod2quat as jax_rod2quat
from dual_space_nerf_tpu_torch.models import rod2quat, state_dict_from_flax
from dual_space_nerf_tpu_torch.models.spacenet import DualSpaceNeRF
from torch_port_common import PARAMS_NPZ, jax_model_and_params, torch_model

# float32 MLPs of 8-10 layers: XLA's and PyTorch's CPU matrix products sum
# in different orders, a few ulps per layer of outputs of size ~1-50
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def models():
    jm, jp = jax_model_and_params()
    return jm, jp, torch_model()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    n = 2048
    return {
        "pos": rng.uniform([-0.4, -0.4, -1.0], [0.4, 0.4, 1.0], (n, 3)).astype(np.float32),
        "body_pose": (0.1 * rng.standard_normal((23, 3))).astype(np.float32),
        "normal": rng.standard_normal((n, 3)).astype(np.float32),
        "xyz": rng.standard_normal((n, 3)).astype(np.float32),
        "view": rng.standard_normal((n, 3)).astype(np.float32),
        "essence": rng.uniform(0, 1, (n, 3)).astype(np.float32),
    }


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_state_dict_conversion_is_complete():
    with np.load(PARAMS_NPZ) as data:
        flat = {k: data[k] for k in data.files}
    sd = state_dict_from_flax(flat)
    model = DualSpaceNeRF(max_frames=16)
    assert set(sd) == set(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == 496_149
    assert sum(p.numel() for p in DualSpaceNeRF().parameters()) == 500_021
    # kernels are transposed to torch's (out, in)
    np.testing.assert_array_equal(
        sd["nerf.stage2.0.weight"].numpy(), flat["params/nerf/Dense_4/Dense_0/kernel"].T
    )
    with pytest.raises(KeyError):
        state_dict_from_flax({**flat, "params/nerf/Dense_99/Dense_0/kernel": np.zeros(1)})


def test_seeded_init_is_reproducible():
    a = DualSpaceNeRF(max_frames=4, generator=torch.Generator().manual_seed(1))
    b = DualSpaceNeRF(max_frames=4, generator=torch.Generator().manual_seed(1))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    w = a.nerf.stage1[0].weight
    assert w.abs().max() <= 1.0 / w.shape[1] ** 0.5


def test_rod2quat_matches_jax(inputs):
    _close(rod2quat(torch.from_numpy(inputs["body_pose"])),
           jax_rod2quat(jnp.asarray(inputs["body_pose"])), atol=1e-7)


def test_pose_feature_and_frame_code_match_jax(models, inputs):
    jm, jp, tm = models
    pf_j = jm.apply(jp, jnp.asarray(inputs["body_pose"]), method="pose_feature")
    pf_t = tm.pose_feature(torch.from_numpy(inputs["body_pose"]))
    _close(pf_t, pf_j)
    for frame in (0, 3, 99):  # 99 clamps to the last row
        _close(tm.frame_code(frame),
               jm.apply(jp, jnp.asarray(frame), method="frame_code"), rtol=0, atol=0)


@pytest.mark.parametrize("code_scale", [1.0, 0.0])
def test_sigma_essence_match_jax(models, inputs, code_scale):
    jm, jp, tm = models
    pf = jm.apply(jp, jnp.asarray(inputs["body_pose"]), method="pose_feature")
    code = jm.apply(jp, jnp.asarray(3), method="frame_code")
    n = inputs["pos"].shape[0]
    pf_n = jnp.broadcast_to(pf, (n, 16))
    ess_j, den_j = jm.apply(jp, jnp.asarray(inputs["pos"]), None, pf_n, code_scale,
                            method="sigma_essence", code=code)
    ess_t, den_t = tm.sigma_essence(
        torch.from_numpy(inputs["pos"]), tm.frame_code(3),
        torch.from_numpy(np.array(pf_n)), torch.tensor(code_scale, dtype=torch.float32),
    )
    _close(ess_t, ess_j)
    # density of a trained field reaches ~1e2; relative 1e-5 of that
    _close(den_t, den_j, atol=1e-4)


def test_density_gradient_matches_jax_vjp(models, inputs):
    jm, jp, tm = models
    pf = jm.apply(jp, jnp.asarray(inputs["body_pose"]), method="pose_feature")
    code = jm.apply(jp, jnp.asarray(3), method="frame_code")
    n = inputs["pos"].shape[0]
    pf_n = jnp.broadcast_to(pf, (n, 16))

    def f(xc):
        return jm.apply(jp, xc, None, pf_n, 1.0, method="sigma_essence", code=code)

    (ess, den), pull = jax.vjp(f, jnp.asarray(inputs["pos"]))
    g_j = pull((jnp.zeros_like(ess), jnp.ones_like(den)))[0]

    pc = torch.from_numpy(inputs["pos"]).requires_grad_(True)
    _, den_t = tm.sigma_essence(pc, tm.frame_code(3),
                                torch.from_numpy(np.array(pf_n)),
                                torch.tensor(1.0, dtype=torch.float32))
    (g_t,) = torch.autograd.grad(den_t.sum(), pc)
    # gradients of ~1e2-1e3 through 8 layers and PE up to 2^9: 1e-4 relative
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-4 * float(np.abs(np.asarray(g_j)).max()))


def test_lighting_matches_jax(models, inputs):
    jm, jp, tm = models
    args = [inputs[k] for k in ("normal", "xyz", "view", "essence")]
    c_j = jm.apply(jp, *(jnp.asarray(a) for a in args), method="lighting")
    c_t = tm.lighting(*(torch.from_numpy(a) for a in args))
    _close(c_t, c_j)
