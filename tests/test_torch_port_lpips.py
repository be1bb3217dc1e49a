"""The port's LPIPS (`evaluation/lpips.py`) against the JAX package's
(`evaluation/lpips_jax.py`, `evaluation/lpips.py`) on the CPU.

No pretrained weights can be fetched here, so the arithmetic (convolution
strides and padding, pools, the scaling layer, channel unit-normalisation,
the lin heads, the spatial mean, the BGR -> RGB input protocol) is held on
seeded random weights in the converted npz layout, drawn as the JAX
package's tests draw them, and on its committed fixture
`tests/fixtures/lpips_golden.npz` (seed 77 weights, images of seeds 101 and
202). Tolerance: 1e-5 relative (both sides are float32 convolutions whose
sums round in different orders).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.evaluation.lpips import make_lpips as jax_make_lpips
from dual_space_nerf_tpu.evaluation.lpips_jax import lpips_distance as jax_lpips_distance
from dual_space_nerf_tpu_torch.evaluation.lpips import (
    load_lpips_params,
    lpips_distance,
    lpips_features,
    make_lpips,
    random_lpips_params,
    scale_input,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "fixtures", "lpips_golden.npz")
REL = 1e-5


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs (restored after):
    the suite runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write(path, net, seed=77):
    np.savez(path, **random_lpips_params(net, np.random.default_rng(seed)),
             **{"meta/net": np.array(net)})
    return str(path)


def _images(h, seeds=(101, 202)):
    """The fixture's images: RGB in (-1, 1), float32 (h, h, 3)."""
    return [(np.random.default_rng(s).random((h, h, 3)).astype(np.float32) * 2 - 1) for s in seeds]


@pytest.mark.parametrize("net,h", [("alex", 64), ("vgg", 32)])
def test_lpips_matches_jax(tmp_path, net, h):
    """`lpips_distance` on the weights of one npz against the JAX package's
    on the same file, and the bound metric (`make_lpips`, [0, 1] BGR
    images) against the JAX package's `make_lpips`: 1e-5 relative."""
    path = _write(tmp_path / f"lpips_{net}.npz", net, seed=3)
    params, stored = load_lpips_params(path, "cpu")
    assert stored == net
    with np.load(path) as data:
        jparams = {k: jnp.asarray(data[k]) for k in data.files if not k.startswith("meta")}
    img0, img1 = _images(h, (5, 6))
    got = float(lpips_distance(params, torch.from_numpy(img0), torch.from_numpy(img1), net))
    want = float(jax_lpips_distance(jparams, jnp.asarray(img0), jnp.asarray(img1), net=net))
    assert got == pytest.approx(want, rel=REL)
    pred, gt = (img0 + 1) / 2, (img1 + 1) / 2
    fn, jfn = make_lpips(net, path, device="cpu"), jax_make_lpips(net, path)
    assert fn(pred, gt) == pytest.approx(jfn(pred, gt), rel=REL)
    # the protocol: BGR in [0, 1] flipped to RGB in (-1, 1)
    flipped = float(lpips_distance(params, torch.from_numpy(2 * pred[..., ::-1].copy() - 1),
                                   torch.from_numpy(2 * gt[..., ::-1].copy() - 1), net))
    assert fn(pred, gt) == pytest.approx(flipped, rel=1e-6)


@pytest.mark.parametrize("net,h", [("alex", 64), ("vgg", 32)])
def test_lpips_matches_committed_golden(net, h):
    """The JAX package's committed fixture: the score and each stage's mean
    and largest magnitude of the seed-77 weights on the seed-101 and -202
    images, within 1e-5 relative."""
    params = {k: torch.from_numpy(v.transpose(3, 2, 0, 1).copy()) if k.endswith("/kernel")
              and k.startswith("conv") else torch.from_numpy(v)
              for k, v in random_lpips_params(net, np.random.default_rng(77)).items()}
    img0, img1 = (torch.from_numpy(x) for x in _images(h))
    with np.load(GOLDEN) as fx:
        assert float(lpips_distance(params, img0, img1, net)) == pytest.approx(
            float(fx[f"{net}/score"]), rel=REL)
        with torch.no_grad():
            feats = lpips_features(params, scale_input(img0), net)
        assert len(feats) == 5
        for i, f in enumerate(feats):
            assert float(f.double().mean()) == pytest.approx(float(fx[f"{net}/feat{i}_mean"]), rel=REL)
            assert float(f.abs().max()) == pytest.approx(float(fx[f"{net}/feat{i}_absmax"]), rel=REL)


class _MeanAbs(torch.nn.Module):
    def forward(self, a, b):
        return (a - b).abs().mean()


def test_make_lpips_routes(tmp_path, monkeypatch):
    """The JAX package's routes in its order: a file whose meta/net is the
    net asked for; a directory holding lpips_{net}.npz; a net mismatch, no
    path, or a missing path -> None; a TorchScript module at the path, run
    on [-1, 1] RGB NCHW tensors as the JAX package runs it. The `lpips`
    package is kept out (it would fetch weights)."""
    monkeypatch.setitem(sys.modules, "lpips", None)
    alex = _write(tmp_path / "lpips_alex.npz", "alex")
    pred, gt = (x[:32, :32] for x in np.random.default_rng(9).random((2, 32, 32, 3)).astype(np.float32))
    by_file = make_lpips("alex", alex, device="cpu")
    by_dir = make_lpips("alex", str(tmp_path), device="cpu")
    assert by_file is not None and by_file(pred, gt) == by_dir(pred, gt) > 0
    assert make_lpips("vgg", alex, device="cpu") is None          # the file's net is alex
    assert make_lpips("vgg", str(tmp_path), device="cpu") is None  # no lpips_vgg.npz
    assert make_lpips("alex", "", device="cpu") is None
    assert make_lpips("alex", str(tmp_path / "nowhere.npz"), device="cpu") is None
    script = str(tmp_path / "meanabs.pt")
    torch.jit.save(torch.jit.script(_MeanAbs()), script)
    fn, jfn = make_lpips("alex", script, device="cpu"), jax_make_lpips("alex", script)
    assert fn is not None and fn(pred, gt) == pytest.approx(jfn(pred, gt), rel=1e-7)
    assert fn(pred, gt) == pytest.approx(float(np.abs(2 * pred - 2 * gt).mean()), rel=1e-6)


def test_lpips_npz_needs_the_card_unless_asked(tmp_path):
    """The npz route runs on the card by default: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_lpips("alex", _write(tmp_path / "lpips_alex.npz", "alex"))
