"""Data parallelism over rays and the eval copy's packing, on the CPU: the
port's `parallel/` (torch.distributed, one process per device) against a
single process, the ray-split `ImageRenderer(devices=...)` against one
device, `DSNERF_EVAL_PACK` against the JAX package's, and the env contract
of `parallel/distributed.py` against the JAX package's.

Multi-process tests start two ranks with gloo (`spawn_ranks`), each with a
timeout of its own, on the tiny shapes of `test_torch_port_cli.py`. Bands:
the two-rank step's loss within 1e-6 relative of the one-process step's and
every gradient within 1e-5 of its largest entry (the ranks' gradients are
means over half the rays, summed and halved: float32 rounding of the sums).
"""

import glob
import logging
import os

import numpy as np
import pytest
import torch
from _pytest.monkeypatch import MonkeyPatch

from dual_space_nerf_tpu_torch.parallel import (
    local_ray_devices,
    maybe_initialize_distributed,
    pad_rays_for_mesh,
    spawn_ranks,
)
from torch_port_common import TINY_CLI_CFG

CPU = torch.device("cpu")
SPAWN_TIMEOUT = 240  # seconds a rank may take; the ranks here take a few


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs (restored after):
    the suite runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the env contract and the device list
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("env", [
    {}, {"DSNERF_NUM_PROCESSES": "1"},
    {"DSNERF_NUM_PROCESSES": "2"},
    {"DSNERF_NUM_PROCESSES": "2", "DSNERF_COORD_ADDR": "localhost:1"},
    {"DSNERF_NUM_PROCESSES": "2", "DSNERF_PROCESS_ID": "0"},
])
def test_env_contract_matches_jax(monkeypatch, env):
    """One process (unset or 1): a no-op, False, as in the JAX package; more
    than one without the address or the rank: the JAX package's ValueError,
    before anything joins."""
    from dual_space_nerf_tpu.parallel.distributed import (
        maybe_initialize_distributed as jax_maybe_initialize,
    )

    for var in ("DSNERF_NUM_PROCESSES", "DSNERF_COORD_ADDR", "DSNERF_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if int(env.get("DSNERF_NUM_PROCESSES", "1")) <= 1:
        assert maybe_initialize_distributed() is False
        assert jax_maybe_initialize() is False
        return
    with pytest.raises(ValueError) as ours:
        maybe_initialize_distributed("gloo")
    with pytest.raises(ValueError) as theirs:
        jax_maybe_initialize()
    assert str(ours.value) == str(theirs.value)


def test_local_devices_and_padding():
    """The CPU is one device (None, as the JAX package's mesh of one device
    is None); rays round up to a multiple of the world."""
    from dual_space_nerf_tpu.parallel.mesh import pad_rays_for_mesh as jax_pad

    assert local_ray_devices(device_type="cpu") is None
    if not torch.cuda.is_available():
        assert local_ray_devices() is None
    for nrays in (1, 5500, 5501, 32):
        for world in (None, 1, 2, 3, 8):
            mesh = None if world is None else np.empty(world)
            want = jax_pad(nrays, None if mesh is None else type("M", (), {"devices": mesh})())
            assert pad_rays_for_mesh(nrays, world) == want


def test_spawn_ranks_ends_the_peers_of_a_failed_rank():
    """A rank that fails ends the run at once: its peer, which would wait
    two minutes, is ended and the failure raised well before that."""
    import time

    from torch_port_parallel_workers import fail_or_wait

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exit codes"):
        spawn_ranks(fail_or_wait, 2, timeout=SPAWN_TIMEOUT)
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# the eval path: the pack and the ray split
# ---------------------------------------------------------------------------
H = W = 16
N_SAMPLES = 8


@pytest.fixture(scope="module")
def eval_setup():
    from dual_space_nerf_tpu_torch.config import get_cfg_defaults
    from dual_space_nerf_tpu_torch.data import SyntheticDataset
    from dual_space_nerf_tpu_torch.renderer import RenderSettings
    from torch_port_common import slice_cfg, torch_model

    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    return ds, ds[0], torch_model(), RenderSettings.from_cfg(slice_cfg(get_cfg_defaults, N_SAMPLES))


def test_pack_reads_the_env_as_jax_does(monkeypatch, eval_setup):
    """DSNERF_EVAL_PACK: "f16" when unset, "f32", anything else the JAX
    package's ValueError; the argument wins over the variable."""
    from dual_space_nerf_tpu.evaluation.render_image import _default_pack as jax_default_pack
    from dual_space_nerf_tpu_torch.evaluation import ImageRenderer, default_pack

    ds, _, model, settings = eval_setup
    monkeypatch.delenv("DSNERF_EVAL_PACK", raising=False)
    assert default_pack() == jax_default_pack() == "f16"
    assert ImageRenderer(model, settings, ds.faces, ds.canonical_vertex, device="cpu").pack == "f16"
    monkeypatch.setenv("DSNERF_EVAL_PACK", "f32")
    assert default_pack() == "f32"
    assert ImageRenderer(model, settings, ds.faces, ds.canonical_vertex, device="cpu",
                         pack="f16").pack == "f16"
    monkeypatch.setenv("DSNERF_EVAL_PACK", "bf16")
    with pytest.raises(ValueError) as ours:
        default_pack()
    with pytest.raises(ValueError) as theirs:
        jax_default_pack()
    assert str(ours.value) == str(theirs.value)


def _f16_ulp(x):
    """The spacing of float16 at |x| (subnormal spacing below its range)."""
    a = np.abs(x).astype(np.float16)
    return np.spacing(a).astype(np.float64)


def test_f16_pack_matches_jax(eval_setup):
    """The val item through both packages' `ImageRenderer` with the f16
    pack and the f32 pack: the port's f16 canvas is its f32 canvas rounded
    to float16, exactly, as the JAX package's is; against the JAX
    package's f16 canvas every value lies within one float16 ulp wherever
    the two f32 renders agree within half an ulp (at least 97% of the
    values: GG's near/far round differently in the two frameworks,
    `test_torch_port_render.py`)."""
    from dual_space_nerf_tpu.config import get_cfg_defaults as jax_defaults
    from dual_space_nerf_tpu.evaluation import ImageRenderer as JaxRenderer
    from dual_space_nerf_tpu.renderer import RenderSettings as JaxSettings
    from dual_space_nerf_tpu_torch.evaluation import ImageRenderer
    from torch_port_common import jax_model_and_params, slice_cfg

    ds, item, model, settings = eval_setup
    jm, jp = jax_model_and_params()
    js = JaxSettings.from_cfg(slice_cfg(jax_defaults, N_SAMPLES))
    out = {}
    for pack in ("f16", "f32"):
        out[("torch", pack)] = ImageRenderer(model, settings, ds.faces, ds.canonical_vertex,
                                             chunk=128, device="cpu", pack=pack).render_item(item)
        out[("jax", pack)] = JaxRenderer(jm, jp, js, np.asarray(ds.faces), ds.canonical_vertex,
                                         chunk=128, pack=pack).render_item(item)
    mask = item["mask_at_box"].reshape(H, W)
    n_close = n_all = 0
    for key in ("coarse_color", "coarse_acc", "coarse_depth"):
        for side in ("torch", "jax"):
            f16, f32 = out[(side, "f16")][key], out[(side, "f32")][key]
            assert f16.dtype == np.float32
            np.testing.assert_array_equal(f16, f32.astype(np.float16).astype(np.float32))
        t16, j16 = out[("torch", "f16")][key][mask], out[("jax", "f16")][key][mask]
        t32, j32 = out[("torch", "f32")][key][mask], out[("jax", "f32")][key][mask]
        ulp = _f16_ulp(j32)
        close = np.abs(t32.astype(np.float64) - j32) <= 0.5 * ulp
        assert (np.abs(t16.astype(np.float64) - j16)[close] <= ulp[close]).all(), key
        n_close += close.sum()
        n_all += close.size
    assert n_close >= 0.97 * n_all, n_close / n_all


def test_renderer_splits_rays_over_devices(eval_setup):
    """`ImageRenderer(devices=["cpu", "cpu"])`: the chunk rounds up to a
    multiple of two (127 -> 128), every chunk splits in halves over the
    replicas, and the images equal the one-device images within 1e-6 (the
    networks see other slice sizes); the caller's model is the first
    replica."""
    from dual_space_nerf_tpu_torch.evaluation import ImageRenderer

    ds, item, model, settings = eval_setup
    one = ImageRenderer(model, settings, ds.faces, ds.canonical_vertex, chunk=128,
                        device="cpu", pack="f32")
    split = ImageRenderer(model, settings, ds.faces, ds.canonical_vertex, chunk=127,
                          devices=["cpu", "cpu"], pack="f32")
    assert split.chunk == 128 and split.replicas[CPU] is model and len(split.replicas) == 1
    a, b = one.render_item(item), split.render_item(item)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError):
        ImageRenderer(model, settings, ds.faces, ds.canonical_vertex, device="cpu", devices=["cpu"])


# ---------------------------------------------------------------------------
# training over two processes
# ---------------------------------------------------------------------------
NRAYS = 64


def _step_inputs(path):
    """The global inputs of one exact step (64 rays x 8 samples, the
    synthetic train item, the trained fixture, seeded draws), saved for the
    ranks; returns them."""
    from dual_space_nerf_tpu_torch.data import SyntheticDataset, item_to_mesh, item_to_train_batch
    from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg
    from dual_space_nerf_tpu_torch.renderer import RenderSettings
    from dual_space_nerf_tpu_torch.training import draw_randoms
    from torch_port_common import MAX_FRAMES, torch_model

    ds = SyntheticDataset(split="train", nrays=NRAYS, n_frames=1, n_views=1, h=32, w=32)
    item = ds[0]
    cfg = train_cfg(production=False, fused=False)
    cfg.MODEL.COARSE_RAY_SAMPLING = N_SAMPLES
    settings = RenderSettings.from_cfg(cfg)
    gen = torch.Generator().manual_seed(4)
    d = {"batch": item_to_train_batch(item, NRAYS, CPU),
         "mesh": item_to_mesh(item, ds.faces, ds.canonical_vertex, CPU),
         "randoms": draw_randoms(NRAYS, N_SAMPLES, gen, CPU), "settings": settings,
         "weights": torch_model().state_dict(), "max_frames": MAX_FRAMES}
    torch.save(d, path)
    return d, cfg


def test_two_process_step_matches_one_process(tmp_path):
    """Two gloo ranks take one step on 32 rays each of a 64-ray batch (each
    its contiguous half of the rays and of the global draws): both ranks end
    with the same metrics and gradients, the loss within 1e-6 relative of
    the one-process step's, every gradient within 1e-5 of its largest
    entry, and the same parameters after Adam within 1e-7."""
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
    from dual_space_nerf_tpu_torch.training import create_train_state, make_train_step
    from torch_port_parallel_workers import step_rank

    d, cfg = _step_inputs(tmp_path / "inputs.pt")
    spawn_ranks(step_rank, 2, args=(str(tmp_path / "inputs.pt"), str(tmp_path)), timeout=SPAWN_TIMEOUT)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    model = DualSpaceNeRF(max_frames=d["max_frames"])
    model.load_state_dict(d["weights"])
    state = create_train_state(model, cfg)
    want = make_train_step(d["settings"], device="cpu")(state, d["batch"], d["mesh"], d["randoms"])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k, v in want.items():
        assert ranks[0]["metrics"][k] == pytest.approx(float(v), rel=1e-6), k
    for n, p in model.named_parameters():
        for r in ranks:
            assert torch.equal(r["grads"][n], ranks[0]["grads"][n]), n
        scale = max(float(p.grad.abs().max()), 1e-30)
        assert float((ranks[0]["grads"][n] - p.grad).abs().max()) <= 1e-5 * scale, n
        assert float((ranks[0]["params"][n] - p.detach()).abs().max()) <= 1e-7, n


def _reset_cli_logger():
    logger = logging.getLogger("NERFRender")
    for h in logger.handlers:
        h.close()
    logger.handlers = []


def test_two_process_train_cli_matches_one_process(tmp_path):
    """`cli.train` as two gloo ranks (the env contract that `spawn_ranks`
    sets, what the CLI does itself with more than one card) against one
    process on the pinned data stream, two epochs of the tiny config: the
    same checkpoints, written by rank 0 only (rank 1 fails if it saves),
    one TensorBoard event file and one log line per iteration; the final
    parameters within 1e-5 of the one-process run's (measured 1.3e-6: the
    halves' gradients round differently, and Adam's update m / sqrt(v)
    carries a rounding of a near-zero gradient entry at full size; eight
    steps at lr <= 5e-4 move a parameter by at most 4e-3)."""
    from dual_space_nerf_tpu_torch.cli import train
    from torch_port_parallel_workers import train_cli_rank

    argv = ["-c", "tiny.yml", "--exp", "t", "--device", "cpu"]
    runs = {}
    mp = MonkeyPatch()
    try:
        for var in ("DSNERF_SEED", "DSNERF_LOADER_BACKEND", "DSNERF_VAL_PERIOD",
                    "DSNERF_NUM_PROCESSES", "DSNERF_COORD_ADDR", "DSNERF_PROCESS_ID"):
            mp.delenv(var, raising=False)
        mp.setenv("DSNERF_DETERMINISTIC_DATA", "1")  # what two ranks force
        for name in ("two", "one"):
            work = tmp_path / name
            work.mkdir()
            (work / "tiny.yml").write_text(TINY_CLI_CFG)
            if name == "two":
                spawn_ranks(train_cli_rank, 2, args=(str(work), argv), timeout=SPAWN_TIMEOUT)
            else:
                mp.chdir(work)
                _reset_cli_logger()
                try:
                    train.main(argv)
                finally:
                    _reset_cli_logger()
            runs[name] = work / "EXP" / "t"
    finally:
        mp.undo()
    names = {k: sorted(os.listdir(v)) for k, v in runs.items()}
    assert "model_epoch_0000002.ckpt" in names["two"]
    assert [n for n in names["two"] if "tfevents" not in n] == [n for n in names["one"] if "tfevents" not in n]
    assert len(glob.glob(str(runs["two"] / "*tfevents*"))) == 1
    with open(runs["two"] / "log.txt") as f:
        assert f.read().count("Epoch[1] Iteration[0/4] Loss:") == 1
    got, want = (torch.load(runs[k] / "model_epoch_0000002.ckpt", weights_only=True) for k in ("two", "one"))
    assert got["step"] == want["step"] == 8
    for n, w in want["model"].items():
        assert float((got["model"][n] - w).abs().max()) <= 1e-5, n
