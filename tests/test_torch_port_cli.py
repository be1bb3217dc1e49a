"""The port's train -> validate -> test CLIs on the CPU, driven in process as
`tests/test_cli_surface.py` drives the JAX package's, on the same tiny
config: the same output tree (``.png`` where the JAX validate writes
``.jpg``) and the same metric keys; the refusals of what is not ported,
each naming its ROADMAP item; and one train run in a subprocess where yaml,
cv2 and JAX cannot be imported, as on the card's machine.
"""

import glob
import logging
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from _pytest.monkeypatch import MonkeyPatch

from dual_space_nerf_tpu_torch.utils.image_io import PNG_SIGNATURE
from torch_port_common import REPO, TINY_CLI_CFG

EXP = "cli"


def _reset_cli_logger():
    """Both packages' CLIs log through the process-wide "NERFRender"
    logger, which keeps the handlers (and log.txt) of the first run."""
    logger = logging.getLogger("NERFRender")
    for h in logger.handlers:
        h.close()
    logger.handlers = []


def _run_clis(work, train, validate, test, device_args):
    cfg = str(work / "tiny.yml")
    _reset_cli_logger()
    try:
        train.main(["-c", cfg, "--exp", EXP] + device_args)
    finally:
        _reset_cli_logger()
    ckpt = sorted(glob.glob(str(work / f"EXP/{EXP}/model_epoch_*.ckpt")))[-1]
    val = validate.main(["-c", cfg, "--exp", EXP, "--ckpt", ckpt] + device_args)
    novel_view, novel_pose = test.main(["-c", cfg, "--exp", EXP, "--ckpt", ckpt] + device_args)
    return val, novel_view, novel_pose


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' CLIs on the tiny config, each in its own directory:
    {"jax" | "torch": (work dir, validate's metrics, novel view's, novel
    pose's)}."""
    from dual_space_nerf_tpu.cli import test as jax_test
    from dual_space_nerf_tpu.cli import train as jax_train
    from dual_space_nerf_tpu.cli import validate as jax_validate
    from dual_space_nerf_tpu_torch.cli import test, train, validate

    mp = MonkeyPatch()
    for var in ("DSNERF_SEED", "DSNERF_LOADER_BACKEND", "DSNERF_VAL_PERIOD",
                "DSNERF_DETERMINISTIC_DATA"):
        mp.delenv(var, raising=False)
    out = {}
    try:
        for side, mods, device_args in (("jax", (jax_train, jax_validate, jax_test), []),
                                        ("torch", (train, validate, test), ["--device", "cpu"])):
            work = tmp_path_factory.mktemp(f"cli_{side}")
            (work / "tiny.yml").write_text(TINY_CLI_CFG)
            mp.chdir(work)
            out[side] = (work, *_run_clis(work, *mods, device_args))
    finally:
        mp.undo()
    return out


LIT_CENTER = "[0.1, -0.2, 0.3]"  # a shifted light for the novel poses


def _flax_npz(ckpt: str, path) -> str:
    """The params of a JAX package checkpoint (flax msgpack) as the flat
    ``.npz`` that the port's `Checkpointer.load_params_only` reads."""
    from flax import serialization

    with open(ckpt, "rb") as f:
        tree = serialization.msgpack_restore(bytearray(f.read()))["params"]
    flat = {}

    def walk(node, prefix):
        for key, value in node.items():
            name = f"{prefix}/{key}" if prefix else key
            if isinstance(value, dict):
                walk(value, name)
            else:
                flat[name] = np.asarray(value)

    walk(tree, "")
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def same_weights(runs, tmp_path_factory):
    """Both packages' validate and test CLIs on the weights the JAX CLI
    trained: the JAX side reads its ``.ckpt``, the port the same params as
    a flax ``.npz`` named for the same epoch. The novel poses run twice:
    with the tiny config's empty ``light_center`` (frame code zeroed only)
    and with a shifted light. {split: (port's metrics, JAX's)}."""
    from dual_space_nerf_tpu.cli import test as jax_test
    from dual_space_nerf_tpu.cli import validate as jax_validate
    from dual_space_nerf_tpu_torch.cli import test, validate

    jax_ckpt = str(runs["jax"][0] / f"EXP/{EXP}/model_epoch_0000002.ckpt")
    work = tmp_path_factory.mktemp("cli_same")
    (work / "tiny.yml").write_text(TINY_CLI_CFG)
    (work / "lit.yml").write_text(
        TINY_CLI_CFG.replace("light_center: []", f"light_center: {LIT_CENTER}"))
    npz = _flax_npz(jax_ckpt, work / "model_epoch_0000002.npz")
    cpu = ["--device", "cpu"]
    mp = MonkeyPatch()
    try:
        mp.chdir(work)
        val = validate.main(["-c", "tiny.yml", "--exp", "port", "--ckpt", npz] + cpu)
        view, pose = test.main(["-c", "tiny.yml", "--exp", "port", "--ckpt", npz] + cpu)
        _, lit = test.main(["-c", "lit.yml", "--exp", "port_lit", "--ckpt", npz] + cpu)
        jval = jax_validate.main(["-c", "tiny.yml", "--exp", "jax", "--ckpt", jax_ckpt])
        _, jlit = jax_test.main(["-c", "lit.yml", "--exp", "jax_lit", "--ckpt", jax_ckpt])
    finally:
        mp.undo()
    _, jview, jpose = runs["jax"][1:]
    return {"validate": (val, jval), "novel_view": (view, jview),
            "novel_pose": (pose, jpose), "novel_pose_lit": (lit, jlit)}


def _tree(work) -> set:
    """Relative paths of the CLIs' outputs, .jpg read as .png, without the
    TensorBoard event files (their names carry the host and the time)."""
    files = set()
    for top in ("EXP", "TEST"):
        for path in glob.glob(str(work / top / "**" / "*"), recursive=True):
            rel = os.path.relpath(path, work)
            if os.path.isfile(path) and "events.out.tfevents" not in rel:
                files.add(rel[:-4] + ".png" if rel.endswith(".jpg") else rel)
    return files


def test_train_writes_the_jax_checkpoints(runs):
    work = runs["torch"][0]
    names = sorted(os.listdir(work / f"EXP/{EXP}"))
    assert "model_epoch_0000001.ckpt" in names and "model_epoch_0000002.ckpt" in names
    with open(work / f"EXP/{EXP}/last_checkpoint") as f:
        assert f.read().strip() == "model_epoch_0000002.ckpt"
    with open(work / f"EXP/{EXP}/log.txt") as f:
        log = f.read()
    assert "Epoch[1] Iteration[0/4] Loss:" in log and "Epoch 2 done." in log


def test_cli_output_tree_matches_jax(runs):
    ours, theirs = _tree(runs["torch"][0]), _tree(runs["jax"][0])
    assert ours == theirs
    assert sum(p.endswith(".png") for p in ours) == 3 * 4 + 2 * 5 * 4


def test_cli_metrics_match_jax_keys(runs):
    _, val, view, pose = runs["torch"]
    _, jval, jview, jpose = runs["jax"]
    assert set(val) == set(jval) == {"psnr_wMask", "psnr_woMask", "ssim"}
    assert set(view) == set(jview) and set(pose) == set(jpose)
    for res in (val, view, pose):
        assert all(np.isfinite(v) for v in res.values()), res
        assert 0.0 < res["ssim"] <= 1.0


@pytest.mark.parametrize("split", ["validate", "novel_view", "novel_pose", "novel_pose_lit"])
def test_cli_metrics_match_jax_on_the_same_weights(same_weights, split):
    """validate's fixed frame (min(50, MAX_FRAMES - 1)), the novel poses'
    zeroed frame code and shifted light, the clip and the masks, held to
    the JAX CLIs on the same weights. PSNR within 1e-5 relative (measured:
    at most 1.4e-6). SSIM within 1e-6 absolute (measured: at most 2.7e-7):
    after two tiny epochs SSIM is ~0.002, a near-cancellation in its
    numerator, so its relative gap (up to 1.3e-4) says nothing of the
    render; SSIM's range is [-1, 1]."""
    ours, theirs = same_weights[split]
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        if key == "ssim":
            assert abs(ours[key] - want) <= 1e-6, (key, ours, theirs)
        else:
            assert ours[key] == pytest.approx(want, rel=1e-5, abs=0.0), (key, ours, theirs)


def test_cli_pngs_are_the_images(runs):
    """Every PNG has the signature and the image's size (render | ground
    truth side by side in img/)."""
    work = runs["torch"][0]
    pngs = glob.glob(str(work / "**" / "*.png"), recursive=True)
    assert pngs
    for path in pngs:
        with open(path, "rb") as f:
            head = f.read(24)
        assert head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR"
        w, h = struct.unpack(">II", head[16:24])
        assert (h, w) == (16, 32 if "/img/" in path else 16), path


# ---------------------------------------------------------------------------
# what is not ported raises, naming its ROADMAP item
# ---------------------------------------------------------------------------
def _refusal(kind, tmp_path):
    from dual_space_nerf_tpu_torch.cli import common, test, validate
    from dual_space_nerf_tpu_torch.data import select_dataset
    from dual_space_nerf_tpu_torch.training import do_train

    cfg_path = tmp_path / "tiny.yml"
    cfg_path.write_text(TINY_CLI_CFG)
    if kind in ("validate --data_parallel", "test --data_parallel"):
        cli = validate if kind.startswith("validate") else test
        return lambda: cli.main(["-c", str(cfg_path), "--ckpt", "x.ckpt", "--data_parallel",
                                 "--device", "cpu"])
    if kind in ("zju_mocap", "h36m"):
        cfg = common.load_cfg(str(cfg_path))
        cfg.defrost()
        cfg.DATASETS.TYPE = kind
        return lambda: select_dataset(cfg)
    if kind == "smpl faces":
        cfg = common.load_cfg("")
        return lambda: common.load_faces(cfg)
    if kind == "mesh_devices":
        cfg = common.load_cfg(str(cfg_path))
        return lambda: do_train(cfg, None, None, None, None, None, str(tmp_path),
                                mesh_devices=object(), device="cpu")
    weights = tmp_path / "alex.npz"
    weights.write_bytes(b"")
    cfg_path.write_text(TINY_CLI_CFG + f"  LPIPS_WEIGHTS: '{weights}'\n")
    return lambda: test.main(["-c", str(cfg_path), "--ckpt", "x.ckpt", "--device", "cpu"])


@pytest.mark.parametrize("kind,item", [
    ("validate --data_parallel", 7), ("test --data_parallel", 7), ("mesh_devices", 7),
    ("zju_mocap", 4), ("h36m", 4), ("smpl faces", 4), ("LPIPS weights", 6),
])
def test_refusals_name_their_roadmap_item(tmp_path, kind, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, item {item}"):
        _refusal(kind, tmp_path)()


def test_train_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """Without --device the CLI asks for CUDA, which is refused here before
    anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from dual_space_nerf_tpu_torch.cli import train

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["-c", os.path.join(REPO, "configs", "synthetic.yml"), "--exp", "x",
                    "--max_epochs", "1"])
    assert os.listdir(tmp_path) == []


def test_train_cli_runs_without_yaml_cv2_or_jax(tmp_path):
    """One epoch in a subprocess where importing yaml, cv2, JAX or the JAX
    package fails: what the card's machine offers. With --profile_dir (a
    trace of the epoch) and --debug_nans (anomaly mode) on."""
    (tmp_path / "tiny.yml").write_text(TINY_CLI_CFG)
    script = textwrap.dedent("""
        import sys
        for name in ("yaml", "cv2", "jax", "flax", "dual_space_nerf_tpu"):
            sys.modules[name] = None
        from dual_space_nerf_tpu_torch.cli import train
        state = train.main(["-c", "tiny.yml", "--exp", "nodeps", "--max_epochs", "2",
                            "--device", "cpu", "--profile_dir", "prof", "--debug_nans"])
        assert state.step == 4, state.step
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(tmp_path / "EXP" / "nodeps" / "model_epoch_0000001.ckpt")
    assert glob.glob(str(tmp_path / "prof" / "*.pt.trace.json")), "no profiler trace"
