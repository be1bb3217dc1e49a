"""The port's train -> validate -> test CLIs on the CPU, driven in process as
`tests/test_cli_surface.py` drives the JAX package's, on the same tiny
config: the same output tree (``.png`` where the JAX validate writes
``.jpg``) and the same metric keys; what the port once refused (data
parallel eval and training, the KNN_IMPL values, LPIPS) run through the
CLIs; and one train run in a subprocess where yaml, cv2 and JAX cannot be
imported, as on the card's machine.
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
from torch_port_common import REPO, TINY_CLI_CFG, flax_ckpt_to_npz

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
    for var in ("DSNERF_SEED", "DSNERF_LOADER_BACKEND", "DSNERF_VAL_PERIOD"):
        mp.delenv(var, raising=False)
    # The weights must be a pure function of the seed: the default loader
    # yields items in completion order from two threads that share one
    # generator, so the items' order and rays (hence the JAX weights that
    # `same_weights` holds both packages to) follow the machine's load.
    mp.setenv("DSNERF_DETERMINISTIC_DATA", "1")
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
    npz = flax_ckpt_to_npz(jax_ckpt, work / "model_epoch_0000002.npz")
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
    the JAX CLIs on the same weights (trained on the pinned data stream of
    `runs`). PSNR within 1e-5 relative (measured: at most 2.4e-6, the same
    at 1, 4 and 8 threads). SSIM within 1e-6 absolute (measured: at most
    7.2e-8): after two tiny epochs SSIM is ~0.002, a near-cancellation in
    its numerator, so its relative gap says nothing of the render; SSIM's
    range is [-1, 1]. These bands hold on the reference seed's weights
    only; `test_validate_matches_jax_on_other_weights` holds the gap on
    others."""
    ours, theirs = same_weights[split]
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        if key == "ssim":
            assert abs(ours[key] - want) <= 1e-6, (key, ours, theirs)
        else:
            assert ours[key] == pytest.approx(want, rel=1e-5, abs=0.0), (key, ours, theirs)


@pytest.mark.parametrize("seed", [13, 21])
def test_validate_matches_jax_on_other_weights(tmp_path, seed):
    """`cli.validate` of both packages on JAX weights trained (pinned data
    stream) from other seeds than the reference's 233. The gap follows the
    weights: over 23 seeds' weights it reached 2.2e-5 relative in PSNR and
    7.8e-6 in SSIM (seed 21's validate: 1.8e-5 and 7.8e-6; seed 13's: 5.0e-6
    and 2.3e-6), where moving the JAX side's rays by one f32 ulp alone moves
    its own metrics by 9.9e-6 and 2.5e-6 (GG's near/far cancellation; a
    one-ulp move of the weights moves them by ~1e-9). Bands: PSNR 1e-4
    relative, SSIM 4e-5, ~5x the largest gap measured. Both CLIs take the
    JAX run's own ``.ckpt`` (the port through `training/flax_ckpt.py`)."""
    from dual_space_nerf_tpu.cli import train as jax_train
    from dual_space_nerf_tpu.cli import validate as jax_validate
    from dual_space_nerf_tpu_torch.cli import validate

    (tmp_path / "tiny.yml").write_text(TINY_CLI_CFG)
    mp = MonkeyPatch()
    try:
        for var in ("DSNERF_LOADER_BACKEND", "DSNERF_VAL_PERIOD"):
            mp.delenv(var, raising=False)
        mp.setenv("DSNERF_DETERMINISTIC_DATA", "1")
        mp.setenv("DSNERF_SEED", str(seed))
        mp.chdir(tmp_path)
        _reset_cli_logger()
        try:
            jax_train.main(["-c", "tiny.yml", "--exp", "jax"])
        finally:
            _reset_cli_logger()
        mp.delenv("DSNERF_SEED")
        jax_ckpt = str(tmp_path / "EXP/jax/model_epoch_0000002.ckpt")
        # the JAX package's own checkpoint, read by the port's flax reader
        ours = validate.main(["-c", "tiny.yml", "--exp", "port", "--ckpt", jax_ckpt, "--device", "cpu"])
        theirs = jax_validate.main(["-c", "tiny.yml", "--exp", "jax", "--ckpt", jax_ckpt])
    finally:
        mp.undo()
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        if key == "ssim":
            assert abs(ours[key] - want) <= 4e-5, (key, ours, theirs)
        else:
            assert ours[key] == pytest.approx(want, rel=1e-4, abs=0.0), (key, ours, theirs)


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
# what the refusals named (ROADMAP queue 1 items 5, 6, 7) runs on the CPU
# ---------------------------------------------------------------------------
def _frames(mp, modules) -> dict:
    """Record the float frames the CLIs of ``modules`` hand `write_png`."""
    frames = {}
    for module in modules:
        real = module.write_png

        def writer(path, img, _real=real):
            frames[os.path.relpath(str(path), os.getcwd())] = np.asarray(img, np.float64)
            return _real(path, img)

        mp.setattr(module, "write_png", writer)
    return frames


class _PoseSequence:
    """The synthetic val split standing in for the ZJU novel-pose sequence
    of `cli.novel_pose_vis`'s default branch (no ZJU tree here)."""

    def __init__(self, *args, **kwargs):
        from dual_space_nerf_tpu_torch.data import SyntheticDataset

        self.ds = SyntheticDataset(split="val", n_frames=2, n_views=1, h=16, w=16)
        self.canonical_vertex, self.faces = self.ds.canonical_vertex, self.ds.faces

    def set_novel_pose_dirs(self, *dirs):
        pass

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i]


def _both_ways(kind, tmp_path, ckpt, runs):
    """Run the CLI of ``kind`` with the feature it names on the torch run's
    checkpoint, and without it where `runs` did not: (with, without)."""
    import dual_space_nerf_tpu_torch.data.zju_novel_pose as zju_novel_pose
    import dual_space_nerf_tpu_torch.parallel as parallel
    from dual_space_nerf_tpu_torch.cli import novel_pose_vis, test, validate, vis_lighting

    cfg = str(tmp_path / "tiny.yml")
    common = ["-c", cfg, "--ckpt", ckpt, "--device", "cpu"]
    mp = MonkeyPatch()
    try:
        mp.chdir(tmp_path)
        if kind.endswith("--data_parallel"):
            cli = {"validate": validate, "test": test, "novel_pose_vis": novel_pose_vis,
                   "vis_lighting": vis_lighting}[kind.split()[0]]
            # two CPU "devices": every chunk split in halves over two replicas
            mp.setattr(parallel, "local_ray_devices",
                       lambda *a, **k: [torch.device("cpu"), torch.device("cpu")])
            mp.setattr(zju_novel_pose, "MocapNovelPoseView", _PoseSequence)
            frames = _frames(mp, [novel_pose_vis, vis_lighting])
            got = cli.main(common + ["--exp", "dp", "--data_parallel"])
            if cli in (validate, test):  # the same checkpoint's metrics, one device
                return got, runs["torch"][1] if cli is validate else tuple(runs["torch"][2:])
            cli.main(common + ["--exp", "one"])
            return [{k: v for k, v in frames.items() if f"/{exp}/" in k} for exp in ("dp", "one")]
        knn = kind.split()[1]
        (tmp_path / "knn.yml").write_text(TINY_CLI_CFG.replace(
            "  MAX_FRAMES: 16\n", f"  MAX_FRAMES: 16\n  KNN_IMPL: '{knn}'\n"))
        # against `runs`' validate of the same checkpoint (brute force)
        return (validate.main(["-c", "knn.yml", "--ckpt", ckpt, "--device", "cpu", "--exp", knn]),
                runs["torch"][1])
    finally:
        mp.undo()


@pytest.fixture
def two_threads():
    """Two intra-op threads while the test runs (restored after): the suite
    runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("two_threads")
@pytest.mark.parametrize("kind,item", [
    ("validate --data_parallel", 7), ("test --data_parallel", 7), ("mesh_devices", 7),
    ("novel_pose_vis --data_parallel", 7), ("vis_lighting --data_parallel", 7),
    ("KNN_IMPL grouped", 5), ("KNN_IMPL clustered", 5), ("KNN_IMPL xla", 5),
    ("LPIPS weights", 6),
])
def test_refusals_name_their_roadmap_item(runs, tmp_path, kind, item):
    """What ROADMAP queue 1 item ``item`` brought runs through the CLIs on
    the CPU, on the torch run's last checkpoint:

    - ``--data_parallel`` with two (CPU) devices splits every chunk over two
      model replicas: the same metrics (1e-6 relative) and frames (1e-4 of
      255) as one device;
    - ``mesh_devices``: `do_train` in a one-rank gloo process group (the
      data-parallel step, its all-reduce and broadcasts) ends with the
      parameters of the plain run, bit for bit;
    - each KNN_IMPL value through `cli.validate`: the metrics of the
      brute-force search within 1e-4 relative (ids part only at float32
      near-ties, and "xla" misranks some of those);
    - TEST.LPIPS_WEIGHTS naming an alex npz (seeded random weights in the
      converted layout): `cli.test` reports a finite ``lpips_alex`` (and no
      ``lpips_vgg``: the file's net is alex)."""
    work = runs["torch"][0]
    ckpt = str(work / f"EXP/{EXP}/model_epoch_0000002.ckpt")
    (tmp_path / "tiny.yml").write_text(TINY_CLI_CFG)
    if kind == "mesh_devices":
        params = [_train_in_group(tmp_path / name, group) for name, group in (("dp", True), ("one", False))]
        for name, p in params[0].items():
            assert torch.equal(p, params[1][name]), name
        return
    if kind == "LPIPS weights":
        from dual_space_nerf_tpu_torch.cli import test
        from dual_space_nerf_tpu_torch.evaluation.lpips import random_lpips_params

        weights = tmp_path / "alex.npz"
        np.savez(weights, **random_lpips_params("alex", np.random.default_rng(77)),
                 **{"meta/net": np.array("alex")})
        # 32x32 images: AlexNet's strides and pools leave nothing of 16x16
        (tmp_path / "lpips.yml").write_text(TINY_CLI_CFG.replace(
            "SYNTHETIC_SIZE: 16", "SYNTHETIC_SIZE: 32") + f"  LPIPS_WEIGHTS: '{weights}'\n")
        mp = MonkeyPatch()
        try:
            mp.chdir(tmp_path)
            view, pose = test.main(["-c", "lpips.yml", "--ckpt", ckpt, "--device", "cpu"])
        finally:
            mp.undo()
        for res in (view, pose):
            assert np.isfinite(res["lpips_alex"]) and res["lpips_alex"] > 0 and "lpips_vgg" not in res
        return
    got, want = _both_ways(kind, tmp_path, ckpt, runs)
    if kind.startswith("KNN_IMPL"):
        assert set(got) == set(want)
        for key, v in want.items():
            assert got[key] == pytest.approx(v, rel=1e-4), (key, got, want)
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert len(w) > 0 and set(g) == {k.replace("/one/", "/dp/") for k in w}
        for key, v in w.items():
            if isinstance(v, np.ndarray):
                assert np.abs(g[key.replace("/one/", "/dp/")] - v).max() <= 1e-4 * 255, key
            else:
                assert g[key] == pytest.approx(v, rel=1e-6), (key, g, w)


def _train_in_group(out_dir, in_group: bool) -> dict:
    """`do_train` of the tiny config for two epochs on the pinned data
    stream, in a one-rank gloo group or without one: the final parameters."""
    import torch.distributed as dist

    from dual_space_nerf_tpu_torch.cli.common import build_model, load_cfg, load_faces
    from dual_space_nerf_tpu_torch.data import select_dataset
    from dual_space_nerf_tpu_torch.parallel.distributed import free_port
    from dual_space_nerf_tpu_torch.training import do_train
    from dual_space_nerf_tpu_torch.utils.logger import _NullWriter

    cfg = load_cfg(str(out_dir.parent / "tiny.yml"))
    train_set, _ = select_dataset(cfg, train_nrays=cfg.SOLVER.TRAIN_NRAYS)
    mp = MonkeyPatch()
    mp.setenv("DSNERF_DETERMINISTIC_DATA", "1")
    mp.delenv("DSNERF_SEED", raising=False)
    if in_group:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    try:
        state = do_train(cfg, build_model(cfg, seed=233), train_set, load_faces(cfg, train_set),
                         _NullWriter(), logging.getLogger("refusal_cases"), str(out_dir),
                         max_epochs=3, device="cpu",
                         mesh_devices=dist.group.WORLD if in_group else None)
    finally:
        if in_group:
            dist.destroy_process_group()
        mp.undo()
    assert state.step == 8
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


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
