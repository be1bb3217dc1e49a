"""The port's CLIs on a ZJU-MoCap tree against the JAX package's, on the CPU.

A CoreView_313-style tree (annots.npy cameras with nonzero distortion, JPEG
frames, cihp PNG masks, per-frame SMPL assets, a stand-in SMPL pickle) is
written here with cv2, as `tests/test_zju.py` writes its trees. On it:

- `cli.train -> cli.validate` of both packages: the same output tree
  (``.jpg`` read as ``.png``) and metric keys; then both validate CLIs on
  the weights the JAX CLI trained, with the metric bands of
  `tests/test_torch_port_cli.py`;
- `cli.novel_pose_vis` (both branches: the same-subject ZJU pose sequence
  and an H36M motion on the performer) and `cli.vis_lighting` of both
  packages on those weights: the same frame files, and every frame within
  the render band (colour 5e-4 of the unit range, `ROADMAP.md`);
- `cli.train` in a subprocess where cv2, yaml and JAX cannot be imported,
  on the committed 1024 x 1024 tree (`.bench_cold_tree/`).
"""

import glob
import logging
import os
import shutil
import subprocess
import sys
import textwrap

import cv2
import numpy as np
import pytest
from _pytest.monkeypatch import MonkeyPatch

from dual_space_nerf_tpu.data.synthetic import look_at_camera, make_scene
from dual_space_nerf_tpu.data.synthetic_dataset import splat_image
from dual_space_nerf_tpu_torch.data.smpl import write_body_model
from torch_port_common import COLD_TREE, REPO, flax_ckpt_to_npz

H = W = 32
HUMAN = "CoreView_313"
COLOR_BAND = 5e-4 * 255  # the golden suite's colour band, on the 0..255 frames

ZJU_CFG = """\
MODEL:
  TYPE: "nerf"
  COARSE_RAY_SAMPLING: 8
  FINE_RAY_SAMPLING: -1
  sample_points_mode: "GG"
  MLP_CHUNK: 2048
  MAX_FRAMES: 16
DATASETS:
  TYPE: "zju_mocap"
  HUMAN: "CoreView_313"
DATALOADER:
  NUM_WORKERS: 2
SOLVER:
  MAX_EPOCHS: 3
  BASE_LR: 0.0005
  WEIGHT_DECAY: 0.0
  WARMUP_ITERS: 5
  CHECKPOINT_PERIOD: 1
  LOG_PERIOD: 2
  TRAIN_NRAYS: 32
TEST:
  IMS_PER_BATCH: 1
  RAY_CHUNK: 512
  light_center: [0.0, 0.0, 0.4]
"""

DATA_CFG = """\
Train:
  views: [0, 1]
  ratio: 0.5
  begin: 0
  end: 1
Val:
  ratio: 0.5
  begin: 0
  end: 3
  intv: 2
Test:
  ratio: 0.5
  begin: 0
  end: 3
  intv: 2
  novel_pose_begin: 2
"""

MOTION_CFG = """\
ratio: 0.5
training_view: [0, 1]
test_view: []
begin_ith_frame: 0
frame_interval: 1
num_train_frame: 2
vertices: 'new_vertices'
params: 'new_params'
"""


def _write_frame(img_path, msk_path, scene):
    img, mask = splat_image(scene, H, W)
    os.makedirs(os.path.dirname(img_path), exist_ok=True)
    os.makedirs(os.path.dirname(msk_path), exist_ok=True)
    cv2.imwrite(str(img_path), (img * 255).astype(np.uint8))
    cv2.imwrite(str(msk_path), mask.astype(np.uint8))


def _smpl_assets(root, scene, names, rng, canonical=True):
    os.makedirs(root / "new_params", exist_ok=True)
    os.makedirs(root / "new_vertices", exist_ok=True)
    for name in names:
        np.save(root / "new_params" / f"{name}.npy", {
            "Rh": (0.1 * rng.standard_normal((1, 3))).astype(np.float32),
            "Th": (0.05 * rng.standard_normal((1, 3))).astype(np.float32),
            "poses": (0.05 * rng.standard_normal((1, 72))).astype(np.float32),
        })
        np.save(root / "new_vertices" / f"{name}.npy", scene.verts_world)
    if canonical:
        np.save(root / "X_smpl_vertices.npy", scene.verts_cano[None])


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The trees, the SMPL pickle and a working directory with the configs.
    Returns a dict of paths."""
    scene = make_scene(n_theta=12, n_phi=10, h=H, w=W)
    rng = np.random.default_rng(3)
    zju_dir = tmp_path_factory.mktemp("zjuroot") / "zju_mocap"
    root = zju_dir / HUMAN
    ring = []
    for c in range(21):
        ang = 2 * np.pi * c / 21
        eye = np.array([2.0 * np.cos(ang), 2.0 * np.sin(ang), 0.3])
        ring.append(look_at_camera(eye, np.zeros(3), H, W, focal=40.0))
    dist = np.array([[-0.05], [0.01], [0.001], [-0.001], [0.0]])
    os.makedirs(root)
    np.save(root / "annots.npy", {"cams": {
        "K": [k for k, _, _ in ring], "R": [r for _, r, _ in ring],
        "T": [t * 1000.0 for _, _, t in ring], "D": [dist for _ in ring]}, "ims": []})
    # train views 0, 1; validation and test on cameras 22, 23; view 9 for
    # novel_pose_vis's default branch
    for cam_dir in ("Camera (1)", "Camera (2)", "Camera (10)", "Camera (22)", "Camera (23)"):
        for f in range(1, 5):
            name = f"{HUMAN}_Camera_(x)_{f:04d}_2019-08-23"
            _write_frame(root / cam_dir / f"{name}.jpg",
                         root / "mask_cihp" / cam_dir / f"{name}.png", scene)
    _smpl_assets(root, scene, [str(f) for f in range(1, 5)], rng)

    work = tmp_path_factory.mktemp("vis_cli")
    pose_dir = work / "poses"  # the novel-pose sequence: frames 0 and 4
    _smpl_assets(pose_dir, scene, ["0", "4"], rng, canonical=False)

    h36m_dir = tmp_path_factory.mktemp("h36mroot")
    hroot = h36m_dir / "S9" / "Posing"
    cams = {"K": [], "R": [], "T": [], "D": []}
    ims = []
    for K, R, T in ring[:3]:
        cams["K"].append(K)
        cams["R"].append(R)
        cams["T"].append(T * 1000.0)
        cams["D"].append(dist)
    for f in range(2):
        rels = [f"images/Camera{c}/{f}.jpg" for c in range(3)]
        for rel in rels:
            _write_frame(hroot / rel, hroot / "mask_cihp" / (rel[:-4] + ".png"), scene)
        ims.append({"ims": rels})
    np.save(hroot / "annots.npy", {"cams": cams, "ims": ims})
    _smpl_assets(hroot, scene, ["0", "1"], rng, canonical=False)

    smpl = work / "SMPL_NEUTRAL.pkl"
    write_body_model(str(smpl), scene.faces, scene.verts_cano.shape[0])
    (work / "zju.yml").write_text(ZJU_CFG)
    os.makedirs(work / "data_configs" / "zju_mocap")
    (work / "data_configs" / "zju_mocap" / f"{HUMAN}.yml").write_text(DATA_CFG)
    os.makedirs(work / "data_configs" / "novel_poses")
    (work / "data_configs" / "novel_poses" / f"{HUMAN}_S9.yml").write_text(MOTION_CFG)
    return {"work": work, "zju": str(zju_dir), "h36m": str(h36m_dir), "smpl": str(smpl),
            "poses": str(pose_dir)}


def _reset_cli_logger():
    logger = logging.getLogger("NERFRender")
    for h in logger.handlers:
        h.close()
    logger.handlers = []


def _capture(mp, module, attr, frames):
    """Record the float frames a CLI hands its image writer (and write them)."""
    real = getattr(module, attr)

    def writer(path, img, *args):
        frames[os.path.relpath(str(path), os.getcwd())] = np.asarray(img, np.float64)
        return real(path, img, *args)

    mp.setattr(module, attr, writer)


@pytest.fixture(scope="module")
def runs(env):
    """Both packages' train -> validate on the tree, then both packages'
    validate, novel_pose_vis (both branches) and vis_lighting on the
    weights the JAX CLI trained: {"jax" | "torch": {"dir": ..., "val":
    metrics, "val_same": metrics, "frames": {path: float frame}}}."""
    from dual_space_nerf_tpu.cli import novel_pose_vis as jax_npv
    from dual_space_nerf_tpu.cli import train as jax_train
    from dual_space_nerf_tpu.cli import validate as jax_validate
    from dual_space_nerf_tpu.cli import vis_lighting as jax_vl
    from dual_space_nerf_tpu_torch.cli import novel_pose_vis, train, validate, vis_lighting

    mp = MonkeyPatch()
    for var in ("DSNERF_SEED", "DSNERF_LOADER_BACKEND", "DSNERF_VAL_PERIOD"):
        mp.delenv(var, raising=False)
    # a pure function of the seed: ordered items, each with its own generator
    mp.setenv("DSNERF_DETERMINISTIC_DATA", "1")
    mp.setenv("DSNERF_ZJU_PATH", env["zju"])
    mp.setenv("DSNERF_H36M_PATH", env["h36m"])
    mp.setenv("DSNERF_SMPL_PATH", env["smpl"])
    out = {}
    try:
        for side, mods, dev in (("jax", (jax_train, jax_validate), []),
                                ("torch", (train, validate), ["--device", "cpu"])):
            work = env["work"] / side
            shutil.copytree(env["work"] / "data_configs", work / "data_configs")
            mp.chdir(work)
            _reset_cli_logger()
            try:
                mods[0].main(["-c", "../zju.yml", "--exp", "zju"] + dev)
            finally:
                _reset_cli_logger()
            ckpt = sorted(glob.glob(str(work / "EXP/zju/model_epoch_*.ckpt")))[-1]
            out[side] = {"dir": work, "ckpt": ckpt, "frames": {},
                         "val": mods[1].main(["-c", "../zju.yml", "--exp", "zju",
                                              "--ckpt", ckpt] + dev)}
        jax_ckpt = out["jax"]["ckpt"]
        npz = flax_ckpt_to_npz(jax_ckpt, env["work"] / os.path.basename(jax_ckpt).replace(
            ".ckpt", ".npz"))
        _capture(mp, jax_npv.cv2, "imwrite", out["jax"]["frames"])
        _capture(mp, novel_pose_vis, "write_png", out["torch"]["frames"])
        _capture(mp, vis_lighting, "write_png", out["torch"]["frames"])
        for side, (val_cli, npv, vl), ckpt, dev in (
                ("jax", (jax_validate, jax_npv, jax_vl), jax_ckpt, []),
                ("torch", (validate, novel_pose_vis, vis_lighting), npz, ["--device", "cpu"])):
            mp.chdir(out[side]["dir"])
            common = ["-c", "../zju.yml", "--ckpt", ckpt] + dev
            out[side]["val_same"] = val_cli.main(common + ["--exp", "same"])
            npv.main(common + ["--exp", "zju_pose", "--pose_dir", env["poses"],
                               "--n_frames", "2"])
            npv.main(common + ["--exp", "h36m_motion", "--performer", HUMAN,
                               "--motion_seq", "S9", "--n_frames", "1"])
            vl.main(common + ["--exp", "relight"])
    finally:
        mp.undo()
    return out


def _tree(work, tops) -> set:
    files = set()
    for top in tops:
        for path in glob.glob(str(work / top / "**" / "*"), recursive=True):
            rel = os.path.relpath(path, work)
            if os.path.isfile(path) and "events.out.tfevents" not in rel:
                files.add(rel[:-4] + ".png" if rel.endswith(".jpg") else rel)
    return files


def test_zju_train_validate_tree_and_metrics_match_jax(runs):
    """The output tree of train -> validate (checkpoints, log, val images)
    and the metric keys, finite."""
    ours, theirs = _tree(runs["torch"]["dir"], ["EXP"]), _tree(runs["jax"]["dir"], ["EXP"])
    assert ours == theirs
    assert "EXP/zju/model_epoch_0000002.ckpt" in ours
    for side in ("torch", "jax"):
        res = runs[side]["val"]
        assert set(res) == {"psnr_wMask", "psnr_woMask", "ssim"}
        assert all(np.isfinite(v) for v in res.values()), res


def test_zju_validate_matches_jax_on_the_same_weights(runs):
    """Validate on the weights the JAX CLI trained, with the bands of
    `test_torch_port_cli.py`: PSNR within 1e-5 relative (measured 1e-8),
    SSIM within 1e-6 absolute (measured 2.4e-8)."""
    ours, theirs = runs["torch"]["val_same"], runs["jax"]["val_same"]
    assert set(ours) == set(theirs)
    for key, want in theirs.items():
        if key == "ssim":
            assert abs(ours[key] - want) <= 1e-6, (key, ours, theirs)
        else:
            assert ours[key] == pytest.approx(want, rel=1e-5, abs=0.0), (key, ours, theirs)


@pytest.mark.parametrize("exp,n_frames", [
    ("motion_transfer/zju_pose", 2 * 2), ("motion_transfer/h36m_motion", 2),
    ("vis_lighting/relight", 10),
])
def test_vis_clis_match_jax_on_the_same_weights(runs, exp, n_frames):
    """novel_pose_vis (the ZJU pose sequence; the H36M motion on the
    performer) and vis_lighting: the same frame files (``.jpg`` read as
    ``.png``), and each frame within the colour band of the JAX frame
    (0.1275 of 255; measured at most 3.0e-3); the ground-truth halves of
    the side-by-side frames equal."""
    ours = {k: v for k, v in runs["torch"]["frames"].items() if k.startswith(exp)}
    theirs = {k[:-4] + ".png": v for k, v in runs["jax"]["frames"].items() if k.startswith(exp)}
    assert len(theirs) == n_frames and set(ours) == set(theirs)
    for name, want in theirs.items():
        got = ours[name]
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= COLOR_BAND, (name, np.abs(got - want).max())
        if "/img/" in name:
            w = want.shape[1] // 2
            assert np.array_equal(got[:, w:], want[:, w:]), name


def test_vis_clis_write_pngs_and_report_no_ffmpeg(runs):
    """Every port frame is a PNG of the frame's size; without ffmpeg on
    PATH no mp4 is written (img2vid returns False)."""
    from dual_space_nerf_tpu_torch.cli.novel_pose_vis import img2vid
    from dual_space_nerf_tpu_torch.utils.image_io import imread

    work = runs["torch"]["dir"]
    for rel, frame in runs["torch"]["frames"].items():
        if rel.startswith(("motion_transfer", "vis_lighting")):
            assert imread(str(work / rel)).shape == frame.shape, rel
    if shutil.which("ffmpeg") is None:
        frames = str(work / "vis_lighting" / "relight" / "2" / "rendering")
        assert not img2vid(frames, str(work / "x.mp4"))
        assert not os.path.exists(work / "x.mp4")


def test_zju_train_runs_without_cv2_yaml_or_jax(tmp_path):
    """`cli.train` for two epochs (--max_epochs 3) over two items of the committed 1024 x 1024
    tree, in a subprocess where importing cv2, yaml, JAX or the JAX package
    fails: JPEG and PNG decoding, undistortion, resizing and the SMPL pickle
    all without them."""
    os.makedirs(tmp_path / "data_configs" / "zju_mocap")
    (tmp_path / "data_configs" / "zju_mocap" / f"{HUMAN}.yml").write_text(
        DATA_CFG.replace("views: [0, 1]", "views: [0]"))
    (tmp_path / "zju.yml").write_text(ZJU_CFG)
    script = textwrap.dedent(f"""
        import sys
        for name in ("yaml", "cv2", "jax", "flax", "PIL", "dual_space_nerf_tpu"):
            sys.modules[name] = None
        import numpy as np
        from dual_space_nerf_tpu_torch.cli import train
        from dual_space_nerf_tpu_torch.data.smpl import write_body_model
        from dual_space_nerf_tpu_torch.data.synthetic import make_scene
        verts = np.load({os.path.join(COLD_TREE, "X_smpl_vertices.npy")!r}).squeeze()
        write_body_model("smpl.pkl", make_scene(h=8, w=8).faces, len(verts))
        state = train.main(["-c", "zju.yml", "--exp", "nodeps", "--max_epochs", "3",
                            "--device", "cpu"])
        assert state.step == 4, state.step
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "DSNERF_ZJU_PATH": os.path.dirname(COLD_TREE),
           "DSNERF_SMPL_PATH": "smpl.pkl"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert os.path.exists(tmp_path / "EXP" / "nodeps" / "model_epoch_0000001.ckpt")


def test_no_port_module_imports_cv2_yaml_pil_or_jax():
    """Every module of the port, and chip_smoke.py, imports in a subprocess
    where importing cv2, yaml, PIL, JAX or the JAX package fails."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("yaml", "cv2", "PIL", "jax", "flax", "dual_space_nerf_tpu"):
            sys.modules[name] = None
        import dual_space_nerf_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        assert len(names) > 40, names
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          env={**os.environ, "PYTHONPATH": REPO},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
