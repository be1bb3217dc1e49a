"""The training loop's slice on the CPU against the JAX package: the
yaml-free config reader and dump, SSIM without cv2, the PNG writer against
cv2, the prefetching loader, the checkpoints, and `do_train` itself against
the JAX `do_train` across a resume.

Small sizes throughout: 16x16 synthetic items, 2 frames x 2 views, 32 rays
x 8 samples a step, the default network widths.
"""

import glob
import logging
import multiprocessing
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from _pytest.monkeypatch import MonkeyPatch

from dual_space_nerf_tpu.cli.common import build_model as jax_build_model
from dual_space_nerf_tpu.cli.common import load_cfg as jax_load_cfg
from dual_space_nerf_tpu.cli.common import load_faces as jax_load_faces
from dual_space_nerf_tpu.data import select_dataset as jax_select_dataset
from dual_space_nerf_tpu.data.prefetch import PrefetchLoader as JaxPrefetchLoader
from dual_space_nerf_tpu.evaluation.metrics import ssim_metric as jax_ssim_metric
from dual_space_nerf_tpu.training import Checkpointer as JaxCheckpointer
from dual_space_nerf_tpu.training import PeriodicCheckpointer as JaxPeriodic
from dual_space_nerf_tpu.training import TrainState as JaxTrainState
from dual_space_nerf_tpu.training.loop import do_train as jax_do_train
from dual_space_nerf_tpu_torch.cli.common import build_model, load_cfg, load_faces
from dual_space_nerf_tpu_torch.config import ConfigSyntaxError, get_cfg_defaults, parse_config_text
from dual_space_nerf_tpu_torch.data import (
    PrefetchLoader,
    SyntheticDataset,
    item_to_mesh,
    item_to_train_batch,
    select_dataset,
)
from dual_space_nerf_tpu_torch.evaluation import ssim_metric
from dual_space_nerf_tpu_torch.models import state_dict_from_flax
from dual_space_nerf_tpu_torch.training import (
    Checkpointer,
    PeriodicCheckpointer,
    create_train_state,
    do_train,
    draw_randoms,
    make_train_step,
)
from dual_space_nerf_tpu_torch.renderer import RenderSettings
from dual_space_nerf_tpu_torch.training.loop import step_seed
from dual_space_nerf_tpu_torch.utils.image_io import PNG_SIGNATURE, write_png
from torch_port_common import PARAMS_NPZ, REPO, TINY_CLI_CFG

CPU = torch.device("cpu")
JAX_CKPT_FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_trained_s233.ckpt")
CONFIG_FILES = sorted(os.path.relpath(p, REPO)
                      for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yml"), recursive=True))


@pytest.fixture(scope="module")
def tiny_cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yml"
    path.write_text(TINY_CLI_CFG)
    return str(path)


# ---------------------------------------------------------------------------
# 1. the config reader
# ---------------------------------------------------------------------------
def _as_lists(tree):
    if isinstance(tree, dict):
        return {k: _as_lists(v) for k, v in tree.items()}
    return list(tree) if isinstance(tree, tuple) else tree


@pytest.mark.parametrize("name", CONFIG_FILES + ["<tiny CLI config>"])
def test_config_reader_equals_yaml(name, tiny_cfg_path):
    """Every config file: the reader equals `yaml.safe_load`, the port's
    `load_cfg` equals the JAX package's, and the dump is yaml's text and
    parses back to the same tree."""
    path = tiny_cfg_path if name.startswith("<") else os.path.join(REPO, name)
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert parse_config_text(text, path) == yaml.safe_load(text)
    cfg, jcfg = load_cfg(path), jax_load_cfg(path)
    assert cfg.to_dict() == jcfg.to_dict()
    dumped = cfg.dump()
    assert dumped == jcfg.dump()  # yaml.safe_dump(..., sort_keys=False)
    assert parse_config_text(dumped) == _as_lists(cfg.to_dict())
    again = get_cfg_defaults()
    again.merge_from_file(path)
    assert again.to_dict() == cfg.to_dict()


@pytest.mark.parametrize("text,line", [
    ("A: 1\nB: yes\n", 2),                       # a YAML 1.1 bool
    ("A: null\n", 1),                            # a null
    ("A: 5e-4\n", 1),                            # a string to PyYAML, no float
    ("A: 010\n", 1),                             # octal to PyYAML
    ("A:\n  B: {C: 1}\n", 2),                    # a flow mapping
    ("A: [1, [2]]\n", 1),                        # a nested list
    ("A: &x 1\n", 1),                            # an anchor
    ("A: \"x\\ty\"\n", 1),                       # an escape
    ("A: 1\nA: 2\n", 2),                         # a duplicate key
    ("A:\n  B: 1\n\tC: 2\n", 3),                 # a tab
    ("A: 1\n  B: 2\n", 2),                       # bad indentation
    ("A:\n  - B: 1\n", 2),                       # a mapping in a list
    ("A: 'x' y\n", 1),                           # text after a quoted string
    ("---\nA: 1\n", 1),                          # a document marker
])
def test_config_reader_refuses_what_it_does_not_read(text, line):
    with pytest.raises(ConfigSyntaxError, match=f"^cfg.yml:{line}: "):
        parse_config_text(text, "cfg.yml")


def test_config_reader_refuses_a_key_without_value():
    with pytest.raises(ConfigSyntaxError, match="cfg.yml: key 'B' has no value"):
        parse_config_text("A: 1\nB:\n", "cfg.yml")


def test_config_dump_round_trips_what_yaml_would_misread():
    tree = {"A": {"S": ["on", "5e-4", "a'b", "x #y", "", "VOLUME RENDERING"],
                  "F": [1e-5, 1e16, -0.5, 2.0], "B": True, "E": []}}
    from dual_space_nerf_tpu_torch.config import dump_config_text

    text = dump_config_text(tree)
    assert parse_config_text(text) == tree
    assert yaml.safe_load(text) == tree


# ---------------------------------------------------------------------------
# 2. SSIM without cv2
# ---------------------------------------------------------------------------
def _mask(kind: str, h: int = 16, w: int = 16) -> np.ndarray:
    m = np.zeros((h, w), bool)
    box = {
        "full": np.s_[:, :],
        "empty": np.s_[0:0, 0:0],
        "narrow_left": np.s_[4:11, 0:3],
        "narrow_right": np.s_[5:12, 13:16],
        "narrow_top": np.s_[0:2, 3:12],
        "narrow_bottom": np.s_[14:16, 2:9],
        "corner": np.s_[0:3, 12:16],
        "border": np.s_[0:16, 0:9],
        "interior": np.s_[3:12, 4:13],
    }[kind]
    m[box] = True
    return m


@pytest.mark.parametrize("kind", ["full", "empty", "narrow_left", "narrow_right", "narrow_top",
                                  "narrow_bottom", "corner", "border", "interior"])
def test_ssim_metric_matches_jax(kind):
    """Against the JAX package's cv2-based `ssim_metric`, within 1e-12."""
    rng = np.random.default_rng(11)
    gt = rng.random((16, 16, 3))
    pred = np.clip(gt + 0.15 * rng.standard_normal(gt.shape), 0.0, 1.0).astype(np.float32)
    mask = _mask(kind)
    want = jax_ssim_metric(pred, gt, mask)
    got = ssim_metric(pred, gt, mask)
    assert abs(got - want) <= 1e-12, (got, want)
    if kind == "empty":
        assert got == 1.0


@pytest.mark.parametrize("shape", [(16, 16), (9, 23), (7, 7)])
def test_box_filter_equals_cv2_blur_reflect(shape):
    """The window itself against `cv2.blur(..., BORDER_REFLECT)`, border
    pixels included (SSIM crops them, so only this test sees the border)."""
    import cv2

    from dual_space_nerf_tpu_torch.evaluation.metrics import _uniform_filter

    img = np.random.default_rng(shape[1]).random(shape)
    want = cv2.blur(img, (7, 7), borderType=cv2.BORDER_REFLECT)
    np.testing.assert_allclose(_uniform_filter(img, 7), want, rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# 3. the PNG writer against cv2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_png_equals_cv2(tmp_path, dtype, channels):
    """cv2.imread of our PNG equals cv2.imread of cv2.imwrite's PNG of the
    same float array: values above 255, below 0, at .5 (ties to even), NaN
    and far out of range."""
    import cv2

    rng = np.random.default_rng(channels)
    img = (200.0 * rng.standard_normal((13, 21, channels)) + 128.0).astype(dtype)
    img.reshape(-1)[:10] = [0.5, 1.5, 2.5, 254.5, 255.5, -0.5, 300.0, -3.0, np.nan, 1e10]
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "cv2.png")
    write_png(ours, img)
    cv2.imwrite(theirs, img)
    with open(ours, "rb") as f:
        assert f.read(8) == PNG_SIGNATURE
    for flag in (cv2.IMREAD_COLOR, cv2.IMREAD_UNCHANGED):
        a, b = cv2.imread(ours, flag), cv2.imread(theirs, flag)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# 4. the prefetching loader
# ---------------------------------------------------------------------------
class _Indices:
    """dataset[i] = i; records set_epoch; item 0 is slow."""

    def __init__(self, n=7, fail_at=None):
        self.n, self.fail_at, self.epochs = n, fail_at, []

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError("corrupt item")
        if i == 0:
            time.sleep(0.05)
        return i


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_ordered_loader_yields_the_jax_order(backend):
    """Same seed, three epochs: the JAX loader's index order, and the epoch
    forwarded to the dataset."""
    ours, theirs = _Indices(), _Indices()
    a = PrefetchLoader(ours, num_workers=3, seed=233, ordered=True, backend=backend)
    b = JaxPrefetchLoader(theirs, num_workers=3, seed=233, ordered=True)
    for _ in range(3):
        assert list(a) == list(b)
    assert ours.epochs == [1, 2, 3]


class _SlowHead:
    """Item 0 sleeps half a second; every start is counted in a counter that
    forked workers share."""

    def __init__(self, n):
        self.n = n
        self.started = multiprocessing.get_context("fork").Value("i", 0)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.started.get_lock():
            self.started.value += 1
        if i == 0:
            time.sleep(0.5)
        return i


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_ordered_loader_bounds_its_items_in_flight(backend):
    """While the head item loads, the other workers start at most up to
    item prefetch + num_workers - 1: the items started and not yet yielded
    peak at prefetch + num_workers (5), not at the epoch's 40; the items
    and their order are unchanged."""
    ds = _SlowHead(40)
    loader = PrefetchLoader(ds, shuffle=False, num_workers=2, prefetch=3, ordered=True, backend=backend)
    got, peak = [], 0
    for k, i in enumerate(loader):
        peak = max(peak, ds.started.value - k)  # started, less the k yielded before
        got.append(i)
    assert got == list(range(40))
    assert loader.window == 5 and 2 <= peak <= loader.window, peak


@pytest.mark.parametrize("where", ["dataset", "transform"])
@pytest.mark.parametrize("backend", ["thread", "process"])
def test_a_failing_worker_fails_the_epoch(backend, where):
    def transform(i):
        if i == 4:
            raise ValueError("bad transform")
        return i

    ds = _Indices(fail_at=4 if where == "dataset" else None)
    loader = PrefetchLoader(ds, num_workers=2, seed=0, backend=backend,
                            transform=transform if where == "transform" else None)
    with pytest.raises((RuntimeError, ValueError), match=r"dataset\[4\]|bad transform"):
        list(loader)


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_abandoning_an_epoch_stops_the_workers(backend):
    reads = []

    class Slow:
        def __len__(self):
            return 200

        def __getitem__(self, i):
            reads.append(i)
            time.sleep(0.005)
            return i

    before = threading.active_count()
    loader = PrefetchLoader(Slow(), shuffle=False, num_workers=4, prefetch=2, backend=backend)
    it = iter(loader)
    for _ in range(3):
        next(it)
    it.close()
    if backend == "thread":
        n = len(reads)
        time.sleep(0.3)
        assert len(reads) <= n + 4, (len(reads), n)  # at most the in-flight items
        assert threading.active_count() <= before + 1
    else:
        assert multiprocessing.active_children() == []


# ---------------------------------------------------------------------------
# 5-6. checkpoints
# ---------------------------------------------------------------------------
def _small_state(cfg, seed=0):
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.arange(6.0).reshape(2, 3) + seed)
    return create_train_state(model, cfg)


@pytest.mark.parametrize("period", [1, 2, 3, 5])
def test_periodic_checkpointer_names_match_jax(tmp_path, period):
    """The same file names and tag over max_epoch 2..9."""
    cfg = get_cfg_defaults()
    for max_epoch in range(2, 10):
        ours = Checkpointer(str(tmp_path / f"t{max_epoch}"))
        theirs = JaxCheckpointer(str(tmp_path / f"j{max_epoch}"))
        p = PeriodicCheckpointer(ours, period, max_epoch)
        q = JaxPeriodic(theirs, period, max_epoch)
        state = _small_state(cfg)
        jstate = JaxTrainState({"w": np.zeros(2, np.float32)}, (), np.int32(0))
        for epoch in range(1, max_epoch):
            p.step_by_epoch(epoch, state)
            q.step_by_epoch(epoch, jstate)
        assert sorted(os.listdir(ours.save_dir)) == sorted(os.listdir(theirs.save_dir))
        if ours.has_checkpoint():
            assert os.path.basename(ours.get_checkpoint_file()) == os.path.basename(
                theirs.get_checkpoint_file())


def _step_setup():
    """A small model, the train config's optimizer with a short warmup, and
    one fixed batch of the tiny scene."""
    from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg

    cfg = train_cfg(True, False)
    cfg.MODEL.COARSE_RAY_SAMPLING = 8
    cfg.MODEL.SHADE_TOPK = 4
    cfg.SOLVER.WARMUP_ITERS = 3
    cfg.SOLVER.START_ITERS, cfg.SOLVER.END_ITERS = 4, 10
    ds = SyntheticDataset(split="train", nrays=32, n_frames=1, n_views=1, h=16, w=16)
    item = ds[0]
    batch = item_to_train_batch(item, 32, CPU)
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, CPU)
    settings = RenderSettings.from_cfg(cfg)
    gen = torch.Generator().manual_seed(3)
    randoms = [draw_randoms(32, 8, gen, CPU) for _ in range(4)]
    return cfg, batch, mesh, settings, randoms


def test_save_load_restores_the_next_update(tmp_path):
    """Save after two steps, load into a fresh state: parameters, Adam's
    moments and step counts, the schedule's lr, step and epoch; then one
    more step on both equals bit for bit."""
    cfg, batch, mesh, settings, randoms = _step_setup()
    step = make_train_step(settings, device="cpu")
    a = create_train_state(build_model(cfg, seed=1), cfg)
    for r in randoms[:2]:
        step(a, batch, mesh, r)
    ck = Checkpointer(str(tmp_path))
    path = ck.save("model_epoch_0000007", a, 7)
    b, epoch = ck.resume_or_load("", create_train_state(build_model(cfg, seed=2), cfg))
    assert ck.get_checkpoint_file() == path and epoch == 7 and b.step == a.step == 2
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (n, k)
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    step(a, batch, mesh, randoms[2])
    step(b, batch, mesh, randoms[2])
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("kind", ["ckpt", "pth", "pth_model_key", "npz", "jax_ckpt"])
def test_load_params_only_reads_each_format(tmp_path, kind):
    """The port's .ckpt, a reference .pth (bare state dict or under "model",
    as the reference's trainer saves it), a flax-params .npz, and the JAX
    package's .ckpt (`tests/fixtures/jax_trained_s233.ckpt`: the npz's
    params, written by the JAX `Checkpointer.save`)."""
    from dual_space_nerf_tpu_torch.models import load_flax_npz

    cfg = load_cfg("")
    cfg.defrost()
    cfg.MODEL.MAX_FRAMES = 16
    want = build_model(cfg, seed=5)
    if kind in ("npz", "jax_ckpt"):
        path = PARAMS_NPZ if kind == "npz" else JAX_CKPT_FIXTURE
        want.load_state_dict(load_flax_npz(PARAMS_NPZ))
    elif kind == "ckpt":
        path = Checkpointer(str(tmp_path)).save("m", create_train_state(want, cfg), 1)
    else:
        path = str(tmp_path / "ref.pth")
        sd = want.state_dict()
        torch.save({"model": sd, "iteration": 3} if kind == "pth_model_key" else sd, path)
    got = Checkpointer(str(tmp_path)).load_params_only(path, build_model(cfg, seed=6))
    for (n, p), q in zip(want.state_dict().items(), got.state_dict().values()):
        assert torch.equal(p, q), n


def test_step_seed_is_a_pure_function_of_seed_and_step():
    assert step_seed(233, 5) == step_seed(233, 5)
    assert len({step_seed(233, s) for s in range(100)} | {step_seed(234, 0)}) == 101


# ---------------------------------------------------------------------------
# 7. do_train against the JAX do_train
# ---------------------------------------------------------------------------
PARITY_CFG = """\
MODEL:
  COARSE_RAY_SAMPLING: 8
  FINE_RAY_SAMPLING: -1
  sample_points_mode: "uniform"
  perturb: 0.0
  raw_noise_std: 0.0
  SHADE_TOPK: {topk}
  REUSE_WARP_FACES: {reuse}
  KNN_IMPL: "{knn}"
  FUSED_MLP: "off"
  MAX_FRAMES: 16
  LOSS: "L2"
DATASETS:
  TYPE: "synthetic"
  HUMAN: "capsule"
  SYNTHETIC_SIZE: 16
  SYNTHETIC_FRAMES: 2
  SYNTHETIC_VIEWS: 2
DATALOADER:
  NUM_WORKERS: 2
SOLVER:
  OPTIMIZER_NAME: "Adam"
  BASE_LR: 0.0005
  WEIGHT_DECAY: 0.0
  START_ITERS: 3000
  END_ITERS: 60000
  LR_SCALE: 0.09
  WARMUP_ITERS: 4
  CHECKPOINT_PERIOD: 1
  LOG_PERIOD: 1
  TRAIN_NRAYS: 32
"""
#: production: 313_tpu.yml's path (K=4 of 8, face reuse, the listed
#: search); exact: 313.yml's (full shading, two brute-force searches)
PATHS = {"production": dict(topk=4, reuse="True", knn="listed"),
         "exact": dict(topk=0, reuse="False", knn="auto")}
#: per path: the max_epochs of each do_train call (a resume after the first)
CALLS = {"production": (2, 3), "exact": (2,)}


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_text(self, *a, **k):
        pass

    def close(self):
        pass


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _flat(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


#: the fixture's cases: each path with both sides from the JAX key(233)
#: init; and the production path's JAX run against the port resuming the
#: JAX side's first-call directory (its flax `.ckpt`) for the second call
CASES = list(PATHS) + ["production_from_jax_ckpt"]
_JAX_SIDES: dict = {}


def _recording_logger(name: str):
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = _Records()
    logger.handlers = [handler]
    return logger, handler


def _jax_side(path_kind: str, tmp_path_factory) -> dict:
    """The JAX package's do_train calls of ``path_kind`` (once per module):
    {"init", "writer", "records", "dir", "final", "step", "first"}, with
    "first" the copy of its directory after the first call and the counts
    of records and scalars written by then."""
    if path_kind in _JAX_SIDES:
        return _JAX_SIDES[path_kind]
    work = tmp_path_factory.mktemp(f"jax_do_train_{path_kind}")
    (work / "cfg.yml").write_text(PARITY_CFG.format(**PATHS[path_kind]))
    jcfg = jax_load_cfg(str(work / "cfg.yml"))
    jmodel = jax_build_model(jcfg)
    init = jmodel.init(jax.random.key(233), jnp.zeros((4, 3)), jnp.zeros((4,), jnp.int32),
                       jnp.zeros((4, 16)))
    logger, handler = _recording_logger(f"do_train_parity.{path_kind}.jax")
    writer = _Writer()
    out_dir = str(work / "jax")
    first = None
    for n, max_epochs in enumerate(CALLS[path_kind]):
        train_set, _ = jax_select_dataset(jcfg, train_nrays=32)
        state = jax_do_train(jcfg, jmodel, train_set, jax_load_faces(jcfg, train_set),
                             writer, logger, out_dir, max_epochs=max_epochs)
        if n == 0:
            shutil.copytree(out_dir, work / "jax_first_call")
            first = {"dir": str(work / "jax_first_call"), "records": len(handler.records),
                     "scalars": len(writer.scalars)}
    _JAX_SIDES[path_kind] = {"init": init, "writer": writer, "records": handler.records,
                             "dir": out_dir, "final": state_dict_from_flax(_flat(state.params)),
                             "step": int(state.step), "first": first}
    return _JAX_SIDES[path_kind]


@pytest.fixture(scope="module", params=CASES)
def trained(request, tmp_path_factory):
    """Both packages' do_train on one path, deterministic data: (jax,
    torch) each {"writer", "records", "dir", "final", "step"} (final:
    reference-named state dict). The port starts from the JAX key(233)
    init; in "production_from_jax_ckpt" it runs only the second call, in a
    copy of the JAX side's first-call directory, and both sides' records
    and scalars are the second call's."""
    case = request.param
    from_jax = case == "production_from_jax_ckpt"
    path_kind = "production" if from_jax else case
    work = tmp_path_factory.mktemp(f"do_train_{case}")
    cfg_path = work / "cfg.yml"
    cfg_path.write_text(PARITY_CFG.format(**PATHS[path_kind]))
    mp = MonkeyPatch()
    mp.setenv("DSNERF_DETERMINISTIC_DATA", "1")
    for var in ("DSNERF_SEED", "DSNERF_LOADER_BACKEND", "DSNERF_VAL_PERIOD"):
        mp.delenv(var, raising=False)
    try:
        jax_side = _jax_side(path_kind, tmp_path_factory)
        cfg = load_cfg(str(cfg_path))
        logger, handler = _recording_logger(f"do_train_parity.{case}.torch")
        writer = _Writer()
        out_dir = str(work / "torch")
        calls = list(enumerate(CALLS[path_kind]))
        if from_jax:
            shutil.copytree(jax_side["first"]["dir"], out_dir)
            calls = calls[1:]
        for n, max_epochs in calls:
            train_set, _ = select_dataset(cfg, train_nrays=32)
            # a resumed call starts from another init: the checkpoint must replace it
            model = build_model(cfg, seed=n + 1)
            if n == 0:
                model.load_state_dict(state_dict_from_flax(_flat(jax_side["init"])))
            state = do_train(cfg, model, train_set, load_faces(cfg, train_set), writer,
                             logger, out_dir, max_epochs=max_epochs, device="cpu")
    finally:
        mp.undo()
    jax_out = dict(jax_side)
    if from_jax:  # the second call's records and scalars
        jax_out["records"] = jax_side["records"][jax_side["first"]["records"]:]
        jax_out["writer"] = _Writer()
        jax_out["writer"].scalars = jax_side["writer"].scalars[jax_side["first"]["scalars"]:]
    return {"jax": jax_out,
            "torch": {"writer": writer, "records": handler.records, "dir": out_dir,
                      "final": state.model.state_dict(), "step": int(state.step)}}


def test_do_train_logs_match_jax(trained):
    """The same log records in the same order (the format strings), and
    the step lines' epoch, iteration and count equal, their loss and PSNR
    within 1e-5 relative and their learning rate within 1e-6 (the JAX
    schedule runs in float32). Measured: 1.1e-7 relative at worst."""
    j, t = trained["jax"]["records"], trained["torch"]["records"]
    assert [r.msg for r in t] == [r.msg for r in j]
    steps = [(a.args, b.args) for a, b in zip(j, t) if a.msg.startswith("Epoch[")]
    assert steps
    for a, b in steps:
        assert b[:3] == a[:3]
        np.testing.assert_allclose(b[3:5], a[3:5], rtol=1e-5)
        np.testing.assert_allclose(b[5], a[5], rtol=1e-6)
    assert trained["torch"]["step"] == trained["jax"]["step"]


def test_do_train_scalars_match_jax(trained):
    """The TensorBoard scalars: the same tags at the same steps, the values
    within 1e-5 relative."""
    j, t = trained["jax"]["writer"].scalars, trained["torch"]["writer"].scalars
    assert [(tag, s) for tag, _, s in t] == [(tag, s) for tag, _, s in j]
    np.testing.assert_allclose([v for _, v, _ in t], [v for _, v, _ in j], rtol=1e-5)


def test_do_train_checkpoints_match_jax(trained):
    j, t = trained["jax"]["dir"], trained["torch"]["dir"]
    names = sorted(os.listdir(t))
    assert names == sorted(os.listdir(j))
    assert any(n.startswith("model_epoch_") for n in names)
    with open(os.path.join(j, "last_checkpoint")) as fj, open(os.path.join(t, "last_checkpoint")) as ft:
        assert ft.read().strip() == fj.read().strip()


def test_do_train_final_params_match_jax(trained):
    """Each final parameter tensor within 1e-4 of its largest entry.
    Warmup is 4 so that the updates move at 1.25e-4 to 5e-4: a lost Adam
    state or a skipped update would part by ~lr / max ~ 1e-2. Measured:
    2.2e-5 on the production path across the resume, 1.0e-5 on the exact
    path (`nerf.stage2.2.weight` both; Adam moves an entry whose gradient
    is ~0 by up to lr either way, so near-zero gradients part first), 5.9e-7
    where the port resumes the JAX side's checkpoint (one call of 4 steps
    apart, from the same params and Adam moments)."""
    j, t = trained["jax"]["final"], trained["torch"]["final"]
    assert set(t) == set(j)
    for name, want in j.items():
        err = float((t[name] - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= 1e-4, (name, err)
