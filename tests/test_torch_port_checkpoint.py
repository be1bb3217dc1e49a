"""The JAX package's checkpoint in the port, on the CPU: a ``.ckpt`` that the
JAX `Checkpointer.save` writes (flax msgpack of {params, opt_state, step,
epoch}) read without flax or msgpack (`training/flax_ckpt.py`), evaluated
and resumed by the port (`training/checkpoint.py`), and resumed by
`cli.train -r N`; the committed fixture of `chip_smoke.py::jax_ckpt_phase`
held to the script that writes it.

The JAX side trains nothing: `make_optimizer`'s optax Adam takes two updates
on gradients drawn with numpy (1e-2 per entry) from the JAX key(233) init at
the tiny CLI config's widths, with WEIGHT_DECAY 0 (optax.adam) and 5e-4
(chain(add_decayed_weights, adam)). Bands: the params, Adam's moments, its
step, the schedule's position and the epoch bit for bit; the next update
within 1e-6 of each tensor's largest entry of optax's (torch's Adam and
optax's round the bias correction and the division in other orders).
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from dual_space_nerf_tpu.cli.common import build_model as jax_build_model
from dual_space_nerf_tpu.cli.common import load_cfg as jax_load_cfg
from dual_space_nerf_tpu.training import Checkpointer as JaxCheckpointer
from dual_space_nerf_tpu.training import TrainState as JaxTrainState
from dual_space_nerf_tpu.training.optim import make_optimizer as jax_make_optimizer
from dual_space_nerf_tpu_torch.cli.common import build_model, load_cfg
from dual_space_nerf_tpu_torch.models import load_flax_npz, state_dict_from_flax
from dual_space_nerf_tpu_torch.training import Checkpointer, create_train_state, reference_schedule
from dual_space_nerf_tpu_torch.training.checkpoint import checkpoint_format
from dual_space_nerf_tpu_torch.training.flax_ckpt import (
    FlaxCheckpointError,
    flatten,
    read_flax_checkpoint,
    read_msgpack,
)
from torch_port_common import MAX_FRAMES, PARAMS_NPZ, REPO, TINY_CLI_CFG

FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_trained_s233.ckpt")
SCRIPT = os.path.join(REPO, "scripts", "make_jax_ckpt_fixture.py")
WEIGHT_DECAYS = {"adam": 0.0, "decayed": 5e-4}
_RUNS: dict = {}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads while a test of this file runs (restored after):
    the suite runs six workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_run(kind: str, root) -> dict:
    """The JAX side of ``kind`` (once per module): the tiny config with its
    weight decay, the JAX `Checkpointer.save` of the state after two
    updates as EXP/jax/model_epoch_0000003.ckpt (step 2, epoch 3), the
    third gradients and optax's params after them."""
    if kind in _RUNS:
        return _RUNS[kind]
    work = root / kind
    work.mkdir()
    cfg_path = work / "tiny.yml"
    cfg_path.write_text(TINY_CLI_CFG.replace("WEIGHT_DECAY: 0.0", f"WEIGHT_DECAY: {WEIGHT_DECAYS[kind]}"))
    jcfg = jax_load_cfg(str(cfg_path))
    params = jax_build_model(jcfg).init(jax.random.key(233), jnp.zeros((4, 3)), jnp.zeros((4,), jnp.int32),
                                        jnp.zeros((4, 16)))
    tx, lr = jax_make_optimizer(jcfg)
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    rng = np.random.default_rng(11)
    grads = [jax.tree_util.tree_map(lambda p: jnp.asarray((1e-2 * rng.standard_normal(p.shape)).astype(np.float32)),
                                    params) for _ in range(3)]
    for g in grads[:2]:
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
    ckpt = JaxCheckpointer(str(work / "EXP" / "jax")).save(
        "model_epoch_0000003", JaxTrainState(params, opt_state, jnp.asarray(2, jnp.int32)), 3)
    upd, _ = update(grads[2], opt_state, params)
    _RUNS[kind] = {"work": work, "cfg": str(cfg_path), "ckpt": ckpt, "params": _flat(params),
                   "opt_state": opt_state, "grads": _flat(grads[2]),
                   "next": _flat(optax.apply_updates(params, upd)), "lr2": float(lr(2))}
    return _RUNS[kind]


@pytest.fixture(scope="module")
def runs_root(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_ckpt")


@pytest.fixture(scope="module", params=list(WEIGHT_DECAYS))
def jax_run(request, runs_root):
    return _jax_run(request.param, runs_root)


@pytest.fixture(scope="module")
def adam_run(runs_root):
    return _jax_run("adam", runs_root)


def _loaded(run):
    cfg = load_cfg(run["cfg"])
    state = create_train_state(build_model(cfg, seed=1), cfg)
    state, epoch = Checkpointer(os.path.dirname(run["ckpt"])).load(run["ckpt"], state)
    return cfg, state, epoch


def _adam_node(opt_state):
    return opt_state[0] if isinstance(opt_state[0], optax.ScaleByAdamState) else opt_state[1][0]


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------
def test_reader_equals_flax_msgpack_restore(jax_run):
    """Every map, key order, leaf, dtype and shape of flax's own decode."""
    with open(jax_run["ckpt"], "rb") as f:
        data = f.read()

    def same(a, b, at):
        if isinstance(b, dict):
            assert isinstance(a, dict) and list(a) == list(b), at
            for key in b:
                same(a[key], b[key], f"{at}/{key}")
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b), at
        else:
            assert type(a) is type(b) and a == b, at

    same(read_msgpack(data, jax_run["ckpt"]), serialization.msgpack_restore(data), "")
    assert checkpoint_format(jax_run["ckpt"]) == "flax"


def test_reader_decodes_every_msgpack_form():
    """Scalars of every width, strings and bins past 255 bytes, numpy
    scalars (ext 3), empty maps and arrays, 16-bit maps, and an array that
    flax splits into chunks, each as flax decodes them."""
    obj = {"ints": [0, 127, 128, 2**16, 2**33, -1, -33, -200, -2**20, -2**40], "f": [1.5, -0.0, 1e300],
           "nil": None, "bools": [True, False], "s": "é" * 200, "b": b"\x00\xff" * 40000,
           "np": np.float32(2.5), "i0": np.array(7, np.int32), "empty": {}, "list": [],
           "wide": {str(i): np.int8(i) for i in range(20)}, "u": np.arange(5, dtype=np.uint16),
           "half": np.ones((2, 3), np.float16), "flag": np.array([True, False])}
    data = serialization.msgpack_serialize(obj)
    ours, theirs = read_msgpack(data), serialization.msgpack_restore(data)
    assert list(ours) == list(theirs)
    for key in theirs:
        a, b = ours[key], theirs[key]
        if isinstance(b, dict):
            assert list(a) == list(b) and all(type(a[k]) is type(b[k]) and a[k] == b[k] for k in b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), key
        else:
            assert type(a) is type(b) and a == b, key
    old = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 1000  # split a 12,000-byte array into 12 chunks
    try:
        big = np.arange(3000, dtype=np.float32).reshape(30, 100)
        got = read_msgpack(serialization.msgpack_serialize({"w": big}))["w"]
    finally:
        serialization.MAX_CHUNK_SIZE = old
    assert got.dtype == big.dtype and np.array_equal(got, big)


def test_reader_needs_neither_flax_nor_msgpack():
    """The committed fixture read and loaded in a fresh interpreter in which
    flax, msgpack and jax cannot be imported: the same params and Adam
    moments as here."""
    code = f"""
import sys
for name in ("flax", "msgpack", "jax", "ml_dtypes"):
    sys.modules[name] = None
import torch
torch.set_num_threads(2)
sys.path.insert(0, {REPO!r})
import json
from dual_space_nerf_tpu_torch.cli.common import build_model
from dual_space_nerf_tpu_torch.config import get_cfg_defaults
from dual_space_nerf_tpu_torch.training import Checkpointer, create_train_state
cfg = get_cfg_defaults()
cfg.MODEL.MAX_FRAMES = {MAX_FRAMES}
state = create_train_state(build_model(cfg, seed=3), cfg)
state, epoch = Checkpointer("{os.path.dirname(FIXTURE)}").load({FIXTURE!r}, state)
sums = {{n: [float(p.double().sum()), float(state.optimizer.state[p]["exp_avg"].double().sum()),
            float(state.optimizer.state[p]["exp_avg_sq"].double().sum())]
        for n, p in state.model.named_parameters()}}
print(json.dumps({{"epoch": epoch, "step": state.step, "sums": sums}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ck = read_flax_checkpoint(FIXTURE)
    adam = ck.opt_state["0"]
    sds = [state_dict_from_flax(t) for t in (ck.params, flatten(adam["mu"]), flatten(adam["nu"]))]
    want = {n: [float(sd[n].double().sum()) for sd in sds] for n in sds[0]}
    assert got["epoch"] == ck.epoch == 1 and got["step"] == ck.step == 2
    assert got["sums"] == want


def test_fixture_is_what_the_script_writes(tmp_path):
    """`scripts/make_jax_ckpt_fixture.py` run again writes every array of the
    committed fixture bit for bit, and its params are the trained npz's."""
    spec = importlib.util.spec_from_file_location("make_jax_ckpt_fixture", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    fresh = script.make(str(tmp_path / "fresh.ckpt"))
    with open(FIXTURE, "rb") as f, open(fresh, "rb") as g:
        committed, again = (flatten(read_msgpack(h.read())) for h in (f, g))
    assert list(committed) == list(again)
    for key, want in again.items():
        got = committed[key]
        assert type(got) is type(want), key
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), key
        else:
            assert got == want, key
    with np.load(PARAMS_NPZ) as data:
        assert all(np.array_equal(committed[f"params/{k}"], data[k]) for k in data.files)


# ---------------------------------------------------------------------------
# params, Adam's state and the schedule, against optax
# ---------------------------------------------------------------------------
def test_jax_ckpt_loads_params_and_adam_state_bit_for_bit(jax_run, tmp_path):
    """The params equal the `.npz` route's and the flax params' bit for bit;
    each parameter's exp_avg / exp_avg_sq equal optax's mu / nu (same names
    and transposes), Adam's step its count (2), the step and epoch the
    payload's; the learning rate of the next update is BASE_LR *
    schedule(2), as in a port run after two updates, and within 1e-6 of
    the JAX schedule's (float32 there)."""
    cfg, state, epoch = _loaded(jax_run)
    assert epoch == 3 and state.step == 2
    npz = tmp_path / "params.npz"
    np.savez(npz, **jax_run["params"])
    want = load_flax_npz(str(npz))
    adam = _adam_node(jax_run["opt_state"])
    mu, nu = (state_dict_from_flax(_flat(t)) for t in (adam.mu, adam.nu))
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
        st = state.optimizer.state[p]
        assert set(st) == {"step", "exp_avg", "exp_avg_sq"}, name
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == int(adam.count) == 2
    ref = create_train_state(build_model(cfg, seed=2), cfg)
    for _ in range(2):  # two updates of a port run (no gradients: no parameter moves)
        ref.optimizer.step()
        ref.scheduler.step()
    lr = state.optimizer.param_groups[0]["lr"]
    sched = reference_schedule(cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.START_ITERS, cfg.SOLVER.END_ITERS,
                               cfg.SOLVER.LR_SCALE)
    assert lr == cfg.SOLVER.BASE_LR * sched(2) == ref.optimizer.param_groups[0]["lr"]
    assert state.scheduler.get_last_lr() == ref.scheduler.get_last_lr()
    assert state.scheduler.state_dict()["last_epoch"] == ref.scheduler.state_dict()["last_epoch"] == 2
    assert lr == pytest.approx(jax_run["lr2"], rel=1e-6)
    assert state.optimizer.param_groups[0]["weight_decay"] == cfg.SOLVER.WEIGHT_DECAY


def test_jax_ckpt_next_update_matches_optax(jax_run):
    """One more update with the same numpy gradients on both sides: every
    parameter within 1e-6 of its tensor's largest entry of optax's."""
    _, state, _ = _loaded(jax_run)
    grads = state_dict_from_flax(jax_run["grads"])
    for name, p in state.model.named_parameters():
        p.grad = grads[name].clone()
    state.optimizer.step()
    want = state_dict_from_flax(jax_run["next"])
    for name, p in state.model.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-6 * float(want[name].abs().max()), (name, err)


def test_load_params_only_reads_the_jax_ckpt(adam_run):
    """`load_params_only` (the eval CLIs' path) takes the params alone."""
    cfg = load_cfg(adam_run["cfg"])
    got = Checkpointer(".").load_params_only(adam_run["ckpt"], build_model(cfg, seed=4))
    want = state_dict_from_flax(adam_run["params"])
    for name, p in got.state_dict().items():
        assert torch.equal(p, want[name]), name


# ---------------------------------------------------------------------------
# what the reader and the loader refuse
# ---------------------------------------------------------------------------
def _rewrite(src, dst, edit):
    with open(src, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    edit(tree)
    with open(dst, "wb") as f:
        f.write(serialization.msgpack_serialize(tree))


def _drop_mu_leaf(tree):
    del tree["opt_state"]["0"]["mu"]["params"]["nerf"]["Dense_3"]["Dense_0"]["bias"]


def _nu_wrong_shape(tree):
    leaf = tree["opt_state"]["0"]["nu"]["params"]["nerf"]["Dense_0"]["Dense_0"]
    leaf["kernel"] = leaf["kernel"][:, :-1].copy()


def _two_adams(tree):
    tree["opt_state"]["2"] = tree["opt_state"]["0"]


@pytest.mark.parametrize("case,match", [
    ("truncated", r"at byte \d+: \d+ bytes needed"),
    ("trailing", r"at byte \d+: 3 bytes after the msgpack object"),
    ("ext_type", r"ext type 7"),
    ("no_adam", r"0 Adam states"),
    ("two_adams", r"2 Adam states"),
    ("missing_leaf", r"Adam's mu does not match the params"),
    ("wrong_shape", r"Adam's nu for nerf.stage1.0.weight has shape"),
    ("not_a_checkpoint", r"neither a torch checkpoint nor a flax msgpack one"),
])
def test_jax_ckpt_refusals(adam_run, tmp_path, monkeypatch, case, match):
    """Each raises with the file's name, the state left as it was, and
    without a second try through torch.load."""
    src = adam_run["ckpt"]
    bad = str(tmp_path / "bad.ckpt")
    with open(src, "rb") as f:
        data = f.read()
    if case == "truncated":
        open(bad, "wb").write(data[:len(data) // 2])
    elif case == "trailing":
        open(bad, "wb").write(data + b"\x00\x00\x00")
    elif case == "ext_type":
        open(bad, "wb").write(msgpack.packb({"params": msgpack.ExtType(7, b"xy")}))
    elif case == "no_adam":
        _rewrite(src, bad, lambda t: t.update(opt_state={"0": {}, "1": {"count": np.int32(2)}}))
    elif case == "two_adams":
        _rewrite(src, bad, _two_adams)
    elif case == "missing_leaf":
        _rewrite(src, bad, _drop_mu_leaf)
    elif case == "wrong_shape":
        _rewrite(src, bad, _nu_wrong_shape)
    else:
        open(bad, "wb").write(b"\x00junk" * 10)

    def no_torch_load(*args, **kwargs):
        raise AssertionError("torch.load called on a file the reader refused")

    monkeypatch.setattr(torch, "load", no_torch_load)
    cfg = load_cfg(adam_run["cfg"])
    state = create_train_state(build_model(cfg, seed=1), cfg)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    with pytest.raises(ValueError, match=match) as info:
        Checkpointer(str(tmp_path)).load(bad, state)
    assert "bad.ckpt" in str(info.value)
    assert case == "not_a_checkpoint" or isinstance(info.value, FlaxCheckpointError)
    assert state.step == 0 and not state.optimizer.state
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), before[n]), n


# ---------------------------------------------------------------------------
# cli.train on a JAX run's EXP directory
# ---------------------------------------------------------------------------
def test_train_cli_resumes_a_jax_run_with_r(adam_run, monkeypatch):
    """`cli.train -r 3` on the JAX CLI's EXP/jax: it resumes the JAX
    model_epoch_0000003.ckpt (epoch 3 from its payload, step 2), trains
    epoch 4 (4 steps) and writes the port's checkpoint; a missing -r N
    fails before anything is written."""
    from dual_space_nerf_tpu_torch.cli import train

    work = adam_run["work"]
    monkeypatch.chdir(work)
    for var in ("DSNERF_SEED", "DSNERF_LOADER_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DSNERF_VAL_PERIOD", "0")
    argv = ["-c", "tiny.yml", "--exp", "jax", "--device", "cpu", "--max_epochs", "5"]
    with pytest.raises(FileNotFoundError, match="model_epoch_0000009.ckpt"):
        train.main(argv + ["-r", "9"])
    try:
        state = train.main(argv + ["-r", "3"])
    finally:
        import logging

        logger = logging.getLogger("NERFRender")
        for h in logger.handlers:
            h.close()
        logger.handlers = []
    exp = work / "EXP" / "jax"
    assert state.step == 2 + 4
    assert checkpoint_format(str(exp / "model_epoch_0000003.ckpt")) == "flax"
    assert checkpoint_format(str(exp / "model_epoch_0000004.ckpt")) == "torch"
    assert (exp / "last_checkpoint").read_text().strip() == "model_epoch_0000004.ckpt"
    saved = torch.load(exp / "model_epoch_0000004.ckpt", weights_only=True)
    assert saved["step"] == 6 and saved["epoch"] == 4
    assert saved["scheduler"]["last_epoch"] == 6
