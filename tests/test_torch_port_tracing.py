"""The port's stage spans (`utils/tracing.py`) and the loader's counters,
on the CPU: what a profiler records with the spans off and on, that they
change no number, the counters of `PrefetchLoader.stats`, the operator's
trace of `do_train(profile_dir=...)`, and the readings of
`scripts/stage_trace.py`."""

from __future__ import annotations

import glob
import importlib.util
import json
import logging
import os
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dual_space_nerf_tpu_torch.cli.common import build_model, load_cfg, load_faces
from dual_space_nerf_tpu_torch.data import select_dataset
from dual_space_nerf_tpu_torch.data.batching import item_to_mesh, item_to_train_batch, iter_ray_chunks
from dual_space_nerf_tpu_torch.data.prefetch import PrefetchLoader
from dual_space_nerf_tpu_torch.data.synthetic_dataset import SyntheticDataset
from dual_space_nerf_tpu_torch.evaluation.golden import train_cfg
from dual_space_nerf_tpu_torch.evaluation.render_image import ImageRenderer
from dual_space_nerf_tpu_torch.renderer import RenderSettings
from dual_space_nerf_tpu_torch.training import create_train_state, draw_randoms, make_train_step
from dual_space_nerf_tpu_torch.training.loop import LOADER_LOG, do_train
from dual_space_nerf_tpu_torch.utils import tracing
from torch_port_common import REPO, TINY_CLI_CFG

CPU = torch.device("cpu")
NRAYS, SAMPLES, CHUNK = 32, 24, 64
STEP_SPANS = ("dsnerf.step.forward", "dsnerf.step.backward", "dsnerf.step.optimizer")
#: (SHADE_TOPK, the config): the gated production path and the full exact one
PATHS = {16: True, 0: False}


def _setup(topk: int):
    """The config of the path (``SAMPLES`` samples, so that 16 gates), the
    settings, one train batch and mesh, a val item."""
    cfg = train_cfg(PATHS[topk], False)
    cfg.MODEL.COARSE_RAY_SAMPLING = SAMPLES
    assert cfg.MODEL.SHADE_TOPK == topk
    ds = SyntheticDataset(split="train", nrays=NRAYS, n_frames=1, n_views=1, h=16, w=16)
    item = ds[0]
    batch = item_to_train_batch(item, NRAYS, CPU)
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, CPU)
    val = SyntheticDataset(split="val", n_frames=1, n_views=1, h=16, w=16)
    return cfg, RenderSettings.from_cfg(cfg), batch, mesh, val


def _recorded(fn, all_threads: bool = False):
    """(fn's result, the ``dsnerf.`` spans a CPU profile of it records:
    [(name, thread, start_ns, end_ns)] by start)."""
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn()
    spans = [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith(tracing.PREFIX)]
    return out, sorted(spans, key=lambda s: s[2])


def _names(spans) -> list:
    return [s[0] for s in spans]


def _step_once(cfg, settings, batch, mesh):
    """One step from the seed-1 model: (metrics, state)."""
    state = create_train_state(build_model(cfg, seed=1), cfg)
    randoms = draw_randoms(NRAYS, SAMPLES, torch.Generator().manual_seed(3), CPU)
    return make_train_step(settings, device="cpu")(state, batch, mesh, randoms), state


def _renderer(cfg, settings, val):
    return ImageRenderer(build_model(cfg, seed=1), settings, val.faces, val.canonical_vertex,
                         chunk=CHUNK, device="cpu", pack="f32")


def test_a_span_that_is_off_calls_no_profiler(monkeypatch):
    """Off, every site gets the one shared no-op, without touching the
    profiler; on, a ``dsnerf.`` record_function; `enabled` restores."""
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    assert not tracing.is_on()
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        assert tracing.span("step.forward") is tracing.span("render.color")
        with tracing.span("step.forward"):
            pass
    with tracing.enabled():
        assert tracing.is_on()
        with tracing.enabled(False):
            assert not tracing.is_on()
        assert isinstance(tracing.span("x"), torch.profiler.record_function)
    assert not tracing.is_on()


@pytest.mark.parametrize("topk", sorted(PATHS))
def test_spans_off_record_nothing(topk):
    """With tracing off a profiled train step and a profiled render_item
    record no ``dsnerf.`` event."""
    cfg, settings, batch, mesh, val = _setup(topk)
    _, spans = _recorded(lambda: _step_once(cfg, settings, batch, mesh))
    assert spans == []
    renderer = _renderer(cfg, settings, val)
    _, spans = _recorded(lambda: renderer.render_item(val[0]))
    assert spans == []


@pytest.mark.parametrize("topk", sorted(PATHS))
def test_the_step_records_its_stages(topk):
    """On: step.forward, step.backward and step.optimizer once each, in that
    order, with every render stage inside step.forward; the gated path
    records render.density and render.select, the full path render.warp
    and its canonical search."""
    cfg, settings, batch, mesh, _ = _setup(topk)
    with tracing.enabled():
        _, spans = _recorded(lambda: _step_once(cfg, settings, batch, mesh))
    names = _names(spans)
    assert [n for n in names if n.startswith("dsnerf.step.")] == list(STEP_SPANS)
    fwd = next(s for s in spans if s[0] == "dsnerf.step.forward")
    render = [s for s in spans if s[0].startswith("dsnerf.render.")]
    assert all(s[1] == fwd[1] and fwd[2] <= s[2] and s[3] <= fwd[3] for s in render)
    want = {"dsnerf.render.sample": 3, "dsnerf.render.color": 1, "dsnerf.render.composite": 1}
    if topk:
        want.update({"dsnerf.render.density": 1, "dsnerf.render.select": 1,
                     "dsnerf.render.search": 1, "dsnerf.render.warp": 0})
    else:
        want.update({"dsnerf.render.density": 0, "dsnerf.render.select": 0,
                     "dsnerf.render.search": 2, "dsnerf.render.warp": 1})
    assert {k: names.count(k) for k in want} == want


@pytest.mark.parametrize("topk", sorted(PATHS))
def test_render_item_records_mesh_chunks_and_pack(topk):
    """On: image.mesh once, then each chunk's render stages (one
    render.color a chunk), then one image.pack."""
    cfg, settings, _, _, val = _setup(topk)
    item = val[0]
    chunks = len(list(iter_ray_chunks(item, CHUNK, CPU)))
    assert chunks >= 2
    renderer = _renderer(cfg, settings, val)
    with tracing.enabled():
        _, spans = _recorded(lambda: renderer.render_item(item))
    names = _names(spans)
    assert names[0] == "dsnerf.image.mesh" and names[-1] == "dsnerf.image.pack"
    assert names.count("dsnerf.image.mesh") == names.count("dsnerf.image.pack") == 1
    for stage in ("color", "composite", "sample"):
        assert names.count(f"dsnerf.render.{stage}") == chunks * (3 if stage == "sample" else 1)
    assert names.count("dsnerf.render.density") == (chunks if topk else 0)


@pytest.mark.parametrize("topk", sorted(PATHS))
def test_outputs_are_bit_identical_with_spans_on(topk):
    """Loss, every gradient, every weight after the step and the rendered
    image are the same bits with the spans on and off."""
    cfg, settings, batch, mesh, val = _setup(topk)
    m_off, s_off = _step_once(cfg, settings, batch, mesh)
    with tracing.enabled():
        m_on, s_on = _step_once(cfg, settings, batch, mesh)
    assert torch.equal(m_off["loss"], m_on["loss"])
    for (name, p), q in zip(s_off.model.named_parameters(), s_on.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name
    item = val[0]
    off = _renderer(cfg, settings, val).render_item(item)
    with tracing.enabled():
        on = _renderer(cfg, settings, val).render_item(item)
    for k in off:
        np.testing.assert_array_equal(on[k], off[k], err_msg=k)


def _slow_transform(i):
    time.sleep(0.002)
    return i


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("backend", ["thread", "process"])
def test_loader_stats_count_the_items(backend, ordered, monkeypatch):
    """`stats` counts every item yielded, the time in the transform and the
    consumer's wait, cumulatively over epochs."""
    monkeypatch.delenv("DSNERF_LOADER_BACKEND", raising=False)
    loader = PrefetchLoader(list(range(12)), num_workers=3, seed=0, transform=_slow_transform,
                            backend=backend, ordered=ordered)
    assert loader.stats == {"items": 0, "wait_s": 0.0, "transform_s": 0.0}
    got = list(loader)
    first = loader.stats
    assert sorted(got) == list(range(12))
    assert first["items"] == 12 and first["wait_s"] >= 0.0
    assert first["transform_s"] >= 12 * 0.002
    assert len(list(loader)) == 12
    second = loader.stats
    assert second["items"] == 24
    assert second["transform_s"] > first["transform_s"] and second["wait_s"] >= first["wait_s"]


def test_pass_counter_loses_no_add_across_threads():
    """`tracing.count_pass` from more threads than cores, the interpreter
    switching threads every microsecond: every add is counted."""
    import sys
    import threading

    n_threads, n_adds = 2 * (os.cpu_count() or 1) + 2, 2000
    before = tracing.passes()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda p=tracing.PATHS[i % 3]: [
            tracing.count_pass(p) for _ in range(n_adds)]) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = tracing.passes()
    added = {k: after[k] - before[k] for k in tracing.PATHS}
    assert added == {p: n_adds * sum(1 for i in range(n_threads) if tracing.PATHS[i % 3] == p)
                     for p in tracing.PATHS}


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_loader_spans_name_their_threads(backend, monkeypatch):
    """On: the consumer's loader.wait on the main thread; the transform on
    the worker threads (thread backend, with dataset[i] as loader.fetch) or
    on the consumer (process backend, whose fetch runs in the forked
    workers)."""
    monkeypatch.delenv("DSNERF_LOADER_BACKEND", raising=False)
    loader = PrefetchLoader(list(range(6)), num_workers=2, seed=0, transform=_slow_transform,
                            backend=backend)
    with tracing.enabled():
        _, spans = _recorded(lambda: list(loader), all_threads=True)
    main = next(s[1] for s in spans if s[0] == "dsnerf.loader.wait")
    threads = {n: {s[1] for s in spans if s[0] == n} for n in set(_names(spans))}
    assert _names(spans).count("dsnerf.loader.transform") == 6
    if backend == "thread":
        assert _names(spans).count("dsnerf.loader.fetch") == 6
        assert main not in threads["dsnerf.loader.transform"] | threads["dsnerf.loader.fetch"]
    else:
        assert "dsnerf.loader.fetch" not in threads
        assert threads["dsnerf.loader.transform"] == {main}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


class _NoWriter:
    def add_scalar(self, *a, **k):
        pass


def test_do_train_profile_holds_the_spans_and_the_loader_threads(tmp_path, monkeypatch):
    """do_train(profile_dir=...) writes a trace with dsnerf.step.backward on
    the loop's thread and dsnerf.loader.transform on another; the iteration
    lines end in the network passes (on the CPU all plain) and the
    loader's readings; the spans are off again after."""
    for var in ("DSNERF_LOADER_BACKEND", "DSNERF_DETERMINISTIC_DATA", "DSNERF_VAL_PERIOD"):
        monkeypatch.delenv(var, raising=False)
    (tmp_path / "tiny.yml").write_text(TINY_CLI_CFG)
    cfg = load_cfg(str(tmp_path / "tiny.yml"))
    train_set, _ = select_dataset(cfg, train_nrays=cfg.SOLVER.TRAIN_NRAYS)
    logger = logging.getLogger("tracing_do_train")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = _Records()
    logger.handlers = [handler]
    do_train(cfg, build_model(cfg, seed=1), train_set, load_faces(cfg, train_set), _NoWriter(),
             logger, str(tmp_path / "out"), max_epochs=2, device="cpu",
             profile_dir=str(tmp_path / "prof"))
    assert not tracing.is_on()
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    tids = lambda name: {e["tid"] for e in events if e["name"] == name}  # noqa: E731
    assert tids("dsnerf.step.backward") and tids("dsnerf.loader.transform")
    assert tids("dsnerf.loader.transform") - tids("dsnerf.step.backward")
    steps = [line for line in handler.lines if line.startswith("Epoch[")]
    assert steps and all(" Loader wait: " in line and line.endswith("[ms/item]") for line in steps)
    assert LOADER_LOG.startswith(" Loader wait: ")
    passes = [re.search(r" Passes: (\d+) fused (\d+) fast (\d+) plain Loader", line) for line in steps]
    assert all(p and p.group(1) == p.group(2) == "0" and int(p.group(3)) > 0 for p in passes)


# ---------------------------------------------------------------------------
# scripts/stage_trace.py
# ---------------------------------------------------------------------------
def _stage_trace():
    spec = importlib.util.spec_from_file_location(
        "stage_trace", os.path.join(REPO, "scripts", "stage_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Event:
    """A profiler event as `stage_device_ns` reads one."""

    def __init__(self, name, kind, thread, start, end, corr=0):
        self._v = (name, kind, thread, start, end, corr)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_thread_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]

    def correlation_id(self):
        return self._v[5]


def test_stage_device_ns_charges_the_launching_stage():
    """A kernel or copy goes to the innermost span open where it was
    launched (a child that starts with its parent included); a launch on a
    thread without spans (autograd's) to the main thread's innermost span
    then; a launch in no span, or an op without a recorded launch, to the
    outside."""
    st = _stage_trace()
    A = "user_annotation"
    events = [
        _Event("portbench.train_step", A, 1, 0, 1000),
        _Event("dsnerf.step.forward", A, 1, 10, 500),
        _Event("dsnerf.render.color", A, 1, 10, 200),
        _Event("dsnerf.render.search", A, 1, 300, 400),
        _Event("dsnerf.step.backward", A, 1, 600, 900),
        _Event("cudaLaunchKernel", "cuda_runtime", 1, 20, 21, corr=1),
        _Event("cudaLaunchKernel", "cuda_runtime", 1, 350, 351, corr=2),
        _Event("cudaLaunchKernel", "cuda_runtime", 7, 650, 651, corr=3),
        _Event("cudaLaunchKernel", "cuda_runtime", 1, 950, 951, corr=4),
        _Event("cudaMemcpyAsync", "cuda_runtime", 1, 420, 430, corr=5),
        _Event("k1", "kernel", 0, 30, 60, corr=1),
        _Event("k2", "kernel", 0, 360, 370, corr=2),
        _Event("k3", "kernel", 0, 700, 800, corr=3),
        _Event("k4", "kernel", 0, 960, 965, corr=4),
        _Event("copy", "gpu_memcpy", 0, 440, 447, corr=5),
        _Event("lost", "gpu_memset", 0, 970, 972, corr=66),
    ]
    assert st.stage_device_ns(st.rows(events)) == {
        "dsnerf.render.color": 30, "dsnerf.render.search": 10, "dsnerf.step.backward": 100,
        "dsnerf.step.forward": 7, st.OUTSIDE: 7}
    assert st.host_ns(st.rows(events)) == {"dsnerf.step.forward": 490, "dsnerf.render.color": 190,
                                  "dsnerf.render.search": 100, "dsnerf.step.backward": 300}
    assert st.host_ns(st.rows(events), st.BENCH_PREFIX) == {"portbench.train_step": 1000}


class _OldEvent(_Event):
    """An event of a profiler that gives no activity type (torch 2.11)."""

    def __init__(self, name, device, *rest):
        super().__init__(name, None, *rest)
        self._device = device

    def device_type(self):
        return self._device

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)


def test_stage_trace_kinds_without_activity_types():
    """Where events carry no activity type, a GPU-side range of a
    ``dsnerf.`` or ``portbench.`` span is an annotation and never a kernel,
    their host sides are annotations, a ``cu*`` host call is a launch."""
    st = _stage_trace()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kinds = {name: st._kind(_OldEvent(name, dev, 0, 0, 1))
             for name, dev in [("dsnerf.render.color", cuda), ("portbench.step", cuda),
                               ("ProfilerStep#3", cuda), ("Memcpy HtoD", cuda),
                               ("Memset (Device)", cuda), ("void gemm_kernel<>", cuda),
                               ("dsnerf.step.forward", cpu), ("cudaLaunchKernel", cpu),
                               ("aten::mm", cpu)]}
    assert kinds == {"dsnerf.render.color": "gpu_user_annotation",
                     "portbench.step": "gpu_user_annotation", "ProfilerStep#3": "gpu_user_annotation",
                     "Memcpy HtoD": "gpu_memcpy", "Memset (Device)": "gpu_memset",
                     "void gemm_kernel<>": "kernel", "dsnerf.step.forward": "user_annotation",
                     "cudaLaunchKernel": "cuda_runtime", "aten::mm": "cpu_op"}
    device, spans = st.device_and_spans(st.rows(
        [_OldEvent("dsnerf.render.color", cuda, 0, 5, 9), _OldEvent("k", cuda, 0, 6, 8),
         _OldEvent("portbench.step", cpu, 1, 0, 10)]))
    assert device == [("k", 6, 8, True)] and spans == [("portbench.step", 0, 10)]


def _tiny(name: str):
    """A benchmark cell at a size the CPU runs in seconds (every width as
    published; a small image, few rays and samples)."""
    from portbench import harness

    c = harness.Cell(name)
    c.traffic["scene"]["size"] = 40 if c.traffic["kind"] == "train" else 20
    c.config["SOLVER"]["TRAIN_NRAYS"] = 48
    c.config["MODEL"]["COARSE_RAY_SAMPLING"] = 8
    if c.config["MODEL"].get("SHADE_TOPK", 0) > 0:
        c.config["MODEL"]["SHADE_TOPK"] = 3
    c.config["TEST"]["RAY_CHUNK"] = 256
    c.traffic["images"] = 2
    c.traffic["trace_units"] = 2 if c.traffic["kind"] == "train" else 1
    return c


@pytest.fixture
def float32_default():
    """The benchmark's sessions build in torch's float32 default, which a
    test module collected in the same process may have changed."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(saved)


@pytest.mark.parametrize("name", ["train.zju313_tpu", "render.zju313"])
def test_stage_trace_reads_a_tiny_cell(name, float32_default):
    """A tiny traced run of a cell on the CPU: the stretch with the spans on
    reads each stage, every stage's host ms at most its benchmark span's,
    the step's three parts at least 90% of the benchmark's step span; the
    stretch with them off reads none; the train window reads the loader's
    transform per item."""
    st = _stage_trace()
    row = st.measure(_tiny(name), 7, "cpu", pairs=1, window=0.2)
    off, on = row["stretches"]
    assert not off["spans"] and on["spans"] and "host_ms" not in off
    for st_ in (off, on):  # the CPU takes the plain chain under "auto"
        assert st_["passes_per_unit"]["fused"] == st_["passes_per_unit"]["fast"] == 0
        assert st_["passes_per_unit"]["plain"] >= (2 if name.startswith("train") else 1)
    if name.startswith("train"):
        unit = on["bench_ms"]["portbench.train_step"]
        parts = sum(on["host_ms"][s] for s in STEP_SPANS)
        assert 0.9 * unit <= parts <= unit
        assert row["window"]["loader_items"] >= row["window"]["steps"]
        assert row["window"]["loader_transform_ms"] > 0
    else:
        unit = on["bench_ms"]["portbench.render_item"]
        assert {"dsnerf.image.pack", "dsnerf.render.color", "dsnerf.render.warp"} <= set(on["host_ms"])
    assert all(0 < v <= unit for v in on["host_ms"].values())
    assert on["device_ms"] == {} and on["launches_per_unit"] == 0
