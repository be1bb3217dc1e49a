"""The fine pass as the benchmark's ``train.zju313_tpu_fine`` cell runs it
(`configs/zju_mocap/313_tpu_fine.yml`), on the CPU: its spans
(``render.fine`` around ``render.resample`` and the second pass's stages),
that the spans change no bit of a step, the sample counter by role, the
benchmark's reading of a span that wraps whole stages, and the tiny cell
against the benchmark's plain reference. Imports no JAX."""

from __future__ import annotations

import os
import sys
import threading

import pytest
import torch

from dual_space_nerf_tpu_torch.renderer import RenderSettings, render_rays
from dual_space_nerf_tpu_torch.renderer.pipeline import LightState
from dual_space_nerf_tpu_torch.training import create_train_state, draw_randoms, make_train_step
from dual_space_nerf_tpu_torch.cli.common import build_model
from dual_space_nerf_tpu_torch.utils import tracing
from portbench import calibrate, enclosing, trace
from portbench.test_portbench import CPU_BOUNDS
from test_torch_port_tracing import NRAYS, SAMPLES, _recorded, _setup, _tiny, float32_default  # noqa: F401

CPU = torch.device("cpu")
N_FINE = 8
RENDER_STAGES = ("sample", "search", "density", "select", "color", "composite")


def _fine_setup(n_fine: int):
    """The gated production path of `_setup` with ``n_fine`` fine samples
    (-1: none): (cfg, settings, batch, mesh)."""
    cfg, _, batch, mesh, _ = _setup(16)
    cfg.MODEL.FINE_RAY_SAMPLING = n_fine
    return cfg, RenderSettings.from_cfg(cfg), batch, mesh


def _step(cfg, settings, batch, mesh):
    """One step from the seed-1 model with its draws: (metrics, state)."""
    state = create_train_state(build_model(cfg, seed=1), cfg)
    randoms = draw_randoms(NRAYS, SAMPLES, torch.Generator().manual_seed(3), CPU,
                           max(settings.n_fine, 0))
    return make_train_step(settings, device="cpu")(state, batch, mesh, randoms), state


def test_the_fine_pass_opens_its_span_around_its_stages():
    """On: one render.fine, render.resample first inside it, then the
    second pass's stages under their own names; the coarse pass's stages
    all before it, with no resample among them."""
    cfg, settings, batch, mesh = _fine_setup(N_FINE)
    with tracing.enabled():
        _, spans = _recorded(lambda: _step(cfg, settings, batch, mesh))
    spans.sort(key=lambda s: (s[2], -s[3]))
    fine = [s for s in spans if s[0] == "dsnerf.render.fine"]
    assert len(fine) == 1
    f = fine[0]
    render = [s for s in spans if s[0].startswith("dsnerf.render.") and s is not f]
    inside = [s[0] for s in render if f[2] <= s[2] and s[3] <= f[3]]
    before = [s for s in render if s[3] <= f[2]]
    assert len(inside) + len(before) == len(render)
    assert all(s[1] == f[1] for s in render)
    assert inside[0] == "dsnerf.render.resample" and inside.count("dsnerf.render.resample") == 1
    want = {f"dsnerf.render.{k}": (3 if k == "sample" else 1) for k in RENDER_STAGES}
    assert {k: [s[0] for s in before].count(k) for k in want} == want
    want["dsnerf.render.sample"] = 2  # the fine pass samples no depths of its own
    assert {k: inside.count(k) for k in want} == want
    assert "dsnerf.render.resample" not in [s[0] for s in before]


@pytest.mark.parametrize("n_fine", [N_FINE, -1])
def test_a_step_is_the_same_bits_with_the_spans_on(n_fine):
    """The step's metrics, every gradient and every weight after it, and
    the train render's outputs, with the spans off and on."""
    cfg, settings, batch, mesh = _fine_setup(n_fine)
    m_off, s_off = _step(cfg, settings, batch, mesh)
    with tracing.enabled():
        m_on, s_on = _step(cfg, settings, batch, mesh)
    assert set(m_off) == set(m_on)
    for k in m_off:
        assert torch.equal(torch.as_tensor(m_off[k]), torch.as_tensor(m_on[k])), k
    for (name, p), q in zip(s_off.model.named_parameters(), s_on.model.parameters()):
        assert torch.equal(p.grad, q.grad), name
        assert torch.equal(p, q), name
    model = build_model(cfg, seed=1)
    randoms = draw_randoms(NRAYS, SAMPLES, torch.Generator().manual_seed(4), CPU, max(n_fine, 0))
    light = LightState.identity(CPU)
    off = render_rays(model, batch.rays, mesh, settings, light, device="cpu", train=True,
                      randoms=randoms)
    with tracing.enabled():
        on = render_rays(model, batch.rays, mesh, settings, light, device="cpu", train=True,
                         randoms=randoms)
    assert set(off) == set(on) and any(k.startswith("fine_") for k in off) == (n_fine > 0)
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("n_fine", [N_FINE, -1])
def test_the_sample_counter_counts_each_pass_by_role(n_fine):
    """A step adds R x S coarse samples and R x (S + n_fine) fine ones;
    without the fine pass no fine sample."""
    cfg, settings, batch, mesh = _fine_setup(n_fine)
    before = tracing.samples()
    _step(cfg, settings, batch, mesh)
    after = tracing.samples()
    fine = NRAYS * (SAMPLES + n_fine) if n_fine > 0 else 0
    assert {k: after[k] - before[k] for k in tracing.ROLES} == {"coarse": NRAYS * SAMPLES,
                                                              "fine": fine}


def test_the_sample_counter_loses_no_add_across_threads():
    """`tracing.count_samples` from more threads than cores, the
    interpreter switching threads every microsecond: every add is counted."""
    n_threads, n_adds = 2 * (os.cpu_count() or 1) + 2, 2000
    before = tracing.samples()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda r=tracing.ROLES[i % 2], n=i + 1: [
            tracing.count_samples(r, n) for _ in range(n_adds)]) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = tracing.samples()
    assert {k: after[k] - before[k] for k in tracing.ROLES} == {
        r: n_adds * sum(i + 1 for i in range(n_threads) if tracing.ROLES[i % 2] == r)
        for r in tracing.ROLES}


class _Event:
    """A profiler event as torch 2.11 gives it: no ``activity_type``."""

    def __init__(self, name, start, end, thread=1, device=False, corr=0):
        self._v = (name, start, end, thread, device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[4] else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[5]


class _Results:
    def __init__(self, events):
        self._events = events

    def events(self):
        return list(self._events)


def _fine_step_events(fine_spans: bool = True) -> list:
    """One traced fine step: the main thread (1) runs the coarse pass's
    sample, density and composite, then render.fine (render.resample
    opening with it, then the same three stages and one launch in no
    stage of its own), the loss and the backward, whose kernel autograd's
    thread (2) launches; a loader thread (3) copies inside its own span.
    The card runs behind: the coarse density and composite kernels start
    after render.fine has opened on the host. Without ``fine_spans`` the
    step is named as before the fine pass had spans: its resample under
    render.sample, no render.fine."""
    spans = [("portbench.step", 0, 2000), ("dsnerf.step.forward", 10, 1500),
             ("dsnerf.render.sample", 20, 100), ("dsnerf.render.density", 100, 200),
             ("dsnerf.render.composite", 200, 300),
             ("dsnerf.render.fine", 300, 900), ("dsnerf.render.resample", 300, 400),
             ("dsnerf.render.sample", 400, 500), ("dsnerf.render.density", 500, 700),
             ("dsnerf.render.composite", 700, 800), ("dsnerf.step.backward", 1500, 1900)]
    if not fine_spans:
        spans = [s for s in spans if s[0] != "dsnerf.render.fine"]
        spans = [("dsnerf.render.sample",) + s[1:] if s[0] == "dsnerf.render.resample" else s
                 for s in spans]
    launches = [(50, 60, 70), (150, 350, 450), (250, 450, 460), (310, 460, 480), (410, 480, 490),
                (550, 560, 600), (750, 750, 760), (850, 850, 870), (1000, 1000, 1010)]
    events = [_Event("dsnerf.loader.transform", -50, 2000, thread=3)]
    events += [_Event(n, s, e) for n, s, e in spans]
    for corr, (at, s, e) in enumerate(launches):
        events += [_Event("cudaLaunchKernel", at, at + 3, corr=corr),
                   _Event(f"k{corr}", s, e, device=True, corr=corr)]
    events += [_Event("cudaLaunchKernel", 1600, 1603, thread=2, corr=50),
               _Event("k_backward", 1600, 1700, device=True, corr=50),
               _Event("cudaMemcpyAsync", 450, 455, thread=3, corr=51),
               _Event("Memcpy HtoD (Pageable -> Device)", 490, 495, device=True, corr=51)]
    return events


def test_the_enclosing_reading_charges_every_open_span():
    """The fine pass's ops at any depth of render.fine (its resample, its
    stages, a launch in no stage of its own), and not the coarse ops the
    card runs while render.fine is open on the host, nor the loader's copy
    or the backward; the innermost charge of the same list as it was."""
    tr = trace._reduce(_Results(_fine_step_events()))
    assert enclosing.enclosing_device_ns(tr, "render.fine", 0, 2000) == 20 + 10 + 40 + 10 + 20
    assert enclosing.enclosing_device_ns(tr, "step.forward", 0, 2000) == 10 + 100 + 10 + 100 + 10
    assert enclosing.enclosing_device_ns(tr, "step.backward", 0, 2000) == 100
    assert enclosing.enclosing_device_ns(tr, "render.fine", 500, 2000) == 40 + 10 + 20
    innermost = {"render.sample": 20, "render.density": 140, "render.composite": 20,
                 "render.resample": 20, "render.fine": 20, "step.forward": 10,
                 "step.backward": 100, "loader.transform": 5}
    assert {k: tr.stage_device_ns(k, 0, 2000) for k in innermost} == innermost


def test_the_enclosing_reading_finds_nothing_without_the_span():
    """A program whose fine pass opens no render.fine reads None, and its
    innermost charges are the parent's."""
    tr = trace._reduce(_Results(_fine_step_events(fine_spans=False)))
    assert enclosing.enclosing_device_ns(tr, "render.fine", 0, 2000) is None
    assert tr.stage_device_ns("render.sample", 0, 2000) == 40
    assert tr.stage_device_ns("render.density", 0, 2000) == 140
    assert tr.stage_device_ns("render.fine", 0, 2000) is None
    assert tr.stage_device_ns("step.forward", 0, 2000) == 30  # the loss, and the bare launch


@pytest.mark.parametrize("seed", [1, 2])
def test_the_tiny_fine_cell_holds_to_the_reference(seed, float32_default):
    """`train.zju313_tpu_fine` at the tiny size (8 coarse + 64 fine samples
    of 48 rays, top-3 colour) against the plain reference."""
    cell = _tiny("train.zju313_tpu_fine")
    assert cell.config["MODEL"]["FINE_RAY_SAMPLING"] == 64
    numbers = calibrate.reading(cell, seed, "cpu")["numbers"]
    for k, v in numbers.items():
        assert v <= CPU_BOUNDS[k], (seed, k, v)
