"""CPU tests of the benchmark, at a tiny size (a 40 x 40 image, 48 rays of 8
samples a step, 256-ray chunks): the plain reference against the program,
also with the fine pass, the faults the comparison must catch, the counts
of `flops.py`, the kernel families, the reading of the profiler's events,
the files a cell is made of, and what a run may load.

    python -m pytest portbench -q

The test marked ``cuda`` runs a short cell on the card and skips here.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import calibrate, faults, flops, harness, trace  # noqa: E402
from portbench import run as run_mod  # noqa: E402
from portbench.reference import networks as nets  # noqa: E402

SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN = [c for c in CELLS if harness.Cell(c).traffic["kind"] == "train"]
RENDER = [c for c in CELLS if harness.Cell(c).traffic["kind"] == "render"]


def tiny(name: str) -> harness.Cell:
    """The cell at a size the CPU runs in seconds: every width as published,
    a small image, few rays and samples (the top-K cut with them)."""
    c = harness.Cell(name)
    c.traffic["scene"]["size"] = 40
    c.config["SOLVER"]["TRAIN_NRAYS"] = 48
    c.config["MODEL"]["COARSE_RAY_SAMPLING"] = 8
    if c.config["MODEL"].get("SHADE_TOPK", 0) > 0:
        c.config["MODEL"]["SHADE_TOPK"] = 3
    c.config["TEST"]["RAY_CHUNK"] = 256
    c.traffic["images"] = 2
    if c.traffic["kind"] == "render":
        c.traffic["check"] = {"images": 2, "rays": 64}
    c.traffic["trace_units"] = 1
    return c


def fine(cell: harness.Cell, n_fine: int = 8) -> harness.Cell:
    """The cell with the fine pass: ``n_fine`` more samples a ray."""
    cell.config["MODEL"]["FINE_RAY_SAMPLING"] = n_fine
    return cell


# At this size a weight's norm rests on 384 samples, so one sample's
# rounding weighs more than at the cells' 352,000: the bounds are the CPU's
# own, about 10x above what seeds 1-4 read here.
CPU_BOUNDS = {"loss_gap": 1e-6, "median_grad_gap": 1e-5, "median_change_gap": 1e-4,
              "mismatch_share": 1e-3}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_holds_the_program(name, seed):
    numbers = calibrate.reading(tiny(name), seed, "cpu")["numbers"]
    for k, v in numbers.items():
        assert v <= CPU_BOUNDS[k], (name, seed, k, v)


@pytest.mark.parametrize("name,kind", [(c, k) for c in TRAIN for k in ("unchanged", "half", "altered")]
                         + [(c, k) for c in RENDER for k in ("half", "altered")])
def test_a_fault_makes_the_run_incorrect(name, kind):
    """A whole run (set-up, window, reference) with the timed path broken
    underneath: ``correct`` comes out false under the cell's own limits."""
    cell = tiny(name)
    hook = ({"wrap_step": faults.train_fault(kind)} if cell.traffic["kind"] == "train"
            else {"wrap_render": faults.render_fault(kind)})
    out = run_mod.run_cell(cell, 11, 0.1, False, "cpu", time.perf_counter(), hooks=hook)
    assert cell.limits, f"{name}: no limits file"
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]


@pytest.mark.parametrize("name", ["train.zju313_tpu", "render.zju313_tpu"])
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_holds_the_program_with_the_fine_pass(name, seed):
    numbers = calibrate.reading(fine(tiny(name)), seed, "cpu")["numbers"]
    for k, v in numbers.items():
        assert v <= CPU_BOUNDS[k], (name, seed, k, v)


@pytest.mark.parametrize("kind", ["half", "altered"])
def test_a_fault_makes_the_fine_run_incorrect(kind):
    cell = fine(tiny("train.zju313_tpu"))
    out = run_mod.run_cell(cell, 11, 0.1, False, "cpu", time.perf_counter(),
                           hooks={"wrap_step": faults.train_fault(kind)})
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_its_metrics(name):
    """The program's spans and counters read in every cell their metrics
    list; a device time only on the card."""
    cell = tiny(name)
    out = run_mod.run_cell(cell, 12, 0.1, True, "cpu", time.perf_counter())
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device", "breakdown"}
    assert list(out)[-1] == "checks"
    assert out["device"]["window_s"] > 0 and out["breakdown"]["idle_gaps"]
    assert set(out["metrics"]) <= {m["name"] for m in cell.metrics("per_layer")}
    for m in cell.metrics("per_layer"):
        if m["source"] in ("program_span", "program_counter"):
            assert m["name"] in out["metrics"], m["name"]
        if "_device_ms." in m["name"]:  # the device ops of a stage or a family
            assert m["name"] not in out["metrics"], m["name"]
    if "fused_pass_share.train" in out["metrics"]:  # the CPU runs the plain chain
        assert out["metrics"]["fused_pass_share.train"]["value"] == 0.0


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


def test_a_stage_span_is_an_annotation_on_either_side():
    assert trace._kind(_Event("dsnerf.render.color", 0, 9, device=True)) == "gpu_user_annotation"
    assert trace._kind(_Event("portbench.step", 0, 9, device=True)) == "gpu_user_annotation"
    assert trace._kind(_Event("dsnerf.render.color", 0, 9)) == "user_annotation"
    assert trace._kind(_Event("cudaLaunchKernel", 0, 9)) == "cuda_runtime"
    assert trace._kind(_Event("aten::mm", 0, 9)) == "cpu_op"
    assert trace._kind(_Event("fused_mlp_fwd_kernel", 0, 9, device=True)) == "kernel"
    assert trace._kind(_Event("Memcpy HtoD (Pageable -> Device)", 0, 9, device=True)) == "gpu_memcpy"


# One traced step: the main thread (1) in the benchmark's step and the
# program's forward (colour inside it) and backward; autograd's thread (2)
# with no span of its own; a loader thread (3) whose transform span opens
# before the step and comes first among the events.
STEP_EVENTS = [
    _Event("dsnerf.loader.transform", -50, 700, thread=3),
    _Event("portbench.step", 0, 1000),
    _Event("dsnerf.step.forward", 10, 500),
    _Event("dsnerf.render.color", 100, 300),
    _Event("dsnerf.step.backward", 550, 900),
    _Event("cudaLaunchKernel", 50, 55, corr=8),
    _Event("cudaLaunchKernel", 150, 155, corr=7),
    _Event("cudaLaunchKernel", 600, 605, thread=2, corr=9),
    _Event("cudaMemcpyAsync", 200, 205, thread=3, corr=10),
    _Event("aten::mm", 140, 160),
    _Event("k1", 160, 200, device=True, corr=7),
    _Event("k2", 60, 90, device=True, corr=8),
    _Event("k3", 610, 700, device=True, corr=9),
    _Event("Memcpy HtoD (Pageable -> Device)", 210, 220, device=True, corr=10),
    _Event("dsnerf.render.color", 100, 300, device=True),
    _Event("portbench.step", 0, 1000, device=True),
]


def test_reduce_charges_a_launch_to_the_innermost_span_of_its_thread():
    tr = trace._reduce(_Results(STEP_EVENTS))
    assert [d[0] for d in tr.device] == ["k2", "k1", "Memcpy HtoD (Pageable -> Device)", "k3"]
    assert tr.launched_in == ["dsnerf.step.forward", "dsnerf.render.color",
                              "dsnerf.loader.transform", "dsnerf.step.backward"]
    assert tr.stage_device_ns("render.color", 0, 1000) == 40
    assert tr.stage_device_ns("step.forward", 0, 1000) == 30
    assert tr.stage_device_ns("step.backward", 0, 1000) == 90
    assert tr.stage_device_ns("loader.transform", 0, 1000) == 10
    assert tr.stage_device_ns("render.density", 0, 1000) is None
    assert sum(1 for d in tr.in_stretch(*tr.stretch("step")[:2]) if d[3]) == 3


def test_reduce_finds_the_main_thread_past_the_loaders_spans():
    tr = trace._reduce(_Results(STEP_EVENTS))
    assert [s[0] for s in tr.spans] == ["portbench.step"]
    assert [s[0] for s in tr.stages] == ["dsnerf.step.forward", "dsnerf.render.color",
                                         "dsnerf.step.backward"]
    assert tr.stage_host_ns("step.forward", 0, 1000) == 490
    assert tr.stage_host_ns("loader.transform", -100, 1000) is None
    assert [h[0] for h in tr.host] == ["cudaLaunchKernel", "aten::mm", "cudaLaunchKernel"]
    assert [h[0] for h in tr.other] == ["cudaMemcpyAsync", "cudaLaunchKernel"]


def _loaded_by_a_run(name: str) -> dict:
    """Top-level modules, module files and opened files of a process that
    imports run.py and runs a tiny cell (the audit hook sees every open)."""
    code = f"""
import json, sys, time
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args else None)
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.dirname(__file__)!r})
import run
from test_portbench import tiny
run.run_cell(tiny({name!r}), 13, 0.1, False, "cpu", time.perf_counter())
mods = sorted(sys.modules)
files = sorted({{getattr(m, "__file__", None) or "" for m in list(sys.modules.values())}})
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in mods}}), "files": files, "opened": opened,
                  "forbidden": run.forbidden_modules()}}))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", [TRAIN[0], RENDER[0]])
def test_a_run_loads_no_jax_and_reads_no_older_bench(name):
    got = _loaded_by_a_run(name)
    assert got["forbidden"] == []
    for top in ("jax", "jaxlib", "flax", "dual_space_nerf_tpu"):
        assert top not in got["top"]
    assert "dual_space_nerf_tpu_torch" in got["top"]  # the system under test
    old = [os.path.join(ROOT, p) for p in ("bench", "scripts")]
    old_files = [os.path.join(ROOT, p) for p in ("bench.py", "chip_smoke.py")]
    for path in got["files"] + got["opened"]:
        p = os.path.abspath(path) if path else ""
        assert not any(p.startswith(d + os.sep) for d in old), p
        assert p not in old_files, p


def test_the_reference_imports_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
import portbench.reference.render, portbench.reference.train, portbench.reference.scene
import portbench.compare, portbench.flops
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    top = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("jax", "jaxlib", "flax", "dual_space_nerf_tpu", "dual_space_nerf_tpu_torch"):
        assert name not in top


def test_forward_counts_equal_the_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    g = torch.Generator().manual_seed(0)
    w = {k: torch.randn(s, generator=g) * 0.1 for k, s in nets.SHAPES.items()}
    n = 37
    pts = torch.rand(n, 3, generator=g)
    code, pose = w["nerf.embedding.weight"][3], torch.randn(16, generator=g)
    with FlopCounterMode(display=False) as fc:
        nets.density_pass(w, pts, code, pose)
    assert fc.get_total_flops() == flops.pass_flops(n, 0, train=False)
    with FlopCounterMode(display=False) as fc:
        sigma, ess, normal = nets.color_pass(w, pts, code, pose, create_graph=False)
        nets.lighting(w, torch.randn(n, 3, generator=g), pts, torch.randn(n, 3, generator=g), ess)
    assert fc.get_total_flops() == flops.pass_flops(0, n, train=False)


def test_fine_pass_counts_equal_the_flop_counter():
    """The fine variant's count (the coarse pass over S samples, the fine
    one over S + n_fine, both gated) against the counter over the
    reference's render of the same rays; `flops.py` leaves out the pose
    MLP, which each pass runs once."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.render import Settings, render
    from portbench.reference.scene import CapsuleScene
    from portbench.reference.train import batch_tensors

    cell = fine(tiny("train.zju313_tpu"))
    s = Settings.from_model_block(cell.config["MODEL"])
    scene = CapsuleScene(3, cell.traffic["scene"])
    rays, _, mesh = batch_tensors(scene.train_item(2, 0, 48, 0, 0, 0.6), scene.verts_cano,
                                  scene.faces, "cpu")
    w = harness.make_weights(nets.SHAPES, 3, "cpu")
    with FlopCounterMode(display=False) as fc:
        render(w, rays, mesh, s)
    with FlopCounterMode(display=False) as fp:
        nets.pose_feature(w, rays["body_pose"])
    assert flops.render_points(48, 8, 8, 3) == [(48 * 8, 48 * 3), (48 * 16, 48 * 3)]
    fwd, _ = flops.render_counts(48, s.n_samples, s.n_fine, s.shade_topk, train=False)
    assert fc.get_total_flops() - 2 * fp.get_total_flops() == fwd
    sess = harness.loop("train").Session(cell, 3, "cpu")
    try:
        assert sess.step_flops() == flops.render_counts(48, 8, 8, 3, train=True)
    finally:
        sess.close()


def test_counts_follow_the_published_widths():
    assert flops.density_macs() == 87 * 256 + 3 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256
    assert flops.points(5500, 64, 16) == (352_000, 88_000)
    assert flops.points(5500, 64, 0) == (0, 352_000)
    # without the fine pass a render is the one pass
    for k in (16, 0):
        p = flops.points(5500, 64, k)
        assert flops.render_counts(5500, 64, 0, k, train=True) == (
            flops.pass_flops(*p, train=True), flops.pass_bytes(*p, train=True))
    assert flops.render_points(5500, 64, 64, 16) == [(352_000, 88_000), (704_000, 88_000)]
    assert flops.WEIGHT_FLOATS == sum(int(np.prod(s)) for s in nets.SHAPES.values())
    # the backward never counts less than the forward, nor more than twice it again
    for args in ((1, 0), (0, 1)):
        fwd, trn = flops.pass_flops(*args, train=False), flops.pass_flops(*args, train=True)
        assert 2 * fwd < trn <= 3 * fwd


# Kernel names as the profiler named them on the card in the port's
# earlier profiles, with their families.
PROFILED = {
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x64x8_stage3_warpsize2x2x1_ffma_aligna4_a":
        "matrix products (cuBLAS)",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_64x128_8x5_nt_align1>(cutlass_80_simt_sgemm_64":
        "matrix products (cuBLAS)",
    "nvjet_tst_64x32_64x16_2x4_h_bz_splitK_NTT": "matrix products (cuBLAS)",
    "void (anonymous namespace)::nearest_face_kernel<true>(float const*, float const*, int*, un":
        "nearest_face kernel",
    "void listed::listed_kernel<true, false>(float const*, float const*, int const*, int const*":
        "tile-pruned search kernel",
    "void (anonymous namespace)::pruned_kernel<4>(float const*, float const*, float const*, flo":
        "tile-pruned search kernel",
    "listed_plan_kernel(float const*, float const*, int const*)": "listed plan kernel",
    "gg_kernel(float const*, float const*, float const*, float const*, float const*, float*)":
        "gg_near_far kernel",
    "void fused_mlp_fwd_kernel<true>(float const*, float const*, float*, float*, float*, float*":
        "fused SpaceNet kernels",
    "void fmlp_tc::fused_mlp_wgrad_kernel<true>(unsigned short const*, int, int, float*)":
        "fused SpaceNet kernels",
    "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<at::native:":
        "gathers / index ops",
    "void at::native::radixSortKVInPlace<2, -1, 32, 32, float, long, unsigned int>(at::cuda::de":
        "sorts",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrappe":
        "elementwise and reductions",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy_alignedK_contig<at::native::(a":
        "elementwise and reductions",
    "Memcpy DtoH (Device -> Pageable)": "copies and fills",
}


@pytest.mark.parametrize("name,family", sorted(PROFILED.items()))
def test_families_classify_profiled_kernels(name, family):
    assert trace.classify(name, trace.load_families()).name == family


def test_roles_of_the_families():
    fams = {f.name: f for f in trace.load_families()}
    assert {n for n, f in fams.items() if "networks" in f.roles} == {
        "matrix products (cuBLAS)", "fused SpaceNet kernels"}
    assert {n for n, f in fams.items() if "searches" in f.roles} == {
        "gg_near_far kernel", "nearest_face kernel", "listed plan kernel", "tile-pruned search kernel"}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_the_benchmark_files_are_complete():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"])) and c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.limits and set(cell.limits) == set(
            {"train": ("loss_gap", "median_grad_gap", "median_change_gap"),
             "render": ("mismatch_share",)}[
                cell.traffic["kind"]])
        assert cell.config["MODEL"].get("FUSED_MLP", "auto") == "auto"
        assert cell.config["MODEL"].get("KNN_IMPL", "auto") == "auto"
        assert w["chips"] == 1
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
        assert callable(harness.load_reader(m["name"]))
    for w in CELLS:  # every cell reports setup_s, another end-to-end and a per-layer metric
        cell = harness.Cell(w)
        reported = {m["name"] for m in cell.metrics("end_to_end")}
        assert "setup_s" in reported
        assert len(reported) >= 2 and cell.metrics("per_layer")
        for m in cell.metrics("per_layer"):  # what a per-layer metric moves, its cell reports
            assert m["moves"] in reported, (w, m["name"])


@pytest.mark.parametrize("name", RENDER)
def test_a_run_without_the_card_reads_no_device_time(name):
    """A device time comes from the card alone: a CPU run leaves such an
    end-to-end metric out and still reports the window's chunks."""
    cell = tiny(name)
    out = run_mod.run_cell(cell, 14, 0.1, False, "cpu", time.perf_counter())
    device_e2e = {m["name"] for m in cell.metrics("end_to_end") if m["source"] == "device_trace"}
    assert "setup_s" in out["metrics"] and not device_e2e & set(out["metrics"])
    chunk = cell.config["TEST"]["RAY_CHUNK"]
    sess = harness.loop("render").Session(cell, 14, "cpu")
    n = out["window"]["units"]
    sizes = [len(sess.items[i % len(sess.items)]["ray_o"]) for i in range(n)]
    assert out["window"]["chunks"] == sum(-(-k // chunk) for k in sizes)
    sess.close()


def test_without_a_card_a_run_exits_non_zero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", CELLS[0], "--seed", str(2**31 + 7), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_the_same_seed_gives_the_same_inputs():
    from portbench.reference.scene import CapsuleScene

    p = harness.Cell(TRAIN[0]).traffic["scene"]
    a, b = CapsuleScene(2**31 + 5, p), CapsuleScene(2**31 + 5, p)
    ia, ib = a.train_item(3, 6, 100, 1, 7, 0.6), b.train_item(3, 6, 100, 1, 7, 0.6)
    for k in ("ray_o", "ray_d", "near", "far", "rgb", "xyz", "poses"):
        np.testing.assert_array_equal(ia[k], ib[k])
    wa = harness.make_weights(nets.SHAPES, 2**31 + 5, "cpu")
    wb = harness.make_weights(nets.SHAPES, 2**31 + 5, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in nets.SHAPES)


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", CELLS[0], "--seed", str(2**31 + 9), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
