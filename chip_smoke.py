#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed):
1. device check: a CUDA card must be present; prints its name and power
   limit as nvidia-smi reports them;
2. builds every CUDA kernel of the port from `dual_space_nerf_tpu_torch/csrc`
   (one nvcc per source, in parallel) and prints the build seconds, and the
   registers, spills, shared memory and blocks per SM of the fused pair's
   bfloat16-fed entry points (`fused_resources`);
3. holds each kernel against its plain PyTorch version on the card, at the
   shapes the render gives it (the first 8192-ray chunk of the 512x512 val
   image: 524,288 points) and on a seeded random cloud, and times kernel,
   plain version, the card's bound and, where one PyTorch call computes the
   same function, that call. The three tile-pruned searches are also held
   against the brute-force kernel, with the visit plan (a kernel of its own,
   held against the plan in plain torch ops bit for bit) timed apart. The
   brute-force search is also held and timed at the training step's 352,000
   world points, GG at its 5500 rays and the plan at its 352,000 blocked
   points. The searches, GG and the plan report their issue floor (single
   FP32 instructions issued on this run's inputs; `issue_floor_ms`: 9 a
   visited pair for the searches; for GG and the plan, the pairs their
   culls keep plus the culls' own work, `gg_floor` / `plan_floor`, with the
   all-pairs figure beside it; for the pruned search, the pairs of the
   plain version's visits plus the sphere, bounds and thresholds,
   `pruned_floor`) and their registers, spills, shared memory and blocks
   per SM (`search_resources`, `small_kernel_resources`); GG, the plan and
   the pruned search also their device time from bare launches
   (`device_turns_ms`) beside the wrapper's event time. The pruned search
   is held and timed on three inputs: the chunk's blocked world points,
   the canonical points of the same chunk (what the exact path's second
   search receives) and the random cloud; the sweep times its block sizes
   in turns. The torch-op searches of `KNN_IMPL` "grouped" (sub-groups of
   4 samples of a ray), "clustered" and "xla" are held to the brute-force
   kernel on the chunk's 524,288 world points (`check_searches`: ids equal
   within SEARCH_NEAR of the mesh but at float32 near-ties, far misses
   below SEARCH_MISS_MAX; "xla" to ties of its own expanded form) and
   timed beside it;
4. renders the full 512x512 val image of the synthetic SMPL-sized scene with
   the trained fixture through `ImageRenderer.render_item` (the port's eval
   entry point) on three paths: (a) exact full shading with the brute-force
   search (`configs/zju_mocap/313.yml`), (b) the production path
   (`configs/zju_mocap/313_tpu.yml`: SHADE_TOPK 16, REUSE_WARP_FACES) with
   `KNN_IMPL: "listed"`, (c) exact full shading with `KNN_IMPL: "pruned"`
   (two pruned searches a chunk; held to (a) but for near-ties, PSNR >=
   40 dB), (d) the production path with `FUSED_MLP: "on"` and `FUSED_FAST`
   (the bfloat16-fed fused forward, two a chunk; held to (b) at PSNR >=
   FAST_PSNR_MIN), (e) the exact path with `FUSED_MLP: "on"` and
   `FINE_RAY_SAMPLING: 64` (the searches and the fused forward again on 64
   + 64 samples; its fine_* images finite), (f) the exact path with
   `KNN_IMPL: "grouped"` (held to (a) as (c) is), then the production image
   once more through the f16 pack (`DSNERF_EVAL_PACK`'s default; held to
   (b), copied as float32, at F16_PSNR_MIN). Each: launch counts per image,
   s_per_image, rays/s, PSNR;
5. renders the golden rays (`tests/fixtures/torch_port_render_golden.npz`,
   the JAX package's CPU render) on the card and holds them to its bands:
   every leg with its config's search, then the exact legs again with
   `KNN_IMPL: "pruned"` and with `"listed"` under `DSNERF_KNN_SLIM=1`, so
   that every kernel is launched on a render path, and every leg with
   "grouped", "clustered" and "xla";
6. holds the fused SpaceNet kernels (forward and backward, density-only and
   with color) against their plain versions at the training step's shapes
   (352,000 and 88,000 canonical points of the train batch, and a ragged
   count), checks that the forward's gpe is the backward's bit for bit,
   and times kernel, plain version, the card's bound and the unfused chain
   (SpaceNet + autograd normal for the forward, and its double backward for
   the backward; each kernel and its chain in turns, median and range);
   reports where kernel and plain version part at ReLU kinks, also for a
   randomly initialised SpaceNet, and each kernel's registers, spills,
   shared memory, scratch, blocks per SM and share of its bound; then the
   same for the bfloat16-fed pair (`FUSED_FAST`, bf16 products on the
   tensor cores): against the oracle of its plain versions, every sum in
   float64 rounded once (`fused_mlp.check_fast_kernels`: the points beyond
   the bands against the two float32 plain orders' count, the gradients,
   the weight-gradient pass on the kernel's own operands, two launches and
   a second grid size), each kernel timed in turns with the float32 kernel
   and the unfused bfloat16 chain (SpaceNet at compute_dtype bfloat16 +
   autograd), its bound at the bf16 tensor-core rate of its type, and the
   tensor-core and FP32 instructions of its SASS (`sass_counts`);
7. trains: `training.make_train_step` on `bench.py`'s train workload (the
   512x512 train item, 5500 rays x 64 samples, the trained fixture, Adam at
   5e-4) on four paths, production or exact with `FUSED_MLP` on or off, and
   three more: (e) production fused with `FUSED_FAST`, (f) production
   unfused with `MATMUL_PRECISION: "bf16"`, (g) exact fused with
   `FINE_RAY_SAMPLING: 64`, (h) exact fused with `KNN_IMPL: "grouped"`;
   from the same weights and the same draws: launch counts per step,
   s_per_step, rays/s, peak memory; every loss finite, the fused and
   unfused gradients of the first step held to each other, (e)'s to the
   fused path's within FAST_STEP_GRAD_TOL, (f)'s to the unfused path's
   within BF16_STEP_GRAD_TOL and (h)'s to the exact fused path's within
   GROUPED_STEP_GRAD_TOL; then LPIPS (`lpips_phase`: alex and vgg on seeded
   random weights in the converted npz layout, the production image
   against the val item's ground truth, the card's score held to the CPU's
   within LPIPS_REL, ms per image) and data parallelism
   (`data_parallel_phase`: the production fused step through a one-rank
   NCCL group and as two gloo processes on the card, 2 x 2750 rays, each
   held to the one-process step within DP_TOL; the production image with
   every chunk split over two replicas on the card, held to (b) within the
   golden bands; s_per_step and s_per_image of each);
8. drives the user's CLIs in a temporary directory (`cli_phase`): a config
   file that the port's own reader parses (the synthetic scene at 512x512,
   2 frames x 2 views; `313_tpu.yml`'s model block with `KNN_IMPL:
   "listed"` and `FUSED_MLP: "on"`; 5500 rays a step), `cli.train` for
   epochs 1-2 (8 steps), again with `--max_epochs 4` (it resumes from
   `last_checkpoint` and runs epoch 3, step 12), then `cli.validate` and
   `cli.test` on the last checkpoint, with validation inside the loop off
   (DSNERF_VAL_PERIOD=0). The resumed call loads its items through the
   forked-process loader (DSNERF_LOADER_BACKEND=process), which forks
   after CUDA is initialised. Fails unless the step counts, the checkpoint
   names, the launch counts per step and per render chunk are exact, every
   logged loss, PSNR and SSIM is finite and every PNG written has the PNG
   signature and the image's size. Prints the `train loop:` line
   (s_per_step of epoch 3, the step call alone; each epoch's wall time
   over its steps; epoch 1's time; the checkpoint's bytes and save
   ms, validate's and test's s_per_image, peak memory, the card);
   then the JAX package's checkpoint (`jax_ckpt_phase`: the committed
   `tests/fixtures/jax_trained_s233.ckpt`, flax msgpack of the trained
   params and Adam's state after two updates, read by the port's own
   reader): `cli.validate --ckpt` it renders the images of the params'
   `.npz` bit for bit, and `cli.train` resumes the JAX run's EXP directory
   from its tag for two steps that equal, bit for bit in params and Adam
   state, two steps from a port `.ckpt` saved right after loading it; the
   `jax ckpt:` line (decode ms, load ms, step times, the card);
9. drives the CLIs on the committed ZJU-313-shaped tree (`zju_cli_phase`,
   `.bench_cold_tree/CoreView_313`: 16 frames x 3 views of 1024x1024
   JPEGs, read in place through symlinks in a temporary data dir that adds
   the eval view "Camera (10)"; a stand-in SMPL pickle with the synthetic
   topology): `cli.train` for one cold epoch over the 48 items at ratio 0.5
   on the loader's threads, a resumed epoch over 6 items on the forked-
   process loader, then `cli.validate`, `cli.test`, `cli.vis_lighting` (its
   10 angles) and `cli.novel_pose_vis` (2 poses, 1024x1024) on the last
   checkpoint, with the same model block and launch checks as phase 8.
   Prints the `zju loop:` line (first-touch decode ms per JPEG, the decode
   thread-seconds of the cold epoch, the time that epoch spent outside its
   step calls, epoch 1's items/s, the resumed epoch's s per
   step, the loop's s_per_step, each CLI's s_per_image, the undistortion
   of one 1024x1024 frame with a nonzero distortion, which the tree's
   cameras skip, checkpoint bytes, peak memory, the card);
then extracts a mesh (`mesh_phase`): `Visualizer3D` on the trained fixture
   and the val item at resolution 128 (2,097,152 grid points through the warp
   and `density_grid`), the density volume and the marching tetrahedra timed
   apart, `extract_mesh` to an .obj and `render_turntable` to one PNG (a
   view is ~20 s of host work), the `mesh:` line;
10. profiles one render chunk of each path of phase 4 and one step of each
   path of phase 7 (`profile_device`: the profiler warmed up by one call,
   and every port kernel the profiled call launched looked up in its
   trace): device ms by kernel family, device ms per step, busy share. They
   run after every timed run: a profiler session leaves the host's later
   launches slower, which inflated the host-clock times taken after it;
11. prints the `kernels` JSON line (each kernel's launches from the path
    that is its own: the exact image for GG, brute force and the pruned
    search, the production image for the plan and the listed search, the
    slim golden leg, the fused production step, and for the bfloat16-fed
    pair the fused fast production step), the card line, and as the
    last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import json
import logging
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from dual_space_nerf_tpu_torch.cli import test as cli_test
from dual_space_nerf_tpu_torch.cli import train as cli_train
from dual_space_nerf_tpu_torch.cli import validate as cli_validate
from dual_space_nerf_tpu_torch.cli.common import load_cfg
from dual_space_nerf_tpu_torch.data import (
    SyntheticDataset,
    item_to_mesh,
    item_to_train_batch,
    iter_ray_chunks,
    select_dataset,
)
from dual_space_nerf_tpu_torch.evaluation import ImageRenderer, psnr
from dual_space_nerf_tpu_torch.evaluation.lpips import (
    load_lpips_params,
    lpips_distance,
    make_lpips_npz,
    random_lpips_params,
)
from dual_space_nerf_tpu_torch.evaluation.golden import (
    GOLDEN_NPZ,
    check_golden,
    production_cfg,
    render_golden,
    slice_cfg,
    train_cfg,
    trained_model,
)
from dual_space_nerf_tpu_torch.geometry import sample_along_rays, stratified_z
from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
from dual_space_nerf_tpu_torch.cli.common import compute_dtype
from dual_space_nerf_tpu_torch.evaluation.visualizer import Visualizer3D
from dual_space_nerf_tpu_torch.ops import (
    FUSED_BWD_FAST_KERNEL,
    FUSED_BWD_KERNEL,
    FUSED_FWD_FAST_KERNEL,
    FUSED_FWD_KERNEL,
    GG_KERNEL,
    KERNELS,
    LISTED_KERNEL,
    LISTED_PLAN_KERNEL,
    LISTED_SLIM_KERNEL,
    NEAREST_KERNEL,
    PRUNED_KERNEL,
    face_centroids,
    gg_near_far_cuda,
    gg_near_far_plain,
    listed_tables,
    nearest_face_clustered,
    nearest_face_cuda,
    nearest_face_grouped,
    nearest_face_plain,
    nearest_face_xla,
    pruned_search_listed,
    pruned_search_presorted,
)
from dual_space_nerf_tpu_torch.ops import fused_mlp, gg_cuda, posenc, pruned_knn
from dual_space_nerf_tpu_torch.ops.cuda_build import build_all
from dual_space_nerf_tpu_torch.ops.nearest_face import kernel_splits
from dual_space_nerf_tpu_torch.parallel import (
    global_ray_group,
    maybe_initialize_distributed,
    spawn_ranks,
)
from dual_space_nerf_tpu_torch.parallel.distributed import free_port
from dual_space_nerf_tpu_torch.renderer import (
    LightState,
    RenderSettings,
    render_rays,
    sample_z,
    warp_world_to_canonical,
)
from dual_space_nerf_tpu_torch.renderer.pipeline import _block_layout, _fused_inputs
from dual_space_nerf_tpu_torch.training import (
    Checkpointer,
    create_train_state,
    draw_randoms,
    make_train_step,
)
from dual_space_nerf_tpu_torch.training import loop as train_loop
from dual_space_nerf_tpu_torch.utils.image_io import PNG_SIGNATURE, imread
from dual_space_nerf_tpu_torch.utils.mesh_extract import marching_tetrahedra

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 operations/s
# outside the tensor cores, an FMA counted as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# dense bfloat16 on the tensor cores: the fast pair's bound (its products'
# type, bf16 x bf16 with float32 sums)
PEAK_BF16_PER_S = 989e12
# single FP32 instructions issued per second: 132 SMs x 128 lanes x 1.98 GHz
# (67 TFLOP/s counts an FMA as two operations)
PEAK_FP32_INSTR_PER_S = 33.5e12
H = W = 512
KERNEL_FAMILY = {  # each port kernel's family in `kernel_family`
    GG_KERNEL.name: "gg_near_far kernel", NEAREST_KERNEL.name: "nearest_face kernel",
    LISTED_PLAN_KERNEL.name: "listed plan kernel", LISTED_KERNEL.name: "tile-pruned search kernel",
    LISTED_SLIM_KERNEL.name: "tile-pruned search kernel", PRUNED_KERNEL.name: "tile-pruned search kernel",
    FUSED_FWD_KERNEL.name: "fused SpaceNet kernels", FUSED_BWD_KERNEL.name: "fused SpaceNet kernels",
    FUSED_FWD_FAST_KERNEL.name: "fused SpaceNet kernels", FUSED_BWD_FAST_KERNEL.name: "fused SpaceNet kernels",
}
N_TIMED_RENDERS = 2  # the production image; the exact ones once (the run keeps ~95-125 s)
# the exact render with the pruned search against the one with brute force:
# the same faces but at float32 near-ties; a search that names wrong faces
# on a share of the points falls far below this
PRUNED_PSNR_MIN = 40.0
PAIR_OPS = 9.0  # 3 sub, 3 mul, 2 add, 1 compare per point-centroid pair
# GG (csrc/gg_near_far.cu), single FP32 instructions: z0 (3 mul, 2 add), d2
# (mul, sub) and the compare per (ray, vertex) pair the cull keeps; sub, max,
# sqrt, sub, add, min, max more per pair inside a sphere; per (ray tile,
# vertex) the staging (3 sub, 3 mul, 2 add, exact) and the cone cull (16: the
# cross product 6, its norm 3, 2 sqrt, lb 1, the tests 4, FMAs fused); per ray
# the unit direction and the two divisions, ~10
GG_PAIR_OPS, GG_INSIDE_OPS, GG_TILE_VERT_OPS, GG_RAY_OPS = 8.0, 7.0, 24.0, 10.0
# the plan (csrc/listed_plan.cu), single FP32 instructions, none fused: per
# (point, witness) the cull keeps 9 (3 sub, 3 mul, 2 add, min); per (point,
# tile) it keeps 16 (6 clamp, 3 sub, 3 mul, 2 add, the test, the min); per
# point 20 (its box 6, U 9, u^2 5); per (row, tile) 41 (the first point's
# witness distance 8, the witness cull 15, the tile cull 18). Taken pair by
# pair without the culls: 9 + 16 = 25 a (point, tile) pair
PLAN_WITNESS_OPS, PLAN_TILE_OPS, PLAN_POINT_OPS, PLAN_ROW_TILE_OPS = 9.0, 16.0, 20.0, 41.0
PLAN_PAIR_OPS = PLAN_WITNESS_OPS + PLAN_TILE_OPS
# the pruned search (csrc/pruned_knn.cu), single FP32 instructions, none
# fused: PAIR_OPS a visited (point, centroid) pair; per point 15 (its box 6,
# its distance to the block's center 8, the max); per (block, tile) 13 (the
# bound: d2 8, sqrt, 2 sub; the seed's compare; the visit test); per point
# and visited tile 1 (the threshold's max)
PRUNED_POINT_OPS, PRUNED_BLOCK_TILE_OPS, PRUNED_VISIT_OPS = 15.0, 13.0, 1.0
SLEEP_CYCLES = 200_000     # ~0.1 ms of device time queued ahead of a timed launch
TRAIN_RAYS = 5500          # bench.py's train workload
N_TIMED_STEPS = 3
# the production image with the bfloat16-fed fused forward against the
# float32 production image (box PSNR): bfloat16 operands move every color a
# little (measured on an H100: 66.2 dB); a kernel that computed something
# else falls far below this
FAST_PSNR_MIN = 55.0
# the first step's gradients, per tensor, over the float32 path's largest
# entry: the fused fast path against the fused one (measured on an H100:
# 0.081, `nerf.stage1.4.weight`; the JAX package's own band between its fast
# and exact pair is 0.25), the bf16 networks against the float32 ones
# (measured 0.104, the lighting MLP's first bias): ~3x the measured
FAST_STEP_GRAD_TOL = 0.25
BF16_STEP_GRAD_TOL = 0.3
# the cluster-pruned searches against the brute-force kernel: ids equal on
# points nearer than SEARCH_NEAR to the mesh (the transparent mask drops the
# others) but at float32 near-ties; elsewhere at most SEARCH_MISS_MAX of the
# points on another face that is no near-tie
SEARCH_NEAR, SEARCH_MISS_MAX = 0.12, 0.01
# the production image through the f16 pack against the f32 copy (box
# PSNR): float16 rounding of [0, 1] colors is ~2.4e-4 at most (~72 dB)
F16_PSNR_MIN = 60.0
# the first step's gradients, exact fused with "grouped" against brute
# force, per tensor over the brute-force path's largest entry: faces part
# only at near-ties and on far points that the transparent mask drops
GROUPED_STEP_GRAD_TOL = 1e-2
# data parallel: every gradient within this share of its tensor's largest
# entry, the loss within it relative, against the one-process step
DP_TOL = 1e-5
LPIPS_REL = 1e-5           # LPIPS on the card against the CPU, relative
MESH_RESOLUTION = 128      # the mesh phase's grid: 2,097,152 points
FWD_TOL, BWD_TOL = 1e-5, 2e-5  # the CPU tests' bands against the JAX package
KINK = 1e-6                # see fused_mlp.kink_distances
ALT_BLOCKS = 66            # the fast pair's second grid: a quarter of two blocks an SM


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def alternate_ms(fns: dict, rounds: int) -> dict:
    """The functions of ``fns`` timed in turns (a, b, a, b, ...) after one
    warm-up each, CUDA events: {name: (median ms, [min, max])}."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: (statistics.median(t), [min(t), max(t)]) for name, t in times.items()}


def device_turns_ms(fns: dict, rounds: int) -> dict:
    """Device time of one call of each function of ``fns`` (a bare kernel
    launch), in turns after one warm-up each: a sleep kernel queued ahead
    keeps the card busy while the host enqueues the events and the launch,
    so the events bracket the kernel's device time alone and not the host's
    enqueue. {name: (median ms, [min, max])}."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: (statistics.median(t), [min(t), max(t)]) for name, t in times.items()}


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def issue_floor_ms(pairs: float, per_pair: float = PAIR_OPS) -> float:
    """The floor of a kernel that must equal its plain version bit for bit:
    ``per_pair`` single FP32 instructions per pair (PAIR_OPS for the
    searches), none of which may fuse into an FMA."""
    return per_pair * pairs / PEAK_FP32_INSTR_PER_S * 1e3


def gg_cull_counts(ray_o, ray_d, verts, gamma) -> dict:
    """GG's pairs on these inputs: all (ray, vertex) pairs, those its cull
    keeps (a torch replica of the cone bound in `csrc/gg_near_far.cu`, over
    the kernel's tiles of consecutive rays) and those inside a sphere (the
    only pairs that run the kernel's sqrt branch)."""
    n, dev = ray_d.shape[0], ray_d.device
    t = GG_KERNEL.extra_function("gg_near_far_ray_tile", [])()
    d = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    rel = verts - ray_o[0]
    r2 = (rel * rel).sum(-1)
    tiles = -(-n // t)
    starts = torch.arange(0, n, t, device=dev)
    mid = d[torch.clamp(starts + t // 2, max=n - 1)]                          # (tiles, 3)
    lanes = d[torch.clamp(torch.arange(tiles * t, device=dev), max=n - 1)].view(tiles, t, 3)
    rho = torch.linalg.norm(lanes - mid[:, None], dim=-1).amax(1) * 1.001 + 1e-4
    rays_in = torch.clamp(n - starts, max=t)
    kept = 0
    for s in range(0, tiles, 64):
        a = mid[s:s + 64, None].expand(-1, rel.shape[0], 3)
        lb = torch.linalg.norm(torch.cross(rel.expand_as(a), a, dim=-1), dim=-1) - r2.sqrt() * rho[s:s + 64, None]
        keep = ~((lb > 0) & (lb * lb > gamma * gamma + 1e-4 * r2))
        kept += int((keep.sum(1) * rays_in[s:s + 64]).sum())
    inside = 0
    for s in range(0, n, 1024):
        z0 = d[s:s + 1024] @ rel.T
        inside += int(((r2 - z0 * z0) < gamma * gamma).sum())
    return {"rays": n, "verts": verts.shape[0], "tiles": tiles, "pairs": n * verts.shape[0],
            "kept_pairs": kept, "inside_pairs": inside}


def gg_floor(c: dict) -> dict:
    """GG's floors on the inputs counted by `gg_cull_counts`: the issue
    floor of the work the kernel must do there (the pairs its cull keeps,
    the cull itself, the rays), its FP32 operations, and the issue floor of
    every pair taken without the cull (secondary)."""
    ops = (GG_PAIR_OPS * c["kept_pairs"] + GG_INSIDE_OPS * c["inside_pairs"]
           + GG_TILE_VERT_OPS * c["tiles"] * c["verts"] + GG_RAY_OPS * c["rays"])
    return {"ops": ops, "issue_floor_ms": ops / PEAK_FP32_INSTR_PER_S * 1e3,
            "kept_pair_share": c["kept_pairs"] / c["pairs"],
            "all_pairs_issue_floor_ms": issue_floor_ms(
                c["pairs"], GG_PAIR_OPS) + issue_floor_ms(c["inside_pairs"], GG_INSIDE_OPS)}


def check_gg(rays, mesh, step_rays, step_mesh, gamma) -> dict:
    """GG against its plain version bit for bit at the render chunk's 8192
    rays and the training step's 5500; timed through the wrapper (events)
    and as bare launches into preallocated outputs (device time), with its
    bound and issue floor from the pairs its cull keeps, and resources."""
    shapes, err = {}, 0.0
    for label, rs, ms in (("render", rays, mesh), ("step", step_rays, step_mesh)):
        args = (rs.ray_o, rs.ray_d, rs.near, rs.far, ms.verts_world)
        n_k, f_k = gg_near_far_cuda(*args, gamma)
        n_p, f_p = gg_near_far_plain(*args, gamma)
        torch.cuda.synchronize()
        err = max(err, float((n_k - n_p).abs().max()), float((f_k - f_p).abs().max()))
        if not (torch.equal(n_k, n_p) and torch.equal(f_k, f_p)):
            raise AssertionError(f"gg_near_far ({label}): kernel differs from plain version by {err}")
        outs = (torch.empty_like(rs.near), torch.empty_like(rs.far))
        bare = lambda args=args, outs=outs: gg_cuda.launch_gg(*args, *outs, gamma)
        counts = gg_cull_counts(rs.ray_o, rs.ray_d, ms.verts_world, gamma)
        floor = gg_floor(counts)
        r, v = counts["rays"], counts["verts"]
        shapes[label] = {
            **counts, "kept_pair_share": floor["kept_pair_share"],
            "wrapper_ms": time_ms(lambda args=args: gg_near_far_cuda(*args, gamma), reps=20),
            "device_ms": device_turns_ms({"k": bare}, rounds=21)["k"][0],
            "issue_floor_ms": floor["issue_floor_ms"],
            "all_pairs_issue_floor_ms": floor["all_pairs_issue_floor_ms"],
            "bound": bound_ms(4.0 * (r * 3 * 2 + r * 2 + v * 3 + r * 2), floor["ops"]),
        }
    s = shapes["render"]
    args = (rays.ray_o, rays.ray_d, rays.near, rays.far, mesh.verts_world)
    return {
        "name": "gg_near_far", "route": "cuda",
        "source": "dual_space_nerf_tpu_torch/csrc/gg_near_far.cu",
        "replaces": "dual_space_nerf_tpu/ops/gg_pallas.py:31",
        "max_abs_err": err,
        "ms": s["wrapper_ms"], "device_ms": s["device_ms"],
        "plain_ms": time_ms(lambda: gg_near_far_plain(*args, gamma), reps=5),
        "bound_ms": s["bound"][0], "bound_by": s["bound"][1], "library_ms": None,
        "issue_floor_ms": s["issue_floor_ms"], "all_pairs_issue_floor_ms": s["all_pairs_issue_floor_ms"],
        "step": {k: v for k, v in shapes["step"].items() if k != "bound"}
        | {"bound_ms": shapes["step"]["bound"][0]},
        "resources": small_kernel_resources(
            GG_KERNEL, dynamic_smem_bytes=0,
            blocks_per_sm=GG_KERNEL.extra_function("gg_near_far_blocks_per_sm", [])()),
        "shape": {k: s[k] for k in ("rays", "verts", "tiles", "kept_pairs", "kept_pair_share", "inside_pairs")},
    }


def cdist_argmin(pts, cents, step: int = 8192):
    """Yardstick only: one PyTorch call family for nearest neighbours."""
    out = torch.empty(pts.shape[0], dtype=torch.int64, device=pts.device)
    for s in range(0, pts.shape[0], step):
        out[s:s + step] = torch.cdist(pts[s:s + step], cents).argmin(1)
    return out


def random_cloud(n: int, cents: torch.Tensor) -> torch.Tensor:
    g = torch.Generator(device=cents.device).manual_seed(0)
    lo, hi = cents.min(0).values - 0.2, cents.max(0).values + 0.2
    return lo + (hi - lo) * torch.rand(n, 3, dtype=torch.float32, device=cents.device, generator=g)


def check_nearest_face(pts_path, cents, pts_step, cents_step) -> dict:
    """The brute-force kernel against its plain version, id for id, on the
    render chunk's world points, a random cloud of as many and the training
    step's world points; timed on each, with its bound, its issue floor and
    its resources."""
    worst, mism = 0, 0
    cloud = random_cloud(pts_path.shape[0], cents)
    for pts, c in ((pts_path, cents), (cloud, cents), (pts_step, cents_step)):
        ids_k = nearest_face_cuda(pts, c)
        ids_p = nearest_face_plain(pts, c)
        torch.cuda.synchronize()
        mism += int((ids_k != ids_p).sum())
        worst = max(worst, int((ids_k.long() - ids_p.long()).abs().max()))
    if mism:
        raise AssertionError(f"nearest_face: {mism} ids differ from the plain version")
    n, f = pts_path.shape[0], cents.shape[0]
    n_bytes = 4.0 * (n * 3 + f * 3 + n)
    b, by = bound_ms(n_bytes, PAIR_OPS * n * f)
    ns, fs = pts_step.shape[0], cents_step.shape[0]
    return {
        "name": "nearest_face", "route": "cuda",
        "source": "dual_space_nerf_tpu_torch/csrc/nearest_face.cu",
        "replaces": "dual_space_nerf_tpu/ops/nearest_face.py:66",
        "max_abs_err": float(worst), "mismatches": mism,
        "ms": time_ms(lambda: nearest_face_cuda(pts_path, cents), reps=10),
        "cloud_ms": time_ms(lambda: nearest_face_cuda(cloud, cents), reps=10),
        "step_ms": time_ms(lambda: nearest_face_cuda(pts_step, cents_step), reps=10),
        "plain_ms": time_ms(lambda: nearest_face_plain(pts_path, cents), reps=3),
        "bound_ms": b, "bound_by": by,
        "issue_floor_ms": issue_floor_ms(n * f),
        "step_bound_ms": bound_ms(4.0 * (ns * 4 + fs * 3), PAIR_OPS * ns * fs)[0],
        "step_issue_floor_ms": issue_floor_ms(ns * fs),
        "step_splits": kernel_splits(ns, fs),
        "library_ms": time_ms(lambda: cdist_argmin(pts_path, cents), reps=3),
        "resources": search_resources(NEAREST_KERNEL),
        "shape": {"points": n, "centroids": f, "step_points": ns},
    }


def near_tie_only(pts, cents, ids_a, ids_b, what: str) -> int:
    """Points where two exact searches name different faces: allowed only
    where the float64 distances of the two faces tie within float32 rounding
    (1e-6 relative). Returns their number; raises on any other difference."""
    off = (ids_a != ids_b).nonzero().squeeze(1)
    if off.numel():
        p = pts[off].double()
        da = ((p - cents[ids_a[off].long()].double()) ** 2).sum(-1)
        db = ((p - cents[ids_b[off].long()].double()) ** 2).sum(-1)
        bad = int(((da - db).abs() > 1e-6 * torch.minimum(da, db)).sum())
        if bad:
            raise AssertionError(f"{what}: {bad} ids differ from the brute-force search beyond a near-tie")
    return int(off.numel())


def plan_cull_counts(pts, tile_c, tile_r, n_tiles, plan_p) -> dict:
    """The witnesses and tiles per row that the plan kernel's culls keep (a
    torch replica of the bounds in `csrc/listed_plan.cu`): totals over the
    rows, means and maxima."""
    p_all = pts.reshape(-1, plan_p, 3)
    wit, lo, hi = tile_r[0:3, :n_tiles].T, tile_c[0:3, :n_tiles].T, tile_c[3:6, :n_tiles].T
    ws, ts = [], []
    for r0 in range(0, p_all.shape[0], 256):
        p = p_all[r0:r0 + 256]
        b_lo, b_hi = p.amin(1)[:, None], p.amax(1)[:, None]                   # (rows, 1, 3)
        d2 = ((p[:, :, None] - wit[None, None]) ** 2).sum(-1)                 # (rows, P, T)
        t0 = d2[:, 0].argmin(-1)
        u_max = d2.gather(2, t0[:, None, None].expand(-1, plan_p, 1)).amax(1)  # (rows, 1)
        gap = torch.where(wit > b_hi, wit - b_hi, torch.where(wit < b_lo, b_lo - wit, 0.0))
        w_keep = (gap * gap).sum(-1) <= u_max
        u = d2.masked_fill(~w_keep[:, None], float("inf")).amin(-1).sqrt() * (1.0 + 1e-5) + 1e-6
        gap = torch.where(lo > b_hi, lo - b_hi, torch.where(hi < b_lo, b_lo - hi, 0.0))
        ws.append(w_keep.sum(1))
        ts.append(((gap * gap).sum(-1) <= (u * u).amax(1, keepdim=True)).sum(1))
    w, t = torch.cat(ws).float(), torch.cat(ts).float()
    return {"rows": int(w.shape[0]), "tiles": n_tiles, "plan_p": plan_p,
            "witnesses_kept": int(w.sum()), "tiles_kept": int(t.sum()),
            "witnesses_kept_mean": float(w.mean()), "witnesses_kept_max": int(w.max()),
            "tiles_kept_mean": float(t.mean()), "tiles_kept_max": int(t.max())}


def plan_floor(c: dict) -> dict:
    """The plan's floors on the inputs counted by `plan_cull_counts`: the
    issue floor of the work the kernel must do there (the (point, witness)
    and (point, tile) pairs its culls keep, the culls, the points), its FP32
    operations (no FMA: the same count), and the issue floor of every
    (point, tile) pair taken without the culls (secondary)."""
    n = c["rows"] * c["plan_p"]
    ops = (c["plan_p"] * (PLAN_WITNESS_OPS * c["witnesses_kept"] + PLAN_TILE_OPS * c["tiles_kept"])
           + PLAN_POINT_OPS * n + PLAN_ROW_TILE_OPS * c["rows"] * c["tiles"])
    return {"ops": ops, "issue_floor_ms": ops / PEAK_FP32_INSTR_PER_S * 1e3,
            "all_pairs_issue_floor_ms": issue_floor_ms(float(n) * c["tiles"], PLAN_PAIR_OPS)}


def check_plan(pts_path, cloud, pts_step, cents, mesh, step_cents, step_mesh) -> dict:
    """The plan kernel against the plan in plain torch ops: the same lists,
    counts and lower bounds bit for bit, at several row sizes, on the
    render's blocked points, a random cloud and the training step's blocked
    points; timed through the wrapper (events) and as bare launches into
    preallocated outputs (device time), with its bound and issue floor from
    the witnesses and tiles its culls keep, and resources."""
    name = LISTED_PLAN_KERNEL.name
    _, tile_c, tile_r, _ = listed_tables(cents, mesh.tile_table)
    n_tiles = mesh.tile_table.shape[0]
    step_tabs = listed_tables(step_cents, step_mesh.tile_table)[1:3]
    mism, err = 0, 0.0
    for pts, tabs in ((pts_path, (tile_c, tile_r)), (cloud, (tile_c, tile_r)), (pts_step, step_tabs)):
        for plan_p in (pruned_knn._PLAN_P_LISTED, 512, 2048):
            if pts.shape[0] % plan_p:
                continue
            got = pruned_knn.listed_plan(pts, *tabs, n_tiles, plan_p)
            want = pruned_knn.listed_plan_plain(pts, *tabs, n_tiles, plan_p)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                mism += int((a != b).sum())
                diff = torch.where(a == b, 0.0, (a.double() - b.double()).abs())  # inf == inf: 0
                err = max(err, float(diff.max()))
    if mism:
        raise AssertionError(f"{name}: {mism} plan entries differ from the plain version")
    plan_p = pruned_knn._PLAN_P_LISTED
    shapes = {}
    for label, pts, tabs in (("render", pts_path, (tile_c, tile_r)), ("step", pts_step, step_tabs)):
        n = pts.shape[0]
        outs = pruned_knn.listed_plan(pts, *tabs, n_tiles, plan_p)
        bare = lambda pts=pts, tabs=tabs, outs=outs: pruned_knn.launch_plan(pts, *tabs, *outs, plan_p)
        counts = plan_cull_counts(pts, *tabs, n_tiles, plan_p)
        floor = plan_floor(counts)
        shapes[label] = {
            "points": n, **{k: counts[k] for k in counts if k.endswith(("_mean", "_max"))},
            "listed_mean": float(outs[1].float().mean()),
            "wrapper_ms": time_ms(lambda pts=pts, tabs=tabs: pruned_knn.listed_plan(
                pts, *tabs, n_tiles, plan_p), reps=10),
            "device_ms": device_turns_ms({"k": bare}, rounds=21)["k"][0],
            "issue_floor_ms": floor["issue_floor_ms"],
            "all_pairs_issue_floor_ms": floor["all_pairs_issue_floor_ms"],
            "bound": bound_ms(4.0 * (n * 3 + 9 * n_tiles + (n // plan_p) * (2 * n_tiles + 1)),
                              floor["ops"]),
        }
    s = shapes["render"]
    q = lambda sym: LISTED_PLAN_KERNEL.extra_function(sym, [ctypes.c_int] * 2)(plan_p, n_tiles)
    return {
        "name": name, "route": "cuda",
        "source": f"dual_space_nerf_tpu_torch/csrc/{LISTED_PLAN_KERNEL.source}",
        "replaces": "dual_space_nerf_tpu/ops/pruned_knn.py:643",
        "max_abs_err": err, "mismatches": mism,
        "ms": s["wrapper_ms"], "device_ms": s["device_ms"],
        "plain_ms": time_ms(lambda: pruned_knn.listed_plan_plain(pts_path, tile_c, tile_r, n_tiles, plan_p), reps=5),
        "bound_ms": s["bound"][0], "bound_by": s["bound"][1], "library_ms": None,
        "issue_floor_ms": s["issue_floor_ms"], "all_pairs_issue_floor_ms": s["all_pairs_issue_floor_ms"],
        "step": {k: v for k, v in shapes["step"].items() if k != "bound"}
        | {"bound_ms": shapes["step"]["bound"][0]},
        "resources": small_kernel_resources(
            LISTED_PLAN_KERNEL, dynamic_smem_bytes=q("listed_plan_smem"),
            blocks_per_sm=q("listed_plan_blocks_per_sm")),
        "shape": {k: s[k] for k in s if k not in ("wrapper_ms", "device_ms", "issue_floor_ms",
                                                   "all_pairs_issue_floor_ms", "bound")}
        | {"tiles": n_tiles, "plan_p": plan_p},
    }


def check_listed(kernel, slim: bool, pts_path, cloud, cents, mesh, brute_ids, library_ms,
                 brute_ms) -> dict:
    """The wide or the slim listed kernel against its plain version (every
    slot id equal) and against the brute-force kernel (equal but for
    near-ties), on the render's blocked points and a random cloud."""
    name = kernel.name
    plan_p = pruned_knn._PLAN_P_LISTED
    tables = listed_tables(cents, mesh.tile_table)
    cent_t, tile_c, tile_r, perm_pad = tables
    n_tiles = mesh.tile_table.shape[0]
    mism, ties, stats = 0, 0, {}
    for label, pts in (("path", pts_path), ("cloud", cloud)):
        order, counts, lbs = pruned_knn.listed_plan(pts, tile_c, tile_r, n_tiles, plan_p)
        for tighten in ((False,) if slim else (False, True)):
            ids_k = pruned_knn.listed_search(pts, cent_t, order, counts, lbs, plan_p, slim, tighten)
            ids_p = pruned_knn.listed_search_plain(pts, cent_t, order, counts, lbs, plan_p, slim, tighten)
            torch.cuda.synchronize()
            mism += int((ids_k != ids_p).sum())
            ties += near_tie_only(pts, cents, perm_pad[ids_k.long()], brute_ids[label], name)
        stats[label] = {"visits_mean": float(counts.float().mean()), "visits_max": int(counts.max())}
    if mism:
        raise AssertionError(f"{name}: {mism} slot ids differ from the plain version")

    pts = pts_path
    n = pts.shape[0]
    order, counts, lbs = pruned_knn.listed_plan(pts, tile_c, tile_r, n_tiles, plan_p)
    pairs = float(counts.sum()) * plan_p * 128
    n_bytes = 4.0 * (n * 3 + n + cent_t.numel() + order.numel() + lbs.numel() + counts.numel())
    b, by = bound_ms(n_bytes, PAIR_OPS * pairs)
    search = lambda: pruned_knn.listed_search(pts, cent_t, order, counts, lbs, plan_p, slim, False)
    c_plan = pruned_knn.listed_plan(cloud, tile_c, tile_r, n_tiles, plan_p)
    c_pairs = float(c_plan[1].sum()) * plan_p * 128
    return {
        "name": name, "route": "cuda",
        "source": f"dual_space_nerf_tpu_torch/csrc/{kernel.source}",
        "replaces": "dual_space_nerf_tpu/ops/pruned_knn.py:" + ("473" if slim else "539"),
        "max_abs_err": 0.0, "mismatches": mism, "near_ties_vs_brute_force": ties,
        "ms": time_ms(search, reps=10),
        "cloud_ms": time_ms(lambda: pruned_knn.listed_search(cloud, cent_t, *c_plan, plan_p, slim, False), reps=5),
        "tighten_ms": None if slim else time_ms(
            lambda: pruned_knn.listed_search(pts, cent_t, order, counts, lbs, plan_p, False, True), reps=10),
        "plan_ms": time_ms(lambda: pruned_knn.listed_plan(pts, tile_c, tile_r, n_tiles, plan_p), reps=5),
        "plan_plain_ms": time_ms(lambda: pruned_knn.listed_plan_plain(pts, tile_c, tile_r, n_tiles, plan_p), reps=3),
        "search_ms": time_ms(lambda: pruned_search_listed(
            pts, cents, mesh.tile_table, slim=slim, tighten=False, return_slots=True, tables=tables), reps=5),
        "plain_ms": time_ms(lambda: pruned_knn.listed_search_plain(
            pts, cent_t, order, counts, lbs, plan_p, slim, False), reps=1, warmup=0),
        "bound_ms": b, "bound_by": by, "library_ms": library_ms, "brute_force_ms": brute_ms,
        "issue_floor_ms": issue_floor_ms(pairs), "cloud_issue_floor_ms": issue_floor_ms(c_pairs),
        "resources": search_resources(kernel, row_stride=n_tiles),
        "shape": {"points": n, "tiles": n_tiles, "plan_p": plan_p, "pairs": pairs,
                  "cloud_pairs": c_pairs, **stats},
    }


def pruned_floor(visits, n_tiles: int, block_p: int) -> dict:
    """The pruned search's floors on one input, from the plain version's
    visits per block: the pairs it must take, the FP32 operations of the
    pairs, the sphere, the bounds and the thresholds (none fused), and
    their issue floor."""
    blocks, visits_sum = visits.shape[0], float(visits.sum())
    pairs = visits_sum * block_p * pruned_knn._BLOCK_F
    ops = (PAIR_OPS * pairs + PRUNED_POINT_OPS * blocks * block_p
           + PRUNED_BLOCK_TILE_OPS * blocks * n_tiles + PRUNED_VISIT_OPS * visits_sum * block_p)
    return {"pairs": pairs, "ops": ops, "issue_floor_ms": ops / PEAK_FP32_INSTR_PER_S * 1e3,
            "visits_mean": float(visits.float().mean()), "visits_max": int(visits.max())}


def canonical_points(pts_w, cents_w, mesh, settings):
    """The canonical points that the exact path's second search receives
    for world points ``pts_w`` (in their layout): the warp through the
    brute-force world search's faces; with the canonical centroids."""
    with torch.no_grad():
        pts_c, _, _ = warp_world_to_canonical(pts_w, mesh, cents_w, settings,
                                              fidx=nearest_face_cuda(pts_w, cents_w))
    return pts_c.contiguous(), face_centroids(mesh.verts_cano, mesh.faces).contiguous()


def check_pruned(inputs: dict, mesh, library_ms, brute_ms) -> dict:
    """The pruned kernel against its plain version (every id equal) and
    against the brute-force kernel (equal but for near-ties) at tighten 1
    and 0, on each of ``inputs`` ({label: (points, centroids)}: the render
    chunk's blocked world points, the canonical points of the same chunk,
    a random cloud); timed on each through the wrapper (events) and as
    bare launches (device time), with its bound, its issue floor from the
    plain version's visits, and its resources."""
    name = PRUNED_KERNEL.name
    block_p = pruned_knn._BLOCK_P
    mism, ties, shapes = 0, 0, {}
    for label, (pts, cents) in inputs.items():
        tabs = pruned_knn.pruned_tables(cents, mesh.face_perm)
        brute = nearest_face_cuda(pts, cents)
        for tighten in (1, 0):
            ids_k = pruned_knn.pruned_search(pts, *tabs, block_p, tighten=tighten)
            ids_p, visits = pruned_knn.pruned_search_plain(pts, *tabs, block_p, tighten=tighten,
                                                           with_visits=True)
            torch.cuda.synchronize()
            mism += int((ids_k != ids_p).sum())
            ties += near_tie_only(pts, cents, mesh.face_perm[ids_k.long()], brute, name)
            if tighten == 1:
                floor = pruned_floor(visits, tabs[3], block_p)
        n = pts.shape[0]
        out = torch.empty(n, dtype=torch.int32, device=pts.device)
        bare = {f"tighten{t}": (lambda pts=pts, tabs=tabs, t=t: pruned_knn.launch_pruned(
            pts, *tabs, out, block_p, t)) for t in (1, 0)}
        dev_ms = device_turns_ms(bare, rounds=11)
        shapes[label] = {
            "points": n, "tiles": tabs[3], **floor,
            "wrapper_ms": time_ms(lambda pts=pts, tabs=tabs: pruned_knn.pruned_search(
                pts, *tabs, block_p), reps=10),
            "device_ms": dev_ms["tighten1"][0], "device_ms_range": dev_ms["tighten1"][1],
            "tighten0_device_ms": dev_ms["tighten0"][0],
            "bound": bound_ms(4.0 * (n * 3 + n + tabs[0].numel() + 4 * tabs[3]), floor["ops"]),
        }
    if mism:
        raise AssertionError(f"{name}: {mism} ids differ from the plain version")
    pts, cents = inputs["world"]
    tabs = pruned_knn.pruned_tables(cents, mesh.face_perm)
    s = shapes["world"]
    return {
        "name": name, "route": "cuda",
        "source": f"dual_space_nerf_tpu_torch/csrc/{PRUNED_KERNEL.source}",
        "replaces": "dual_space_nerf_tpu/ops/pruned_knn.py:64",
        "max_abs_err": 0.0, "mismatches": mism, "near_ties_vs_brute_force": ties,
        "ms": s["wrapper_ms"], "device_ms": s["device_ms"],
        "search_ms": time_ms(lambda: pruned_search_presorted(pts, cents, mesh.face_perm), reps=5),
        "tables_ms": time_ms(lambda: pruned_knn.pruned_tables(cents, mesh.face_perm), reps=10),
        "plain_ms": time_ms(lambda: pruned_knn.pruned_search_plain(pts, *tabs, block_p), reps=1, warmup=0),
        "bound_ms": s["bound"][0], "bound_by": s["bound"][1], "library_ms": library_ms,
        "brute_force_ms": brute_ms, "issue_floor_ms": s["issue_floor_ms"],
        "inputs": {label: {k: v for k, v in sh.items() if k != "bound"} | {"bound_ms": sh["bound"][0]}
                   for label, sh in shapes.items()},
        "resources": search_resources(PRUNED_KERNEL),
        "shape": {"block_p": block_p},
    }


def sweep_granularity(pts, cents, mesh) -> dict:
    """The searches' times over their plan and block sizes, the figures
    behind the module defaults (`ops/pruned_knn.py`)."""
    cent_t, tile_c, tile_r, _ = listed_tables(cents, mesh.tile_table)
    n_tiles = mesh.tile_table.shape[0]
    out = {"listed": [], "pruned": []}
    for plan_p in (128, 256, 512, 1024, 2048):
        order, counts, lbs = pruned_knn.listed_plan(pts, tile_c, tile_r, n_tiles, plan_p)
        row = {"plan_p": plan_p, "visits_mean": float(counts.float().mean()),
               "plan_ms": time_ms(lambda: pruned_knn.listed_plan(pts, tile_c, tile_r, n_tiles, plan_p), reps=3)}
        for key, slim, tighten in (("wide_ms", False, False), ("tighten_ms", False, True),
                                   ("slim_ms", True, False)):
            row[key] = time_ms(lambda: pruned_knn.listed_search(
                pts, cent_t, order, counts, lbs, plan_p, slim, tighten), reps=5)
        out["listed"].append(row)
    tabs = pruned_knn.pruned_tables(cents, mesh.face_perm)
    ids = torch.empty(pts.shape[0], dtype=torch.int32, device=pts.device)
    sizes = (128, 256, 512, 1024)
    for tighten in (1, 0):  # device time of bare launches, the block sizes in turns
        t = device_turns_ms({bp: (lambda bp=bp: pruned_knn.launch_pruned(pts, *tabs, ids, bp, tighten))
                             for bp in sizes}, rounds=5)
        for bp in sizes:
            row = {"block_p": bp, "tighten": tighten, "device_ms": t[bp][0]}
            if tighten == 1:
                visits = pruned_knn.pruned_search_plain(pts, *tabs, bp, with_visits=True)[1]
                row |= {"visits_mean": float(visits.float().mean()),
                        "issue_floor_ms": pruned_floor(visits, tabs[3], bp)["issue_floor_ms"]}
            out["pruned"].append(row)
    return out


def kernel_family(name: str) -> str:
    """The family of a kernel in a profiler trace, by its name."""
    name = name.lower()
    if "gg_kernel" in name:
        return "gg_near_far kernel"
    if "nearest_face" in name:
        return "nearest_face kernel"
    if "listed_plan" in name:
        return "listed plan kernel"
    if "listed" in name or "pruned_kernel" in name:  # with the listed row order
        return "tile-pruned search kernel"
    if "fused_mlp" in name:
        return "fused SpaceNet kernels"
    if "gemm" in name or "cutlass" in name or "xmma" in name:
        return "matrix products (cuBLAS)"
    if "index" in name or "gather" in name or "scatter" in name:
        return "gathers / index ops"
    if "sort" in name or "radix" in name:
        return "sorts"
    return "elementwise and reductions"


def profile_device(fn) -> dict:
    """Device time of one call of ``fn`` by kernel family (torch.profiler).
    The profiler is warmed up by one call of ``fn`` and records the next:
    port kernels early in a cold trace were missing from it in earlier runs.
    ``missed``: the port kernels' families with fewer calls in the trace
    than the recorded call launched (the launch counts)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    traced = []  # the recorded call's events, kept when its trace is ready
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        reset_launches()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launched = launches_now()
        prof.step()
    fam: dict[str, float] = {}
    calls: dict[str, int] = {}
    kernels = []
    if len(traced) != 1:
        raise AssertionError(f"profile_device: {len(traced)} traces recorded, expected 1")
    for ev in traced[0]:
        # host-side ops: no double count; the step's span on the device is no kernel
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("ProfilerStep"):
            continue
        ms = ev.self_device_time_total / 1e3
        kernels.append((ev.key, ms, ev.count))
        k = kernel_family(ev.key)
        fam[k] = fam.get(k, 0.0) + ms
        calls[k] = calls.get(k, 0) + ev.count
    expected: dict[str, int] = {}
    for k in KERNELS:
        if launched[k.name]:
            f = KERNEL_FAMILY[k.name]
            expected[f] = expected.get(f, 0) + launched[k.name]
    total = sum(fam.values())
    top = sorted(kernels, key=lambda x: -x[1])[:10]
    return {
        "wall_ms_profiled": wall_ms,
        "device_ms": total if total else "not measured",
        "kernel_launches": sum(c for _, _, c in kernels),
        "by_family_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
        "port_kernels_launched": launched,
        "missed": {f: {"launched": n, "in_trace": calls.get(f, 0)}
                   for f, n in expected.items() if calls.get(f, 0) < n},
        "top_kernels": [{"name": n[:90], "ms": t, "calls": c} for n, t, c in top],
    }


def profile_chunk(model, rays, mesh, settings, light) -> dict:
    """Device time of one render chunk by kernel family."""
    return profile_device(lambda: render_rays(model, rays, mesh, settings, light, device="cuda"))


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches_now() -> dict:
    return {k.name: k.launches for k in KERNELS}


def render_path(label, cfg, model, ds, item, rays0, mesh, expect: dict, n_timed: int,
                reference=None, pack: str = "f32") -> tuple:
    """Render the full image on one path through `ImageRenderer.render_item`:
    a warm-up, the counted run (launch counts asserted against ``expect``),
    timed runs, finiteness, PSNR. ``pack``: the device-to-host copy's
    precision (float32 unless asked: the image checks compare floats).
    Returns (the images, the launch counts, a function that profiles one
    chunk of this path, the report). A profiler session leaves the host's
    later launches slower, so the profiles run after every timed run of
    the script."""
    dev = torch.device("cuda")
    settings = RenderSettings.from_cfg(cfg)
    renderer = ImageRenderer(model, settings, ds.faces, ds.canonical_vertex,
                             chunk=cfg.TEST.RAY_CHUNK, device=dev, pack=pack)
    renderer.render_item(item)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = renderer.render_item(item)  # this path's counted run
    times = [time.perf_counter() - t0]
    launches = launches_now()
    if launches != expect:
        raise AssertionError(f"{label}: launches per image {launches}, expected {expect}")
    for _ in range(n_timed - 1):
        t0 = time.perf_counter()
        renderer.render_item(item)
        times.append(time.perf_counter() - t0)
    for name, img in out.items():  # disparity where the ray holds opacity
        vals = img if not name.endswith("_disp") else img[out[name[:-len("disp")] + "acc"] > 1e-3]
        if not np.isfinite(vals).all():
            raise AssertionError(f"{label}: {name}: non-finite values in the render")
    n_rays = int(item["ray_o"].shape[0])
    mask = np.asarray(item["mask_at_box"]).reshape(H, W)
    s_img = statistics.median(times)
    render = {
        "path": label, "pack": pack, "rays": n_rays, "chunks": -(-n_rays // cfg.TEST.RAY_CHUNK),
        "launches_per_image": launches,
        "s_per_image": s_img, "s_per_image_runs": times, "rays_per_s": n_rays / s_img,
        "psnr_box": psnr(out["coarse_color"], item["img"], mask),
        "psnr_image": psnr(out["coarse_color"], item["img"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if reference is not None:
        render["psnr_box_vs_exact_render"] = psnr(out["coarse_color"], reference["coarse_color"], mask)
        render["max_abs_color_vs_exact_render"] = float(
            np.abs(out["coarse_color"] - reference["coarse_color"]).max())
        render["max_abs_acc_vs_exact_render"] = float(
            np.abs(out["coarse_acc"] - reference["coarse_acc"]).max())
    log("render: " + json.dumps(render))

    def profile_later() -> None:
        prof = profile_chunk(model, rays0, mesh, settings, LightState.identity(dev))
        if isinstance(prof["device_ms"], float):
            # device time of all chunks over the unprofiled wall time
            prof["device_busy_share_est"] = prof["device_ms"] * render["chunks"] / (s_img * 1e3)
        log(f"profile_chunk {label}: " + json.dumps(prof))

    return out, launches, profile_later, render


# ---- the fused SpaceNet kernels -------------------------------------------
FUSED_SIZES = (352_000, 88_000, 100_003)  # density pass, color pass, a ragged count


def fused_macs(with_color: bool, backward: bool) -> float:
    """Multiply-adds per point of the fused chain's algebra (`ops/fused_mlp.py`)."""
    w, pe, x, e = 256, 63, 87, 128
    backbone = x * w + 3 * w * w + (w * w + pe * w) + 2 * w * w       # h1..h7
    u_chain = 6 * w * w + 2 * pe * w                                   # u6..u1, gpe
    heads = w * e + e * 3                                              # e1, essence
    if not backward:
        return backbone + w + (heads + u_chain if with_color else 0)
    n = backbone + (6 * w * w + x * w + pe * w)                        # dz6..dz1, xbar
    n += x * w + 6 * w * w + pe * w + w                                # k1..k8 gradients
    if with_color:
        n += 3 * w * e + 6 * e                                         # e1, de1, k9/k10, dh7
        n += u_chain                                                   # u-chain, gpe
        n += 6 * w * w + 2 * pe * w                                    # gb1..gb7
        n += 6 * w * w + 2 * pe * w + w                                # second-order gradients
    return n


def fused_bound(n: int, with_color: bool, backward: bool, peak: float = PEAK_FP32_PER_S) -> tuple[float, str]:
    """The fused chain's bound on ``n`` points: its bytes over the memory
    rate against its operations over ``peak`` (FP32 on the CUDA cores, or
    PEAK_BF16_PER_S: the tensor cores, for the fast pair's bf16 products)."""
    per_point = (87 + 1 + (66 if with_color else 0)) if not backward else (
        87 + 1 + 87 + ((3 + 63 + 63) if with_color else 0))
    n_bytes = 4.0 * (n * per_point + fused_mlp.W_FLOATS + (fused_mlp.G_FLOATS if backward else 0))
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2.0 * fused_macs(with_color, backward) * n / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def train_world_points(batch, mesh, settings, blocked: bool = False) -> torch.Tensor:
    """The 352,000 world points of the train batch (5500 rays x 64 samples),
    formed by the pipeline's own steps: GG and jittered z. blocked: in the
    listed search's block-coherent layout, its tail padded as the search
    pads it (352,256 points), as the production step's plan takes them."""
    dev = torch.device("cuda")
    with torch.no_grad():
        rays = batch.rays
        gen = torch.Generator(device=dev).manual_seed(7)
        u, _ = draw_randoms(rays.ray_o.shape[0], settings.n_samples, gen, dev)
        z = sample_z(rays, mesh, settings, u)
        pts = sample_along_rays(rays.ray_o, rays.ray_d, z)
        if not blocked:
            return pts.reshape(-1, 3).contiguous()
        to_blocked, _ = _block_layout(*z.shape, settings.block_sc)
        return pruned_knn._pad_edge(to_blocked(pts).contiguous(), pruned_knn._BLOCK_P_LISTED).contiguous()


def fused_check_inputs(model, batch, mesh, settings, pts_w):
    """352,000 canonical points of the train batch (`train_world_points`
    through the world search and the warp), and their kernel input
    x = [pe | code | pose]."""
    with torch.no_grad():
        rays = batch.rays
        pts_c, _, _ = warp_world_to_canonical(pts_w, mesh, face_centroids(mesh.verts_world, mesh.faces),
                                              settings)
        code, pf = model.frame_code(rays.frame), model.pose_feature(rays.body_pose)
        x = fused_mlp.build_x(*_fused_inputs(pts_c, code, pf, 1.0))
    return pts_c.contiguous(), code, pf, x


def _rel_err(got, want, keep=None) -> tuple[float, float]:
    if keep is not None:
        got, want = got[keep], want[keep]
    err = float((got - want).abs().max())
    return err, err / (float(want.abs().max()) + 1e-30)


def unfused_chain(model, pts_c, code, pf, with_color: bool, cots=None):
    """The unfused SpaceNet chain (cuBLAS + autograd): forward with the
    autograd normal; with ``cots`` also the (double) backward of a loss on
    its outputs."""
    n = pts_c.shape[0]
    with torch.enable_grad():
        pc = pts_c.detach().requires_grad_(True)
        ess, dens = model.sigma_essence(pc, code, pf.expand(n, 16), 1.0, density_only=not with_color)
        outs = [dens[:, 0]]
        if with_color:
            (normal,) = torch.autograd.grad(dens.sum(), pc, create_graph=cots is not None)
            outs += [ess, normal]
        if cots is not None:
            model.zero_grad(set_to_none=True)
            sum((o * c).sum() for o, c in zip(outs, cots)).backward()


def fused_chain(model, pts_c, code, pf, with_color: bool, cots, fast: bool = False):
    """The same through the fused kernels' autograd functions."""
    with torch.enable_grad():
        pc = pts_c.detach().requires_grad_(True)
        pe, cp = _fused_inputs(pc, code, pf, 1.0)
        params = fused_mlp.nerf_params(model.nerf)
        if with_color:
            outs = fused_mlp.fused_sigma_essence_normal(params, pe, cp, fast=fast)
        else:
            outs = (fused_mlp.fused_sigma(params, pe, cp, fast=fast),)
        model.zero_grad(set_to_none=True)
        sum((o * c).sum() for o, c in zip(outs, cots)).backward()


def flip_report(got, want, band: float, kinks) -> dict:
    """Where a mask-dependent output of a kernel and of its plain version
    part by more than ``band`` of the reference's max-abs scale, over all
    points (kinks: `fused_mlp.kink_distances`, (N, 8)): how many points,
    how many of them the check keeps (must be 0), their largest distance
    from a kink over all eight ReLUs and over the backbone's seven, and the
    largest error on the points the check leaves out."""
    err = (got - want).abs().reshape(got.shape[0], -1).amax(1)
    scale = float(want.abs().max()) + 1e-30
    beyond = err > band * scale
    near = kinks.amin(1) <= KINK
    some = bool(beyond.any())
    return {
        "beyond_band_points": int(beyond.sum()),
        "beyond_band_kept": int((beyond & ~near).sum()),
        "kink_of_beyond_band_max": float(kinks[beyond].amin(1).max()) if some else None,
        "backbone_kink_of_beyond_band_max": float(kinks[beyond, :7].amin(1).max()) if some else None,
        "left_out_max_rel_err": float(err[near].max()) / scale if bool(near.any()) else 0.0,
    }


def fused_variant(w, wflat, x, with_color: bool, gen, fast: bool = False) -> tuple[dict, tuple]:
    """One variant of the fused pair against its plain versions on ``x``.
    Points within KINK of a ReLU's kink are left out of the mask-dependent
    outputs (gpe, xbar) and, for the weight gradients, their cotangents are
    zeroed; everything else is held to the bands. A second backward with
    every cotangent reports what the left-out points do (`flip_report`).

    fast: the bfloat16-fed kernels, held to the oracle of their plain
    versions instead (`fused_mlp.check_fast_kernels`), with the same
    cotangents. Returns the report and the cotangents the check used."""
    dev = x.device
    n = x.shape[0]
    rnd = lambda *sh: torch.randn(*sh, dtype=torch.float32, device=dev, generator=gen)
    cots = (rnd(n), rnd(n, 3), rnd(n, 63)) if with_color else (rnd(n), None, None)
    if fast:
        v = {"fast": True, **fused_mlp.check_fast_kernels(w, x, cots, with_color, ALT_BLOCKS)}
        v["kink_share"] = float((fused_mlp.kink_distances(w, x, True).amin(1) <= KINK).float().mean())
        return v, cots
    kinks = fused_mlp.kink_distances(w, x)
    keep = kinks.amin(1) > KINK
    v = {"with_color": with_color, "fast": fast, "points": n,
         "kink_points_left_out": int((~keep).sum()), "kink_share_left_out": float((~keep).float().mean())}
    got = fused_mlp.fused_fwd(w, x, with_color, wflat)
    want = fused_mlp.fused_fwd_plain(w, x, with_color)
    xb, gp, gr = fused_mlp.fused_bwd(w, x, *cots, with_color, wflat)
    xb_p, _, gr_p = fused_mlp.fused_bwd_plain(w, x, *cots, with_color)
    if with_color and not torch.equal(got[2], gp):  # the same routines on the same rows
        raise AssertionError("fused kernels: the forward's gpe differs from the backward's")
    errs = [_rel_err(got[0], want[0])]
    if with_color:
        errs += [_rel_err(got[1], want[1]), _rel_err(got[2], want[2], keep)]
        v["gpe_flips"] = flip_report(got[2], want[2], FWD_TOL, kinks)
    v["fwd_max_abs_err"], v["fwd_max_rel_err"] = max(e[0] for e in errs), max(e[1] for e in errs)
    v["xbar_flips"] = flip_report(xb, xb_p, BWD_TOL, kinks)
    v["grads_all_cotangents_max_rel_err"] = max(_rel_err(gr[k].reshape(t.shape), t)[1] for k, t in gr_p.items())
    kept = tuple(c * (keep if c.dim() == 1 else keep[:, None]) if c is not None else None for c in cots)
    xb, gp, gr = fused_mlp.fused_bwd(w, x, *kept, with_color, wflat)
    xb_p, gp_p, gr_p = fused_mlp.fused_bwd_plain(w, x, *kept, with_color)
    errs = [_rel_err(xb, xb_p, keep)]
    if with_color:
        errs.append(_rel_err(gp, gp_p, keep))
    v["bwd_max_abs_err"], v["bwd_max_rel_err"] = max(e[0] for e in errs), max(e[1] for e in errs)
    g_errs = {k: _rel_err(gr[k].reshape(t.shape), t) for k, t in gr_p.items()}
    worst = max(g_errs, key=lambda k: g_errs[k][1])
    v["grads_max_rel_err"], v["grads_worst"] = g_errs[worst][1], worst
    v["bwd_max_abs_err"] = max(v["bwd_max_abs_err"], max(e[0] for e in g_errs.values()))
    torch.cuda.synchronize()
    if v["fwd_max_rel_err"] > FWD_TOL or v["bwd_max_rel_err"] > BWD_TOL or v["grads_max_rel_err"] > BWD_TOL:
        raise AssertionError(f"fused kernels differ from their plain versions: {v}")
    v["bwd_max_rel_err"] = max(v["bwd_max_rel_err"], v["grads_max_rel_err"])
    return v, kept


def check_fused_random(n: int = 352_000) -> None:
    """The same check on a randomly initialised SpaceNet and seeded inputs
    (as `tests/test_torch_port_cuda.py` makes them), both variants, float32
    and bfloat16-fed."""
    dev = torch.device("cuda")
    model = DualSpaceNeRF(max_frames=4, generator=torch.Generator().manual_seed(0)).to(dev)
    w = {k: v.detach() for k, v in fused_mlp.pack(fused_mlp.nerf_params(model.nerf)).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    x = fused_mlp.build_x(posenc(0.3 * torch.randn(n, 3, device=dev, generator=gen), 10),
                          torch.randn(n, 24, device=dev, generator=gen))
    for fast in (False, True):
        for with_color in (False, True):
            v, _ = fused_variant(w, fused_mlp.flat_weights(w), x, with_color, gen, fast)
            log("fused random weights: " + json.dumps(v))


def check_fused(model, pts_c, code, pf, x_all, fast: bool = False, model_bf16=None) -> tuple[dict, dict]:
    """Both fused kernels in both variants against their plain versions at
    the training step's shapes (`fused_variant`), and timed. Returns the
    forward and backward kernel rows (their numbers per production step:
    the density pass over 352,000 points plus the color pass over 88,000).

    fast: the bfloat16-fed pair, each kernel timed in turns with the
    float32 kernel and with the unfused bfloat16 chain (``model_bf16``:
    SpaceNet at compute_dtype bfloat16, cuBLAS + autograd), its bound at the
    bf16 tensor-core rate of its products' type."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    w = {k: v.detach() for k, v in fused_mlp.pack(fused_mlp.nerf_params(model.nerf)).items()}
    wflat = fused_mlp.flat_weights(w)
    wb = fused_mlp.fast_weights(w) if fast else None  # built once, as wflat is
    gen = torch.Generator(device=dev).manual_seed(11)
    chain_model = model_bf16 if fast else model
    variants = []
    for with_color in (False, True):
        for n in FUSED_SIZES:
            x = x_all[:n].contiguous()
            v, (sbar, ebar, gbar) = fused_variant(w, wflat, x, with_color, gen, fast)
            if n != FUSED_SIZES[2]:
                v["fwd_plain_ms"] = time_ms(lambda: fused_mlp.fused_fwd_plain(w, x, with_color, fast), reps=3)
                v["bwd_plain_ms"] = time_ms(
                    lambda: fused_mlp.fused_bwd_plain(w, x, sbar, ebar, gbar, with_color, fast), reps=3)
                # the bound at the peak of the products' type: bf16 x bf16 with
                # float32 sums (tensor cores) for the fast pair, else FP32
                peak = PEAK_BF16_PER_S if fast else PEAK_FP32_PER_S
                v["fwd_bound_ms"], v["fwd_bound_by"] = fused_bound(n, with_color, False, peak)
                v["bwd_bound_ms"], v["bwd_bound_by"] = fused_bound(n, with_color, True, peak)
                pc = pts_c[:n]
                cots = [sbar] + ([ebar, torch.randn(n, 3, device=dev, generator=gen)] if with_color else [])
                # each kernel and its unfused chain in turns, in this call; the
                # fast pair also with the float32 kernel
                fwd = {"fwd": lambda: fused_mlp.fused_fwd(w, x, with_color, wflat, fast, wb),
                       "unfused_fwd": lambda: unfused_chain(chain_model, pc, code, pf, with_color)}
                bwd = {"bwd": lambda: fused_mlp.fused_bwd(w, x, sbar, ebar, gbar, with_color, wflat, fast, wb),
                       "unfused_fwd_bwd": lambda: unfused_chain(chain_model, pc, code, pf, with_color, cots)}
                if fast:
                    fwd["fwd_f32"] = lambda: fused_mlp.fused_fwd(w, x, with_color, wflat)
                    bwd["bwd_f32"] = lambda: fused_mlp.fused_bwd(w, x, sbar, ebar, gbar, with_color, wflat)
                for alt in (fwd, bwd):
                    for key, (med, spread) in alternate_ms(alt, rounds=5).items():
                        v[f"{key}_ms"], v[f"{key}_ms_range"] = med, spread
                for tag in ("fwd", "bwd"):
                    v[f"{tag}_bound_share"] = v[f"{tag}_bound_ms"] / v[f"{tag}_ms"]
                v["fused_fwd_bwd_ms"] = time_ms(lambda: fused_chain(model, pc, code, pf, with_color, cots, fast),
                                                reps=3)
            variants.append(v)
            log("fused: " + json.dumps(v))
    model.zero_grad(set_to_none=True)
    step = [v for v in variants if (v["points"], v["with_color"]) in ((352_000, False), (88_000, True))]
    exact = next(v for v in variants if (v["points"], v["with_color"]) == (352_000, True))
    kernels = ((FUSED_FWD_FAST_KERNEL, "fwd", "unfused_fwd"), (FUSED_BWD_FAST_KERNEL, "bwd", "unfused_fwd_bwd")) \
        if fast else ((FUSED_FWD_KERNEL, "fwd", "unfused_fwd"), (FUSED_BWD_KERNEL, "bwd", "unfused_fwd_bwd"))
    for kernel, tag, unfused in kernels:
        keys = (f"{tag}_ms", f"{tag}_bound_ms", f"{unfused}_ms") + (
            (f"{tag}_f32_ms",) if fast else ())
        log(f"{kernel.name}: " + json.dumps({
            **fused_resources(kernel),
            "production_step": {key: sum(v[key] for v in step) for key in keys},
            "exact_step": {key: exact[key] for key in keys},
            "production_bound_share": sum(v[f"{tag}_bound_ms"] for v in step) / sum(v[f"{tag}_ms"] for v in step),
            "exact_bound_share": exact[f"{tag}_bound_share"],
            "ranges_ms": {f"{v['points']} {'color' if v['with_color'] else 'density'}":
                          {key: v[f"{key}_ms_range"] for key in (tag, unfused) + ((f"{tag}_f32",) if fast else ())}
                          for v in variants if f"{tag}_ms_range" in v},
        }))
    rows = {}
    for kernel, tag, _ in kernels:
        replaces = "294" if tag == "fwd" else "311"
        bounds = [v[f"{tag}_bound_ms"] for v in step]
        unfused = "unfused_fwd" if tag == "fwd" else "unfused_fwd_bwd"
        rows[tag] = {
            "name": kernel.name, "route": "cuda",
            "source": f"dual_space_nerf_tpu_torch/csrc/{kernel.source}",
            "replaces": f"dual_space_nerf_tpu/ops/fused_mlp.py:{replaces}",
            "max_abs_err": max(v[f"{tag}_max_abs_err"] for v in variants),
            "max_rel_err": max(v[f"{tag}_max_rel_err"] for v in variants),
            "ms": sum(v[f"{tag}_ms"] for v in step),
            "plain_ms": sum(v[f"{tag}_plain_ms"] for v in step),
            "bound_ms": sum(bounds), "bound_by": step[0][f"{tag}_bound_by"],
            "library_ms": None,
            "bound_share": sum(bounds) / sum(v[f"{tag}_ms"] for v in step),
            ("unfused_bf16_chain_ms" if fast else "unfused_chain_ms"): sum(v[f"{unfused}_ms"] for v in step),
            "note": "per production step: density-only at 352,000 points + with color at 88,000",
        }
        if fast:
            shares = [v["oracle_beyond_band_share"] for v in variants]
            rows[tag] |= {"f32_kernel_ms": sum(v[f"{tag}_f32_ms"] for v in step),
                          "oracle_beyond_band_share_max": {k: max(sh[k] for sh in shares) for k in shares[0]},
                          "note": rows[tag]["note"] + "; bound_ms at the bf16 tensor-core rate of its "
                                  "products' type; oracle_beyond_band_share: the points beyond the bands "
                                  "against the float64 oracle, of the kernel and of the two float32 plain "
                                  "orders"}
    return rows["fwd"], rows["bwd"]


def ptxas_entries(kernel) -> dict:
    """Per entry function of a kernel's library, from its `ptxas -v` lines
    in this run's build: registers, static shared memory, and spilled bytes
    (stores + loads) in the entry itself and summed over the device
    functions listed after it (routines it calls out of line)."""
    out, cur, key = {}, None, None
    for line in kernel.build_log.splitlines():
        if "Compiling entry function" in line:
            cur = re.search(r"'([^']+)'", line)[1]
            out[cur] = {"registers": None, "static_smem_bytes": 0,
                        "kernel_spill_bytes": 0, "functions_spill_bytes": 0}
            key = "kernel_spill_bytes"
        elif cur and "spill" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[cur][key] += int(m[1]) + int(m[2])
        elif cur and "Used" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", line)[1])
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem_bytes"] = int(m[1]) if m else 0
            key = "functions_spill_bytes"
    return out


def entry_resources(kernel, pattern: str) -> dict:
    """`ptxas_entries` of the one entry whose name matches ``pattern``."""
    found = [v for name, v in ptxas_entries(kernel).items() if re.search(pattern, name)]
    return dict(found[0]) if found else {"registers": "not measured (no build in this run)"}


def search_resources(kernel, row_stride: int = 0) -> dict:
    """A search kernel's resources per variant: `entry_resources`, the
    dynamic shared memory of a block and the resident blocks per SM (the
    occupancy query of the library), and the kernel's points per block."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    q = lambda sym, *args: kernel.extra_function(f"{kernel.name}_{sym}", [ctypes.c_int] * len(args))(*args)
    out = {}
    if kernel is NEAREST_KERNEL:
        for label, split in (("whole", 0), ("split", 1)):
            v = entry_resources(kernel, rf"nearest_face_kernelILb{split}E")
            v["dynamic_smem_bytes"] = 0
            v["blocks_per_sm"] = q("blocks_per_sm", split)
            out[label] = v
        out["block_points"] = q("block_points", 0)
    elif kernel is PRUNED_KERNEL:
        block_p = pruned_knn._BLOCK_P
        v = entry_resources(kernel, rf"pruned_kernelILi{q('points_per_thread', block_p)}E")
        v["dynamic_smem_bytes"] = 0
        v["blocks_per_sm"] = q("blocks_per_sm", block_p)
        out["main"] = v
        out["blocks_per_sm_by_block_p"] = {bp: q("blocks_per_sm", bp) for bp in (128, 256, 512, 1024)}
        out["block_points"] = block_p
        out["points_per_thread"] = q("points_per_thread", block_p)
    else:
        wide = kernel is LISTED_KERNEL
        for label, tighten in ((("wide", 0), ("tighten", 1)) if wide else (("slim", 0),)):
            v = entry_resources(kernel, rf"listed_kernelILb{int(wide)}ELb{tighten}E")
            v["dynamic_smem_bytes"] = q("smem", row_stride, tighten)
            v["blocks_per_sm"] = q("blocks_per_sm", row_stride, tighten)
            out[label] = v
        out["block_points"] = pruned_knn.LISTED_BLOCK_P
    out["sms"] = sms
    return out


def small_kernel_resources(kernel, **queried) -> dict:
    """GG's or the plan's registers, spills and static shared memory
    (`ptxas_entries` of its one entry), the SMs, and what its caller queried
    of the library (``queried``: dynamic shared memory, blocks per SM)."""
    entries = ptxas_entries(kernel)
    if not entries:
        return {"registers": "not measured (no build in this run)"}
    return {**next(iter(entries.values())), **queried,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}


def sass_counts(kernel) -> dict:
    """Per function of a kernel's library, from its SASS (`cuobjdump -sass`
    of this run's build): the tensor-core MMA instructions (HMMA) and the
    FP32 FMAs (FFMA)."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                     "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", kernel.library_path()], capture_output=True, text=True,
                          timeout=300).stdout
    counts, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(m[1], {"HMMA": 0, "FFMA": 0})
        elif cur is not None:
            for op in cur:
                cur[op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def fused_resources(kernel) -> dict:
    """A fused kernel's registers and spilled bytes (stores + loads) per
    variant (`entry_resources`, from the build log of its library: a fast
    launcher's ``base`` built it, its kernels in namespace fmlp_tc); its
    dynamic shared memory and resident blocks per SM (the occupancy query
    the wrapper sizes its grid by), its tile and its scratch per block (the
    fast backward: its record per tile); the HMMA and FFMA instructions of
    the library's SASS, summed over the fast kernels' functions (fmlp_tc)
    and over the float32 kernels' (`sass_counts`)."""
    dev = torch.device("cuda")
    built = kernel.base or kernel
    fast = kernel.base is not None
    entry = f"{built.name}_tc_kernel" if fast else f"{built.name}_kernel"
    out = {}
    for label, color in (("density", 0), ("with_color", 1)):
        v = entry_resources(built, rf"{entry}ILb{color}E")
        out[label] = {k: v[k] for k in ("registers", "kernel_spill_bytes", "functions_spill_bytes") if k in v}
        if fast and built is fused_mlp.BWD_KERNEL:  # the weight-gradient pass
            g = entry_resources(built, rf"fused_mlp_wgrad_kernelILb{color}E")
            out[label]["wgrad_pass"] = {k: g[k] for k in ("registers", "kernel_spill_bytes") if k in g}
    query = lambda sym, color=0: built.extra_function(f"{built.name}_{sym}", [ctypes.c_int])(color)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, color in (("density", False), ("with_color", True)):
        blocks = fused_mlp._blocks(kernel, f"{kernel.name}_blocks", dev, color)
        v = out[label]
        v["blocks_per_sm"] = blocks / sms
        if not fast:
            v["scratch_bytes_per_block"] = 4 * query("scratch", int(color))
        elif built is fused_mlp.FWD_KERNEL:
            v["scratch_bytes_per_block"] = 2 * query("fast_scratch", int(color))
        else:
            v["record_bytes_per_tile"] = 2 * query("fast_record", int(color))
    out["dynamic_smem_bytes"] = query("fast_smem" if fast else "smem")
    if fast and built is fused_mlp.BWD_KERNEL:
        out["wgrad_pass_dynamic_smem_bytes"] = query("fast_wgrad_smem")
    out["tile_points"] = query("tile")
    sass = sass_counts(built)
    if sass:
        out["sass"] = {side: {op: sum(c[op] for name, c in sass.items() if ("7fmlp_tc" in name) == tc)
                              for op in ("HMMA", "FFMA")}
                       for side, tc in (("fast_functions", True), ("float32_functions", False))}
    else:
        out["sass"] = "not measured (no cuobjdump)"
    return out


# ---- the training step -------------------------------------------------------
def train_path(label, production: bool, fused: bool, batch, mesh, expect: dict,
               model_opts: dict | None = None) -> tuple:
    """`make_train_step` on one path from the fixture's weights and the same
    draws: a counted first step (launches asserted against ``expect``, its
    gradients kept), timed steps. ``model_opts``: MODEL keys set over
    `train_cfg`'s (FUSED_FAST, MATMUL_PRECISION, FINE_RAY_SAMPLING). Returns
    (report, grads, a function that profiles one more step and adds its
    device time to the report; run after every timed run, as
    `render_path`'s)."""
    dev = torch.device("cuda")
    cfg = train_cfg(production, fused)
    for key, value in (model_opts or {}).items():
        cfg.MODEL[key] = value
    settings = RenderSettings.from_cfg(cfg)
    model = trained_model(cfg.MODEL.MAX_FRAMES, compute_dtype(cfg)).to(dev)
    state = create_train_state(model, cfg)
    step = make_train_step(settings, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = [draw_randoms(TRAIN_RAYS, settings.n_samples, gen, dev, settings.n_fine)
             for _ in range(N_TIMED_STEPS + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    m = step(state, batch, mesh, randoms=draws[0])  # this path's counted run
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launches_now()
    if launches != expect:
        raise AssertionError(f"train {label}: launches per step {launches}, expected {expect}")
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    losses = [float(m["loss"])]
    times = []
    for i in range(N_TIMED_STEPS):
        t0 = time.perf_counter()
        m = step(state, batch, mesh, randoms=draws[1 + i])
        losses.append(float(m["loss"]))  # a host copy: the step has ended
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train {label}: non-finite loss {losses}")
    s_step = statistics.median(times)
    report = {
        "path": label, "rays": TRAIN_RAYS, "points": TRAIN_RAYS * (2 * settings.n_samples + settings.n_fine)
        if settings.n_fine else TRAIN_RAYS * settings.n_samples,
        "launches_per_step": launches, "first_step_s": first_s,
        "s_per_step": s_step, "s_per_step_runs": times, "rays_per_s": TRAIN_RAYS / s_step,
        "losses": losses, "psnr_last": float(m["psnr"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"train {label}: " + json.dumps(report))

    def profile_later() -> None:
        prof = profile_device(lambda: step(state, batch, mesh, randoms=draws[-1]))
        report["device_ms_per_step"] = prof["device_ms"]
        report["device_busy_share_est"] = (prof["device_ms"] / (s_step * 1e3)
                                           if isinstance(prof["device_ms"], float) else "not measured")
        log(f"profile_step {label}: " + json.dumps({k: report[k] for k in (
            "device_ms_per_step", "device_busy_share_est")} | {"profile": prof}))

    return report, grads, profile_later


def compare_grads(label, g_fused: dict, g_plain: dict, tol: float = 1e-3) -> dict:
    """Per tensor max |fused - unfused| over the unfused max: the worst is
    reported; a NaN or a ratio above ``tol`` fails the run."""
    ratios = {}
    for n, b in g_plain.items():
        a = g_fused[n]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"train {label}: non-finite gradient in {n}")
        ratios[n] = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
    worst = max(ratios, key=ratios.get)
    out = {"path": label, "worst_tensor": worst, "worst_ratio": ratios[worst],
           "tensors_beyond_2e-5": sorted(k for k, r in ratios.items() if r > BWD_TOL)}
    log(f"grads {label}: " + json.dumps(out))
    if ratios[worst] > tol:
        raise AssertionError(f"train {label}: fused and unfused gradients differ: {out}")
    return out


def golden_leg(label, golden, model, expect: dict, **kwargs) -> dict:
    """Render golden legs on the card, hold them to the bands and the
    kernels to the launch counts; returns the launch counts."""
    reset_launches()
    report = check_golden(render_golden(golden, device=torch.device("cuda"), model=model, **kwargs),
                          golden)
    launches = launches_now()
    log(f"golden {label}: " + json.dumps({**report, "launches": launches}))
    if not report["ok"]:
        raise AssertionError(f"golden {label}: render outside its bands")
    if launches != expect:
        raise AssertionError(f"golden {label}: launches {launches}, expected {expect}")
    return launches


# ---- the cluster-pruned and expanded-form searches --------------------------
def check_searches(pts_rs, cents, mesh) -> dict:
    """`KNN_IMPL` "grouped" (the chunk's ray-major points in sub-groups of
    4 consecutive samples, as the renderer forms them), "clustered" and
    "xla" against the brute-force kernel on the render chunk's world
    points: ids equal on every point nearer than SEARCH_NEAR to its face
    but at float32 near-ties, elsewhere at most SEARCH_MISS_MAX of the
    points on a face that is no near-tie; "xla" only to near-ties of its
    own expanded form (8 float32 ulps of |p|^2 + |c|^2). Each timed (CUDA
    events, median) beside the kernel. Torch ops, not kernels of the port:
    they stay out of the `kernels` line."""
    pts = pts_rs.reshape(-1, 3).contiguous()
    table = mesh.cluster_table
    brute = nearest_face_cuda(pts, cents)
    p64, c64 = pts.double(), cents.double()
    d_brute = ((p64 - c64[brute.long()]) ** 2).sum(-1)
    near = d_brute.sqrt() < SEARCH_NEAR
    runs = {
        "grouped": lambda: nearest_face_grouped(pts_rs.reshape(-1, 4, 3), cents, table).reshape(-1),
        "clustered": lambda: nearest_face_clustered(pts, cents, table),
        "xla": lambda: nearest_face_xla(pts, cents),
    }
    report = {"points": pts.shape[0], "near_points": int(near.sum()),
              "brute_force_kernel_ms": time_ms(lambda: nearest_face_cuda(pts, cents), reps=10)}
    eps32 = float(torch.finfo(torch.float32).eps)
    for name, fn in runs.items():
        ids = fn()
        off = ids != brute
        d_got = ((p64 - c64[ids.long()]) ** 2).sum(-1)
        gap = (d_got - d_brute).abs()
        tie = gap <= 1e-6 * torch.minimum(d_got, d_brute)
        row = {"differ": int(off.sum()), "near_tie": int((off & tie).sum())}
        if name == "xla":
            scale = (p64 * p64).sum(-1) + torch.maximum((c64[ids.long()] ** 2).sum(-1),
                                                       (c64[brute.long()] ** 2).sum(-1))
            row["beyond_own_ties"] = int((off & (gap > 8 * eps32 * scale)).sum())
            ok = row["beyond_own_ties"] == 0
        else:
            row["near_misses"] = int((off & near & ~tie).sum())
            row["far_miss_share"] = float((off & ~near & ~tie).sum()) / max(1, int((~near).sum()))
            ok = row["near_misses"] == 0 and row["far_miss_share"] <= SEARCH_MISS_MAX
        row["ms"] = time_ms(fn, reps=5)
        report[name] = row
        if not ok:
            log("searches: " + json.dumps(report))
            raise AssertionError(f"search {name}: ids depart from the brute-force kernel: {row}")
    log("searches: " + json.dumps(report))
    return report


# ---- LPIPS -------------------------------------------------------------------
def lpips_phase(image: np.ndarray, gt: np.ndarray, card: str, dev=torch.device("cuda")) -> dict:
    """LPIPS alex and vgg (seeded random weights in the converted npz
    layout: no pretrained weights are in the repo) of ``image`` against
    ``gt`` ([0, 1] BGR, 512x512) on the card, held to the same function on
    the CPU within LPIPS_REL; ms per image pair on the card (events,
    median; the images already on the card)."""
    out = {"card": card, "image": list(image.shape)}
    with tempfile.TemporaryDirectory() as d:
        for net in ("alex", "vgg"):
            path = os.path.join(d, f"lpips_{net}.npz")
            np.savez(path, **random_lpips_params(net, np.random.default_rng(77)),
                     **{"meta/net": np.array(net)})
            got = make_lpips_npz(net, path, device=dev)(image, gt)
            want = make_lpips_npz(net, path, device="cpu")(image, gt)
            rel = abs(got - want) / abs(want)
            params, _ = load_lpips_params(path, dev)
            x0, x1 = (torch.as_tensor(np.ascontiguousarray(2.0 * x[..., ::-1] - 1.0, np.float32), device=dev)
                      for x in (image, gt))
            out[net] = {"card": got, "cpu": want, "rel": rel,
                        "ms": time_ms(lambda: lpips_distance(params, x0, x1, net), reps=5)}
            if not rel <= LPIPS_REL:
                raise AssertionError(f"lpips {net}: card {got} against CPU {want} ({rel:.2e} relative)")
    log("lpips: " + json.dumps(out))
    return out


# ---- data parallel -------------------------------------------------------------
def dp_rank(rank: int, inputs: str, out_dir: str) -> None:
    """A rank of the two-process phase (spawned; gloo on CUDA tensors, both
    ranks on the one card): the production fused step on its share of the
    inputs' global batch and draws, then N_TIMED_STEPS timed steps; saves
    its first step's loss and gradients and s_per_step."""
    d = torch.load(inputs, weights_only=False)
    dev = d["device"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not maybe_initialize_distributed("gloo"):
        raise AssertionError("dp_rank: no process group")
    try:
        cfg = train_cfg(production=True, fused=True)
        model = trained_model(cfg.MODEL.MAX_FRAMES).to(dev)
        state = create_train_state(model, cfg)
        step = make_train_step(RenderSettings.from_cfg(cfg), device=dev, group=global_ray_group())
        m = step(state, d["batch"], d["mesh"], d["draws"][0])
        first = {"loss": float(m["loss"]),
                 "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()}}
        times = []
        for i in range(N_TIMED_STEPS):
            t0 = time.perf_counter()
            float(step(state, d["batch"], d["mesh"], d["draws"][1 + i])["loss"])
            times.append(time.perf_counter() - t0)
        torch.save({**first, "s_per_step": statistics.median(times), "s_per_step_runs": times},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _held(label: str, loss: float, grads: dict, want_loss: float, want: dict, tol: float) -> dict:
    """Loss relative gap and the worst gradient gap over its tensor's
    largest entry against the one-process step; fails beyond ``tol``."""
    ratios = {n: float((grads[n].to(w.device) - w).abs().max()) / (float(w.abs().max()) + 1e-30)
              for n, w in want.items()}
    worst = max(ratios, key=ratios.get)
    row = {"loss_rel": abs(loss - want_loss) / abs(want_loss), "worst_tensor": worst,
           "worst_ratio": ratios[worst],
           "bitwise_equal": all(torch.equal(grads[n].to(w.device), w) for n, w in want.items())}
    if not (row["loss_rel"] <= tol and row["worst_ratio"] <= tol):
        raise AssertionError(f"data parallel {label}: departs from the one-process step: {row}")
    return row


def data_parallel_phase(batch, mesh, ds, item, out_prod, card, dev=torch.device("cuda", 0)) -> dict:
    """The data-parallel paths on the one card: (1) the production fused
    step through a one-rank NCCL group (the rank's share is the whole
    batch; the flat all-reduce runs), (2) two processes on the card with
    gloo, each on 2750 of the 5500 rays, (3) `ImageRenderer(devices=
    [cuda:0, cuda:0])` (every chunk split in halves) on the production
    image. (1) and (2) are held to the one-process step from the same
    weights and draws within DP_TOL, (3) to the production image (b) within
    the golden bands. s_per_step of each step, s_per_image of (3)."""
    import torch.distributed as dist

    cfg = train_cfg(production=True, fused=True)
    settings = RenderSettings.from_cfg(cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = [draw_randoms(TRAIN_RAYS, settings.n_samples, gen, dev) for _ in range(N_TIMED_STEPS + 1)]

    def run(step) -> tuple:
        model = trained_model(cfg.MODEL.MAX_FRAMES).to(dev)
        state = create_train_state(model, cfg)
        m = step(state, batch, mesh, draws[0])
        loss = float(m["loss"])
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        times = []
        for i in range(N_TIMED_STEPS):
            t0 = time.perf_counter()
            float(step(state, batch, mesh, draws[1 + i])["loss"])
            times.append(time.perf_counter() - t0)
        return loss, grads, statistics.median(times)

    report = {"card": card, "rays": TRAIN_RAYS}
    loss1, grads1, s1 = run(make_train_step(settings, device=dev))
    report["one_process"] = {"s_per_step": s1}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        loss_g, grads_g, s_g = run(make_train_step(settings, device=dev, group=dist.group.WORLD))
    finally:
        dist.destroy_process_group()
    report["nccl_one_rank"] = {"s_per_step": s_g, **_held("nccl", loss_g, grads_g, loss1, grads1, DP_TOL)}
    with tempfile.TemporaryDirectory() as d:
        inputs = os.path.join(d, "inputs.pt")
        torch.save({"batch": batch, "mesh": mesh, "draws": draws, "device": dev}, inputs)
        t0 = time.perf_counter()
        spawn_ranks(dp_rank, 2, args=(inputs, d), timeout=600)
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    for n in grads1:
        if not torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]):
            raise AssertionError(f"data parallel gloo: the ranks' gradients of {n} differ")
    report["gloo_two_processes"] = {
        "rays_per_rank": TRAIN_RAYS // 2, "s_per_step": [r["s_per_step"] for r in ranks],
        "s_per_step_runs": [r["s_per_step_runs"] for r in ranks], "spawn_wall_s": wall,
        **_held("gloo", ranks[0]["loss"], ranks[0]["grads"], loss1, grads1, DP_TOL)}
    # (3) the production image with every chunk split over two replicas
    model = trained_model(cfg.MODEL.MAX_FRAMES).eval()
    renderer = ImageRenderer(model, RenderSettings.from_cfg(production_cfg()), ds.faces,
                             ds.canonical_vertex, chunk=production_cfg().TEST.RAY_CHUNK,
                             devices=[dev, dev], pack="f32")
    renderer.render_item(item)  # warm-up; render_item ends in its host copy
    t0 = time.perf_counter()
    out = renderer.render_item(item)
    times = [time.perf_counter() - t0]
    box = np.asarray(item["mask_at_box"]).reshape(-1)
    errs = {}
    for key, band in (("color", 5e-4), ("acc", 1e-4), ("depth", 1e-4)):
        a = out[f"coarse_{key}"].reshape(-1, 3 if key == "color" else 1)[box]
        b = out_prod[f"coarse_{key}"].reshape(-1, 3 if key == "color" else 1)[box]
        err = np.abs(a - b).max(1) / (np.maximum(1.0, np.abs(b).max(1)) if key == "depth" else 1.0)
        errs[key] = {"worst_over_band": float(err.max() / band), "share_within": float((err <= band).mean())}
        if err.max() > band:
            raise AssertionError(f"data parallel render: {key} departs from the production image: {errs}")
    report["render_two_replicas"] = {"s_per_image": statistics.median(times), "s_per_image_runs": times,
                                     "vs_production": errs}
    log("data parallel: " + json.dumps(report))
    return report


# ---- the mesh extraction ----------------------------------------------------
def mesh_phase(model, ds, item, settings, card: str) -> dict:
    """`Visualizer3D` on the trained fixture and the val item's posed mesh at
    MESH_RESOLUTION: the density volume (the warp's brute-force search and
    `density_grid` in chunks of 100,000 grid points) and the marching
    tetrahedra timed apart, then the user's entry points: `extract_mesh`
    to an .obj (the same mesh) and `render_turntable` to one PNG. Fails
    unless the mesh is non-empty and inside the item's bounds (within a grid
    step), the launches are the chunks' searches and every file has its
    signature. Prints the `mesh:` line."""
    dev = torch.device("cuda")
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, dev)
    bounds = np.asarray(item["bounds"], np.float64)
    viz = Visualizer3D(model, settings, resolution=MESH_RESOLUTION, device=dev)
    n_points = MESH_RESOLUTION ** 3
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        grid, origin, spacing = viz.density_volume(mesh, bounds, 0, item["poses"])  # ends in a host copy
        density_s = time.perf_counter() - t0
        launches = launches_now()
        want = {**{k.name: 0 for k in KERNELS}, NEAREST_KERNEL.name: -(-n_points // viz.chunk)}
        if launches != want:
            raise AssertionError(f"mesh: launches {launches}, expected {want}")
        t0 = time.perf_counter()
        verts, faces = marching_tetrahedra(grid, viz.level, origin, spacing)
        marching_s = time.perf_counter() - t0
        obj = os.path.join(tmp, "mesh.obj")
        t0 = time.perf_counter()
        v2, f2 = viz.extract_mesh(mesh, bounds, 0, item["poses"], out_path=obj)
        extract_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # one view: each takes ~20 s of host rasterization
        frames = viz.render_turntable(mesh, bounds, 0, item["poses"], out_dir=os.path.join(tmp, "turntable"),
                                      n_views=1, size=512)
        turntable_s = time.perf_counter() - t0
        if len(faces) == 0 or not (np.array_equal(v2, verts) and np.array_equal(f2, faces)):
            raise AssertionError(f"mesh: {len(faces)} faces, or extract_mesh gave another mesh")
        if (verts < bounds[0] - spacing).any() or (verts > bounds[1] + spacing).any():
            raise AssertionError("mesh: vertices outside the item's bounds")
        with open(obj, encoding="ascii") as f:
            lines = f.read().splitlines()
        if sum(ln.startswith("v ") for ln in lines) != len(verts) or sum(
                ln.startswith("f ") for ln in lines) != len(faces):
            raise AssertionError("mesh: the .obj does not hold the mesh")
        pngs = sorted(glob.glob(os.path.join(tmp, "turntable", "mesh_*.png")))
        if len(pngs) != 1 or any(png_size(p) != (512, 512) for p in pngs):
            raise AssertionError(f"mesh: turntable PNGs {pngs}")
        if not all((fr.sum(-1) > 0).mean() > 0.01 for fr in frames):
            raise AssertionError("mesh: an empty turntable frame")
        out = {"resolution": MESH_RESOLUTION, "grid_points": n_points, "density_volume_s": density_s,
               "grid_points_per_s": n_points / density_s, "marching_tetrahedra_s": marching_s,
               "extract_mesh_s": extract_s, "render_turntable_1_view_s": turntable_s,
               "vertices": int(len(verts)), "faces": int(len(faces)), "obj_bytes": os.path.getsize(obj),
               "occupied_share": float((grid > viz.level).mean()), "launches": launches, "card": card}
    log("mesh: " + json.dumps(out))
    return out


# ---- the user's CLIs --------------------------------------------------------
# the synthetic scene at 512x512, 313_tpu.yml's model block with the listed
# search and the fused kernels, bench.py's train workload (5500 rays a step);
# read by the port's own config reader
CLI_CFG = """\
MODEL:
  TYPE: "nerf"
  COARSE_RAY_SAMPLING: 64
  FINE_RAY_SAMPLING: -1
  SAMPLE_METHOD: "NEAR_FAR"
  SAME_SPACENET: False
  sample_points_mode: "GG"
  TKERNEL_INC_RAW: True
  POSE_REFINEMENT: False
  USE_DIR: True
  LOSS: 'L2'
  LOSSwMask: False
  SHADE_TOPK: 16
  REUSE_WARP_FACES: True
  KNN_IMPL: "listed"
  FUSED_MLP: "on"
DATASETS:
  TYPE: "synthetic"
  HUMAN: "capsule"
  SYNTHETIC_SIZE: 512
  SYNTHETIC_FRAMES: 2
  SYNTHETIC_VIEWS: 2
DATALOADER:
  NUM_WORKERS: 2
SOLVER:
  OPTIMIZER_NAME: "Adam"
  MAX_EPOCHS: 3
  BASE_LR: 0.0005
  WEIGHT_DECAY: 0.0
  START_ITERS: 3000
  END_ITERS: 60000
  LR_SCALE: 0.09
  WARMUP_ITERS: 1000
  CHECKPOINT_PERIOD: 1
  LOG_PERIOD: 1
  TRAIN_NRAYS: 5500
TEST:
  IMS_PER_BATCH: 1
  RAY_CHUNK: 8192
  light_center: []
"""
CLI_STEP_LINE = re.compile(r"Epoch\[(\d+)\] Iteration\[(\d+)/(\d+)\] Loss: (\S+) Psnr: (\S+)")


def png_size(path: str) -> tuple[int, int]:
    """(height, width) from a PNG's header; fails on anything else."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise AssertionError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def check_pngs(root: str, expect_n: int, size: tuple = (H, W)) -> int:
    """Every PNG under ``root`` has the image's size ``size`` (render |
    ground truth side by side under img/); returns their count, which must
    be ``expect_n``."""
    paths = glob.glob(os.path.join(root, "**", "*.png"), recursive=True)
    h, w = size
    for path in paths:
        want = (h, 2 * w) if f"{os.sep}img{os.sep}" in path else (h, w)
        if png_size(path) != want:
            raise AssertionError(f"{path}: size {png_size(path)}, expected {want}")
    if len(paths) != expect_n:
        raise AssertionError(f"{root}: {len(paths)} PNGs, expected {expect_n}")
    return len(paths)


@contextlib.contextmanager
def cli_session(prefix: str, env_keys: tuple, images: list | None = None):
    """A temporary working directory for the CLIs, entered; the loop's step
    calls timed on the host clock (each ended by a synchronize) and
    render_item timed per image (it ends in the host copy). Yields (step
    seconds, image seconds, ray chunks per image), three lists the timers
    append to; ``images``, when given, receives a copy of each image's
    outputs. On exit restores the variables ``env_keys`` names, the timed
    functions, the CLI logger (it holds log.txt open) and the working
    directory, and deletes the directory."""
    step_times, image_times, image_chunks = [], [], []
    make_step, render_item = train_loop.make_train_step, ImageRenderer.render_item

    def timed_make_step(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - t0)
            return out

        return timed

    def timed_render(self, item, *a, **k):
        image_chunks.append(-(-int(item["ray_o"].shape[0]) // self.chunk))
        t0 = time.perf_counter()
        out = render_item(self, item, *a, **k)
        image_times.append(time.perf_counter() - t0)
        if images is not None:
            images.append({key: np.array(v, copy=True) for key, v in out.items()})
        return out

    work = tempfile.mkdtemp(prefix=prefix)
    cwd = os.getcwd()
    saved_env = {k: os.environ.get(k) for k in env_keys}
    train_loop.make_train_step, ImageRenderer.render_item = timed_make_step, timed_render
    try:
        os.chdir(work)
        yield step_times, image_times, image_chunks
    finally:
        train_loop.make_train_step, ImageRenderer.render_item = make_step, render_item
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        logger = logging.getLogger("NERFRender")
        for h in logger.handlers:
            h.close()
        logger.handlers = []
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def cli_phase(card: str) -> dict:
    """Train (two calls, the second resuming), validate and test through
    the port's CLIs on the card, in a temporary directory (`cli_session`)."""
    zero = {k.name: 0 for k in KERNELS}
    t_phase = time.perf_counter()
    with cli_session("dsnerf_cli_", ("DSNERF_VAL_PERIOD", "DSNERF_LOADER_BACKEND")) as (
            step_times, image_times, _):
        os.environ["DSNERF_VAL_PERIOD"] = "0"
        with open("cli.yml", "w", encoding="utf-8") as f:
            f.write(CLI_CFG)
        exp = os.path.join("EXP", "smoke")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps = []
        for max_epochs, backend in ((3, "thread"), (4, "process")):  # epochs 1-2, then a resume
            os.environ["DSNERF_LOADER_BACKEND"] = backend
            state = cli_train.main(["-c", "cli.yml", "--exp", "smoke", "--max_epochs", str(max_epochs)])
            steps.append(state.step)
        train_launches = launches_now()
        if steps != [8, 12]:
            raise AssertionError(f"cli: steps after each train call {steps}, expected [8, 12]")
        ckpts = sorted(n for n in os.listdir(exp) if n.endswith(".ckpt"))
        want_ckpts = [f"model_epoch_{e:07d}.ckpt" for e in (1, 2, 3)]
        with open(os.path.join(exp, "last_checkpoint"), encoding="utf-8") as f:
            tag = f.read().strip()
        if ckpts != want_ckpts or tag != want_ckpts[-1]:
            raise AssertionError(f"cli: checkpoints {ckpts}, tag {tag!r}")
        want = {**zero, GG_KERNEL.name: 12, LISTED_PLAN_KERNEL.name: 12, LISTED_KERNEL.name: 12,
                FUSED_FWD_KERNEL.name: 24, FUSED_BWD_KERNEL.name: 24}
        if train_launches != want:
            raise AssertionError(f"cli train: launches {train_launches}, expected {want}")
        with open(os.path.join(exp, "log.txt"), encoding="utf-8") as f:
            log_text = f.read()
        logged = [m.groups() for m in CLI_STEP_LINE.finditer(log_text)]
        losses = [float(g[3]) for g in logged]
        if len(logged) != 9 or not np.isfinite(losses).all():  # 3 lines an epoch (read one step late)
            raise AssertionError(f"cli train: logged steps {logged}")
        epoch_s = {int(e): float(t) for e, t in
                   re.findall(r"Epoch (\d+) done\. Time: (\S+)\[s\]", log_text)}
        probe = Checkpointer(os.path.join(os.getcwd(), "probe"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.save("probe", state, 3)
        save_ms = (time.perf_counter() - t0) * 1e3
        del state
        torch.cuda.empty_cache()

        ckpt = os.path.join(exp, want_ckpts[-1])
        cfg = load_cfg("cli.yml")
        _, val_set = select_dataset(cfg, train_nrays=TRAIN_RAYS)
        chunks = sum(-(-int(val_set[i]["ray_o"].shape[0]) // cfg.TEST.RAY_CHUNK)
                     for i in range(len(val_set)))
        per_chunk = {**zero, GG_KERNEL.name: 1, LISTED_PLAN_KERNEL.name: 1, LISTED_KERNEL.name: 1,
                     FUSED_FWD_KERNEL.name: 2}
        evals = {}
        for label, fn, n_images in (("validate", cli_validate.main, len(val_set)),
                                    ("test", cli_test.main, 2 * len(val_set))):
            reset_launches()
            del image_times[:]
            res = fn(["-c", "cli.yml", "--exp", "smoke", "--ckpt", ckpt])
            launched = launches_now()
            want = {k: v * chunks * n_images // len(val_set) for k, v in per_chunk.items()}
            if launched != want:
                raise AssertionError(f"cli {label}: launches {launched}, expected {want}")
            for r in (res if isinstance(res, tuple) else (res,)):
                if not (np.isfinite(list(r.values())).all() and 0.0 < r["ssim"] <= 1.0):
                    raise AssertionError(f"cli {label}: metrics {r}")
            evals[label] = {"images": len(image_times), "s_per_image": statistics.median(image_times),
                            "s_per_image_runs": list(image_times), "chunks": chunks * n_images // len(val_set),
                            "launches": launched, "metrics": res}
        n_val_png = check_pngs(os.path.join(exp, "vis"), 3 * len(val_set))
        n_test_png = check_pngs(os.path.join("TEST", "smoke"), 2 * 5 * len(val_set))
        report = {
            "steps": steps, "s_per_step": statistics.median(step_times[8:]),
            "s_per_step_runs": step_times[8:], "epoch1_s_warmup": epoch_s.get(1),
            "epoch_s": epoch_s, "epoch_s_per_step": {e: t / 4 for e, t in epoch_s.items()},
            "epoch3_loader": "process", "first_call_step_s": step_times[:8],
            "rays_per_s": TRAIN_RAYS / statistics.median(step_times[8:]),
            "losses_logged": losses, "psnr_logged": [float(g[4]) for g in logged],
            "ckpt_bytes": os.path.getsize(ckpt), "ckpt_save_ms": save_ms,
            "train_launches": train_launches,
            "validate": evals["validate"], "test": evals["test"], "pngs": n_val_png + n_test_png,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "phase_s": time.perf_counter() - t_phase, "card": card,
        }
    log("train loop: " + json.dumps(report))
    return report


# ---- a JAX-trained avatar's checkpoint through the CLIs ---------------------
#: the JAX package's `Checkpointer.save` of the trained fixture's params and
#: Adam's state after two updates (`scripts/make_jax_ckpt_fixture.py`)
JAX_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                        "jax_trained_s233.ckpt")
#: phase 8's config with the fixture's 16-frame embedding, one frame x two
#: views: two steps an epoch, two val images
JAX_CKPT_CFG = (CLI_CFG.replace("MODEL:\n", "MODEL:\n  MAX_FRAMES: 16\n", 1)
                .replace("SYNTHETIC_FRAMES: 2", "SYNTHETIC_FRAMES: 1"))


def tree_difference(a, b, at: str = "") -> str:
    """Where two state dicts (nested dicts, lists, tensors, numbers) first
    differ, every tensor compared bit for bit; "" where they are equal."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and a.device == b.device and torch.equal(a, b))
        return "" if same else f"{at}: {a!r:.200} against {b!r:.200}"
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return f"{at}: keys {sorted(map(str, a))} against {sorted(map(str, b)) if isinstance(b, dict) else b!r}"
        return next((d for k in a if (d := tree_difference(a[k], b[k], f"{at}/{k}"))), "")
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return f"{at}: {a!r:.200} against {b!r:.200}"
        return next((d for i, (x, y) in enumerate(zip(a, b)) if (d := tree_difference(x, y, f"{at}/{i}"))), "")
    return "" if a == b else f"{at}: {a!r} against {b!r}"


def jax_ckpt_phase(card: str) -> dict:
    """The JAX package's `.ckpt` (`JAX_CKPT`, flax msgpack) through the
    port's CLIs on the card, in a temporary directory (`cli_session`):

    (a) `cli.validate --ckpt` the JAX `.ckpt` renders the val images of the
        `.npz` of the same params bit for bit (every output of every image,
        the metrics, the PNG bytes);
    (b) `cli.train` resumes the JAX run's EXP directory from its
        `last_checkpoint` tag for two steps, and the same two steps from a
        port `.ckpt` saved right after loading the JAX one: the checkpoints
        they write hold the same params, Adam state, schedule and step, bit
        for bit.

    Each CLI call's launches are counted from 0 and must be the production
    path's; prints the `jax ckpt:` line (the reader's decode ms of the file,
    the load into a train state on the card, the step times, the card)."""
    from dual_space_nerf_tpu_torch.cli.common import build_model
    from dual_space_nerf_tpu_torch.evaluation.golden import TRAINED_NPZ
    from dual_space_nerf_tpu_torch.models import load_flax_npz
    from dual_space_nerf_tpu_torch.training.flax_ckpt import read_flax_checkpoint

    zero = {k.name: 0 for k in KERNELS}
    t_phase = time.perf_counter()
    decode_ms = []
    for _ in range(5):  # the first read may find the file outside the page cache
        t0 = time.perf_counter()
        ckpt = read_flax_checkpoint(JAX_CKPT)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    n_floats = sum(int(v.size) for v in ckpt.params.values())
    images = []
    with cli_session("dsnerf_jax_ckpt_", ("DSNERF_VAL_PERIOD", "DSNERF_LOADER_BACKEND",
                                          "DSNERF_DETERMINISTIC_DATA"), images) as (step_times, image_times, _):
        os.environ["DSNERF_VAL_PERIOD"] = "0"
        os.environ["DSNERF_LOADER_BACKEND"] = "thread"
        os.environ["DSNERF_DETERMINISTIC_DATA"] = "1"  # both resumed runs see the same batches
        with open("cli.yml", "w", encoding="utf-8") as f:
            f.write(JAX_CKPT_CFG)
        cfg = load_cfg("cli.yml")
        _, val_set = select_dataset(cfg, train_nrays=TRAIN_RAYS)
        chunks = sum(-(-int(val_set[i]["ray_o"].shape[0]) // cfg.TEST.RAY_CHUNK) for i in range(len(val_set)))
        per_chunk = {**zero, GG_KERNEL.name: 1, LISTED_PLAN_KERNEL.name: 1, LISTED_KERNEL.name: 1,
                     FUSED_FWD_KERNEL.name: 2}
        # (a) validate from the JAX .ckpt and from the .npz of its params
        val_runs = {}
        for label, path in (("jax_ckpt", JAX_CKPT), ("npz", TRAINED_NPZ)):
            del images[:], image_times[:]
            reset_launches()
            metrics = cli_validate.main(["-c", "cli.yml", "--exp", label, "--ckpt", path])
            launched = launches_now()
            want = {k: v * chunks for k, v in per_chunk.items()}
            if launched != want:
                raise AssertionError(f"jax ckpt validate {label}: launches {launched}, expected {want}")
            pngs = sorted(glob.glob(os.path.join("EXP", label, "vis", "**", "*.png"), recursive=True))
            png_bytes = {}
            for png in pngs:
                with open(png, "rb") as f:
                    png_bytes[os.path.relpath(png, os.path.join("EXP", label))] = f.read()
            val_runs[label] = {"metrics": metrics, "images": list(images), "pngs": png_bytes,
                               "s_per_image": list(image_times)}
        a, b = val_runs["jax_ckpt"], val_runs["npz"]
        if len(a["images"]) != len(val_set) or len(a["pngs"]) != 3 * len(val_set):
            raise AssertionError(f"jax ckpt validate: {len(a['images'])} images, {len(a['pngs'])} PNGs")
        same_images = all(set(x) == set(y) and all(x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
                                                   and x[k].tobytes() == y[k].tobytes() for k in x)
                          for x, y in zip(a["images"], b["images"]))  # bits: NaN outputs included
        if not (same_images and a["metrics"] == b["metrics"] and a["pngs"] == b["pngs"]):
            raise AssertionError("jax ckpt validate: the JAX .ckpt's images differ from the .npz's")
        if not (np.isfinite(list(a["metrics"].values())).all() and 0.0 < a["metrics"]["ssim"] <= 1.0):
            raise AssertionError(f"jax ckpt validate: metrics {a['metrics']}")

        # (b) two steps resumed from the JAX run's EXP directory (its tag),
        # and from a port .ckpt saved right after loading the JAX one
        for exp in ("jax", "port"):
            os.makedirs(os.path.join("EXP", exp))
        shutil.copyfile(JAX_CKPT, os.path.join("EXP", "jax", "model_epoch_0000001.ckpt"))
        with open(os.path.join("EXP", "jax", "last_checkpoint"), "w", encoding="utf-8") as f:
            f.write("model_epoch_0000001.ckpt")
        dev = torch.device("cuda")
        state = create_train_state(build_model(cfg, seed=1).to(dev), cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, epoch = Checkpointer(os.path.join("EXP", "port")).load(JAX_CKPT, state)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        if (state.step, epoch) != (ckpt.step, ckpt.epoch):
            raise AssertionError(f"jax ckpt load: step {state.step}, epoch {epoch}")
        Checkpointer(os.path.join("EXP", "port")).save("model_epoch_0000001", state, epoch)
        del state
        finals, train_launches = {}, {}
        for exp in ("jax", "port"):
            del step_times[:]
            reset_launches()
            st = cli_train.main(["-c", "cli.yml", "--exp", exp, "--max_epochs", "3"])
            train_launches[exp] = launches_now()
            n = len(step_times)
            want = {**zero, GG_KERNEL.name: n, LISTED_PLAN_KERNEL.name: n, LISTED_KERNEL.name: n,
                    FUSED_FWD_KERNEL.name: 2 * n, FUSED_BWD_KERNEL.name: 2 * n}
            if n != 2 or st.step != ckpt.step + 2 or train_launches[exp] != want:
                raise AssertionError(f"jax ckpt train {exp}: {n} steps to step {st.step}, "
                                     f"launches {train_launches[exp]}")
            finals[exp] = {"payload": torch.load(os.path.join("EXP", exp, "model_epoch_0000002.ckpt"),
                                                 map_location="cpu", weights_only=True),
                           "step_s": list(step_times)}
            del st
        x, y = finals["jax"]["payload"], finals["port"]["payload"]
        for key in ("model", "optimizer", "scheduler", "step", "epoch"):
            if diff := tree_difference(x[key], y[key], key):
                raise AssertionError(f"jax ckpt train: resumed from the JAX .ckpt against the port "
                                     f".ckpt, {diff}")
        moved = max(float((x["model"][k] - v).abs().max()) for k, v in load_flax_npz(TRAINED_NPZ).items())
        if not moved > 0.0:
            raise AssertionError("jax ckpt train: the resumed steps moved no parameter")
    report = {
        "ckpt_bytes": os.path.getsize(JAX_CKPT), "params_floats": n_floats,
        "decode_ms": decode_ms, "load_into_cuda_state_ms": load_ms,
        "validate_bit_equal_to_npz": True, "validate_s_per_image": a["s_per_image"],
        "validate_s_per_image_npz": b["s_per_image"], "val_images": len(val_set),
        "val_metrics": a["metrics"], "resumed_steps_bit_equal": True,
        "step_s_jax_ckpt": finals["jax"]["step_s"], "step_s_port_ckpt": finals["port"]["step_s"],
        "max_param_move": moved, "train_launches": train_launches["jax"],
        "phase_s": time.perf_counter() - t_phase, "card": card,
    }
    log("jax ckpt: " + json.dumps(report))
    return report


# ---- the user's CLIs on a ZJU-MoCap tree ------------------------------------
# the committed ZJU-313-shaped tree of bench.py's cold epoch: annots.npy with
# 21 cameras, 16 frames x 3 views of 1024x1024 JPEGs with mask_cihp PNGs, the
# per-frame SMPL assets at the synthetic scene's V=6890 / F=13,776
COLD_TREE = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_cold_tree",
                         "CoreView_313")
ZJU_CLI_CFG = (CLI_CFG.replace('TYPE: "synthetic"', 'TYPE: "zju_mocap"')
               .replace('HUMAN: "capsule"', 'HUMAN: "CoreView_313"')
               .replace("  SYNTHETIC_SIZE: 512\n  SYNTHETIC_FRAMES: 2\n  SYNTHETIC_VIEWS: 2\n", "")
               .replace("NUM_WORKERS: 2", "NUM_WORKERS: 3")  # 313_tpu.yml's
               .replace("light_center: []", "light_center: [0.21903692, -0.17755836, 1.1463718]"))
# frames are 0-based indices here (the tree's files are 1..16); the eval view
# is "Camera (10)" (view 9, not a train view): camera 1's frames under the
# name, with camera 1's parameters in annots slot 9
ZJU_DATA_CFG = """\
Train:
  views: [0, 1, 2]
  ratio: 0.5
  begin: 0
  end: {train_end}
Val:
  ratio: 0.5
  begin: 0
  end: 15
  intv: 8
Test:
  ratio: 0.5
  begin: 0
  end: 15
  intv: 8
  novel_pose_begin: 8
"""


def zju_tree(work: str) -> str:
    """A data dir whose CoreView_313 reads the committed tree in place
    (symlinks) and adds the eval view "Camera (10)" (camera 1's frames and
    parameters) that validate, test and novel_pose_vis read. Returns the
    data dir; nothing is written into the committed tree."""
    data_dir = os.path.join(work, "zju_mocap")
    root = os.path.join(data_dir, "CoreView_313")
    os.makedirs(os.path.join(root, "mask_cihp"))
    for name in os.listdir(COLD_TREE):
        if name not in ("annots.npy", "mask_cihp"):
            os.symlink(os.path.join(COLD_TREE, name), os.path.join(root, name))
    for name in os.listdir(os.path.join(COLD_TREE, "mask_cihp")):
        os.symlink(os.path.join(COLD_TREE, "mask_cihp", name), os.path.join(root, "mask_cihp", name))
    for sub in ("", "mask_cihp"):
        os.symlink(os.path.join(COLD_TREE, sub, "Camera (1)"), os.path.join(root, sub, "Camera (10)"))
    annots = np.load(os.path.join(COLD_TREE, "annots.npy"), allow_pickle=True).item()
    for key in ("K", "R", "T", "D"):
        annots["cams"][key] = list(annots["cams"][key])
        annots["cams"][key][9] = annots["cams"][key][0]
    np.save(os.path.join(root, "annots.npy"), annots)
    return data_dir


def zju_cli_phase(card: str) -> dict:
    """The user's CLIs on the ZJU-shaped tree: `cli.train` for one cold
    epoch over the 48 items (threads, every item a first touch: JPEG and
    PNG decode, mask dilation, x0.5 resize, sample pools), a resumed call
    of one epoch over 6 items on the forked-process loader, then
    `cli.validate` (2 images), `cli.test` (2), `cli.vis_lighting` (its 10
    angles) and `cli.novel_pose_vis` (2 poses at the branch's ratio 1,
    1024x1024) on the last checkpoint. Launch counts exact per step and per
    chunk rendered (`cli_session` counts the chunks of each image)."""
    from dual_space_nerf_tpu_torch.cli import novel_pose_vis as cli_npv
    from dual_space_nerf_tpu_torch.cli import vis_lighting as cli_vl
    from dual_space_nerf_tpu_torch.data import zju as zju_data
    from dual_space_nerf_tpu_torch.data.cameras import Undistorter
    from dual_space_nerf_tpu_torch.data.smpl import write_body_model
    from dual_space_nerf_tpu_torch.data.synthetic import make_scene

    decode_ms = []
    imread_jpeg = zju_data.imread

    def timed_imread(path):
        t0 = time.perf_counter()
        out = imread_jpeg(path)
        if path.endswith(".jpg"):
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    zero = {k.name: 0 for k in KERNELS}
    t_phase = time.perf_counter()
    env_keys = ("DSNERF_VAL_PERIOD", "DSNERF_LOADER_BACKEND", "DSNERF_ZJU_PATH", "DSNERF_SMPL_PATH")
    zju_data.imread = timed_imread
    try:
        with cli_session("dsnerf_zju_", env_keys) as (step_times, image_times, image_chunks):
            work = os.getcwd()
            # build and load the host libraries (JPEG, PNG, remap) before
            # anything is timed: a checkout compiles them at first use
            first = sorted(glob.glob(os.path.join(COLD_TREE, "Camera (1)", "*.jpg")))[0]
            frame = imread(first)
            imread(os.path.join(COLD_TREE, "mask_cihp", "Camera (1)",
                                os.path.basename(first)[:-4] + ".png"))
            Undistorter()(np.zeros((8, 8), np.uint8), np.eye(3), np.array([0.1, 0.0, 0.0, 0.0, 0.0]))
            data_dir = zju_tree(work)
            verts = np.load(os.path.join(COLD_TREE, "X_smpl_vertices.npy")).squeeze()
            write_body_model("SMPL_NEUTRAL.pkl", make_scene(h=8, w=8).faces, len(verts))
            os.environ.update({"DSNERF_VAL_PERIOD": "0", "DSNERF_ZJU_PATH": data_dir,
                               "DSNERF_SMPL_PATH": os.path.join(work, "SMPL_NEUTRAL.pkl")})
            os.makedirs(os.path.join("data_configs", "zju_mocap"))
            data_cfg = os.path.join("data_configs", "zju_mocap", "CoreView_313.yml")
            with open("zju.yml", "w", encoding="utf-8") as f:
                f.write(ZJU_CLI_CFG)
            exp = os.path.join("EXP", "zju")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            steps, wall = [], []
            # epoch 1: all 48 items, cold; epoch 2 (resumed): frames 1-2, 6 items
            for train_end, max_epochs, backend in ((15, 2, "thread"), (1, 3, "process")):
                with open(data_cfg, "w", encoding="utf-8") as f:
                    f.write(ZJU_DATA_CFG.format(train_end=train_end))
                os.environ["DSNERF_LOADER_BACKEND"] = backend
                t0 = time.perf_counter()
                state = cli_train.main(["-c", "zju.yml", "--exp", "zju", "--max_epochs", str(max_epochs)])
                wall.append(time.perf_counter() - t0)
                steps.append(state.step)
            train_launches = launches_now()
            if steps != [48, 54]:
                raise AssertionError(f"zju: steps after each train call {steps}, expected [48, 54]")
            n_cold_decodes = len(decode_ms)
            per_step = {**zero, GG_KERNEL.name: 1, LISTED_PLAN_KERNEL.name: 1, LISTED_KERNEL.name: 1,
                        FUSED_FWD_KERNEL.name: 2, FUSED_BWD_KERNEL.name: 2}
            want = {k: v * 54 for k, v in per_step.items()}
            if train_launches != want:
                raise AssertionError(f"zju train: launches {train_launches}, expected {want}")
            with open(os.path.join(exp, "log.txt"), encoding="utf-8") as f:
                log_text = f.read()
            logged = [m.groups() for m in CLI_STEP_LINE.finditer(log_text)]
            losses = [float(g[3]) for g in logged]
            if not logged or not np.isfinite(losses).all() or not np.isfinite(
                    [float(g[4]) for g in logged]).all():
                raise AssertionError(f"zju train: logged steps {logged}")
            epoch_s = {int(e): float(t) for e, t in
                       re.findall(r"Epoch (\d+) done\. Time: (\S+)\[s\]", log_text)}
            ckpts = sorted(n for n in os.listdir(exp) if n.endswith(".ckpt"))
            if ckpts != ["model_epoch_0000001.ckpt", "model_epoch_0000002.ckpt"]:
                raise AssertionError(f"zju: checkpoints {ckpts}")
            ckpt = os.path.join(exp, ckpts[-1])
            del state
            torch.cuda.empty_cache()

            per_chunk = {**zero, GG_KERNEL.name: 1, LISTED_PLAN_KERNEL.name: 1, LISTED_KERNEL.name: 1,
                         FUSED_FWD_KERNEL.name: 2}
            pose_dir = os.path.join(work, "poses")
            for sub in ("new_params", "new_vertices"):  # the sequence's poses 0 and 4
                os.makedirs(os.path.join(pose_dir, sub))
                for dst, src in (("0", "1"), ("4", "5")):
                    shutil.copy(os.path.join(COLD_TREE, sub, f"{src}.npy"),
                                os.path.join(pose_dir, sub, f"{dst}.npy"))
            common = ["-c", "zju.yml", "--exp", "zju", "--ckpt", ckpt]
            runs = (("validate", cli_validate.main, common, 2),
                    ("test", cli_test.main, common, 2),
                    ("vis_lighting", cli_vl.main, common, 10),
                    ("novel_pose_vis", cli_npv.main,
                     common + ["--pose_dir", pose_dir, "--n_frames", "2"], 2))
            evals = {}
            for label, fn, argv, n_images in runs:
                reset_launches()
                del image_times[:], image_chunks[:]
                res = fn(argv)
                launched = launches_now()
                if len(image_times) != n_images:
                    raise AssertionError(f"zju {label}: {len(image_times)} images, expected {n_images}")
                want = {k: v * sum(image_chunks) for k, v in per_chunk.items()}
                if launched != want:
                    raise AssertionError(f"zju {label}: launches {launched}, expected {want}")
                for r in (res if isinstance(res, tuple) else (res,) if isinstance(res, dict) else ()):
                    if not (np.isfinite(list(r.values())).all() and -1.0 <= r["ssim"] <= 1.0):
                        raise AssertionError(f"zju {label}: metrics {r}")
                evals[label] = {"images": n_images, "chunks": sum(image_chunks),
                                "s_per_image": statistics.median(image_times),
                                "s_per_image_runs": list(image_times),
                                "metrics": res if not isinstance(res, int) else None}
            # what the tree's zero-distortion cameras skip: one 1024x1024
            # frame and its mask through a fresh map cache, with a nonzero
            # distortion
            annots = np.load(os.path.join(COLD_TREE, "annots.npy"), allow_pickle=True).item()
            und, cam_k = Undistorter(), np.asarray(annots["cams"]["K"][0], np.float64)
            dist = np.array([[-0.25, 0.12, 0.001, -0.0005, -0.03]])
            und_ms = []
            for img in (frame, frame, frame[..., 0] > 127):
                t0 = time.perf_counter()
                und(img.astype(np.uint8), cam_k, dist)
                und_ms.append((time.perf_counter() - t0) * 1e3)
            pngs = (check_pngs(os.path.join(exp, "vis"), 3 * 2, (512, 512))
                    + check_pngs(os.path.join("TEST", "zju"), 5 * 2, (512, 512))
                    + check_pngs(os.path.join("vis_lighting", "zju"), 10, (512, 512))
                    + check_pngs(os.path.join("motion_transfer", "zju"), 2 * 2, (1024, 1024)))
            cold_s = epoch_s.get(1, wall[0])
            report = {
                "steps": steps, "items_epoch1": 48, "items_epoch2": 6,
                "decode_ms_per_jpeg": statistics.median(decode_ms[:n_cold_decodes]),
                "decode_ms_per_jpeg_runs": [min(decode_ms[:n_cold_decodes]),
                                            max(decode_ms[:n_cold_decodes])],
                "jpeg_decodes_epoch1": n_cold_decodes,
                # summed over the loader's threads, which decode while the
                # steps run: thread time, not a share of the epoch's wall time
                "decode_thread_s_epoch1": sum(decode_ms[:n_cold_decodes]) / 1e3,
                # the epoch's wall time less its step calls: the loop's waits
                # on the loader, plus its draws, log lines and checkpoint save
                "epoch1_outside_step_calls_s": cold_s - sum(step_times[:48]),
                "cold_epoch1_s": cold_s, "cold_epoch1_items_per_s": 48 / cold_s,
                "epoch2_process_s": epoch_s.get(2), "epoch2_process_s_per_step": epoch_s.get(2, 0.0) / 6,
                "train_call_wall_s": wall,
                "s_per_step": statistics.median(step_times[1:48]), "s_per_step_runs": [
                    min(step_times[1:48]), max(step_times[1:48])], "first_step_s": step_times[0],
                "resumed_steps_s": step_times[48:],
                "rays_per_s": TRAIN_RAYS / statistics.median(step_times[1:48]),
                "losses_logged": losses[:4] + losses[-2:], "n_logged": len(logged),
                "ckpt_bytes": os.path.getsize(ckpt), "train_launches": train_launches,
                "undistort_1024_ms": {"maps_and_remap": und_ms[0], "remap": und_ms[1],
                                      "mask_remap": und_ms[2]},
                "evals": evals, "pngs": pngs,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "phase_s": time.perf_counter() - t_phase, "card": card,
            }
    finally:
        zju_data.imread = imread_jpeg
    log("zju loop: " + json.dumps(report))
    return report


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script measures only on the card")
        return 2
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # ---- 2. build ------------------------------------------------------
    build_s = build_all(KERNELS)
    log(f"build: {build_s:.2f} s for {len(KERNELS)} kernels")
    for k in KERNELS:  # ptxas -v: registers, shared memory, spills
        for line in k.build_log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"ptxas {k.name}: {line.strip()}")
    for k in (FUSED_FWD_FAST_KERNEL, FUSED_BWD_FAST_KERNEL):  # entry points of the f32 pair's libraries
        log(f"resources {k.name}: " + json.dumps(fused_resources(k)))

    cfg = slice_cfg()
    settings = RenderSettings.from_cfg(cfg)
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=H, w=W)
    item = ds[0]
    n_rays = int(item["ray_o"].shape[0])
    n_chunks = -(-n_rays // cfg.TEST.RAY_CHUNK)
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, dev)
    rays0, _ = next(iter_ray_chunks(item, cfg.TEST.RAY_CHUNK, dev))
    # the train item of phases 6-7; its world points feed phase 3 too
    tds = SyntheticDataset(split="train", nrays=TRAIN_RAYS, n_frames=1, n_views=1, h=H, w=W)
    titem = tds[0]
    tbatch = item_to_train_batch(titem, TRAIN_RAYS, dev)
    tmesh = item_to_mesh(titem, tds.faces, tds.canonical_vertex, dev)
    tpts_w = train_world_points(tbatch, tmesh, settings)

    # ---- 3. kernels against their plain versions, main-path shapes ------
    kernels = [check_gg(rays0, mesh, tbatch.rays, tmesh, settings.gg_gamma)]
    near, far = gg_near_far_cuda(rays0.ray_o, rays0.ray_d, rays0.near, rays0.far,
                                 mesh.verts_world, settings.gg_gamma)
    z = stratified_z(near, far, settings.n_samples)
    pts_rs = sample_along_rays(rays0.ray_o, rays0.ray_d, z)          # (R, S, 3)
    pts_w = pts_rs.reshape(-1, 3).contiguous()
    cents_w = face_centroids(mesh.verts_world, mesh.faces).contiguous()
    kernels.append(check_nearest_face(pts_w, cents_w, tpts_w,
                                      face_centroids(tmesh.verts_world, tmesh.faces).contiguous()))
    # the tile-pruned searches take the render's block-coherent layout
    to_blocked, _ = _block_layout(*z.shape, settings.block_sc)
    pts_blocked = to_blocked(pts_rs).contiguous()
    cloud = random_cloud(pts_blocked.shape[0], cents_w)
    brute_ids = {"path": nearest_face_cuda(pts_blocked, cents_w), "cloud": nearest_face_cuda(cloud, cents_w)}
    # the exact path's second search: the same chunk's canonical points
    pts_cano, cents_c = canonical_points(pts_blocked, cents_w, mesh, settings)
    brute_ms = time_ms(lambda: nearest_face_cuda(pts_blocked, cents_w), reps=10)
    lib_ms = kernels[1]["library_ms"]
    tcents_w = face_centroids(tmesh.verts_world, tmesh.faces).contiguous()
    kernels.append(check_plan(pts_blocked, cloud, train_world_points(tbatch, tmesh, settings, blocked=True),
                              cents_w, mesh, tcents_w, tmesh))
    kernels.append(check_listed(LISTED_KERNEL, False, pts_blocked, cloud, cents_w, mesh, brute_ids, lib_ms, brute_ms))
    kernels.append(check_listed(LISTED_SLIM_KERNEL, True, pts_blocked, cloud, cents_w, mesh, brute_ids, lib_ms, brute_ms))
    kernels.append(check_pruned({"world": (pts_blocked, cents_w), "canonical": (pts_cano, cents_c),
                                 "cloud": (cloud, cents_w)}, mesh, lib_ms, brute_ms))
    for k in kernels:
        log("kernel: " + json.dumps({key: k[key] for key in k if key not in ("route", "source", "replaces")}))
    for k in kernels:  # GG, the searches and the plan: time against floor, resources
        if "issue_floor_ms" not in k:
            continue
        floor = {"ms": k["ms"], "issue_floor_ms": k["issue_floor_ms"], "bound_ms": k["bound_ms"],
                 "issue_floor_share": k["issue_floor_ms"] / k["ms"], "bound_share": k["bound_ms"] / k["ms"]}
        if "device_ms" in k:  # GG, the plan, the pruned search: bare launches, device time alone
            floor |= {"device_ms": k["device_ms"], "device_issue_floor_share": k["issue_floor_ms"] / k["device_ms"],
                      "device_bound_share": k["bound_ms"] / k["device_ms"]}
        if "step" in k:  # GG and the plan: the training step's shapes too
            st = k["step"]
            floor |= {"all_pairs_issue_floor_ms": k["all_pairs_issue_floor_ms"],
                      "step": st | {"device_issue_floor_share": st["issue_floor_ms"] / st["device_ms"],
                                    "device_bound_share": st["bound_ms"] / st["device_ms"]}}
        if "inputs" in k:  # the pruned search: each input
            floor["inputs"] = {label: {key: v[key] for key in ("device_ms", "issue_floor_ms", "bound_ms",
                                                                  "visits_mean")}
                               | {"device_issue_floor_share": v["issue_floor_ms"] / v["device_ms"]}
                               for label, v in k["inputs"].items()}
        log(f"floor {k['name']}: " + json.dumps({**floor, "resources": k["resources"]}))
    log("sweep: " + json.dumps(sweep_granularity(pts_blocked, cents_w, mesh)))
    # the cluster-pruned and expanded-form searches (torch ops) on the chunk
    check_searches(pts_rs, cents_w, mesh)
    log("tables: " + json.dumps({
        "listed_tables_ms": time_ms(lambda: listed_tables(cents_w, mesh.tile_table), reps=10),
        "note": "item_to_mesh derives the posed mesh's tables once per item; per chunk it would be this x chunks",
        "chunks": n_chunks,
    }))

    # ---- 4. the full 512x512 render through the eval entry point --------
    model = trained_model(cfg.MODEL.MAX_FRAMES).eval()
    zero = {k.name: 0 for k in KERNELS}
    # (a) exact full shading, brute-force search: two searches per chunk
    out_exact, launches_exact, profile_exact, _ = render_path(
        "exact", cfg, model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, NEAREST_KERNEL.name: 2 * n_chunks}, n_timed=1)
    # (b) production: gated shading with face reuse, one listed search per chunk
    out_prod, launches_prod, profile_prod, render_prod = render_path(
        "production", production_cfg(), model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, LISTED_PLAN_KERNEL.name: n_chunks,
         LISTED_KERNEL.name: n_chunks}, n_timed=N_TIMED_RENDERS,
        reference=out_exact)
    # (c) exact full shading, the pruned search: two searches per chunk; the
    # same image as (a) but where a near-tie names another face
    pruned_cfg = slice_cfg()
    pruned_cfg.MODEL.KNN_IMPL = "pruned"
    out_pruned, launches_exact_pruned, profile_pruned, _ = render_path(
        "exact pruned", pruned_cfg, model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, PRUNED_KERNEL.name: 2 * n_chunks}, n_timed=1,
        reference=out_exact)
    box = np.asarray(item["mask_at_box"]).reshape(H, W)
    if psnr(out_pruned["coarse_color"], out_exact["coarse_color"], box) < PRUNED_PSNR_MIN:
        raise AssertionError("exact pruned: the render departs from the brute-force exact render")
    del out_pruned
    # (f) exact full shading with the grouped search (torch ops, no search
    # kernel): held to (a) as (c) is; then the production image through the
    # f16 pack, held to (b)
    grouped_cfg = slice_cfg()
    grouped_cfg.MODEL.KNN_IMPL = "grouped"
    out_grouped, _, _, render_grouped = render_path(
        "exact grouped", grouped_cfg, model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks}, n_timed=1, reference=out_exact)
    if psnr(out_grouped["coarse_color"], out_exact["coarse_color"], box) < PRUNED_PSNR_MIN:
        raise AssertionError("exact grouped: the render departs from the brute-force exact render")
    out_f16, _, _, render_f16 = render_path(
        "production f16", production_cfg(), model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, LISTED_PLAN_KERNEL.name: n_chunks,
         LISTED_KERNEL.name: n_chunks}, n_timed=1, reference=out_exact, pack="f16")
    f16_psnr = psnr(out_f16["coarse_color"], out_prod["coarse_color"], box)
    log("render production f16: " + json.dumps({
        "psnr_box_vs_f32_production": f16_psnr, "floor_db": F16_PSNR_MIN,
        "s_per_image_f16": render_f16["s_per_image"], "s_per_image_f32": render_prod["s_per_image"],
        "max_abs_color_vs_f32_production": float(np.abs(out_f16["coarse_color"] - out_prod["coarse_color"]).max()),
        "exact_grouped_s_per_image": render_grouped["s_per_image"]}))
    if f16_psnr < F16_PSNR_MIN:
        raise AssertionError(f"production f16: {f16_psnr:.2f} dB against the f32 copy")
    del out_grouped, out_f16
    # (d) production with the bfloat16-fed fused forward: two launches a
    # chunk (density, then color), held to the float32 production image
    fast_cfg = production_cfg()
    fast_cfg.MODEL.FUSED_MLP, fast_cfg.MODEL.FUSED_FAST = "on", True
    out_fast, launches_fast_img, profile_fast, _ = render_path(
        "production fused fast", fast_cfg, model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, LISTED_PLAN_KERNEL.name: n_chunks, LISTED_KERNEL.name: n_chunks,
         FUSED_FWD_FAST_KERNEL.name: 2 * n_chunks}, n_timed=N_TIMED_RENDERS, reference=out_exact)
    fast_psnr = psnr(out_fast["coarse_color"], out_prod["coarse_color"], box)
    log("render production fused fast: " + json.dumps({
        "psnr_box_vs_f32_production": fast_psnr, "floor_db": FAST_PSNR_MIN,
        "max_abs_color_vs_f32_production": float(np.abs(out_fast["coarse_color"] - out_prod["coarse_color"]).max())}))
    if fast_psnr < FAST_PSNR_MIN:
        raise AssertionError(f"production fused fast: {fast_psnr:.2f} dB against the f32 production image")
    # (e) exact, fused, with the fine pass (64 + 64 samples): the searches
    # and the fused forward run again on the fine samples
    fine_cfg = slice_cfg()
    fine_cfg.MODEL.FUSED_MLP, fine_cfg.MODEL.FINE_RAY_SAMPLING = "on", 64
    out_fine, launches_fine_img, profile_fine, _ = render_path(
        "exact fused fine", fine_cfg, model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, NEAREST_KERNEL.name: 4 * n_chunks,
         FUSED_FWD_KERNEL.name: 2 * n_chunks}, n_timed=1, reference=out_exact)
    if not {"fine_color", "fine_acc", "fine_depth", "fine_disp"} <= set(out_fine):
        raise AssertionError(f"exact fused fine: no fine images ({sorted(out_fine)})")
    log("render exact fused fine: " + json.dumps({
        "psnr_box_fine_vs_coarse": psnr(out_fine["fine_color"], out_fine["coarse_color"], box),
        "psnr_box_fine_vs_gt": psnr(out_fine["fine_color"], item["img"], box)}))
    del out_fast, out_fine
    profiles = [profile_exact, profile_prod, profile_pruned, profile_fast, profile_fine]

    # ---- 5. golden rays against the JAX package's render ---------------
    with np.load(GOLDEN_NPZ) as data:
        golden = {k: data[k] for k in data.files}
    # one 2048-ray chunk per leg: gg runs GG; the exact legs search twice
    golden_leg("configs", golden, model,
               {**zero, GG_KERNEL.name: 1, NEAREST_KERNEL.name: 4, LISTED_PLAN_KERNEL.name: 1,
                LISTED_KERNEL.name: 1})
    golden_leg("pruned", golden, model, {**zero, GG_KERNEL.name: 1, PRUNED_KERNEL.name: 4},
               legs=("fixed", "gg"), knn_impl="pruned")
    os.environ["DSNERF_KNN_SLIM"] = "1"  # read when a search is called
    try:
        launches_slim = golden_leg("listed slim", golden, model,
                                   {**zero, GG_KERNEL.name: 1, LISTED_PLAN_KERNEL.name: 4,
                                    LISTED_SLIM_KERNEL.name: 4},
                                   legs=("fixed", "gg"), knn_impl="listed")
    finally:
        del os.environ["DSNERF_KNN_SLIM"]
    # the cluster-pruned and expanded-form searches on every leg: GG once
    # (the gg leg), no search kernel
    for impl in ("grouped", "clustered", "xla"):
        golden_leg(impl, golden, model, {**zero, GG_KERNEL.name: 1}, knn_impl=impl)

    # ---- 6. the fused SpaceNet kernels at the training step's shapes ------
    fmodel = trained_model(cfg.MODEL.MAX_FRAMES).to(dev)
    pts_c, fcode, fpf, x_all = fused_check_inputs(fmodel, tbatch, tmesh, settings, tpts_w)
    fwd_row, bwd_row = check_fused(fmodel, pts_c, fcode, fpf, x_all)
    # the bfloat16-fed pair, timed with the float32 pair and the unfused bf16 chain
    fmodel16 = trained_model(cfg.MODEL.MAX_FRAMES, torch.bfloat16).to(dev)
    ffwd_row, fbwd_row = check_fused(fmodel, pts_c, fcode, fpf, x_all, fast=True, model_bf16=fmodel16)
    check_fused_random()
    kernels += [fwd_row, bwd_row, ffwd_row, fbwd_row]
    for k in (fwd_row, bwd_row, ffwd_row, fbwd_row):
        log("kernel: " + json.dumps({key: k[key] for key in k if key not in ("route", "source", "replaces")}))
    del fmodel, fmodel16, pts_c, x_all

    # ---- 7. one training step on four paths ------------------------------
    base = {GG_KERNEL.name: 1}
    prod_base = {**zero, **base, LISTED_PLAN_KERNEL.name: 1, LISTED_KERNEL.name: 1}
    exact_base = {**zero, **base, NEAREST_KERNEL.name: 2}
    train, grads = {}, {}
    step_profiles = {}
    for label, production, fused, opts, expect in (
        ("production", True, False, None, prod_base),
        ("production fused", True, True, None,
         {**prod_base, FUSED_FWD_KERNEL.name: 2, FUSED_BWD_KERNEL.name: 2}),
        ("exact", False, False, None, exact_base),
        ("exact fused", False, True, None, {**exact_base, FUSED_FWD_KERNEL.name: 1, FUSED_BWD_KERNEL.name: 1}),
        # (e) the bfloat16-fed fused pair; (f) the networks in bfloat16
        # (cuBLAS); (g) the fine pass, 64 + 64 samples: the searches and the
        # fused pair run again on the 128 samples of each ray
        ("production fused fast", True, True, {"FUSED_FAST": True},
         {**prod_base, FUSED_FWD_FAST_KERNEL.name: 2, FUSED_BWD_FAST_KERNEL.name: 2}),
        ("production bf16", True, False, {"MATMUL_PRECISION": "bf16"}, prod_base),
        ("exact fused fine", False, True, {"FINE_RAY_SAMPLING": 64},
         {**exact_base, NEAREST_KERNEL.name: 4, FUSED_FWD_KERNEL.name: 2, FUSED_BWD_KERNEL.name: 2}),
        # (h) exact fused with the grouped search: GG and the fused pair
        ("exact fused grouped", False, True, {"KNN_IMPL": "grouped"},
         {**zero, **base, FUSED_FWD_KERNEL.name: 1, FUSED_BWD_KERNEL.name: 1}),
    ):
        train[label], grads[label], step_profiles[label] = train_path(label, production, fused, tbatch, tmesh,
                                                                      expect, opts)
        torch.cuda.empty_cache()
    profiles += list(step_profiles.values())
    compared = [compare_grads(f"{path}: fused vs unfused", grads[f"{path} fused"], grads[path])
                for path in ("production", "exact")]
    compared.append(compare_grads("production: fused fast vs fused", grads["production fused fast"],
                                  grads["production fused"], FAST_STEP_GRAD_TOL))
    compared.append(compare_grads("production: bf16 vs f32", grads["production bf16"], grads["production"],
                                  BF16_STEP_GRAD_TOL))
    compared.append(compare_grads("exact fused: grouped vs brute force", grads["exact fused grouped"],
                                  grads["exact fused"], GROUPED_STEP_GRAD_TOL))
    del grads

    # ---- LPIPS of the production image against the ground truth -------------
    lpips_phase(np.clip(out_prod["coarse_color"], 0.0, 1.0), item["img"], card)
    # ---- data parallel: a one-rank NCCL group, two gloo processes, the split render
    data_parallel_phase(tbatch, tmesh, ds, item, out_prod, card)
    del out_prod

    # ---- 8. the train / validate / test CLIs ------------------------------
    cli_phase(card)
    # ---- 8b. the JAX package's .ckpt through validate and a resumed train ---
    jax_ckpt_phase(card)
    # ---- 9. the CLIs on the ZJU-shaped tree --------------------------------
    zju_cli_phase(card)

    # ---- the mesh extraction -------------------------------------------------
    mesh_phase(trained_model(cfg.MODEL.MAX_FRAMES), ds, item, settings, card)

    # ---- 10. profiles, after every timed run -------------------------------
    for profile_later in profiles:
        profile_later()
    log("train summary: " + json.dumps({
        label: {k: r[k] for k in ("s_per_step", "rays_per_s", "device_ms_per_step", "peak_mem_gb")}
        for label, r in train.items()} | {"grads": compared}))

    # ---- 11. results -----------------------------------------------------
    # each kernel's launches on the path that is its own
    on_path = {
        GG_KERNEL.name: launches_exact, NEAREST_KERNEL.name: launches_exact,
        LISTED_PLAN_KERNEL.name: launches_prod, LISTED_KERNEL.name: launches_prod,
        LISTED_SLIM_KERNEL.name: launches_slim,
        PRUNED_KERNEL.name: launches_exact_pruned,
        FUSED_FWD_KERNEL.name: train["production fused"]["launches_per_step"],
        FUSED_BWD_KERNEL.name: train["production fused"]["launches_per_step"],
        FUSED_FWD_FAST_KERNEL.name: train["production fused fast"]["launches_per_step"],
        FUSED_BWD_FAST_KERNEL.name: train["production fused fast"]["launches_per_step"],
    }
    for k in kernels:
        k["launches"] = on_path[k["name"]][k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']}: no launch on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "oracle_beyond_band_share_max")  # the last: the fast pair's
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after start")
    print(json.dumps({"kernels": [{key: k[key] for key in keys if key in k} for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
