#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, before the last line is printed):
1. device check: a CUDA card must be present; prints its name and power
   limit as nvidia-smi reports them;
2. builds every CUDA kernel of the port from `dual_space_nerf_tpu_torch/csrc`
   (one nvcc per source, in parallel) and prints the build seconds;
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
   in turns;
4. renders the full 512x512 val image of the synthetic SMPL-sized scene with
   the trained fixture through `ImageRenderer.render_item` (the port's eval
   entry point) on three paths: (a) exact full shading with the brute-force
   search (`configs/zju_mocap/313.yml`), (b) the production path
   (`configs/zju_mocap/313_tpu.yml`: SHADE_TOPK 16, REUSE_WARP_FACES) with
   `KNN_IMPL: "listed"`, (c) exact full shading with `KNN_IMPL: "pruned"`
   (two pruned searches a chunk; held to (a) but for near-ties, PSNR >=
   40 dB). Each: launch counts per image, s_per_image, rays/s, PSNR;
5. renders the golden rays (`tests/fixtures/torch_port_render_golden.npz`,
   the JAX package's CPU render) on the card and holds them to its bands:
   every leg with its config's search, then the exact legs again with
   `KNN_IMPL: "pruned"` and with `"listed"` under `DSNERF_KNN_SLIM=1`, so
   that every kernel is launched on a render path;
6. holds the fused SpaceNet kernels (forward and backward, density-only and
   with color) against their plain versions at the training step's shapes
   (352,000 and 88,000 canonical points of the train batch, and a ragged
   count), checks that the forward's gpe is the backward's bit for bit,
   and times kernel, plain version, the card's bound and the unfused chain
   (SpaceNet + autograd normal for the forward, and its double backward for
   the backward; each kernel and its chain in turns, median and range);
   reports where kernel and plain version part at ReLU kinks, also for a
   randomly initialised SpaceNet, and each kernel's registers, spills,
   shared memory, scratch, blocks per SM and share of its bound;
7. trains: `training.make_train_step` on `bench.py`'s train workload (the
   512x512 train item, 5500 rays x 64 samples, the trained fixture, Adam at
   5e-4) on four paths, production or exact with `FUSED_MLP` on or off, from
   the same weights and the same draws: launch counts per step, s_per_step,
   rays/s, peak memory; every loss finite, and the fused and unfused
   gradients of the first step held to each other;
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
9. profiles one render chunk of each path of phase 4 and one step of each
   path of phase 7 (`profile_device`: the profiler warmed up by one call,
   and every port kernel the profiled call launched looked up in its
   trace): device ms by kernel family, device ms per step, busy share. They
   run after every timed run: a profiler session leaves the host's later
   launches slower, which inflated the host-clock times taken after it;
10. prints the `kernels` JSON line (each kernel's launches from the path
    that is its own: the exact image for GG, brute force and the pruned
    search, the production image for the plan and the listed search, the
    slim golden leg, the fused production step), the card line, and as the
    last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
from dual_space_nerf_tpu_torch.ops import (
    FUSED_BWD_KERNEL,
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
    nearest_face_cuda,
    nearest_face_plain,
    pruned_search_listed,
    pruned_search_presorted,
)
from dual_space_nerf_tpu_torch.ops import fused_mlp, gg_cuda, posenc, pruned_knn
from dual_space_nerf_tpu_torch.ops.cuda_build import build_all
from dual_space_nerf_tpu_torch.ops.nearest_face import kernel_splits
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
from dual_space_nerf_tpu_torch.utils.image_io import PNG_SIGNATURE

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 operations/s
# outside the tensor cores, an FMA counted as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# single FP32 instructions issued per second: 132 SMs x 128 lanes x 1.98 GHz
# (67 TFLOP/s counts an FMA as two operations)
PEAK_FP32_INSTR_PER_S = 33.5e12
H = W = 512
KERNEL_FAMILY = {  # each port kernel's family in `kernel_family`
    GG_KERNEL.name: "gg_near_far kernel", NEAREST_KERNEL.name: "nearest_face kernel",
    LISTED_PLAN_KERNEL.name: "listed plan kernel", LISTED_KERNEL.name: "tile-pruned search kernel",
    LISTED_SLIM_KERNEL.name: "tile-pruned search kernel", PRUNED_KERNEL.name: "tile-pruned search kernel",
    FUSED_FWD_KERNEL.name: "fused SpaceNet kernels", FUSED_BWD_KERNEL.name: "fused SpaceNet kernels",
}
N_TIMED_RENDERS = 3
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
FWD_TOL, BWD_TOL = 1e-5, 2e-5  # the CPU tests' bands against the JAX package
KINK = 1e-6                # see fused_mlp.kink_distances


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
                reference=None) -> tuple:
    """Render the full image on one path through `ImageRenderer.render_item`:
    a warm-up, the counted run (launch counts asserted against ``expect``),
    timed runs, finiteness, PSNR. Returns (the images, the launch counts, a
    function that profiles one chunk of this path). A profiler session
    leaves the host's later launches slower, so the profiles run after
    every timed run of the script."""
    dev = torch.device("cuda")
    settings = RenderSettings.from_cfg(cfg)
    renderer = ImageRenderer(model, settings, ds.faces, ds.canonical_vertex,
                             chunk=cfg.TEST.RAY_CHUNK, device=dev)
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
    for name, img in out.items():
        vals = img if name != "coarse_disp" else img[out["coarse_acc"] > 1e-3]
        if not np.isfinite(vals).all():
            raise AssertionError(f"{label}: {name}: non-finite values in the render")
    n_rays = int(item["ray_o"].shape[0])
    mask = np.asarray(item["mask_at_box"]).reshape(H, W)
    s_img = statistics.median(times)
    render = {
        "path": label, "rays": n_rays, "chunks": -(-n_rays // cfg.TEST.RAY_CHUNK),
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

    return out, launches, profile_later


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


def fused_bound(n: int, with_color: bool, backward: bool) -> tuple[float, str]:
    per_point = (87 + 1 + (66 if with_color else 0)) if not backward else (
        87 + 1 + 87 + ((3 + 63 + 63) if with_color else 0))
    n_bytes = 4.0 * (n * per_point + fused_mlp.W_FLOATS + (fused_mlp.G_FLOATS if backward else 0))
    return bound_ms(n_bytes, 2.0 * fused_macs(with_color, backward) * n)


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


def fused_chain(model, pts_c, code, pf, with_color: bool, cots):
    """The same through the fused kernels' autograd functions."""
    with torch.enable_grad():
        pc = pts_c.detach().requires_grad_(True)
        pe, cp = _fused_inputs(pc, code, pf, 1.0)
        params = fused_mlp.nerf_params(model.nerf)
        if with_color:
            outs = fused_mlp.fused_sigma_essence_normal(params, pe, cp)
        else:
            outs = (fused_mlp.fused_sigma(params, pe, cp),)
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


def fused_variant(w, wflat, x, with_color: bool, gen) -> tuple[dict, tuple]:
    """One variant of the fused pair against its plain versions on ``x``.
    Points within KINK of a ReLU's kink are left out of the mask-dependent
    outputs (gpe, xbar) and, for the weight gradients, their cotangents are
    zeroed; everything else is held to the bands. A second backward with
    every cotangent reports what the left-out points do (`flip_report`).
    Returns the report and the cotangents the check used."""
    dev = x.device
    n = x.shape[0]
    kinks = fused_mlp.kink_distances(w, x)
    keep = kinks.amin(1) > KINK
    v = {"with_color": with_color, "points": n, "kink_points_left_out": int((~keep).sum()),
         "kink_share_left_out": float((~keep).float().mean())}
    got = fused_mlp.fused_fwd(w, x, with_color, wflat)
    want = fused_mlp.fused_fwd_plain(w, x, with_color)
    errs = [_rel_err(got[0], want[0])]
    if with_color:
        errs += [_rel_err(got[1], want[1]), _rel_err(got[2], want[2], keep)]
        v["gpe_flips"] = flip_report(got[2], want[2], FWD_TOL, kinks)
    v["fwd_max_abs_err"], v["fwd_max_rel_err"] = max(e[0] for e in errs), max(e[1] for e in errs)
    rnd = lambda *sh: torch.randn(*sh, dtype=torch.float32, device=dev, generator=gen)
    cots = (rnd(n), rnd(n, 3), rnd(n, 63)) if with_color else (rnd(n), None, None)
    xb, gp, gr = fused_mlp.fused_bwd(w, x, *cots, with_color, wflat)
    xb_p, _, gr_p = fused_mlp.fused_bwd_plain(w, x, *cots, with_color)
    if with_color and not torch.equal(got[2], gp):  # the same routines on the same rows
        raise AssertionError("fused kernels: the forward's gpe differs from the backward's")
    v["xbar_flips"] = flip_report(xb, xb_p, BWD_TOL, kinks)
    v["grads_all_cotangents_max_rel_err"] = max(_rel_err(gr[k].reshape(t.shape), t)[1] for k, t in gr_p.items())
    kept = tuple(c * (keep if c.dim() == 1 else keep[:, None]) if c is not None else None for c in cots)
    xb, gp, gr = fused_mlp.fused_bwd(w, x, *kept, with_color, wflat)
    xb_p, gp_p, gr_p = fused_mlp.fused_bwd_plain(w, x, *kept, with_color)
    errs = [_rel_err(xb, xb_p, keep)] + [_rel_err(gr[k].reshape(t.shape), t) for k, t in gr_p.items()]
    if with_color:
        errs.append(_rel_err(gp, gp_p, keep))
    v["bwd_max_abs_err"], v["bwd_max_rel_err"] = max(e[0] for e in errs), max(e[1] for e in errs)
    torch.cuda.synchronize()
    if v["fwd_max_rel_err"] > FWD_TOL or v["bwd_max_rel_err"] > BWD_TOL:
        raise AssertionError(f"fused kernels differ from their plain versions: {v}")
    return v, kept


def check_fused_random(n: int = 352_000) -> None:
    """The same check on a randomly initialised SpaceNet and seeded inputs
    (as `tests/test_torch_port_cuda.py` makes them), both variants."""
    dev = torch.device("cuda")
    model = DualSpaceNeRF(max_frames=4, generator=torch.Generator().manual_seed(0)).to(dev)
    w = {k: v.detach() for k, v in fused_mlp.pack(fused_mlp.nerf_params(model.nerf)).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    x = fused_mlp.build_x(posenc(0.3 * torch.randn(n, 3, device=dev, generator=gen), 10),
                          torch.randn(n, 24, device=dev, generator=gen))
    for with_color in (False, True):
        v, _ = fused_variant(w, fused_mlp.flat_weights(w), x, with_color, gen)
        log("fused random weights: " + json.dumps(v))


def check_fused(model, pts_c, code, pf, x_all) -> tuple[dict, dict]:
    """Both fused kernels in both variants against their plain versions at
    the training step's shapes (`fused_variant`), and timed. Returns the
    forward and backward kernel rows (their numbers per production step:
    the density pass over 352,000 points plus the color pass over 88,000)."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    w = {k: v.detach() for k, v in fused_mlp.pack(fused_mlp.nerf_params(model.nerf)).items()}
    wflat = fused_mlp.flat_weights(w)
    gen = torch.Generator(device=dev).manual_seed(11)
    variants = []
    for with_color in (False, True):
        for n in FUSED_SIZES:
            x = x_all[:n].contiguous()
            v, (sbar, ebar, gbar) = fused_variant(w, wflat, x, with_color, gen)
            if n != FUSED_SIZES[2]:
                v["fwd_plain_ms"] = time_ms(lambda: fused_mlp.fused_fwd_plain(w, x, with_color), reps=3)
                v["bwd_plain_ms"] = time_ms(lambda: fused_mlp.fused_bwd_plain(w, x, sbar, ebar, gbar, with_color),
                                            reps=3)
                v["fwd_bound_ms"], v["fwd_bound_by"] = fused_bound(n, with_color, False)
                v["bwd_bound_ms"], v["bwd_bound_by"] = fused_bound(n, with_color, True)
                pc = pts_c[:n]
                cots = [sbar] + ([ebar, torch.randn(n, 3, device=dev, generator=gen)] if with_color else [])
                # each kernel and its unfused chain in turns, in this call
                for alt in ({
                    "fwd": lambda: fused_mlp.fused_fwd(w, x, with_color, wflat),
                    "unfused_fwd": lambda: unfused_chain(model, pc, code, pf, with_color),
                }, {
                    "bwd": lambda: fused_mlp.fused_bwd(w, x, sbar, ebar, gbar, with_color, wflat),
                    "unfused_fwd_bwd": lambda: unfused_chain(model, pc, code, pf, with_color, cots),
                }):
                    for key, (med, spread) in alternate_ms(alt, rounds=5).items():
                        v[f"{key}_ms"], v[f"{key}_ms_range"] = med, spread
                for tag in ("fwd", "bwd"):
                    v[f"{tag}_bound_share"] = v[f"{tag}_bound_ms"] / v[f"{tag}_ms"]
                v["fused_fwd_bwd_ms"] = time_ms(lambda: fused_chain(model, pc, code, pf, with_color, cots),
                                                reps=3)
            variants.append(v)
            log("fused: " + json.dumps(v))
    model.zero_grad(set_to_none=True)
    step = [v for v in variants if (v["points"], v["with_color"]) in ((352_000, False), (88_000, True))]
    exact = next(v for v in variants if (v["points"], v["with_color"]) == (352_000, True))
    for kernel, tag, unfused in ((FUSED_FWD_KERNEL, "fwd", "unfused_fwd"),
                                 (FUSED_BWD_KERNEL, "bwd", "unfused_fwd_bwd")):
        keys = (f"{tag}_ms", f"{tag}_bound_ms", f"{unfused}_ms")
        log(f"fused_{tag}: " + json.dumps({
            **fused_resources(kernel),
            "production_step": {key: sum(v[key] for v in step) for key in keys},
            "exact_step": {key: exact[key] for key in keys},
            "production_bound_share": sum(v[f"{tag}_bound_ms"] for v in step) / sum(v[f"{tag}_ms"] for v in step),
            "exact_bound_share": exact[f"{tag}_bound_share"],
            "ranges_ms": {f"{v['points']} {'color' if v['with_color'] else 'density'}":
                          {tag: v[f"{tag}_ms_range"], unfused: v[f"{unfused}_ms_range"]}
                          for v in variants if f"{tag}_ms_range" in v},
        }))
    rows = {}
    for kernel, tag, replaces in ((FUSED_FWD_KERNEL, "fwd", "294"), (FUSED_BWD_KERNEL, "bwd", "311")):
        bounds = [v[f"{tag}_bound_ms"] for v in step]
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
            "unfused_chain_ms": sum(v["unfused_fwd_ms" if tag == "fwd" else "unfused_fwd_bwd_ms"] for v in step),
            "note": "per production step: density-only at 352,000 points + with color at 88,000",
        }
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


def fused_resources(kernel) -> dict:
    """A fused kernel's registers and spilled bytes (stores + loads) per
    variant (`entry_resources`); its dynamic shared memory and resident
    blocks per SM (the occupancy query the wrapper sizes its grid by), its
    tile and its scratch per block."""
    dev = torch.device("cuda")
    out = {}
    for label, color in (("density", 0), ("with_color", 1)):
        v = entry_resources(kernel, rf"{kernel.name}_kernelILb{color}E")
        out[label] = {k: v[k] for k in ("registers", "kernel_spill_bytes", "functions_spill_bytes") if k in v}
    query = lambda sym, color=0: kernel.extra_function(f"{kernel.name}_{sym}", [ctypes.c_int])(color)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, color in (("density", False), ("with_color", True)):
        blocks = fused_mlp._blocks(kernel, f"{kernel.name}_blocks", dev, color)
        v = out[label]
        v["blocks_per_sm"] = blocks / sms
        v["scratch_bytes_per_block"] = 4 * query("scratch", int(color))
    out["dynamic_smem_bytes"] = query("smem")
    out["tile_points"] = query("tile")
    return out


# ---- the training step -------------------------------------------------------
def train_path(label, production: bool, fused: bool, batch, mesh, expect: dict) -> tuple:
    """`make_train_step` on one path from the fixture's weights and the same
    draws: a counted first step (launches asserted against ``expect``, its
    gradients kept), timed steps. Returns (report, grads, a function that
    profiles one more step and adds its device time to the report; run
    after every timed run, as `render_path`'s)."""
    dev = torch.device("cuda")
    cfg = train_cfg(production, fused)
    settings = RenderSettings.from_cfg(cfg)
    model = trained_model(cfg.MODEL.MAX_FRAMES).to(dev)
    state = create_train_state(model, cfg)
    step = make_train_step(settings, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = [draw_randoms(TRAIN_RAYS, settings.n_samples, gen, dev) for _ in range(N_TIMED_STEPS + 2)]
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
        "path": label, "rays": TRAIN_RAYS, "points": TRAIN_RAYS * settings.n_samples,
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


def compare_grads(label, g_fused: dict, g_plain: dict) -> dict:
    """Per tensor max |fused - unfused| over the unfused max: the worst is
    reported; a NaN or a ratio above 1e-3 fails the run."""
    ratios = {}
    for n, b in g_plain.items():
        a = g_fused[n]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"train {label}: non-finite gradient in {n}")
        ratios[n] = float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)
    worst = max(ratios, key=ratios.get)
    out = {"path": label, "worst_tensor": worst, "worst_ratio": ratios[worst],
           "tensors_beyond_2e-5": sorted(k for k, r in ratios.items() if r > BWD_TOL)}
    log("grads fused vs unfused: " + json.dumps(out))
    if ratios[worst] > 1e-3:
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


def check_pngs(root: str, expect_n: int) -> int:
    """Every PNG under ``root`` has the image's size (render | ground truth
    side by side under img/); returns their count, which must be ``expect_n``."""
    paths = glob.glob(os.path.join(root, "**", "*.png"), recursive=True)
    for path in paths:
        want = (H, 2 * W) if f"{os.sep}img{os.sep}" in path else (H, W)
        if png_size(path) != want:
            raise AssertionError(f"{path}: size {png_size(path)}, expected {want}")
    if len(paths) != expect_n:
        raise AssertionError(f"{root}: {len(paths)} PNGs, expected {expect_n}")
    return len(paths)


def cli_phase(card: str) -> dict:
    """Train (two calls, the second resuming), validate and test through
    the port's CLIs on the card, in a temporary directory. The step calls of
    the loop are timed on the host clock, each ended by a synchronize;
    render_item is timed per image (it ends in the host copy)."""
    zero = {k.name: 0 for k in KERNELS}
    step_times, image_times = [], []
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

    def timed_render(self, *a, **k):
        t0 = time.perf_counter()
        out = render_item(self, *a, **k)
        image_times.append(time.perf_counter() - t0)
        return out

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dsnerf_cli_")
    cwd = os.getcwd()
    saved_env = {k: os.environ.get(k) for k in ("DSNERF_VAL_PERIOD", "DSNERF_LOADER_BACKEND")}
    train_loop.make_train_step, ImageRenderer.render_item = timed_make_step, timed_render
    os.environ["DSNERF_VAL_PERIOD"] = "0"
    try:
        os.chdir(work)
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
        probe = Checkpointer(os.path.join(work, "probe"))
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
    finally:
        train_loop.make_train_step, ImageRenderer.render_item = make_step, render_item
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        logger = logging.getLogger("NERFRender")  # holds log.txt open
        for h in logger.handlers:
            h.close()
        logger.handlers = []
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    log("train loop: " + json.dumps(report))
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
    log("tables: " + json.dumps({
        "listed_tables_ms": time_ms(lambda: listed_tables(cents_w, mesh.tile_table), reps=10),
        "note": "item_to_mesh derives the posed mesh's tables once per item; per chunk it would be this x chunks",
        "chunks": n_chunks,
    }))

    # ---- 4. the full 512x512 render through the eval entry point --------
    model = trained_model(cfg.MODEL.MAX_FRAMES).eval()
    zero = {k.name: 0 for k in KERNELS}
    # (a) exact full shading, brute-force search: two searches per chunk
    out_exact, launches_exact, profile_exact = render_path(
        "exact", cfg, model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, NEAREST_KERNEL.name: 2 * n_chunks}, n_timed=2)
    # (b) production: gated shading with face reuse, one listed search per chunk
    out_prod, launches_prod, profile_prod = render_path(
        "production", production_cfg(), model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, LISTED_PLAN_KERNEL.name: n_chunks,
         LISTED_KERNEL.name: n_chunks}, n_timed=N_TIMED_RENDERS,
        reference=out_exact)
    # (c) exact full shading, the pruned search: two searches per chunk; the
    # same image as (a) but where a near-tie names another face
    pruned_cfg = slice_cfg()
    pruned_cfg.MODEL.KNN_IMPL = "pruned"
    out_pruned, launches_exact_pruned, profile_pruned = render_path(
        "exact pruned", pruned_cfg, model, ds, item, rays0, mesh,
        {**zero, GG_KERNEL.name: n_chunks, PRUNED_KERNEL.name: 2 * n_chunks}, n_timed=1,
        reference=out_exact)
    box = np.asarray(item["mask_at_box"]).reshape(H, W)
    if psnr(out_pruned["coarse_color"], out_exact["coarse_color"], box) < PRUNED_PSNR_MIN:
        raise AssertionError("exact pruned: the render departs from the brute-force exact render")
    del out_prod, out_pruned
    profiles = [profile_exact, profile_prod, profile_pruned]

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

    # ---- 6. the fused SpaceNet kernels at the training step's shapes ------
    fmodel = trained_model(cfg.MODEL.MAX_FRAMES).to(dev)
    pts_c, fcode, fpf, x_all = fused_check_inputs(fmodel, tbatch, tmesh, settings, tpts_w)
    fwd_row, bwd_row = check_fused(fmodel, pts_c, fcode, fpf, x_all)
    check_fused_random()
    kernels += [fwd_row, bwd_row]
    for k in (fwd_row, bwd_row):
        log("kernel: " + json.dumps({key: k[key] for key in k if key not in ("route", "source", "replaces")}))
    del fmodel, pts_c, x_all

    # ---- 7. one training step on four paths ------------------------------
    base = {GG_KERNEL.name: 1}
    prod_base = {**zero, **base, LISTED_PLAN_KERNEL.name: 1, LISTED_KERNEL.name: 1}
    exact_base = {**zero, **base, NEAREST_KERNEL.name: 2}
    train, grads = {}, {}
    for label, production, fused, expect in (
        ("production", True, False, prod_base),
        ("production fused", True, True,
         {**prod_base, FUSED_FWD_KERNEL.name: 2, FUSED_BWD_KERNEL.name: 2}),
        ("exact", False, False, exact_base),
        ("exact fused", False, True, {**exact_base, FUSED_FWD_KERNEL.name: 1, FUSED_BWD_KERNEL.name: 1}),
    ):
        train[label], grads[label], profile_step = train_path(label, production, fused, tbatch, tmesh,
                                                              expect)
        profiles.append(profile_step)
        torch.cuda.empty_cache()
    compared = [compare_grads(path, grads[f"{path} fused"], grads[path])
                for path in ("production", "exact")]
    del grads

    # ---- 8. the train / validate / test CLIs ------------------------------
    cli_phase(card)

    # ---- 9. profiles, after every timed run -------------------------------
    for profile_later in profiles:
        profile_later()
    log("train summary: " + json.dumps({
        label: {k: r[k] for k in ("s_per_step", "rays_per_s", "device_ms_per_step", "peak_mem_gb")}
        for label, r in train.items()} | {"grads": compared}))

    # ---- 10. results -----------------------------------------------------
    # each kernel's launches on the path that is its own
    on_path = {
        GG_KERNEL.name: launches_exact, NEAREST_KERNEL.name: launches_exact,
        LISTED_PLAN_KERNEL.name: launches_prod, LISTED_KERNEL.name: launches_prod,
        LISTED_SLIM_KERNEL.name: launches_slim,
        PRUNED_KERNEL.name: launches_exact_pruned,
        FUSED_FWD_KERNEL.name: train["production fused"]["launches_per_step"],
        FUSED_BWD_KERNEL.name: train["production fused"]["launches_per_step"],
    }
    for k in kernels:
        k["launches"] = on_path[k["name"]][k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']}: no launch on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after start")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
