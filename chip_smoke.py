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
   image), and times kernel, plain version, the card's bound and, where one
   PyTorch call computes the same function, that call;
4. renders the full 512x512 val image of the synthetic SMPL-sized scene with
   the trained fixture through `ImageRenderer.render_item` (the port's eval
   entry point): launch counts per image, s_per_image, rays/s, PSNR, and a
   profile of one render chunk;
5. renders the golden rays (`tests/fixtures/torch_port_render_golden.npz`,
   the JAX package's CPU render) on the card and holds them to its bands;
6. prints the `kernels` JSON line, the card line, and as the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from dual_space_nerf_tpu_torch.data import SyntheticDataset, item_to_mesh, iter_ray_chunks
from dual_space_nerf_tpu_torch.evaluation import ImageRenderer, psnr
from dual_space_nerf_tpu_torch.evaluation.golden import (
    GOLDEN_NPZ,
    check_golden,
    render_golden,
    slice_cfg,
    trained_model,
)
from dual_space_nerf_tpu_torch.geometry import sample_along_rays, stratified_z
from dual_space_nerf_tpu_torch.ops import (
    GG_KERNEL,
    KERNELS,
    NEAREST_KERNEL,
    face_centroids,
    gg_near_far_cuda,
    gg_near_far_plain,
    nearest_face_cuda,
    nearest_face_plain,
)
from dual_space_nerf_tpu_torch.ops.cuda_build import build_all
from dual_space_nerf_tpu_torch.renderer import LightState, RenderSettings, render_rays

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 operations/s
# outside the tensor cores, an FMA counted as two operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
H = W = 512
N_TIMED_RENDERS = 3


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


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def gg_inside_pairs(ray_o, ray_d, verts, gamma) -> int:
    """(ray, vertex) pairs inside a sphere on these inputs: the only pairs
    that run the kernel's sqrt branch."""
    dirs = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    rel = verts - ray_o[0]
    r2 = (rel * rel).sum(-1)
    total = 0
    for s in range(0, dirs.shape[0], 1024):
        z0 = dirs[s:s + 1024] @ rel.T
        total += int(((r2 - z0 * z0) < gamma * gamma).sum())
    return total


def check_gg(rays, mesh, gamma) -> dict:
    args = (rays.ray_o, rays.ray_d, rays.near, rays.far, mesh.verts_world)
    n_k, f_k = gg_near_far_cuda(*args, gamma)
    n_p, f_p = gg_near_far_plain(*args, gamma)
    torch.cuda.synchronize()
    err = max(float((n_k - n_p).abs().max()), float((f_k - f_p).abs().max()))
    if not (torch.equal(n_k, n_p) and torch.equal(f_k, f_p)):
        raise AssertionError(f"gg_near_far: kernel differs from plain version by {err}")
    r, v = rays.ray_d.shape[0], mesh.verts_world.shape[0]
    inside = gg_inside_pairs(rays.ray_o, rays.ray_d, mesh.verts_world, gamma)
    # per pair: z0 (3 mul, 2 add), d2 (mul, sub), compare; per inside pair:
    # sub, max, sqrt, sub, add, min, max
    n_ops = 8.0 * r * v + 7.0 * inside + 10.0 * r
    n_bytes = 4.0 * (r * 3 * 2 + r * 2 + v * 3 + r * 2)
    b, by = bound_ms(n_bytes, n_ops)
    return {
        "name": "gg_near_far", "route": "cuda",
        "source": "dual_space_nerf_tpu_torch/csrc/gg_near_far.cu",
        "replaces": "dual_space_nerf_tpu/ops/gg_pallas.py:31",
        "max_abs_err": err,
        "ms": time_ms(lambda: gg_near_far_cuda(*args, gamma), reps=20),
        "plain_ms": time_ms(lambda: gg_near_far_plain(*args, gamma), reps=5),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": {"rays": r, "verts": v, "inside_pairs": inside},
    }


def cdist_argmin(pts, cents, step: int = 8192):
    """Yardstick only: one PyTorch call family for nearest neighbours."""
    out = torch.empty(pts.shape[0], dtype=torch.int64, device=pts.device)
    for s in range(0, pts.shape[0], step):
        out[s:s + step] = torch.cdist(pts[s:s + step], cents).argmin(1)
    return out


def check_nearest_face(pts_path, cents) -> dict:
    g = torch.Generator(device=cents.device).manual_seed(0)
    lo, hi = cents.min(0).values - 0.2, cents.max(0).values + 0.2
    cloud = lo + (hi - lo) * torch.rand(pts_path.shape[0], 3, dtype=torch.float32,
                                        device=cents.device, generator=g)
    worst, mism = 0, 0
    for pts in (pts_path, cloud):
        ids_k = nearest_face_cuda(pts, cents)
        ids_p = nearest_face_plain(pts, cents)
        torch.cuda.synchronize()
        mism += int((ids_k != ids_p).sum())
        worst = max(worst, int((ids_k.long() - ids_p.long()).abs().max()))
    if mism:
        raise AssertionError(f"nearest_face: {mism} ids differ from the plain version")
    n, f = pts_path.shape[0], cents.shape[0]
    n_ops = 9.0 * n * f  # 3 sub, 3 mul, 2 add, 1 compare per pair
    n_bytes = 4.0 * (n * 3 + f * 3 + n)
    b, by = bound_ms(n_bytes, n_ops)
    return {
        "name": "nearest_face", "route": "cuda",
        "source": "dual_space_nerf_tpu_torch/csrc/nearest_face.cu",
        "replaces": "dual_space_nerf_tpu/ops/nearest_face.py:66",
        "max_abs_err": float(worst), "mismatches": mism,
        "ms": time_ms(lambda: nearest_face_cuda(pts_path, cents), reps=10),
        "plain_ms": time_ms(lambda: nearest_face_plain(pts_path, cents), reps=3),
        "bound_ms": b, "bound_by": by,
        "library_ms": time_ms(lambda: cdist_argmin(pts_path, cents), reps=3),
        "shape": {"points": n, "centroids": f},
    }


def profile_chunk(model, rays, mesh, settings, light) -> dict:
    """Device time of one render chunk by kernel family (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render_rays(model, rays, mesh, settings, light, device="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    fam: dict[str, float] = {}
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # host-side ops: no double count
            continue
        ms = ev.self_device_time_total / 1e3
        kernels.append((ev.key, ms, ev.count))
        name = ev.key.lower()
        if "gg_kernel" in name or "gg_rel" in name:
            k = "gg_near_far kernel"
        elif "nearest_face" in name:
            k = "nearest_face kernel"
        elif "gemm" in name or "cutlass" in name or "xmma" in name:
            k = "matrix products (cuBLAS)"
        elif "index" in name or "gather" in name or "scatter" in name:
            k = "gathers / index ops"
        else:
            k = "elementwise and reductions"
        fam[k] = fam.get(k, 0.0) + ms
    total = sum(fam.values())
    top = sorted(kernels, key=lambda x: -x[1])[:10]
    return {
        "wall_ms_profiled": wall_ms,
        "device_ms": total if total else "not measured",
        "kernel_launches": sum(c for _, _, c in kernels),
        "by_family_ms": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
        "top_kernels": [{"name": n[:90], "ms": t, "calls": c} for n, t, c in top],
    }


def main() -> int:
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
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, dev)
    rays0, _ = next(iter_ray_chunks(item, cfg.TEST.RAY_CHUNK, dev))

    # ---- 3. kernels against their plain versions, main-path shapes ------
    kernels = [check_gg(rays0, mesh, settings.gg_gamma)]
    near, far = gg_near_far_cuda(rays0.ray_o, rays0.ray_d, rays0.near, rays0.far,
                                 mesh.verts_world, settings.gg_gamma)
    z = stratified_z(near, far, settings.n_samples)
    pts_w = sample_along_rays(rays0.ray_o, rays0.ray_d, z).reshape(-1, 3).contiguous()
    cents_w = face_centroids(mesh.verts_world, mesh.faces).contiguous()
    kernels.append(check_nearest_face(pts_w, cents_w))
    for k in kernels:
        log("kernel: " + json.dumps({key: k[key] for key in (
            "name", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}))

    # ---- 4. the full 512x512 render through the eval entry point --------
    model = trained_model(cfg.MODEL.MAX_FRAMES).eval()
    renderer = ImageRenderer(model, settings, ds.faces, ds.canonical_vertex,
                             chunk=cfg.TEST.RAY_CHUNK, device=dev)
    renderer.render_item(item)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    out = renderer.render_item(item)  # the main path's counted run
    first_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    n_chunks = -(-n_rays // cfg.TEST.RAY_CHUNK)
    expect = {GG_KERNEL.name: n_chunks, NEAREST_KERNEL.name: 2 * n_chunks}
    if launches != expect:
        raise AssertionError(f"launches per image {launches}, expected {expect}")
    times = [first_s]
    for _ in range(N_TIMED_RENDERS - 1):
        t0 = time.perf_counter()
        renderer.render_item(item)
        times.append(time.perf_counter() - t0)
    for name, img in out.items():
        vals = img if name != "coarse_disp" else img[out["coarse_acc"] > 1e-3]
        if not np.isfinite(vals).all():
            raise AssertionError(f"{name}: non-finite values in the render")
    mask = np.asarray(item["mask_at_box"]).reshape(H, W)
    s_img = statistics.median(times)
    render = {
        "rays": n_rays, "chunks": n_chunks, "launches_per_image": launches,
        "s_per_image": s_img, "s_per_image_runs": times, "rays_per_s": n_rays / s_img,
        "psnr_box": psnr(out["coarse_color"], item["img"], mask),
        "psnr_image": psnr(out["coarse_color"], item["img"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("render: " + json.dumps(render))
    prof = profile_chunk(model, rays0, mesh, settings, LightState.identity(dev))
    if isinstance(prof["device_ms"], float):
        # device time of the 18 chunks over the unprofiled wall time
        prof["device_busy_share_est"] = prof["device_ms"] * n_chunks / (s_img * 1e3)
    log("profile_chunk: " + json.dumps(prof))
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # ---- 5. golden rays against the JAX package's render ---------------
    with np.load(GOLDEN_NPZ) as data:
        golden = {k: data[k] for k in data.files}
    report = check_golden(render_golden(golden, device=dev, model=model), golden)
    log("golden: " + json.dumps(report))
    if not report["ok"]:
        raise AssertionError("golden render outside its bands")

    # ---- 6. results ------------------------------------------------------
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
