#!/usr/bin/env python3
"""The port's search, GG, visit-plan and fused SpaceNet kernels against
another tree's, in turns, on one NVIDIA card.

    git archive <commit> dual_space_nerf_tpu_torch/csrc | tar -x -C <dir>
    python3 scripts/torch_search_ab.py --other <dir>/dual_space_nerf_tpu_torch/csrc [--other ...]
        [--sections searches,gg,plan,pruned,fused]

Each other tree's `nearest_face.cu`, `listed_knn.cu`, `listed_knn_slim.cu`,
`gg_near_far.cu`, `listed_plan.cu` and `pruned_knn.cu` are built beside this tree's
(`CudaKernel(csrc=...)`), named by the directory two levels above its csrc/
(or the csrc/'s parent). A brute-force launcher without the face split has
the signature `nearest_face_launch(pts, cents, out, n_pts, n_faces,
stream)`; a GG launcher with a `rel` scratch argument (the two-kernel
design) takes a (V, 4) scratch after `verts`; a plan launcher with
`n_sort` (the bitonic design) takes the power of two >= n_tiles before the
stream. On the shapes of
`chip_smoke.py` phase 3 (the render chunk's 8192 rays and 524,288 world
points, as many blocked points, a random cloud, and the training step's
5500 rays, 352,000 world points and 352,256 blocked points; for the pruned
search also the canonical points of the same chunk, which the exact path's
second search receives) the script:

1. holds every version's outputs equal, bit for bit or id for id, and to
   the plain versions;
2. times each kernel and the other trees' in turns (this, other, ...,
   this, other, ...; CUDA events, median and range over ``--rounds``);
   GG, the plan and the pruned search as bare launches into preallocated
   outputs with the card kept busy ahead of each
   (`chip_smoke.device_turns_ms`: device time alone), GG and the plan also
   through this tree's wrapper; with the SM clock and power under load;
3. times this tree's brute-force kernel at forced face splits against the
   split that `face_splits` chooses, in turns, and reports the share of
   GG's pairs and the plan's witnesses and tiles that this tree's culls
   keep (`chip_smoke.gg_cull_counts`, `plan_cull_counts`), with the issue
   floors they give and the all-pairs floors beside them, and the pruned
   search's issue floor from the plain version's visits
   (`chip_smoke.pruned_floor`) and its time with the blocks taken longest
   visit list first and last.

With ``--sections fused`` (not among the default sections) each other
tree's `fused_mlp_fwd.cu` and `fused_mlp_bwd.cu` are built into a library of
their own and their bfloat16-fed entry points (`fused_mlp_fwd_fast_launch`,
`fused_mlp_bwd_fast_launch`, in the signature of the float32 launchers:
the trees before the tensor-core design) are timed in turns with this
tree's, wrapper and allocations included as each tree's wrapper makes them,
at the training step's 352,000 density-only and 88,000 color points
(random inputs, the trained fixture's weights); the outputs of each other
tree are held to this tree's oracle (`fused_mlp.beyond_band`, under 5% of
the points beyond the bands).

Prints one JSON line per measurement, the card line, and writes all of it
to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dual_space_nerf_tpu_torch.data import (  # noqa: E402
    SyntheticDataset,
    item_to_mesh,
    item_to_train_batch,
    iter_ray_chunks,
)
from dual_space_nerf_tpu_torch.evaluation.golden import slice_cfg  # noqa: E402
from dual_space_nerf_tpu_torch.geometry import sample_along_rays, stratified_z  # noqa: E402
from dual_space_nerf_tpu_torch.ops import (  # noqa: E402
    GG_KERNEL,
    LISTED_KERNEL,
    LISTED_PLAN_KERNEL,
    LISTED_SLIM_KERNEL,
    NEAREST_KERNEL,
    PRUNED_KERNEL,
    face_centroids,
    gg_near_far_cuda,
    gg_near_far_plain,
    listed_tables,
    nearest_face_plain,
    pruned_knn,
)
from dual_space_nerf_tpu_torch.ops import fused_mlp, gg_cuda, posenc  # noqa: E402
from dual_space_nerf_tpu_torch.ops.cuda_build import CudaKernel, build_all, stream_ptr  # noqa: E402
from dual_space_nerf_tpu_torch.ops.nearest_face import kernel_splits  # noqa: E402
from dual_space_nerf_tpu_torch.renderer import RenderSettings  # noqa: E402
from dual_space_nerf_tpu_torch.renderer.pipeline import _block_layout  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int


def clock_under_load(fn, launches: int = 400) -> str:
    """The card's SM clock and power draw (nvidia-smi) while ``fn`` runs
    ``launches`` times back to back."""
    for _ in range(launches):
        fn()
    time.sleep(0.2)
    q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60).stdout.strip()
    torch.cuda.synchronize()
    return q


def other_kernels(csrc: str) -> dict:
    with open(os.path.join(csrc, "nearest_face.cu")) as f:
        split = "void* keys" in f.read()
    with open(os.path.join(csrc, "listed_knn.cu")) as f:
        ranked = "row_of_rank" in f.read()
    with open(os.path.join(csrc, "gg_near_far.cu")) as f:
        gg_rel = "float* rel" in f.read()
    with open(os.path.join(csrc, "listed_plan.cu")) as f:
        bitonic = "n_sort" in f.read()
    nearest_args = NEAREST_KERNEL.argtypes if split else [_P, _P, _P, _I, _I, _P]
    gg_args = [_P] * 8 + [_I, _I, ctypes.c_float, _P] if gg_rel else GG_KERNEL.argtypes
    plan_args = LISTED_PLAN_KERNEL.argtypes[:-1] + [_I, _P] if bitonic else LISTED_PLAN_KERNEL.argtypes
    # a listed launcher without the row order lacks its scratch pointer
    wide_args, slim_args = LISTED_KERNEL.argtypes, LISTED_SLIM_KERNEL.argtypes
    if not ranked:
        wide_args, slim_args = wide_args[:6] + wide_args[7:], slim_args[:6] + slim_args[7:]
    return {
        "split": split, "ranked": ranked, "gg_rel": gg_rel, "bitonic": bitonic,
        "nearest_face": CudaKernel("nearest_face.cu", "nearest_face_launch", nearest_args, csrc=csrc),
        "listed_knn": CudaKernel("listed_knn.cu", "listed_knn_launch", wide_args,
                                 includes=("listed_knn.cuh",), csrc=csrc),
        "listed_knn_slim": CudaKernel("listed_knn_slim.cu", "listed_knn_slim_launch", slim_args,
                                      includes=("listed_knn.cuh",), csrc=csrc),
        "gg_near_far": CudaKernel("gg_near_far.cu", "gg_near_far_launch", gg_args, csrc=csrc),
        "listed_plan": CudaKernel("listed_plan.cu", "listed_plan_launch", plan_args, csrc=csrc),
        "pruned_knn": CudaKernel("pruned_knn.cu", "pruned_knn_launch", PRUNED_KERNEL.argtypes, csrc=csrc),
    }


FLAGS = ("split", "ranked", "gg_rel", "bitonic")


def other_fused(csrc: str) -> dict:
    """Another tree's fused pair, its fast entry points in the float32
    launchers' signature of that time (the backward's: x, sbar, ebar, gbar,
    weights, xbar, gpe, partials, grads, scratch, n, with_color, blocks,
    stream)."""
    inc = ("fused_mlp.cuh", "fused_mlp_tiled.cuh")
    bwd_args = [_P] * 10 + [_I] * 3 + [_P]
    return {"fwd": CudaKernel("fused_mlp_fwd.cu", "fused_mlp_fwd_fast_launch", fused_mlp.FWD_KERNEL.argtypes,
                              includes=inc, csrc=csrc),
            "bwd": CudaKernel("fused_mlp_bwd.cu", "fused_mlp_bwd_fast_launch", bwd_args,
                              includes=inc, csrc=csrc)}


def other_fused_fns(k: dict, w, wflat, x, cots, with_color: bool) -> tuple:
    """(forward, backward) through another tree's fast entry points, with
    the allocations its wrapper made: float32 scratch per block, and for the
    backward zeroed partials per block."""
    dev, n = x.device, x.shape[0]
    q = lambda kern, sym: kern.extra_function(sym, [_I])(int(with_color))
    nbf = q(k["fwd"], "fused_mlp_fwd_fast_blocks")
    nbb = q(k["bwd"], "fused_mlp_bwd_fast_blocks")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None

    def fwd():
        sigma = torch.empty((n,), device=dev)
        ess = torch.empty((n, 3), device=dev) if with_color else None
        gpe = torch.empty((n, 63), device=dev) if with_color else None
        scratch = torch.empty((nbf * q(k["fwd"], "fused_mlp_fwd_scratch"),), device=dev)
        k["fwd"].launch(x.data_ptr(), wflat.data_ptr(), sigma.data_ptr(), ptr(ess), ptr(gpe),
                        scratch.data_ptr(), n, int(with_color), nbf, stream)
        return sigma, ess, gpe

    def bwd():
        xbar = torch.empty((n, 87), device=dev)
        gpe = torch.empty((n, 63), device=dev) if with_color else None
        grads = torch.empty((fused_mlp.G_FLOATS,), device=dev)
        partials = torch.zeros((nbb * fused_mlp.G_FLOATS,), device=dev)
        scratch = torch.empty((nbb * q(k["bwd"], "fused_mlp_bwd_scratch"),), device=dev)
        k["bwd"].launch(x.data_ptr(), *(ptr(c) for c in cots), wflat.data_ptr(), xbar.data_ptr(),
                        ptr(gpe), partials.data_ptr(), grads.data_ptr(), scratch.data_ptr(), n,
                        int(with_color), nbb, stream)
        return xbar, gpe

    return fwd, bwd


def fused_section(others: dict, rounds: int, report) -> None:
    """The fast fused pair of this tree and of the other trees in turns,
    per production step (352,000 density-only + 88,000 color points)."""
    dev = torch.device("cuda")
    model = cs.trained_model().to(dev)
    w = {k: v.detach() for k, v in fused_mlp.pack(fused_mlp.nerf_params(model.nerf)).items()}
    wflat, wb = fused_mlp.flat_weights(w), fused_mlp.fast_weights(w)
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda *sh: torch.randn(*sh, device=dev, generator=gen)
    kernels = {label: other_fused(o["csrc"]) for label, o in others.items()}
    build_all([k for ks in kernels.values() for k in ks.values()])
    step = {}
    for n, with_color in ((352_000, False), (88_000, True)):
        x = fused_mlp.build_x(posenc(0.3 * rnd(n, 3), 10), rnd(n, 24))
        cots = (rnd(n), *((rnd(n, 3), rnd(n, 63)) if with_color else (None, None)))
        fwd = {"this": lambda: fused_mlp.fused_fwd(w, x, with_color, wflat, True, wb)}
        bwd = {"this": lambda: fused_mlp.fused_bwd(w, x, *cots, with_color, wflat, True, wb)}
        want_f, want_b = fwd["this"](), bwd["this"]()
        for label, ks in kernels.items():
            f, b = other_fused_fns(ks, w, wflat, x, cots, with_color)
            fwd[label], bwd[label] = f, b
            share = float((fused_mlp.beyond_band(zip(f(), want_f), 1e-5)
                           | fused_mlp.beyond_band(zip(b(), want_b[:2]), 2e-5)).float().mean())
            if share >= 0.05:
                raise AssertionError(f"fused {label}: {share:.3f} of the points beyond the bands")
            report("fused", {"points": n, "with_color": with_color, "other": label,
                             "beyond_band_share_against_this": share})
        for tag, fns in (("fwd", fwd), ("bwd", bwd)):
            row = {"points": n, "with_color": with_color, "kernel": f"fused_mlp_{tag}_fast",
                   **{f"{k}_ms": v for k, v in cs.alternate_ms(fns, rounds).items()}}
            report("fused", row)
            for k in fns:
                step.setdefault(tag, {}).setdefault(k, 0.0)
                step[tag][k] += row[f"{k}_ms"][0]
    for tag, per in step.items():
        report("fused", {"production_step": f"fused_mlp_{tag}_fast", **{f"{k}_ms": v for k, v in per.items()},
                         **{f"this_over_{k}": per["this"] / v for k, v in per.items() if k != "this"}})


def other_gg(other, args, outs, gamma, rel=None):
    """One bare GG launch of a tree's kernel into ``outs``; ``rel``: the
    (V, 4) scratch of the two-kernel design, preallocated."""
    head = [a.data_ptr() for a in args]
    r, v = args[1].shape[0], args[4].shape[0]
    g2 = float(gamma) * float(gamma)
    dev = args[1].device
    scratch = (rel.data_ptr(),) if other["gg_rel"] else ()
    other["gg_near_far"].launch(*head, *scratch, outs[0].data_ptr(), outs[1].data_ptr(), r, v, g2,
                                stream_ptr(dev))


def other_plan(other, pts, tile_c, tile_r, outs, plan_p):
    """One bare plan launch of a tree's kernel into ``outs`` (order, counts,
    lbs)."""
    n_tiles = outs[0].shape[1]
    n_sort = (1 << (n_tiles - 1).bit_length(),) if other["bitonic"] else ()
    other["listed_plan"].launch(pts.data_ptr(), tile_c.data_ptr(), tile_r.data_ptr(),
                                *(o.data_ptr() for o in outs), pts.shape[0], plan_p, n_tiles,
                                tile_c.shape[1], *n_sort, stream_ptr(pts.device))


def other_pruned(other, pts, tabs, out, block_p, tighten):
    """One bare launch of a tree's pruned kernel into ``out`` (the launcher's
    signature is the same in every version)."""
    cent_t, tile_c, tile_r, n_tiles = tabs
    other["pruned_knn"].launch(pts.data_ptr(), cent_t.data_ptr(), tile_c.data_ptr(), tile_r.data_ptr(),
                               out.data_ptr(), pts.shape[0], block_p, n_tiles, cent_t.shape[1],
                               tile_c.shape[1], tighten, stream_ptr(pts.device))


def other_nearest(other, pts, cents, splits):
    out = torch.empty(pts.shape[0], dtype=torch.int32, device=pts.device)
    head = (pts.data_ptr(), cents.data_ptr(), out.data_ptr())
    if other["split"]:
        keys = torch.empty(pts.shape[0], dtype=torch.int64, device=pts.device) if splits > 1 else None
        other["nearest_face"].launch(*head, keys.data_ptr() if keys is not None else None,
                                     pts.shape[0], cents.shape[0], splits, stream_ptr(pts.device))
    else:
        other["nearest_face"].launch(*head, pts.shape[0], cents.shape[0], stream_ptr(pts.device))
    return out


def other_listed(other, slim, tighten, pts, cent_t, order, counts, lbs, plan_p):
    out = torch.empty(pts.shape[0], dtype=torch.int32, device=pts.device)
    args = (pts.data_ptr(), cent_t.data_ptr(), order.data_ptr(), counts.data_ptr(), lbs.data_ptr())
    if other["ranked"]:
        args += (torch.empty(counts.shape[0], dtype=torch.int32, device=pts.device).data_ptr(),)
    args += (out.data_ptr(), pts.shape[0], plan_p, order.shape[1], cent_t.shape[1])
    if slim:
        other["listed_knn_slim"].launch(*args, stream_ptr(pts.device))
    else:
        other["listed_knn"].launch(*args, int(tighten), stream_ptr(pts.device))
    return out


def inputs(dev):
    """Phase 3's shapes: the render chunk's world and blocked points, a
    random cloud, and the training step's world points with its mesh."""
    cfg = slice_cfg()
    settings = RenderSettings.from_cfg(cfg)
    ds = SyntheticDataset(split="val", n_frames=1, n_views=1, h=cs.H, w=cs.W)
    item = ds[0]
    mesh = item_to_mesh(item, ds.faces, ds.canonical_vertex, dev)
    rays0, _ = next(iter_ray_chunks(item, cfg.TEST.RAY_CHUNK, dev))
    near, far = gg_near_far_cuda(rays0.ray_o, rays0.ray_d, rays0.near, rays0.far,
                                 mesh.verts_world, settings.gg_gamma)
    z = stratified_z(near, far, settings.n_samples)
    pts_rs = sample_along_rays(rays0.ray_o, rays0.ray_d, z)
    to_blocked, _ = _block_layout(*z.shape, settings.block_sc)
    cents = face_centroids(mesh.verts_world, mesh.faces).contiguous()
    tds = SyntheticDataset(split="train", nrays=cs.TRAIN_RAYS, n_frames=1, n_views=1, h=cs.H, w=cs.W)
    titem = tds[0]
    tmesh = item_to_mesh(titem, tds.faces, tds.canonical_vertex, dev)
    tbatch = item_to_train_batch(titem, cs.TRAIN_RAYS, dev)
    tpts = cs.train_world_points(tbatch, tmesh, settings)
    blocked = to_blocked(pts_rs).contiguous()
    canonical, cents_c = cs.canonical_points(blocked, cents, mesh, settings)
    return {
        "canonical": canonical, "cents_c": cents_c,
        "rays": rays0, "step_rays": tbatch.rays, "step_mesh": tmesh, "gamma": settings.gg_gamma,
        "step_blocked": cs.train_world_points(tbatch, tmesh, settings, blocked=True),
        "mesh": mesh, "cents": cents, "world": pts_rs.reshape(-1, 3).contiguous(),
        "blocked": blocked, "cloud": cs.random_cloud(blocked.shape[0], cents),
        "step": tpts, "step_cents": face_centroids(tmesh.verts_world, tmesh.faces).contiguous(),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, action="append",
                    help="another tree's dual_space_nerf_tpu_torch/csrc (repeatable)")
    ap.add_argument("--rounds", type=int, default=11)
    ap.add_argument("--sections", default="searches,gg,plan,pruned",
                    help="comma-separated: searches, gg, plan, pruned, fused")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "search_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_search_ab: no CUDA device; this script measures only on the card")
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    others = {}
    for d in args.other:
        d = os.path.abspath(d)
        parts = d.rstrip("/").split("/")
        label = parts[-3] if parts[-1] == "csrc" and parts[-2] == "dual_space_nerf_tpu_torch" else parts[-2]
        others[label] = other_kernels(d) | {"csrc": d}
    sections = set(args.sections.split(","))
    build_s = build_all([NEAREST_KERNEL, LISTED_KERNEL, LISTED_SLIM_KERNEL, LISTED_PLAN_KERNEL, GG_KERNEL, PRUNED_KERNEL,
                         *(k for o in others.values() for n, k in o.items() if n not in FLAGS + ("csrc",))])
    results = {"card": card, "build_s": build_s, "rounds": args.rounds, "nearest_face": [],
               "listed": [], "listed_even": [], "listed_order": [], "splits": [], "gg": [], "plan": [],
               "pruned": [], "pruned_order": [], "fused": [],
               "ptxas": {}}
    for label, kernels in (("this", {"nearest_face": NEAREST_KERNEL, "listed_knn": LISTED_KERNEL,
                                     "listed_knn_slim": LISTED_SLIM_KERNEL, "gg_near_far": GG_KERNEL,
                                     "listed_plan": LISTED_PLAN_KERNEL, "pruned_knn": PRUNED_KERNEL}),
                        *others.items()):
        for name, k in kernels.items():
            if name not in FLAGS + ("csrc",):  # registers, spills and shared memory per entry
                results["ptxas"][f"{label} {name}"] = cs.ptxas_entries(k)
    print("ptxas: " + json.dumps(results["ptxas"]), flush=True)

    def report(kind, row):
        results[kind].append(row)
        print(f"{kind}: " + json.dumps(row), flush=True)

    mine = {"split": True, "ranked": True, "gg_rel": False, "bitonic": False, "nearest_face": NEAREST_KERNEL,
            "listed_knn": LISTED_KERNEL, "listed_knn_slim": LISTED_SLIM_KERNEL, "gg_near_far": GG_KERNEL,
            "listed_plan": LISTED_PLAN_KERNEL}
    if "fused" in sections:
        fused_section(others, args.rounds, report)
    if not sections - {"fused"}:
        sections = set()
    x = inputs(dev) if sections else None
    if "gg" in sections:
        gg_section(x, others, args.rounds, report)
    if "plan" in sections:
        plan_section(x, others, args.rounds, report)
    if "searches" in sections:
        search_sections(x, mine, others, args.rounds, report)
    if "pruned" in sections:
        pruned_section(x, others, args.rounds, report)
    print(card)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


def equal_outputs(want, fns: dict, what: str) -> None:
    """Every version's outputs (each fn returns a tuple of tensors) equal
    ``want`` bit for bit."""
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name}'s output {i} differs from the plain version")


def gg_section(x, others, rounds, report) -> None:
    """GG: this tree's kernel and the other trees', bit for bit and in turns
    (device time of bare launches), at the render chunk's 8192 rays and the
    step's 5500."""
    gamma = x["gamma"]
    for label, rays, mesh in (("render 8192 rays", x["rays"], x["mesh"]),
                              ("train step 5500 rays", x["step_rays"], x["step_mesh"])):
        args = (rays.ray_o, rays.ray_d, rays.near, rays.far, mesh.verts_world)
        rel = torch.empty((mesh.verts_world.shape[0], 4), dtype=torch.float32, device=rays.ray_d.device)
        fns, outs = {}, {}
        outs["this"] = (torch.empty_like(rays.near), torch.empty_like(rays.far))
        fns["this"] = lambda: gg_cuda.launch_gg(*args, *outs["this"], gamma)
        for name, o in others.items():
            outs[name] = (torch.empty_like(rays.near), torch.empty_like(rays.far))
            fns[name] = lambda o=o, out=outs[name]: other_gg(o, args, out, gamma, rel)
        want = gg_near_far_plain(*args, gamma)

        def run(fn, name):
            fn()
            return outs[name]

        equal_outputs(want, {name: (lambda fn=fn, name=name: run(fn, name)) for name, fn in fns.items()}, label)
        t = cs.device_turns_ms(fns, rounds)
        wrap = cs.alternate_ms({"this wrapper": lambda: gg_near_far_cuda(*args, gamma)}, rounds)
        counts = cs.gg_cull_counts(rays.ray_o, rays.ray_d, mesh.verts_world, gamma)
        floor = cs.gg_floor(counts)
        report("gg", {"shape": label, **counts, "kept_pair_share": floor["kept_pair_share"],
                      "issue_floor_ms": floor["issue_floor_ms"],
                      "all_pairs_issue_floor_ms": floor["all_pairs_issue_floor_ms"],
                      **{f"{k}_device_ms": v[0] for k, v in t.items()},
                      **{f"{k}_range": v[1] for k, v in t.items()},
                      "this_wrapper_ms": wrap["this wrapper"][0], "this_wrapper_range": wrap["this wrapper"][1],
                      "clock_sm_power_under_load": clock_under_load(fns["this"], 4000)})


def plan_section(x, others, rounds, report) -> None:
    """The plan: this tree's kernel and the other trees', bit for bit and in
    turns (device time of bare launches), at the render's blocked 524,288
    points and the step's 352,256."""
    plan_p = pruned_knn._PLAN_P_LISTED
    for label, pts, cents, mesh in (
        ("render blocked 524,288", x["blocked"], x["cents"], x["mesh"]),
        ("train step blocked 352,256", x["step_blocked"], x["step_cents"], x["step_mesh"]),
    ):
        _, tile_c, tile_r, _ = listed_tables(cents, mesh.tile_table)
        n_tiles = mesh.tile_table.shape[0]
        want = pruned_knn.listed_plan_plain(pts, tile_c, tile_r, n_tiles, plan_p)
        fns, outs = {}, {}
        outs["this"] = tuple(torch.empty_like(w) for w in want)
        fns["this"] = lambda: pruned_knn.launch_plan(pts, tile_c, tile_r, *outs["this"], plan_p)
        for name, o in others.items():
            outs[name] = tuple(torch.empty_like(w) for w in want)
            fns[name] = lambda o=o, out=outs[name]: other_plan(o, pts, tile_c, tile_r, out, plan_p)

        def run(fn, name):
            fn()
            return outs[name]

        equal_outputs(want, {name: (lambda fn=fn, name=name: run(fn, name)) for name, fn in fns.items()}, label)
        t = cs.device_turns_ms(fns, rounds)
        wrap = cs.alternate_ms({"this wrapper": lambda: pruned_knn.listed_plan(
            pts, tile_c, tile_r, n_tiles, plan_p)}, rounds)
        q = lambda sym: LISTED_PLAN_KERNEL.extra_function(sym, [_I, _I])(plan_p, n_tiles)
        counts = cs.plan_cull_counts(pts, tile_c, tile_r, n_tiles, plan_p)
        floor = cs.plan_floor(counts)
        report("plan", {"shape": label, "points": pts.shape[0], "tiles": n_tiles,
                        "visits_mean": float(want[1].float().mean()),
                        **counts, "issue_floor_ms": floor["issue_floor_ms"],
                        "all_pairs_issue_floor_ms": floor["all_pairs_issue_floor_ms"],
                        "blocks_per_sm": q("listed_plan_blocks_per_sm"), "smem_bytes": q("listed_plan_smem"),
                        **{f"{k}_device_ms": v[0] for k, v in t.items()},
                        **{f"{k}_range": v[1] for k, v in t.items()},
                        "this_wrapper_ms": wrap["this wrapper"][0], "this_wrapper_range": wrap["this wrapper"][1],
                        "clock_sm_power_under_load": clock_under_load(fns["this"], 4000)})


def pruned_section(x, others, rounds, report) -> None:
    """The pruned search: this tree's kernel and the other trees', id for id
    with each other and with the plain version, and in turns (device time
    of bare launches), on the render chunk's blocked world points, the
    canonical points of the same chunk and the random cloud, at tighten 1
    and 0, with the issue floor from the plain version's visits; then this
    tree's kernel on the world blocks taken longest visit list first and
    last."""
    block_p = pruned_knn._BLOCK_P
    for label, pts, cents in (("render blocked world 524,288", x["blocked"], x["cents"]),
                              ("render blocked canonical 524,288", x["canonical"], x["cents_c"]),
                              ("random cloud 524,288", x["cloud"], x["cents"])):
        tabs = pruned_knn.pruned_tables(cents, x["mesh"].face_perm)
        for tighten in (1, 0):
            want, visits = pruned_knn.pruned_search_plain(pts, *tabs, block_p, tighten=tighten,
                                                          with_visits=True)
            outs = {name: torch.empty_like(want) for name in ("this", *others)}
            fns = {"this": lambda: pruned_knn.launch_pruned(pts, *tabs, outs["this"], block_p, tighten)}
            for name, o in others.items():
                fns[name] = lambda o=o, out=outs[name]: other_pruned(o, pts, tabs, out, block_p, tighten)
            for fn in fns.values():
                fn()
            torch.cuda.synchronize()
            for name, out in outs.items():
                if not torch.equal(out, want):
                    raise AssertionError(f"pruned {label}: {name}'s ids differ from the plain version")
            t = cs.device_turns_ms(fns, rounds)
            floor = cs.pruned_floor(visits, tabs[3], block_p)
            report("pruned", {"shape": label, "tighten": tighten, "points": pts.shape[0], "tiles": tabs[3],
                              "block_p": block_p, **floor,
                              **{f"{k}_device_ms": v[0] for k, v in t.items()},
                              **{f"{k}_range": v[1] for k, v in t.items()},
                              "this_issue_floor_share": floor["issue_floor_ms"] / t["this"][0],
                              "clock_sm_power_under_load": clock_under_load(fns["this"], 400)})
    # this tree's kernel on the world blocks in another order, by the plain
    # version's visits: longest list first, and last (the same blocks, so
    # the same pairs; the order only moves the tail)
    tabs = pruned_knn.pruned_tables(x["cents"], x["mesh"].face_perm)
    for bp in (256, block_p):
        visits = pruned_knn.pruned_search_plain(x["blocked"], *tabs, bp, with_visits=True)[1]
        blocks = x["blocked"].reshape(-1, bp, 3)
        fns = {}
        for order, perm in (("own", torch.arange(blocks.shape[0], device=blocks.device)),
                            ("longest first", torch.sort(visits, descending=True, stable=True).indices),
                            ("longest last", torch.sort(visits, stable=True).indices)):
            p = blocks[perm].reshape(-1, 3).contiguous()
            out = torch.empty(p.shape[0], dtype=torch.int32, device=p.device)
            fns[order] = lambda p=p, out=out: pruned_knn.launch_pruned(p, *tabs, out, bp, 1)
        t = cs.device_turns_ms(fns, rounds)
        report("pruned_order", {"block_p": bp, "visits_min": int(visits.min()), "visits_max": int(visits.max()),
                                **{f"{k} device_ms": v[0] for k, v in t.items()},
                                **{f"{k} range": v[1] for k, v in t.items()}})


def search_sections(x, mine, others, rounds, report) -> None:
    """The brute-force and listed searches against the other trees'."""

    def turns(this, that: dict, same) -> dict:
        """``this`` and every other version: the same ids, then timed in turns."""
        ids = this()
        for name, fn in that.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(ids, got):
                raise AssertionError(f"{name}: ids differ from this tree's")
        if not torch.equal(ids, same()):
            raise AssertionError("this tree's ids differ from the plain version")
        t = cs.alternate_ms({"this": this, **that}, rounds)
        return {f"{k}_ms": v[0] for k, v in t.items()} | {f"{k}_range": v[1] for k, v in t.items()}

    for label, pts, cents in (("render world 524,288", x["world"], x["cents"]),
                              ("random cloud 524,288", x["cloud"], x["cents"]),
                              ("train step 352,000", x["step"], x["step_cents"])):
        auto = kernel_splits(pts.shape[0], cents.shape[0])
        # every version through the same bare launch (no wrapper checks)
        this = lambda: other_nearest(mine, pts, cents, auto)
        that = {name: (lambda o=o: other_nearest(o, pts, cents, auto)) for name, o in others.items()}
        report("nearest_face", {"shape": label, "points": pts.shape[0], "faces": cents.shape[0],
                                "splits": auto, **turns(this, that, lambda: nearest_face_plain(pts, cents)),
                                "clock_sm_power_under_load": clock_under_load(this)})
        if label != "random cloud 524,288":
            splits = {f"splits={s}": (lambda s=s: other_nearest(mine, pts, cents, s)) for s in (1, 2, 3, 4)}
            t = cs.alternate_ms({"auto": this, **splits}, rounds)
            report("splits", {"shape": label, "auto": auto, **{k: {"ms": v[0], "range": v[1]} for k, v in t.items()}})

    cent_t, tile_c, tile_r, _ = listed_tables(x["cents"], x["mesh"].tile_table)
    n_tiles = x["mesh"].tile_table.shape[0]
    plan_p = pruned_knn._PLAN_P_LISTED
    for label in ("blocked", "cloud"):
        pts = x[label]
        plan = pruned_knn.listed_plan(pts, tile_c, tile_r, n_tiles, plan_p)
        pairs = float(plan[1].sum()) * plan_p * 128
        for variant, slim, tighten in (("wide", False, False), ("tighten", False, True), ("slim", True, False)):
            this = lambda: other_listed(mine, slim, tighten,
                                        pts, cent_t, *plan, plan_p)
            that = {name: (lambda o=o: other_listed(o, slim, tighten, pts, cent_t, *plan, plan_p))
                    for name, o in others.items()}
            report("listed", {"shape": label, "variant": variant, "points": pts.shape[0], "pairs": pairs,
                              "issue_floor_ms": cs.issue_floor_ms(pairs),
                              **turns(this, that, lambda: pruned_knn.listed_search_plain(
                                  pts, cent_t, *plan, plan_p, slim, tighten)),
                              "clock_sm_power_under_load": clock_under_load(this, 2000)})
    # this tree's listed kernels on the blocked rows' own lists cut to one
    # length for every row: per-pair time without the spread of list lengths
    order, counts, lbs = pruned_knn.listed_plan(x["blocked"], tile_c, tile_r, n_tiles, plan_p)
    for visits in (1, 10, 26):
        even = torch.full_like(counts, visits)
        pairs = float(even.sum()) * plan_p * 128
        for variant, slim in (("wide", False), ("slim", True)):
            t = cs.time_ms(lambda: other_listed(mine, slim, False,
                                                x["blocked"], cent_t, order, even, lbs, plan_p), reps=rounds)
            report("listed_even", {"visits_per_row": visits, "variant": variant, "pairs": pairs, "ms": t,
                                   "ns_per_pair": t * 1e6 / pairs, "issue_floor_ms": cs.issue_floor_ms(pairs)})
    # the same rows in another order: longest list first, and last
    rows = counts.shape[0]
    by_rows = x["blocked"].reshape(rows, plan_p, 3)
    for label, descending in (("longest first", True), ("longest last", False)):
        perm = torch.sort(counts, descending=descending, stable=True).indices
        p_pts = by_rows[perm].reshape(-1, 3).contiguous()
        p_plan = (order[perm].contiguous(), counts[perm].contiguous(), lbs[perm].contiguous())
        pairs = float(counts.sum()) * plan_p * 128
        for variant, slim in (("wide", False), ("slim", True)):
            t = cs.time_ms(lambda: other_listed(mine, slim, False,
                                                p_pts, cent_t, *p_plan, plan_p), reps=rounds)
            report("listed_order", {"rows": label, "variant": variant, "pairs": pairs, "ms": t,
                                    "issue_floor_ms": cs.issue_floor_ms(pairs)})


if __name__ == "__main__":
    sys.exit(main())
