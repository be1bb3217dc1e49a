"""Traffic of kind ``render``: whole images of held-out views, one after
another, through the program's `ImageRenderer.render_item` as
`cli/test.py` renders them (the configuration's ray chunk, the default
float16 eval copy).

The images (every ray of the view that hits the body's box, of a frame)
are made in set-up from the seed and cycled through; the window renders
until its time is up and the image across the end finishes and counts.
Afterwards a sample of the window's images, and of the rays of each,
drawn from the seed, is rendered again by the plain reference (with the
fine pass, ``FINE_RAY_SAMPLING`` > 0, both passes' values are compared).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import compare, flops, harness
from ..reference import scene as scene_mod
from ..reference.render import Settings, render
from ..trace import record


def _span(on: bool, name: str):
    return torch.profiler.record_function("portbench." + name) if on else contextlib.nullcontext()


def _one_chunk(item: dict, chunk: int) -> dict:
    """The first ``chunk`` rays of an image, as an image of their own."""
    out = dict(item)
    for k in ("ray_o", "ray_d", "near", "far", "coord"):
        out[k] = item[k][:chunk]
    mab = np.zeros_like(item["mask_at_box"])
    mab[np.flatnonzero(item["mask_at_box"])[:chunk]] = True
    out["mask_at_box"] = mab
    return out


class Session:
    """Set-up: the images, the model with fresh weights, the renderer, and
    one chunk rendered to warm every shape up (every chunk has the same
    size: the last is padded)."""

    unit = "render_item"

    def __init__(self, cell: harness.Cell, seed: int, device, hooks: dict | None = None):
        from dual_space_nerf_tpu_torch.evaluation.render_image import ImageRenderer
        from dual_space_nerf_tpu_torch.renderer import RenderSettings

        hooks = hooks or {}
        t0 = time.perf_counter()
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        tr = cell.traffic
        cfg = self.cfg = harness.port_cfg(cell.config)
        self.settings = RenderSettings.from_cfg(cfg)
        self.scene = scene_mod.CapsuleScene(seed, tr["scene"])
        first, last = tr["frames"]
        frames = list(range(first, last + 1))
        self.items = [self.scene.image_item(frames[(i * tr["frame_stride"]) % len(frames)],
                                            tr["views"][i % len(tr["views"])])
                      for i in range(tr["images"])]
        t1 = time.perf_counter()
        self.model, self.weights = harness.build_model(cfg, seed, self.dev)
        self.renderer = ImageRenderer(self.model, self.settings, self.scene.faces,
                                      self.scene.verts_cano, chunk=cfg.TEST.RAY_CHUNK,
                                      device=self.dev, pack=tr["pack"])
        self.render_item = (hooks["wrap_render"](self.renderer.render_item)
                            if "wrap_render" in hooks else self.renderer.render_item)
        t2 = time.perf_counter()
        self.render_item(_one_chunk(self.items[0], cfg.TEST.RAY_CHUNK))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.setup_parts = {"images_s": t1 - t0, "model_s": t2 - t1,
                            "warm_chunk_s": time.perf_counter() - t2}
        self.outputs = []  # (item index, the program's images)

    def image_flops(self, item: dict) -> tuple[float, float]:
        return flops.render_counts(len(item["ray_o"]), int(self.cfg.MODEL.COARSE_RAY_SAMPLING),
                                   max(int(self.cfg.MODEL.FINE_RAY_SAMPLING), 0),
                                   self.settings.shade_topk, train=False)

    def window(self, seconds: float | None = None, images: int | None = None) -> dict:
        """Images until ``seconds`` have passed (or ``images`` are done)."""
        t0 = t_prev = time.perf_counter()
        n, unit_s = 0, []
        while True:
            i = len(self.outputs) % len(self.items)
            self.outputs.append((i, self.render_item(self.items[i])))
            n += 1
            now = time.perf_counter()
            unit_s.append(now - t_prev)
            t_prev = now
            t = now - t0
            if (images is not None and n >= images) or (seconds is not None and t >= seconds):
                break
        done = [self.items[i] for i, _ in self.outputs[-n:]]
        fl = sum(self.image_flops(item)[0] for item in done)
        chunk = int(self.cfg.TEST.RAY_CHUNK)
        chunks = sum(-(-len(item["ray_o"]) // chunk) for item in done)
        return {"units": n, "seconds": t, "flops": fl, "unit_s": unit_s, "chunks": chunks,
                "metrics": {"s_per_image": t / n}}

    def device_metrics(self, win: dict, busy_s: float) -> dict:
        """The window's device time per chunk of RAY_CHUNK rays (every
        chunk is that size, the last padded): images differ in size and
        the window ends after as many as the host manages, so a time per
        image would follow how far into the cycle it got."""
        return {"device_ms_per_chunk": 1e3 * busy_s / win["chunks"]}

    def trace(self, n: int):
        """The traced stretch: the cycle's first image ``n`` times after
        one unrecorded, so that every run traces the same work."""
        item = self.items[0]

        def unit(_):
            with _span(True, "render_item"):
                self.render_item(item)

        tr = record(unit, n_active=n, n_warm=1)
        fl, by = self.image_flops(item)
        return tr, fl * n, by * n

    def close(self) -> None:
        del self.renderer, self.model, self.render_item
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self) -> list:
        """(output, ray indices) of the compared images, drawn from the seed."""
        tr = self.cell.traffic["check"]
        g = scene_mod.rng(self.seed, 5)
        picks = g.choice(len(self.outputs), size=min(tr["images"], len(self.outputs)), replace=False)
        out = []
        for j in sorted(picks):
            i, images = self.outputs[j]
            n = len(self.items[i]["ray_o"])
            out.append((i, images, np.sort(g.choice(n, size=min(tr["rays"], n), replace=False))))
        return out

    def check(self, tf32: bool = False, detail: dict | None = None) -> dict:
        """The reference on the sampled rays against the program's values
        there (with ``tf32``: the reference computed in TF32 and copied
        as the program copies, in the program's place)."""
        settings = Settings.from_model_block(self.cell.config["MODEL"])
        passes = ("coarse", "fine") if settings.n_fine > 0 else ("coarse",)
        progs, refs, ctls = [], [], []
        for i, images, rays in self._sample():
            item = self.items[i]
            pix = np.flatnonzero(item["mask_at_box"])[rays]
            flat = lambda k, c: images[k].reshape(-1, c)[pix]
            progs.append(np.concatenate([flat(f"{p}_{k}", c) for p in passes
                                         for k, c in (("color", 3), ("acc", 1), ("depth", 1))],
                                        axis=1))
            refs.append(self._reference(item, rays, settings))
            if tf32:
                prev = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    ctls.append(compare.pack_f16(self._reference(item, rays, settings)))
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = prev
        prog = np.concatenate(ctls if tf32 else progs)
        if detail is not None:
            detail["images"] = []
            for p_i, r_i in zip(ctls if tf32 else progs, refs):
                d = {}
                compare.render_numbers(p_i, r_i, d)
                detail["images"].append(d)
        return compare.render_numbers(prog, np.concatenate(refs), detail)

    def _reference(self, item: dict, rays: np.ndarray, settings: Settings) -> np.ndarray:
        dev = self.dev
        t = lambda k: torch.as_tensor(np.ascontiguousarray(item[k][rays]), device=dev)
        batch = {"ray_o": t("ray_o"), "ray_d": t("ray_d"), "near": t("near"), "far": t("far"),
                 "frame": int(item["frame"]),
                 "body_pose": torch.as_tensor(item["poses"][1:24], device=dev)}
        mesh = {"faces": torch.as_tensor(self.scene.faces.astype(np.int64), device=dev),
                "verts_world": torch.as_tensor(item["xyz"], device=dev),
                "verts_cano": torch.as_tensor(self.scene.verts_cano, device=dev)}
        out = render(self.weights, batch, mesh, settings)
        prefixes = ("", "fine_") if settings.n_fine > 0 else ("",)
        return torch.cat([t for p in prefixes for t in (out[p + "color"], out[p + "acc"][:, None],
                                                         out[p + "depth"][:, None])], 1).cpu().numpy()
