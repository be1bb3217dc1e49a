"""Traffic of kind ``train``: the training loop as the program's
`training/loop.py::do_train` composes it, checkpoints and logging left out.

Items of the mix's split (frames x views of the capsule scene, a fixed
number of rays each) come through the program's `PrefetchLoader` (the
configuration's workers, ordered, so that a seed gives the same stream)
with its own transform, `item_to_train_batch` and `item_to_mesh`; each
step draws its uniforms and normals on the device from the seed (with the
fine pass, ``FINE_RAY_SAMPLING`` > 0, two more after them) and calls the
program's step; the previous step's metrics are read one step
late. The first steps run in set-up and are the ones the reference
follows; the measured window continues with the same state.
"""

from __future__ import annotations

import contextlib
import time

import torch

from .. import compare, flops, harness
from ..reference.render import Settings
from ..reference.scene import CapsuleScene
from ..reference.train import batch_tensors, train_steps
from ..trace import record


class Items:
    """The split's items by index, as the loader asks for them."""

    def __init__(self, scene: CapsuleScene, traffic: dict, nrays: int):
        first, last = traffic["frames"]
        self.index = [(f, v) for f in range(first, last + 1) for v in traffic["views"]]
        self.scene, self.nrays, self.body_share = scene, nrays, traffic["body_share"]
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.index)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __getitem__(self, i: int) -> dict:
        frame, view = self.index[i]
        return self.scene.train_item(frame, view, self.nrays, self.epoch, i, self.body_share)


def _span(on: bool, name: str):
    return torch.profiler.record_function("portbench." + name) if on else contextlib.nullcontext()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Session:
    """Set-up: the scene, the model with fresh weights, Adam, the loader,
    and the first steps (which also warm every shape up)."""

    unit = "step"

    def __init__(self, cell: harness.Cell, seed: int, device, hooks: dict | None = None):
        from dual_space_nerf_tpu_torch.data.batching import item_to_mesh, item_to_train_batch
        from dual_space_nerf_tpu_torch.data.prefetch import PrefetchLoader
        from dual_space_nerf_tpu_torch.renderer import RenderSettings
        from dual_space_nerf_tpu_torch.training import create_train_state, make_train_step

        hooks = hooks or {}
        t0 = time.perf_counter()
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        cfg = self.cfg = harness.port_cfg(cell.config)
        self.settings = RenderSettings.from_cfg(cfg)
        self.scene = CapsuleScene(seed, cell.traffic["scene"])
        self.nrays, self.n_samples = int(cfg.SOLVER.TRAIN_NRAYS), int(cfg.MODEL.COARSE_RAY_SAMPLING)
        self.n_fine = max(int(cfg.MODEL.FINE_RAY_SAMPLING), 0)
        self.model, self.weights = harness.build_model(cfg, seed, self.dev)
        self.state = create_train_state(self.model, cfg)
        step = make_train_step(self.settings, loss_type=cfg.MODEL.LOSS,
                               loss_with_mask=cfg.MODEL.LOSSwMask, device=self.dev)
        self.step = hooks["wrap_step"](step) if "wrap_step" in hooks else step
        faces, cano, dev = self.scene.faces, self.scene.verts_cano, self.dev

        def to_device(item):  # do_train's transform, with the item kept for the reference
            return item_to_train_batch(item, self.nrays, dev), item_to_mesh(item, faces, cano, dev), item

        self.loader = PrefetchLoader(
            Items(self.scene, cell.traffic, self.nrays), shuffle=True,
            num_workers=cfg.DATALOADER.NUM_WORKERS, seed=harness.sub_seed(seed, "loader"),
            transform=to_device, backend=cfg.DATALOADER.BACKEND, ordered=True)
        self.it = iter(self.loader)
        self.gen = torch.Generator(device=self.dev)
        self.k, self.pending = 0, None
        t1 = time.perf_counter()
        self._first_steps(int(cell.traffic["check_steps"]))
        _sync(self.dev)
        self.setup_parts = {"model_and_loader_s": t1 - t0, "first_steps_s": time.perf_counter() - t1}

    # ---- the loop's parts -------------------------------------------------
    def _next(self):
        try:
            return next(self.it)
        except StopIteration:  # the next epoch
            self.it = iter(self.loader)
            return next(self.it)

    def _draw(self):
        """The step's uniforms and normals (R, S); with the fine pass then
        its uniforms (R, n_fine) and normals (R, S + n_fine), drawn after
        the first two, so that without it the draws are the same bits."""
        self.k += 1
        self.gen.manual_seed(harness.sub_seed(self.seed, "draws", self.k) & ((1 << 63) - 1))
        r, s, nf = self.nrays, self.n_samples, self.n_fine
        draws = (torch.rand((r, s), generator=self.gen, device=self.dev),
                 torch.randn((r, s), generator=self.gen, device=self.dev))
        if nf > 0:
            draws += (torch.rand((r, nf), generator=self.gen, device=self.dev),
                      torch.randn((r, s + nf), generator=self.gen, device=self.dev))
        return draws

    @staticmethod
    def _read(metrics) -> None:
        float(metrics["loss"])
        float(metrics["psnr"])

    def _iterate(self, traced: bool = False) -> float:
        """One iteration of the loop; returns its wait in next()."""
        with _span(traced, "step"):
            t0 = time.perf_counter()
            with _span(traced, "loader_wait"):
                batch, mesh, _ = self._next()
            wait = time.perf_counter() - t0
            with _span(traced, "draws"):
                randoms = self._draw()
            with _span(traced, "train_step"):
                metrics = self.step(self.state, batch, mesh, randoms)
            with _span(traced, "metrics_read"):
                if self.pending is not None:
                    self._read(self.pending)
            self.pending = metrics
        return wait

    def _first_steps(self, n: int) -> None:
        """The steps the reference follows: their items and draws, each
        loss, Adam's first moments after the first, the weights after the last."""
        self.check_items, self.check_randoms, self.losses = [], [], []
        names = dict((id(p), k) for k, p in self.model.named_parameters())
        for i in range(n):
            batch, mesh, item = self._next()
            randoms = self._draw()
            metrics = self.step(self.state, batch, mesh, randoms)
            self.losses.append(float(metrics["loss"]))
            self.check_items.append(item)
            self.check_randoms.append(randoms)
            if i == 0:
                opt = self.state.optimizer
                self.first_moments = {
                    names[id(p)]: (opt.state[p]["exp_avg"].clone() if "exp_avg" in opt.state.get(p, {})
                                   else torch.zeros_like(p))
                    for g in opt.param_groups for p in g["params"]}
        self.after_steps = {k: p.detach().clone() for k, p in self.model.named_parameters()}

    # ---- the run ----------------------------------------------------------
    def step_flops(self) -> tuple[float, float]:
        return flops.render_counts(self.nrays, self.n_samples, self.n_fine,
                                   self.settings.shade_topk, train=True)

    def window(self, seconds: float) -> dict:
        """Steps until ``seconds`` have passed; the step across the end
        finishes and counts. Returns the end-to-end numbers and the
        window's readings, the loader's counters at its start and end among
        them."""
        _sync(self.dev)
        stats_at = self.loader.stats
        t0 = t_prev = time.perf_counter()
        intervals, waits = [], []
        while True:
            waits.append(self._iterate())
            t = time.perf_counter()
            intervals.append(t - t_prev)
            t_prev = t
            if t - t0 >= seconds:
                break
        self._read(self.pending)
        self.pending = None
        elapsed = time.perf_counter() - t0
        n = len(intervals)
        return {"units": n, "seconds": elapsed, "waits": waits, "unit_s": intervals,
                "loader_stats": (stats_at, self.loader.stats),
                "metrics": {"s_per_step": elapsed / n, "step_p90_s": harness.p90(intervals)}}

    def trace(self, n: int):
        """The traced stretch: ``n`` iterations after one unrecorded, the
        last metrics read in a closing span."""
        last = n  # the warm-up is iteration 0

        def unit(i):
            self._iterate(traced=True)
            if i == last:
                with _span(True, "drain"):
                    self._read(self.pending)
                self.pending = None

        tr = record(unit, n_active=n, n_warm=1)
        fl, by = self.step_flops()
        return tr, fl * n, by * n

    def close(self) -> None:
        """Stop the loader's workers and free the program's state."""
        self.it.close()
        del self.state, self.model, self.step, self.loader, self.it
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, tf32: bool = False, detail: dict | None = None) -> dict:
        """The reference's steps from the same weights, items and draws,
        against the program's (with ``tf32``: the reference computed in
        TF32, in the program's place)."""
        ref_settings = Settings.from_model_block(self.cell.config["MODEL"])
        batches = [batch_tensors(it, self.scene.verts_cano, self.scene.faces, self.dev)
                   for it in self.check_items]
        ref = train_steps(self.weights, batches, self.check_randoms, ref_settings,
                          self.cell.config["SOLVER"])
        if not tf32:
            return compare.train_numbers(self.losses, self.first_moments, self.after_steps,
                                         self.weights, ref, detail)
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ctl = train_steps(self.weights, batches, self.check_randoms, ref_settings,
                              self.cell.config["SOLVER"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        moments = {k: (1.0 - compare.BETA1) * g for k, g in ctl["first_grads"].items()}
        return compare.train_numbers(ctl["losses"], moments, ctl["final"], self.weights, ref, detail)
