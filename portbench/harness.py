"""The harness's shared parts: the benchmark's files found by name, the
program's configuration, weights from the seed, the result line.

A cell (an entry of BENCHMARK.json's ``workloads``) names a configuration
(``configs/<name>.json``: the shipped config's blocks, copied as data) and
a traffic mix (``traffic/<name>.json``, whose ``kind`` picks the loop
``loops/<kind>.py``). Its per-layer metrics are read by
``metrics/<metric>.py``, and its correctness limits are in
``limits/<cell>.json``. Adding any of these is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
#: the blocks of a configuration file that are merged into the program's config
RUN_BLOCKS = ("MODEL", "SOLVER", "DATALOADER", "TEST")
_MASK64 = (1 << 64) - 1


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and limits."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec or load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
        self.spec = spec
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = load_json(os.path.join(ROOT, configs[self.entry["config"]]["file"]))
        self.traffic = load_json(os.path.join(BENCH, "traffic", self.entry["traffic"] + ".json"))
        limits = os.path.join(BENCH, "limits", name + ".json")
        self.limits = load_json(limits)["limits"] if os.path.exists(limits) else None

    def metrics(self, kind: str) -> list[dict]:
        """The cell's ``end_to_end`` or ``per_layer`` metrics."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]


def sub_seed(seed: int, *keys) -> int:
    """A 64-bit seed that depends on ``seed`` and the keys alone."""
    words = [int(seed) & _MASK64] + [k if isinstance(k, int) else sum(map(ord, k)) for k in keys]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def port_cfg(config: dict):
    """The program's config tree: its defaults with the configuration's
    run blocks merged in, as `cli/common.py::load_cfg` merges a file."""
    from dual_space_nerf_tpu_torch.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_other_cfg({k: config[k] for k in RUN_BLOCKS if k in config})
    cfg.freeze()
    return cfg


#: raised density bias of the fresh avatar (see `make_weights`)
DENSITY_BIAS = 20.0


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Fresh weights on ``device`` from the seed, in two draws: every
    Linear weight and bias uniform in +-1/sqrt(fan in) (torch's default
    initialisation), the frame codes standard normal; the density head's
    bias is then raised by `DENSITY_BIAS`, so that the body's 10 cm shell
    is opaque within a few samples, as a trained avatar's surface is (at
    torch's initialisation alone a seed's density can be negative
    everywhere, and its images empty). ``shapes``: name -> shape; returns
    name -> float32 tensor."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights") & ((1 << 63) - 1))
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in names]
    bounds = []
    for k in names:
        if k.endswith(".bias"):
            fan_in = shapes[k[:-len("bias")] + "weight"][1]
        else:
            fan_in = shapes[k][1]
        bounds.append(1.0 / float(fan_in) ** 0.5)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    flat *= torch.repeat_interleave(torch.tensor(bounds, device=device),
                                    torch.tensor(sizes, device=device))
    out = dict(zip(names, (t.view(shapes[k]) for k, t in zip(names, flat.split(sizes)))))
    codes = [k for k in names if k.endswith("embedding.weight")]
    normals = torch.randn(sum(out[k].numel() for k in codes), generator=gen, device=device)
    at = 0
    for k in codes:
        out[k] = normals[at:at + out[k].numel()].view(shapes[k])
        at += out[k].numel()
    for k in names:
        if k.endswith("density_net.0.bias"):
            out[k] = out[k] + DENSITY_BIAS
    return out


def build_model(cfg, seed: int, device):
    """The program's model at the configuration's widths, built on
    ``device`` and given fresh weights from the seed: (model, weights)."""
    import torch

    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF, compute_dtype

    with torch.device(device):
        model = DualSpaceNeRF(max_frames=cfg.MODEL.MAX_FRAMES, code_dim=cfg.MODEL.CODE_DIM,
                              backbone_dim=cfg.MODEL.BACKBONE_DIM, compute_dtype=compute_dtype(cfg))
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    weights = make_weights(shapes, seed, device)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(weights[k])
    return model, weights


def p90(xs: list) -> float:
    """The 90th percentile, as `statistics.quantiles` gives it."""
    return statistics.quantiles(xs, n=10)[-1] if len(xs) > 1 else float(xs[0])


def load_reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop(kind: str):
    return importlib.import_module(f"portbench.loops.{kind}")


def peaks(device_name: str, precision: str) -> tuple[float | None, float | None]:
    """The card's (FLOP/s at ``precision``, bytes/s) from `peaks.json`, or
    (None, None) for a card it does not list."""
    card = load_json(os.path.join(BENCH, "peaks.json"))["cards"].get(device_name)
    if card is None:
        return None, None
    return float(card["flops"][precision]), float(card["bytes_per_s"])


def judge(numbers: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number that is not finite fails; without limits nothing is
    correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in numbers.items()}
    if set(limits) != set(numbers):
        raise KeyError(f"limits for {sorted(limits)}, numbers {sorted(numbers)}")
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(numbers)}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return bool(ok), checks
