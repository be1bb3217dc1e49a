"""What the per-layer metric readers (`metrics/<name>.py`) share.

A reader takes the run's `Readings` and returns the metric's number, or
None where the run holds nothing to read it from (no trace, no device time
of the families it needs, a card without a row in `peaks.json`): the
harness then leaves the metric out of the result line.
"""

from __future__ import annotations

import dataclasses

from . import flops
from .trace import Trace, classify


@dataclasses.dataclass
class Readings:
    trace: Trace | None          # the traced stretch
    unit: str                    # the stretch's unit span: "step" or "render_item"
    families: list               # kernel families, in the order they are tried
    stretch_flops: float         # model FLOPs and bytes of the stretch's units
    stretch_bytes: float
    window_units: int            # steps or images of the measured window
    window_s: float              # its wall seconds
    window_flops: float          # model FLOPs of its units
    peak_flops: float | None     # the card's peaks at the configuration's precision
    peak_bytes: float | None
    loader_waits_s: list         # train: the wait in next() of each window step
    loader_stats: tuple = ()     # train: the loader's counters at the window's start and end


def family_device_s(r: Readings, role: str) -> float | None:
    """Device seconds in the stretch of the families with ``role``."""
    if r.trace is None:
        return None
    t0, t1, _ = r.trace.stretch(r.unit)
    fams = {f.name for f in r.families if role in f.roles}
    ns = sum(e - s for name, s, e, _ in r.trace.in_stretch(t0, t1)
             if classify(name, r.families).name in fams)
    return ns / 1e9


def launches_per_unit(r: Readings) -> float | None:
    if r.trace is None:
        return None
    t0, t1, n = r.trace.stretch(r.unit)
    return sum(1 for d in r.trace.in_stretch(t0, t1) if d[3]) / n


def search_ms_per_unit(r: Readings) -> float | None:
    s = family_device_s(r, "searches")
    if s is None or s == 0:
        return None
    return s * 1e3 / r.trace.stretch(r.unit)[2]


def stage_host_ms(r: Readings, stage: str) -> float | None:
    """Wall ms a unit of the stretch in which the main thread is inside
    the program's ``dsnerf.<stage>`` spans."""
    if r.trace is None:
        return None
    t0, t1, n = r.trace.stretch(r.unit)
    ns = r.trace.stage_host_ns(stage, t0, t1)
    return None if ns is None else ns / 1e6 / n


def stage_device_ms(r: Readings, stage: str) -> float | None:
    """Device ms a unit of the stretch of the ops launched inside the
    program's ``dsnerf.<stage>`` spans."""
    if r.trace is None:
        return None
    t0, t1, n = r.trace.stretch(r.unit)
    ns = r.trace.stage_device_ns(stage, t0, t1)
    return None if ns is None else ns / 1e6 / n


def loader_transform_ms(r: Readings) -> float | None:
    """The loader's transform time over the items it yielded in the
    window, ms: the difference of its counters at the window's ends."""
    if len(r.loader_stats) != 2:
        return None
    start, end = r.loader_stats
    items = end["items"] - start["items"]
    return 1e3 * (end["transform_s"] - start["transform_s"]) / items if items > 0 else None


def fused_pass_share(r: Readings) -> float | None:
    """The fused network passes of the stretch over all its passes, %."""
    if r.trace is None or not sum(r.trace.passes.values()):
        return None
    return 100.0 * r.trace.passes.get("fused", 0) / sum(r.trace.passes.values())


def networks_roofline(r: Readings) -> float | None:
    """The networks' bound (model FLOPs at the peak, or their bytes at the
    memory rate) over the device time of the families that run them, %."""
    s = family_device_s(r, "networks")
    if not s or r.peak_flops is None:
        return None
    return 100.0 * flops.bound_s(r.stretch_flops, r.stretch_bytes, r.peak_flops, r.peak_bytes) / s


def device_idle(r: Readings) -> float | None:
    """Share of the stretch in which no device op runs, %."""
    if r.trace is None:
        return None
    t0, t1, _ = r.trace.stretch(r.unit)
    return 100.0 * (1.0 - r.trace.busy_ns(t0, t1) / (t1 - t0))


def mfu(r: Readings) -> float | None:
    """Model FLOPs of the measured window over its wall time at the peak, %."""
    if r.peak_flops is None or r.window_s <= 0:
        return None
    return 100.0 * r.window_flops / (r.window_s * r.peak_flops)


def wall_s_per_unit(r: Readings) -> float | None:
    """The measured window's wall seconds over the steps or images it completed."""
    return r.window_s / r.window_units if r.window_units else None


def device_mfu(r: Readings) -> float | None:
    """Model FLOPs of the traced stretch over the card's busy time in it at
    the peak, %: the whole unit's share of the peak while the card works."""
    if r.trace is None or r.peak_flops is None:
        return None
    t0, t1, _ = r.trace.stretch(r.unit)
    busy = r.trace.busy_ns(t0, t1) / 1e9
    return 100.0 * r.stretch_flops / (busy * r.peak_flops) if busy > 0 else None
