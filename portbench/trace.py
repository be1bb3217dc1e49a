"""The traced stretch of a run: torch.profiler over a few steps or images,
reduced to device intervals, host spans and kernel families.

The profiler records host ops and the card's activity (CUPTI) in one
timeline. The stretch runs after the measured window (a profiler session
slows later host launches), one unit warms the profiler up unrecorded, and
the events are read from the profiler's raw results, without building its
per-op tables.

Spans are the benchmark's own (``portbench.*``, `torch.profiler.record_function`
around the calls into the program); the program has none yet.
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import json
import os
import time

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
SPAN_PREFIX = "portbench."
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Family:
    name: str
    priority: int
    roles: tuple
    patterns: tuple


def load_families(folder: str = os.path.join(BENCH, "families")) -> list[Family]:
    """Every kernel family under ``folder``, in the order they are tried."""
    fams = []
    for path in sorted(glob.glob(os.path.join(folder, "*.json"))):
        with open(path) as f:
            d = json.load(f)
        fams.append(Family(d["name"], int(d["priority"]), tuple(d["roles"]),
                           tuple(p.lower() for p in d["patterns"])))
    return sorted(fams, key=lambda f: (f.priority, f.name))


def classify(name: str, families: list[Family]) -> Family:
    """The first family (by priority) with a pattern in the kernel's name."""
    low = name.lower()
    for fam in families:
        if any(p in low for p in fam.patterns):
            return fam
    raise ValueError(f"kernel {name!r}: no family matches (give one an empty pattern)")


@dataclasses.dataclass
class Trace:
    """Device ops (name, start_ns, end_ns, is_kernel), the benchmark's spans
    (name, start_ns, end_ns), the main thread's host ops (name, start_ns,
    end_ns) and the other threads' (autograd's backward, the loader), each
    sorted by start."""

    device: list
    spans: list
    host: list
    other: list = dataclasses.field(default_factory=list)

    def stretch(self, unit: str) -> tuple[int, int, int]:
        """(start, end, count) over the spans named ``unit`` (and the
        closing ``drain`` span, if any)."""
        units = [s for s in self.spans if s[0] == SPAN_PREFIX + unit]
        if not units:
            raise ValueError(f"trace: no {unit!r} span")
        end = max(s[2] for s in self.spans if s[0] in (SPAN_PREFIX + unit, SPAN_PREFIX + "drain"))
        return units[0][1], end, len(units)

    def busy_ns(self, t0: int, t1: int) -> int:
        """Time in [t0, t1] in which some device op runs (their union)."""
        busy, cur_s, cur_e = 0, None, None
        for _, s, e, _ in self.device:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def idle_gaps(self, t0: int, t1: int) -> list[tuple[int, int]]:
        """The intervals of [t0, t1] in which no device op runs."""
        gaps, at = [], t0
        for _, s, e, _ in self.device:
            if e <= at:
                continue
            if s > at:
                gaps.append((at, min(s, t1)))
            at = max(at, e)
            if at >= t1:
                break
        if at < t1:
            gaps.append((at, t1))
        return [g for g in gaps if g[1] > g[0]]

    def in_stretch(self, t0: int, t1: int) -> list:
        return [d for d in self.device if d[1] >= t0 and d[1] < t1]


def _innermost(items: list, starts: list, t: int, walk: int = 64) -> str | None:
    """Name of the latest-starting item of ``items`` that contains ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - walk, -1), -1):
        if items[j][2] >= t:
            return items[j][0]
    return None


def gap_breakdown(tr: Trace, t0: int, t1: int, top: int = 10) -> list:
    """Idle time of the stretch by what the host was doing when each gap
    began: the benchmark span and the innermost host op of the main thread,
    else of another thread ("other thread: ...", as autograd's backward),
    else "python"; summed, the ``top`` largest."""
    span_starts = [s[1] for s in tr.spans]
    host_starts = [h[1] for h in tr.host]
    other_starts = [h[1] for h in tr.other]
    total: dict[str, int] = {}
    for g0, g1 in tr.idle_gaps(t0, t1):
        span = _innermost(tr.spans, span_starts, g0) or "outside spans"
        op = _innermost(tr.host, host_starts, g0)
        if op is None:
            op = _innermost(tr.other, other_starts, g0)
            op = "python" if op is None else "other thread: " + op
        key = f"{span.removeprefix(SPAN_PREFIX)} / {op}"
        total[key] = total.get(key, 0) + (g1 - g0)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]


def device_breakdown(ops: list, families: list[Family], top: int = 10) -> list:
    """Device seconds of the stretch by kernel (family: name), the ``top``."""
    total: dict[str, int] = {}
    for name, s, e, _ in ops:
        key = f"{classify(name, families).name}: {name[:100]}"
        total[key] = total.get(key, 0) + (e - s)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v / 1e9] for k, v in ranked]


class DeviceTime:
    """The card's busy time over a block of work (``with DeviceTime() as
    dt: ...``): torch.profiler with the device's activity alone (no host
    ops are recorded), reduced on exit to the union of the device ops'
    intervals, ``busy_s``, and their count, ``ops``; ``read_s`` is what the
    profiler's stop and this reading took."""

    busy_s: float = 0.0
    ops: int = 0
    read_s: float = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        t0 = time.perf_counter()
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        if exc[0] is None:
            ops = sorted((("", e.start_ns(), e.start_ns() + e.duration_ns(), True)
                          for e in prof.profiler.kineto_results.events()
                          if _kind(e) in DEVICE_ACTIVITIES), key=lambda x: x[1])
            self.ops = len(ops)
            if ops:
                self.busy_s = Trace(ops, [], []).busy_ns(ops[0][1], max(o[2] for o in ops)) / 1e9
        self.read_s = time.perf_counter() - t0
        return False


def record(unit, n_active: int, n_warm: int = 1) -> Trace:
    """Run ``unit(i)`` n_warm + n_active times under the profiler, the
    first n_warm unrecorded; returns the recorded units' trace."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    got = []
    with profile(activities=acts, schedule=schedule(wait=0, warmup=n_warm, active=n_active, repeat=1),
                 on_trace_ready=lambda p: got.append(_reduce(p.profiler.kineto_results))) as prof:
        for i in range(n_warm + n_active):
            unit(i)
            prof.step()
    if len(got) != 1:
        raise RuntimeError(f"trace: {len(got)} traces recorded, expected 1")
    return got[0]


def _kind(e) -> str:
    """The event's activity type, from the event where the profiler
    gives it, else from its device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        low = name.lower()
        if name.startswith(SPAN_PREFIX) or low.startswith("profilerstep"):
            return "gpu_user_annotation"
        return "gpu_memcpy" if low.startswith("memcpy") else (
            "gpu_memset" if low.startswith("memset") else "kernel")
    if name.startswith(SPAN_PREFIX):
        return "user_annotation"
    return "cpu_op"


def _thread(e):
    return e.start_thread_id() if hasattr(e, "start_thread_id") else None


def _reduce(results) -> Trace:
    device, spans, host, other = [], [], [], []
    main_thread = None
    events = list(results.events())
    for e in events:
        if _kind(e) == "user_annotation":
            main_thread = _thread(e)
            break
    for e in events:
        kind = _kind(e)
        s = e.start_ns()
        if kind in DEVICE_ACTIVITIES:
            device.append((e.name(), s, s + e.duration_ns(), kind == "kernel"))
        elif kind == "user_annotation" and e.name().startswith(SPAN_PREFIX):
            spans.append((e.name(), s, s + e.duration_ns()))
        elif kind == "cpu_op" or kind.startswith("cuda"):
            (host if _thread(e) == main_thread else other).append((e.name(), s, s + e.duration_ns()))
    for lst in (device, spans, host, other):
        lst.sort(key=lambda x: x[1])
    return Trace(device, spans, host, other)
