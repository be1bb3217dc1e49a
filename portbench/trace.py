"""The traced stretch of a run: torch.profiler over a few steps or images,
reduced to device intervals, host spans and kernel families.

The profiler records host ops and the card's activity (CUPTI) in one
timeline. The stretch runs after the measured window (a profiler session
slows later host launches), one unit warms the profiler up unrecorded, and
the events are read from the profiler's raw results, without building its
per-op tables.

Spans are the benchmark's own (``portbench.*``, `torch.profiler.record_function`
around the calls into the program) and the program's stage spans
(``dsnerf.*``, `utils/tracing.py`), which the stretch turns on and the
measured window leaves off. Both are annotations, never device work. A
device op is charged to the innermost stage span open on the thread that
launched it when it was launched; on a thread with none open (autograd's
device thread runs the backward while the caller waits in its stage), to
the main thread's. The main thread is that of the first benchmark span:
the loader's threads open stage spans of their own.
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
STAGE_PREFIX = "dsnerf."
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
    sorted by start; the main thread's stage spans (name, start_ns,
    end_ns), by start; the stage span that launched each device op, in the
    order of ``device`` (None: no stage was open); the network passes of
    the recorded units by path (`utils/tracing.py::passes`)."""

    device: list
    spans: list
    host: list
    other: list = dataclasses.field(default_factory=list)
    stages: list = dataclasses.field(default_factory=list)
    launched_in: list = dataclasses.field(default_factory=list)
    passes: dict = dataclasses.field(default_factory=dict)

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

    def stage_host_ns(self, stage: str, t0: int, t1: int) -> int | None:
        """Wall ns of the main thread's ``dsnerf.<stage>`` spans that start
        in [t0, t1); None where there is none."""
        got = [e - s for name, s, e in self.stages if name == STAGE_PREFIX + stage and t0 <= s < t1]
        return sum(got) if got else None

    def stage_device_ns(self, stage: str, t0: int, t1: int) -> int | None:
        """Device ns of the ops that start in [t0, t1) and were launched
        inside ``dsnerf.<stage>``; None where there is none."""
        got = [e - s for (_, s, e, _), at in zip(self.device, self.launched_in)
               if at == STAGE_PREFIX + stage and t0 <= s < t1]
        return sum(got) if got else None


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
    """Run ``unit(i)`` n_warm + n_active times under the profiler with the
    program's stage spans on, the first n_warm unrecorded; returns the
    recorded units' trace, with the network passes they made."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from dual_space_nerf_tpu_torch.utils import tracing

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    got = []
    with tracing.enabled(), profile(
            activities=acts, schedule=schedule(wait=0, warmup=n_warm, active=n_active, repeat=1),
            on_trace_ready=lambda p: got.append(_reduce(p.profiler.kineto_results))) as prof:
        for i in range(n_warm + n_active):
            if i == n_warm:
                before = tracing.passes()
            unit(i)
            prof.step()
        after = tracing.passes()
    if len(got) != 1:
        raise RuntimeError(f"trace: {len(got)} traces recorded, expected 1")
    got[0].passes = {k: after[k] - before[k] for k in after}
    return got[0]


def _kind(e) -> str:
    """The event's activity type, from the event where the profiler
    gives it, else (torch 2.11's events have no ``activity_type``) from its
    device and name: the GPU-side ranges of benchmark and stage spans are
    annotations, never kernels, and a host call named ``cu*`` is a runtime
    call."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    annotated = name.startswith((SPAN_PREFIX, STAGE_PREFIX))
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        low = name.lower()
        if annotated or low.startswith("profilerstep"):
            return "gpu_user_annotation"
        return "gpu_memcpy" if low.startswith("memcpy") else (
            "gpu_memset" if low.startswith("memset") else "kernel")
    if annotated:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def _thread(e):
    return e.start_thread_id() if hasattr(e, "start_thread_id") else None


def _open_spans(spans: list, queries: list) -> dict:
    """{query index: name of the innermost span open at its time} for
    queries [(t, index)] sorted by t, over one thread's spans [(start, end,
    name)], which nest, sorted by start with a parent before a child that
    starts with it."""
    found, stack, at = {}, [], 0
    for t, q in queries:
        while at < len(spans) and spans[at][0] <= t:
            while stack and stack[-1][1] < spans[at][0]:
                stack.pop()
            stack.append(spans[at])
            at += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            found[q] = stack[-1][2]
    return found


def _reduce(results) -> Trace:
    rows = []
    for e in results.events():
        s = e.start_ns()
        rows.append((_kind(e), e.name(), _thread(e), s, s + e.duration_ns(), e.correlation_id()))
    bench = [r for r in rows if r[0] == "user_annotation" and r[1].startswith(SPAN_PREFIX)]
    main = min(bench, key=lambda r: r[3])[2] if bench else None
    device, spans, host, other = [], [], [], []
    stages: dict = {}    # thread -> [(start, end, name)] of its stage spans
    launches = {}        # correlation id -> (thread, time) of the runtime call
    for kind, name, thread, s, e, corr in rows:
        if kind in DEVICE_ACTIVITIES:
            device.append((name, s, e, kind == "kernel", corr))
        elif kind == "user_annotation":
            if name.startswith(SPAN_PREFIX):
                spans.append((name, s, e))
            elif name.startswith(STAGE_PREFIX):
                stages.setdefault(thread, []).append((s, e, name))
        elif kind == "cpu_op" or kind.startswith("cuda"):
            (host if thread == main else other).append((name, s, e))
            if kind.startswith("cuda"):
                launches[corr] = (thread, s)
    for lst in stages.values():
        lst.sort(key=lambda x: (x[0], -x[1]))
    by_thread: dict = {}
    for i, d in enumerate(device):
        at = launches.get(d[4])
        if at is not None:
            by_thread.setdefault(at[0], []).append((at[1], i))
    launched_in: dict = {}
    for thread, queries in by_thread.items():
        queries.sort()
        got = _open_spans(stages.get(thread, []), queries)
        launched_in.update(got)
        if thread != main:
            rest = [q for q in queries if q[1] not in got]
            launched_in.update(_open_spans(stages.get(main, []), rest))
    order = sorted(range(len(device)), key=lambda i: device[i][1])
    for lst in (spans, host, other):
        lst.sort(key=lambda x: x[1])
    return Trace([device[i][:4] for i in order], spans, host, other,
                 stages=[(n, s, e) for s, e, n in stages.get(main, [])],
                 launched_in=[launched_in.get(i) for i in order])
