#!/usr/bin/env python3
"""The port's stage spans read in a benchmark cell's traced stretch, and
what turning them on costs, on one NVIDIA card.

    python3 scripts/stage_trace.py --workload train.zju313_tpu --seeds 11 12 13 \
        [--pairs 2] [--window 10] [--out stage_trace.json]

For each seed: the cell's set-up as the benchmark makes it
(`portbench/loops/<kind>.py::Session`); for a train cell a window of
``--window`` seconds with the spans off, over which the loader's counters
(`PrefetchLoader.stats`) give the transform's ms per item; then ``--pairs``
pairs of traced stretches, the program's spans (`utils/tracing.py`) off,
then on, in turns (off, on, on, off, ...), after one stretch left unread.
A stretch is the benchmark's: the cell's ``trace_units`` steps or
images after one unrecorded, under torch.profiler with the host's and the
card's activity. Each stretch gives its wall ms per unit, the card's busy
ms and launches per unit; a stretch with the spans on also gives, per unit,

- ``host_ms``: the main thread's wall ms in each ``dsnerf.`` span, and in
  the benchmark's own unit span (``portbench.train_step`` or
  ``portbench.render_item``), which holds the step's or image's spans;
- ``device_ms``: the device ms of the ops launched inside each stage
  (`stage_device_ns`).

Every stretch also gives ``passes_per_unit``: the network passes of its
recorded units by path (fused, fast, plain; the port's counter,
`utils/tracing.py::passes`).

One JSON line a seed on standard output; all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH_PREFIX = "portbench."
STAGE_PREFIX = "dsnerf."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
#: device ops whose launch lies in no stage
OUTSIDE = "(outside stages)"


def _kind(e) -> str:
    """The event's activity type, from the event where the profiler gives
    it, else from its device and name (torch 2.11's events have no
    ``activity_type``): the GPU-side ranges of ``portbench.`` and
    ``dsnerf.`` spans are annotations, never kernels, and a host call
    named ``cu*`` is a runtime call."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    import torch

    name = e.name()
    annotated = name.startswith((BENCH_PREFIX, STAGE_PREFIX))
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        low = name.lower()
        if annotated or low.startswith("profilerstep"):
            return "gpu_user_annotation"
        return "gpu_memcpy" if low.startswith("memcpy") else (
            "gpu_memset" if low.startswith("memset") else "kernel")
    if annotated:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cu") else "cpu_op"


def rows(events) -> list[tuple]:
    """The profiler's events as (kind, name, thread, start_ns, end_ns,
    correlation id), read once."""
    out = []
    for e in events:
        s = e.start_ns()
        out.append((_kind(e), e.name(), e.start_thread_id(), s, s + e.duration_ns(),
                    e.correlation_id()))
    return out


def device_and_spans(rows_: list) -> tuple[list, list]:
    """The device ops [(name, start, end, is_kernel)] and the benchmark's
    spans [(name, start, end)], by start: what `portbench.trace.Trace`
    holds, with `_kind` above."""
    device, spans = [], []
    for kind, name, _, s, e, _ in rows_:
        if kind in DEVICE_KINDS:
            device.append((name, s, e, kind == "kernel"))
        elif kind == "user_annotation" and name.startswith(BENCH_PREFIX):
            spans.append((name, s, e))
    device.sort(key=lambda x: x[1])
    spans.sort(key=lambda x: x[1])
    return device, spans


def _annotations(rows_: list) -> tuple[dict, object]:
    """({thread: [(start, end, name)] of its ``dsnerf.`` spans, parents
    first}, the main thread: that of the first ``portbench.`` span, else of
    the first ``dsnerf.`` span)."""
    spans: dict = {}
    main = bench_main = None
    for kind, name, thread, s, e, _ in rows_:
        if kind != "user_annotation":
            continue
        if name.startswith(BENCH_PREFIX) and bench_main is None:
            bench_main = thread
        if name.startswith(STAGE_PREFIX):
            main = thread if main is None else main
            spans.setdefault(thread, []).append((s, e, name))
    for lst in spans.values():
        lst.sort(key=lambda x: (x[0], -x[1]))  # a parent before a child that starts with it
    return spans, bench_main if bench_main is not None else main


def host_ns(rows_: list, prefix: str = STAGE_PREFIX) -> dict:
    """Wall ns of the main thread's spans whose names start with
    ``prefix``, summed by name."""
    _, main = _annotations(rows_)
    out: dict = {}
    for kind, name, thread, s, e, _ in rows_:
        if kind == "user_annotation" and name.startswith(prefix) and thread == main:
            out[name] = out.get(name, 0) + e - s
    return out


def _innermost(spans: list, queries: list) -> dict:
    """{query index: name of the innermost span that holds its time} for
    queries [(t, index)] sorted by t, over one thread's spans, which nest,
    sorted by start (parents first)."""
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


def stage_device_ns(rows_: list) -> dict:
    """Device ns (kernels, copies, fills) by the stage that launched them.

    A device op's launch is the runtime call with its correlation id: the
    thread and the time it was made. The op is charged to the innermost
    ``dsnerf.`` span open on that thread at that time; where none is, as on
    autograd's device thread, which runs a backward or the normal's
    gradient while the calling thread waits in its stage, to the main
    thread's innermost span at that time; else, and where no launch was
    recorded, to `OUTSIDE`."""
    spans, main = _annotations(rows_)
    launches, ops = {}, []
    for row in rows_:
        kind, _, thread, s, _, corr = row
        if kind in DEVICE_KINDS:
            ops.append(row)
        elif kind.startswith("cuda"):
            launches[corr] = (thread, s)
    by_thread: dict = {}
    for i, row in enumerate(ops):
        at = launches.get(row[5])
        if at is not None:
            by_thread.setdefault(at[0], []).append((at[1], i))
    names: dict = {}
    for thread, queries in by_thread.items():
        queries.sort()
        got = _innermost(spans.get(thread, []), queries)
        names.update(got)
        if thread != main:
            rest = [q for q in queries if q[1] not in got]
            names.update(_innermost(spans.get(main, []), rest))
    out: dict = {}
    for i, (_, _, _, s, e, _) in enumerate(ops):
        name = names.get(i, OUTSIDE)
        out[name] = out.get(name, 0) + e - s
    return out


def _stretch(sess, n: int, spans_on: bool, read: bool = True) -> dict | None:
    """One traced stretch of the cell (the benchmark's: ``n`` units after
    one unrecorded, host and card activity) with the program's spans on or
    off; its readings per unit (None with ``read`` false)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from dual_space_nerf_tpu_torch.utils import tracing
    from portbench.trace import Trace

    def unit(i):
        if sess.unit == "step":
            sess._iterate(traced=True)
            if i == n:
                with torch.profiler.record_function(BENCH_PREFIX + "drain"):
                    sess._read(sess.pending)
                sess.pending = None
        else:
            with torch.profiler.record_function(BENCH_PREFIX + "render_item"):
                sess.render_item(sess.items[0])

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    got = []

    def ready(p):
        if not read:
            got.append(None)
            return
        r = rows(p.profiler.kineto_results.events())
        device, spans = device_and_spans(r)
        got.append((Trace(device, spans, []), host_ns(r, BENCH_PREFIX), host_ns(r),
                    stage_device_ns(r)))

    with tracing.enabled(spans_on), profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=n, repeat=1), on_trace_ready=ready) as prof:
        for i in range(n + 1):
            if i == 1:
                passes_at = tracing.passes()
            unit(i)
            prof.step()
    if not read:
        return None
    passes = tracing.passes()
    tr, bench_host, stage_host, stage_dev = got[0]
    t0, t1, units = tr.stretch(sess.unit)
    per = lambda d: {k: v / 1e6 / units for k, v in sorted(d.items())}  # noqa: E731
    out = {"spans": spans_on, "units": units, "ms_per_unit": (t1 - t0) / 1e6 / units,
           "busy_ms_per_unit": tr.busy_ns(t0, t1) / 1e6 / units,
           "launches_per_unit": sum(1 for d in tr.in_stretch(t0, t1) if d[3]) / units,
           "bench_ms": per(bench_host),
           "passes_per_unit": {k: (passes[k] - passes_at[k]) / n for k in tracing.PATHS}}
    if spans_on:
        out["host_ms"], out["device_ms"] = per(stage_host), per(stage_dev)
    return out


def measure(cell, seed: int, device, pairs: int = 2, window: float = 10.0) -> dict:
    """The readings of one seed: set-up, the train cells' counter window, one
    stretch unread (a process's first profiled stretch runs slower), then
    ``pairs`` pairs of stretches in turns: off, on, on, off, ..."""
    import torch

    from portbench import harness

    sess = harness.loop(cell.traffic["kind"]).Session(cell, seed, torch.device(device))
    out = {"workload": cell.name, "seed": seed, "device": str(device), "stretches": []}
    if str(device).startswith("cuda"):
        out["card"] = torch.cuda.get_device_name(torch.device(device))
    try:
        if sess.unit == "step":
            before = sess.loader.stats
            win = sess.window(window)
            after = sess.loader.stats
            items = after["items"] - before["items"]
            out["window"] = {"steps": win["units"], "s_per_step": win["metrics"]["s_per_step"],
                             "loader_items": items,
                             "loader_transform_ms": 1e3 * (after["transform_s"] - before["transform_s"]) / items,
                             "loader_wait_ms": 1e3 * (after["wait_s"] - before["wait_s"]) / items}
        n = int(cell.traffic["trace_units"])
        _stretch(sess, n, False, read=False)
        for k in range(pairs):
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                out["stretches"].append(_stretch(sess, n, on))
    finally:
        sess.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--window", type=float, default=10.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("stage_trace: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = measure(cell, seed, "cuda", args.pairs, args.window)
        row["run_s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
