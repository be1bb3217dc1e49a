"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (imports, the kernels' first build, the scene, the weights,
the warm-up) is ``setup_s``; then the window runs for ``--seconds`` (under
the profiler's device activity alone where an end-to-end metric of the
cell is a device time); with ``--trace 1`` a profiled stretch follows it
and the per-layer metrics are read; then the program's state is freed and the plain reference decides
``correct``. The last line of standard output is one JSON object; the
compared numbers and their limits are the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level modules that the process may not hold once the window has
#: closed: JAX and the JAX package (the port's name starts with its name,
#: so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "dual_space_nerf_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _environment() -> None:
    """Caches inside the checkout at fixed paths, and no setting of the
    program's from the caller's environment."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, ".portbench_cache", "triton"))
    for k in [k for k in os.environ if k.startswith("DSNERF_")]:
        del os.environ[k]


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             hooks: dict | None = None) -> dict:
    """The result of one run of ``cell`` (a `harness.Cell`), ``correct``
    included, and the compared numbers under ``checks``."""
    import torch

    from portbench import harness
    from portbench.readers import Readings
    from portbench.trace import DeviceTime, device_breakdown, gap_breakdown, load_families

    dev = torch.device(device)
    t_imports = time.perf_counter() - t_start
    drv = harness.loop(cell.traffic["kind"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sess = drv.Session(cell, seed, dev, hooks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    device_e2e = [m for m in cell.metrics("end_to_end") if m["source"] == "device_trace"]
    if not trace and device_e2e and dev.type == "cuda":
        # the window's device time, for the end-to-end metrics read from it
        with DeviceTime() as dt:
            win = sess.window(seconds)
        win["metrics"].update(sess.device_metrics(win, dt.busy_s))
        win["device_ops"], win["device_read_s"] = dt.ops, dt.read_s
    else:
        win = sess.window(seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        mem = int(torch.cuda.max_memory_allocated(dev))
        name = torch.cuda.get_device_name(dev)
    else:
        mem, name = 0, "cpu"
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.spec["end_to_end"] + cell.spec["per_layer"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": mem}
    breakdown = None
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.metrics("end_to_end"):
            if m["name"] in values:  # a device time is not read without the device
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        n = int(cell.traffic["trace_units"])
        tr, st_flops, st_bytes = sess.trace(n)
        fams = load_families()
        pf, pb = harness.peaks(name, cell.config["MODEL"].get("MATMUL_PRECISION", "f32"))
        if "flops" in win:
            w_flops = win["flops"]
        else:
            w_flops = win["units"] * sess.step_flops()[0]
        r = Readings(trace=tr, unit=drv.Session.unit, families=fams,
                     stretch_flops=st_flops, stretch_bytes=st_bytes, window_units=win["units"],
                     window_s=win["seconds"], window_flops=w_flops, peak_flops=pf, peak_bytes=pb,
                     loader_waits_s=win.get("waits", []),
                     loader_stats=win.get("loader_stats", ()))
        for m in cell.metrics("per_layer"):
            v = harness.load_reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
        t0, t1, _ = tr.stretch(drv.Session.unit)
        device_info.update(busy_s=tr.busy_ns(t0, t1) / 1e9, window_s=(t1 - t0) / 1e9)
        breakdown = {"device_ops": device_breakdown(tr.in_stretch(t0, t1), fams),
                     "idle_gaps": gap_breakdown(tr, t0, t1)}
    sess.close()
    numbers = sess.check()
    correct, checks = harness.judge(numbers, cell.limits)
    out = {"correct": correct, "attempted": win["units"],
           "failed": sum(1 for c in checks.values() if c["limit"] is None or not c["value"] <= c["limit"]),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["window"] = {"units": win["units"], "seconds": win["seconds"], "unit_s": win["unit_s"],
                     "setup_parts": dict(imports_s=t_imports, **sess.setup_parts)}
    for k in ("chunks", "device_ops", "device_read_s"):
        if k in win:
            out["window"][k] = win[k]
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch

    from portbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad}: the port may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
