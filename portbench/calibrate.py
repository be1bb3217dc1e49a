"""Readings of a cell's compared numbers, from which its limits are set:

- the program, on each seed (at the cell's sizes: the first steps of a
  training run; a run's number of compared images, rendered at the cell's
  load);
- the control: the reference computed in TF32 (the nearest precision below
  the configurations' float32) in the program's place;
- with ``--faults``, the faults of `faults.py` planted in the program.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 4 5 6] [--faults half altered] [--fault-seeds 7 8 9]

On the card. One JSON line per reading on standard output (and in
``--out``). The benchmark's own runs never run this.
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


def reading(cell, seed: int, device, hooks=None, tf32: bool = False) -> dict:
    """The compared numbers of one seed."""
    import torch

    from portbench import harness

    t0 = time.perf_counter()
    sess = harness.loop(cell.traffic["kind"]).Session(cell, seed, device, hooks)
    if cell.traffic["kind"] == "render":
        sess.window(images=int(cell.traffic["check"]["images"]))
    sess.close()
    detail: dict = {}
    numbers = sess.check(tf32=tf32, detail=detail)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"numbers": numbers, "seconds": time.perf_counter() - t0, "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    from portbench import faults, harness

    cell = harness.Cell(args.workload)
    plan = [("program", s, None) for s in args.seeds]
    plan += [("control", s, None) for s in args.control_seeds]
    kind = cell.traffic["kind"]
    for f in args.faults:
        hook = {"wrap_step": faults.train_fault(f)} if kind == "train" else {
            "wrap_render": faults.render_fault(f)}
        plan += [(f"fault:{f}", s, hook) for s in args.fault_seeds]
    out = open(args.out, "a") if args.out else None
    try:
        for what, seed, hooks in plan:
            r = reading(cell, seed, args.device, hooks, tf32=(what == "control"))
            line = json.dumps({"cell": cell.name, "what": what, "seed": seed, **r})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
