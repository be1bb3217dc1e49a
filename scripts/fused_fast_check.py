#!/usr/bin/env python3
"""A short check of the bfloat16-fed fused SpaceNet kernels on one NVIDIA
card: the first call to make after editing them, before `chip_smoke.py`.

    python3 scripts/fused_fast_check.py

Builds the fused pair's two libraries and prints their `ptxas -v` lines,
holds the fast kernels to their float64 oracle (`fused_mlp.
check_fast_kernels`) at 100, 6,400 and 88,000 points of a randomly
initialised SpaceNet, density-only and with color, printing each report
(or the failure), then times the float32 and the fast pair over three
launches (CUDA events) at the training step's 352,000 density-only and
88,000 color points.
"""

import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dual_space_nerf_tpu_torch.models import DualSpaceNeRF  # noqa: E402
from dual_space_nerf_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from dual_space_nerf_tpu_torch.ops.cuda_build import build_all  # noqa: E402
from dual_space_nerf_tpu_torch.ops.posenc import posenc  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_fast_check: no CUDA device; this script runs only on the card")
        return 2
    t = time.time()
    try:
        build_all([fm.FWD_KERNEL, fm.BWD_KERNEL])
    finally:
        for k in (fm.FWD_KERNEL, fm.BWD_KERNEL):
            for line in k.build_log.splitlines():
                if any(s in line for s in ("error", "warning", "Compiling entry", "Used", "spill")):
                    print("ptxas", k.name, line.strip()[:300])
    print("build", time.time() - t, flush=True)
    dev = torch.device("cuda")
    model = DualSpaceNeRF(max_frames=4, generator=torch.Generator().manual_seed(0)).to(dev)
    w = {k: v.detach() for k, v in fm.pack(fm.nerf_params(model.nerf)).items()}
    g = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)
    failed = False
    for n in (100, 6400, 88000):
        x = fm.build_x(posenc(0.3 * rnd(n, 3), 10), rnd(n, 24))
        for wc in (False, True):
            cots = (rnd(n), *((rnd(n, 3), rnd(n, 63)) if wc else (None, None)))
            try:
                print("ok", n, wc, json.dumps(fm.check_fast_kernels(w, x, cots, wc)), flush=True)
            except AssertionError as e:
                failed = True
                print("FAIL", n, wc, str(e)[:3000], flush=True)
                traceback.print_exc()
    wflat, wb = fm.flat_weights(w), fm.fast_weights(w)
    for n, wc in ((352000, False), (88000, True)):
        x = fm.build_x(posenc(0.3 * rnd(n, 3), 10), rnd(n, 24))
        cots = (rnd(n), *((rnd(n, 3), rnd(n, 63)) if wc else (None, None)))
        fns = {"fwd_f32": lambda: fm.fused_fwd(w, x, wc, wflat),
               "fwd_fast": lambda: fm.fused_fwd(w, x, wc, wflat, True, wb),
               "bwd_f32": lambda: fm.fused_bwd(w, x, *cots, wc, wflat),
               "bwd_fast": lambda: fm.fused_bwd(w, x, *cots, wc, wflat, True, wb)}
        out = {}
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(3):
                fn()
            b.record()
            torch.cuda.synchronize()
            out[name] = a.elapsed_time(b) / 3
        print("time", n, wc, json.dumps(out), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
