"""The gap between the port's and the JAX package's CLI metrics on the same
JAX-trained weights, over seeds: the measurement behind the bands of
`tests/test_torch_port_cli.py`. For each seed the JAX `cli.train` runs
the tests' tiny config (data stream pinned unless ``--unpinned``), then
both packages' `cli.validate` and `cli.test` (with and without a shifted
light) run on its last checkpoint. With ``--ulp`` it also reruns the JAX
validate with the rays', then the weights', values moved by one float32
ulp (random signs): the reference's own conditioning. One JSON line a
seed: relative PSNR gaps and absolute SSIM gaps by split and key.

    JAX_PLATFORMS=cpu python tests/torch_port_metric_gaps.py --seeds 233 13 21 --ulp
"""

import argparse
import glob
import json
import logging
import os
import sys
import tempfile

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
from torch_port_common import TINY_CLI_CFG, flax_ckpt_to_npz  # noqa: E402

LIT = TINY_CLI_CFG.replace("light_center: []", "light_center: [0.1, -0.2, 0.3]")


def _reset_logger():
    logger = logging.getLogger("NERFRender")
    for h in logger.handlers:
        h.close()
    logger.handlers = []


def _gaps(ours: dict, theirs: dict) -> dict:
    return {k: abs(ours[k] - v) if k == "ssim" else abs(ours[k] - v) / abs(v)
            for k, v in theirs.items()}


def _one_ulp(a: np.ndarray, rng) -> np.ndarray:
    a = np.asarray(a, np.float32)
    up = rng.integers(0, 2, a.shape).astype(bool)
    return np.where(up, np.nextafter(a, np.float32(np.inf)),
                    np.nextafter(a, np.float32(-np.inf))).astype(np.float32)


def _ulp_runs(ck: str, base: dict) -> dict:
    """JAX validate with the rays, then the weights, one ulp off."""
    from flax import serialization

    from dual_space_nerf_tpu.cli import validate as jax_validate
    from dual_space_nerf_tpu.evaluation import ImageRenderer

    rng = np.random.default_rng(0)
    render_item = ImageRenderer.render_item

    def moved(self, item, *a, **k):
        item = {**item, "ray_o": _one_ulp(item["ray_o"], rng), "ray_d": _one_ulp(item["ray_d"], rng)}
        return render_item(self, item, *a, **k)

    ImageRenderer.render_item = moved
    try:
        rays = jax_validate.main(["-c", "tiny.yml", "--exp", "ulp_rays", "--ckpt", ck])
    finally:
        ImageRenderer.render_item = render_item

    with open(ck, "rb") as f:
        tree = serialization.msgpack_restore(bytearray(f.read()))

    def walk(node):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value)
            elif isinstance(value, np.ndarray) and value.dtype == np.float32:
                node[key] = _one_ulp(value, rng)

    walk(tree["params"])
    moved_ck = os.path.join("EXP", "ulp_weights", os.path.basename(ck))
    os.makedirs(os.path.dirname(moved_ck), exist_ok=True)
    with open(moved_ck, "wb") as f:
        f.write(serialization.msgpack_serialize(tree))
    weights = jax_validate.main(["-c", "tiny.yml", "--exp", "ulp_weights", "--ckpt", moved_ck])
    return {"jax_rays_one_ulp": _gaps(rays, base), "jax_weights_one_ulp": _gaps(weights, base)}


def measure(seed: int, pinned: bool, ulp: bool) -> dict:
    from dual_space_nerf_tpu.cli import test as jax_test
    from dual_space_nerf_tpu.cli import train as jax_train
    from dual_space_nerf_tpu.cli import validate as jax_validate
    from dual_space_nerf_tpu_torch.cli import test, validate

    for var in ("DSNERF_LOADER_BACKEND", "DSNERF_VAL_PERIOD", "DSNERF_DETERMINISTIC_DATA"):
        os.environ.pop(var, None)
    if pinned:
        os.environ["DSNERF_DETERMINISTIC_DATA"] = "1"
    os.chdir(tempfile.mkdtemp(prefix=f"gaps_{seed}_"))
    with open("tiny.yml", "w", encoding="utf-8") as f:
        f.write(TINY_CLI_CFG)
    with open("lit.yml", "w", encoding="utf-8") as f:
        f.write(LIT)
    os.environ["DSNERF_SEED"] = str(seed)
    _reset_logger()
    try:
        jax_train.main(["-c", "tiny.yml", "--exp", "jax"])
    finally:
        _reset_logger()
        os.environ.pop("DSNERF_SEED")
    ck = sorted(glob.glob("EXP/jax/model_epoch_*.ckpt"))[-1]
    npz = flax_ckpt_to_npz(ck, os.path.abspath(os.path.basename(ck)[:-5] + ".npz"))
    cpu = ["--device", "cpu"]
    val = validate.main(["-c", "tiny.yml", "--exp", "port", "--ckpt", npz] + cpu)
    view, pose = test.main(["-c", "tiny.yml", "--exp", "port", "--ckpt", npz] + cpu)
    _, lit = test.main(["-c", "lit.yml", "--exp", "port_lit", "--ckpt", npz] + cpu)
    jval = jax_validate.main(["-c", "tiny.yml", "--exp", "jax", "--ckpt", ck])
    jview, jpose = jax_test.main(["-c", "tiny.yml", "--exp", "jax", "--ckpt", ck])
    _, jlit = jax_test.main(["-c", "lit.yml", "--exp", "jax_lit", "--ckpt", ck])
    out = {"seed": seed, "pinned": pinned, "jax_validate": jval,
           "gaps": {split: _gaps(o, t) for split, (o, t) in (
               ("validate", (val, jval)), ("novel_view", (view, jview)),
               ("novel_pose", (pose, jpose)), ("novel_pose_lit", (lit, jlit)))}}
    if ulp:
        out.update(_ulp_runs(ck, jval))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[233])
    parser.add_argument("--unpinned", action="store_true",
                        help="the default loader's stream (order follows the machine's load)")
    parser.add_argument("--ulp", action="store_true",
                        help="also the JAX validate with rays / weights one ulp off")
    args = parser.parse_args()
    cwd = os.getcwd()
    for seed in args.seeds:
        row = measure(seed, not args.unpinned, args.ulp)
        os.chdir(cwd)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
