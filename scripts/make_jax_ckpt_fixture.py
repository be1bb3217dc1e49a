#!/usr/bin/env python3
"""Write the JAX package's checkpoint of the trained fixture, the input of
`chip_smoke.py::jax_ckpt_phase` and of `tests/test_torch_port_checkpoint.py`:

    JAX_PLATFORMS=cpu python scripts/make_jax_ckpt_fixture.py \
        [--out tests/fixtures/jax_trained_s233.ckpt]

The file is what the JAX package's `training/checkpoint.py::Checkpointer.save`
writes (flax msgpack of {params, opt_state, step, epoch}) for:

- params: the trained weights `bench/r5/abhq_exact_s233_params.npz`
  unchanged (496,149 floats at full width, a 16-frame embedding), so that
  the checkpoint renders the npz's image;
- opt_state: optax's Adam from the JAX package's `make_optimizer` with
  `chip_smoke.py::CLI_CFG`'s solver (BASE_LR 5e-4, no weight decay, the
  reference schedule), after two ``tx.update`` calls on gradients drawn
  with numpy (seed 233, N(0, 1e-3^2) per entry);
- step 2, epoch 1.

About 6 MB: the params and Adam's two moments. Runs on the CPU in a few
seconds; `tests/test_torch_port_checkpoint.py` runs it again and holds
every array of the committed file to the fresh one.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS_NPZ = os.path.join(REPO, "bench", "r5", "abhq_exact_s233_params.npz")
OUT = os.path.join(REPO, "tests", "fixtures", "jax_trained_s233.ckpt")
SEED = 233
GRAD_SCALE = 1e-3
STEP, EPOCH = 2, 1
#: chip_smoke.py::CLI_CFG's SOLVER block
SOLVER = {"BASE_LR": 0.0005, "WEIGHT_DECAY": 0.0, "WARMUP_ITERS": 1000, "START_ITERS": 3000,
          "END_ITERS": 60000, "LR_SCALE": 0.09}


def nest(flat: dict) -> dict:
    """{"params": {"nerf": {...}}} from flat "params/nerf/..." keys."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def make(out: str) -> str:
    """Write the checkpoint to ``out``; returns ``out``."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    import jax
    import jax.numpy as jnp
    import numpy as np

    from dual_space_nerf_tpu.config import get_cfg_defaults
    from dual_space_nerf_tpu.training import Checkpointer, TrainState
    from dual_space_nerf_tpu.training.optim import make_optimizer

    cfg = get_cfg_defaults()
    for key, value in SOLVER.items():
        setattr(cfg.SOLVER, key, value)
    with np.load(PARAMS_NPZ) as data:
        params = jax.tree_util.tree_map(jnp.asarray, nest({k: data[k] for k in sorted(data.files)}))
    tx, _ = make_optimizer(cfg)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)  # one compile, not one per leaf and op
    rng = np.random.default_rng(SEED)
    for _ in range(STEP):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray((GRAD_SCALE * rng.standard_normal(p.shape)).astype(np.float32)), params)
        _, opt_state = update(grads, opt_state, params)
    state = TrainState(params, opt_state, jnp.asarray(STEP, jnp.int32))
    with tempfile.TemporaryDirectory() as tmp:  # Checkpointer.save also writes a tag file
        written = Checkpointer(tmp).save("fixture", state, EPOCH)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        shutil.copyfile(written, out)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args(argv)
    path = make(args.out)
    print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
