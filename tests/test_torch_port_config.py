"""Port config tree vs the JAX package's: same keys, same merges, same dumps."""

import os

import pytest

from dual_space_nerf_tpu.config import get_cfg_defaults as jax_defaults
from dual_space_nerf_tpu_torch.config import get_cfg_defaults as torch_defaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_defaults_dump_the_same():
    assert torch_defaults().dump() == jax_defaults().dump()


@pytest.mark.parametrize("path", ["configs/zju_mocap/313.yml", "configs/synthetic.yml"])
def test_yaml_merge_dumps_the_same(path):
    a, b = jax_defaults(), torch_defaults()
    a.merge_from_file(os.path.join(REPO, path))
    b.merge_from_file(os.path.join(REPO, path))
    assert b.dump() == a.dump()


def test_merge_from_list_coerces_like_jax():
    opts = ["MODEL.KNN_IMPL", "pallas", "SOLVER.BASE_LR", "5e-4", "MODEL.REMAT", "True"]
    a, b = jax_defaults(), torch_defaults()
    a.merge_from_list(list(opts))
    b.merge_from_list(list(opts))
    assert b.to_dict() == a.to_dict()
    with pytest.raises(KeyError):
        b.merge_from_list(["MODEL.NOT_A_KEY", "1"])
