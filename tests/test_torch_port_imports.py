"""The port stands alone: no JAX, no flax or msgpack, nothing of the JAX
package, and no module-level cv2 or yaml (the card's machine has neither)
anywhere in the package or in chip_smoke.py. And its entry points never run
on the CPU unless asked to."""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dual_space_nerf_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "dual_space_nerf_tpu")
LAZY_ONLY = ("cv2", "yaml")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(tree):
    """(top-level module name, at module level?) for every import."""
    found = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Import):
                found.extend((a.name.split(".")[0], not in_function) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                found.append((child.module.split(".")[0], not in_function))
            visit(child, in_function or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    visit(tree, False)
    return found


def test_sources_exist():
    assert len(_sources()) > 20
    # the last modules ported are among the files checked below
    for rel in ("parallel/distributed.py", "parallel/mesh.py", "evaluation/lpips.py",
                "ops/clustered_knn.py"):
        assert os.path.join(PKG, rel) in _sources(), rel


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for name, module_level in _imports(tree):
        assert name not in FORBIDDEN, f"{path} imports {name}"
        if module_level:
            assert name not in LAZY_ONLY, f"{path} imports {name} at module level"


def test_entry_points_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from dual_space_nerf_tpu_torch.data.synthetic import make_scene
    from dual_space_nerf_tpu_torch.evaluation import ImageRenderer
    from dual_space_nerf_tpu_torch.models import DualSpaceNeRF
    from dual_space_nerf_tpu_torch.renderer import (
        LightState,
        MeshBundle,
        RayBatch,
        RenderSettings,
        render_rays,
    )

    scene = make_scene(n_theta=6, n_phi=6)
    model = DualSpaceNeRF(max_frames=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ImageRenderer(model, RenderSettings(), scene.faces, scene.verts_cano)
    mesh = MeshBundle(torch.as_tensor(scene.faces.astype(np.int64)),
                      torch.as_tensor(scene.verts_world), torch.as_tensor(scene.verts_cano))
    f32 = torch.float32
    rays = RayBatch(torch.zeros(2, 3, dtype=f32), torch.ones(2, 3, dtype=f32),
                    torch.ones(2, dtype=f32), 2 * torch.ones(2, dtype=f32),
                    0, torch.zeros(23, 3, dtype=f32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_rays(model, rays, mesh, RenderSettings(), LightState.identity())
    # asked for: runs on the CPU
    out = render_rays(model, rays, mesh, RenderSettings(n_samples=4), LightState.identity(),
                      device="cpu")
    assert out["color"].shape == (2, 3)
