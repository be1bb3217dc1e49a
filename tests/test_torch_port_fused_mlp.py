"""The port's fused SpaceNet functions (`ops/fused_mlp.py`, plain versions on
the CPU, through their `torch.autograd.Function`) against the JAX package's
`ops/fused_mlp.py` in interpret mode, and against torch's own double backward
through the port's `SpaceNet`.

Same seeded numpy inputs on both sides and the trained fixture's weights
carried across (`models/convert.py`). Tolerances as the JAX package's own
`tests/test_fused_mlp.py` states them: max-abs error within 1e-5 of the
reference's max-abs scale for sigma, essence and the normal, 2e-5 for every
gradient (the second-order ones included). Both sides are float32; the sums
run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.ops import fused_mlp as jfm
from dual_space_nerf_tpu.ops.posenc import posenc as jax_posenc
from dual_space_nerf_tpu_torch.ops import fused_mlp as fm
from dual_space_nerf_tpu_torch.ops.posenc import posenc
from torch_port_common import jax_model_and_params, torch_model

FWD_TOL, GRAD_TOL = 1e-5, 2e-5
BLOCK = 64


@pytest.fixture(scope="module")
def models():
    jm, jp = jax_model_and_params()
    tm = torch_model()
    return jfm.extract_nerf_weights(jp["params"]["nerf"]), tm


def _inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    # points near the trained body (canonical capsule, |xyz| < ~1)
    pts = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    code = rng.standard_normal(8).astype(np.float32)
    pose = (rng.standard_normal(16) * 0.3).astype(np.float32)
    cp = np.concatenate([np.broadcast_to(code * 0.7, (n, 8)), np.broadcast_to(pose, (n, 16))], 1)
    return pts, np.ascontiguousarray(cp, dtype=np.float32)


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max() + 1e-12
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max abs err {err:.3g} > {tol} x {scale:.3g}"


def _torch_params(tm):
    return tuple(p.detach().clone().requires_grad_(True) for p in fm.nerf_params(tm.nerf))


@pytest.mark.parametrize("with_color", [True, False])
@pytest.mark.parametrize("n", [64, 100])
def test_forward_and_gradients_match_jax_interpret(models, with_color, n):
    """sigma/essence/normal and the gradients in every weight, in pe and in
    cp, through the JAX package's kernels in interpret mode (block 64, so
    n=100 is ragged)."""
    jw, tm = models
    pts, cp = _inputs(n)
    pe_np = np.array(jax_posenc(jnp.asarray(pts), 10))
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((n,), (n, 3), (n, 3))]

    if with_color:
        fn = lambda w, pe, c: jfm.fused_sigma_essence_normal(w, pe, c, block=BLOCK, interpret=True)
    else:
        fn = lambda w, pe, c: (jfm.fused_sigma(w, pe, c, block=BLOCK, interpret=True),)
    outs_j, vjp = jax.vjp(fn, jw, jnp.asarray(pe_np), jnp.asarray(cp))
    wbar_j, pebar_j, cpbar_j = vjp(tuple(jnp.asarray(c) for c in cots[:len(outs_j)]))

    params = _torch_params(tm)
    pe = torch.from_numpy(pe_np).requires_grad_(True)
    cpt = torch.from_numpy(cp).requires_grad_(True)
    if with_color:
        outs_t = fm.fused_sigma_essence_normal(params, pe, cpt)
    else:
        outs_t = (fm.fused_sigma(params, pe, cpt),)
    for name, a, b in zip(("sigma", "essence", "normal"), outs_t, outs_j):
        _close(a.detach().numpy(), b, FWD_TOL, name)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs_t, cots))
    grads = torch.autograd.grad(loss, (*params, pe, cpt))
    _close(grads[-2].numpy(), pebar_j, GRAD_TOL, "pe")
    _close(grads[-1].numpy(), cpbar_j, GRAD_TOL, "cp")
    for i, (gt, gj) in enumerate(zip(grads[:20], wbar_j)):
        gj = np.asarray(gj)
        if i < 10:  # kernels: flax (in, out) against nn.Linear (out, in)
            gj = gj.T
        _close(gt.numpy(), gj, GRAD_TOL, f"{'Kb'[i // 10]}{i % 10 + 1}")


@pytest.mark.parametrize("with_color", [True, False])
def test_matches_torch_double_backward_through_spacenet(models, with_color):
    """The fused chain against SpaceNet itself: forward, autograd normal
    with create_graph, and the gradient of a loss on all three outputs in
    every parameter, the points, the code and the pose feature."""
    _, tm = models
    n = 300
    pts_np, _ = _inputs(n, seed=3)
    rng = np.random.default_rng(11)
    code0 = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    pose0 = torch.from_numpy((rng.standard_normal(16) * 0.3).astype(np.float32))
    cots = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((n,), (n, 3), (n, 3))]
    nerf = tm.nerf

    def run(fused):
        pts = torch.from_numpy(pts_np).requires_grad_(True)
        code = code0.clone().requires_grad_(True)
        pose = pose0.clone().requires_grad_(True)
        params = fm.nerf_params(nerf)
        for p in params:
            p.grad = None
        if fused:
            cp = torch.cat([code.expand(n, 8), pose.expand(n, 16)], 1)
            pe = posenc(pts, 10)
            if with_color:
                outs = fm.fused_sigma_essence_normal(params, pe, cp)
            else:
                outs = (fm.fused_sigma(params, pe, cp),)
        else:
            ess, dens = nerf(pts, code, pose.expand(n, 16))
            if with_color:
                (normal,) = torch.autograd.grad(dens.sum(), pts, create_graph=True)
                outs = (dens[:, 0], ess, normal)
            else:
                outs = (dens[:, 0],)
        loss = sum((o * c).sum() for o, c in zip(outs, cots))
        grads = torch.autograd.grad(loss, (*params, pts, code, pose), allow_unused=True)
        return [o.detach() for o in outs], grads

    outs_f, grads_f = run(True)
    outs_r, grads_r = run(False)
    for name, a, b in zip(("sigma", "essence", "normal"), outs_f, outs_r):
        _close(a.numpy(), b.numpy(), FWD_TOL, name)
    names = [f"K{i}" for i in range(1, 11)] + [f"b{i}" for i in range(1, 11)] + ["pts", "code", "pose"]
    for name, a, b in zip(names, grads_f, grads_r):
        if b is None:  # the color heads without color: the fused side gives zeros
            assert not with_color and float(a.abs().max()) == 0.0, name
            continue
        _close(a.numpy(), b.numpy(), GRAD_TOL, name)


def test_packing_round_trips(models):
    """pack / flat_weights / split_grads / unpack_grads land every tensor
    where it came from (the CUDA kernels' buffers use these layouts)."""
    _, tm = models
    params = fm.nerf_params(tm.nerf)
    w = fm.pack(params)
    flat = fm.flat_weights(w)
    assert flat.shape == (fm.W_FLOATS,)
    g = fm.split_grads(flat[:fm.G_FLOATS].clone())
    for k in ("k1", "k5a", "k5b", "k8", "k10", "b8", "b10"):
        assert torch.equal(g[k], w[k].detach().reshape(g[k].shape)), k
    back = fm.unpack_grads(g)
    for a, b in zip(back, params):
        assert torch.equal(a.reshape(b.shape), b.detach())
    # the transposed copies sit behind the gradient part
    o = fm.G_FLOATS
    assert torch.equal(flat[o:o + 256 * 87].view(256, 87), w["k1"].detach().t())


def test_wrappers_refuse_other_devices(models):
    _, tm = models
    w = fm.pack(fm.nerf_params(tm.nerf))
    x = torch.zeros(4, fm.IN, device="meta")
    with pytest.raises(ValueError):
        fm.fused_fwd(w, x, True)
    with pytest.raises(ValueError):
        fm.build_x(torch.zeros(4, 60), torch.zeros(4, 24))


# an H100's grid of the float32 backward (132 SMs, two blocks each) and its
# records (`fused_mlp_bwd_record`: 3,761 / 8,012 rows of 64 floats a tile)
# and gradient tiles (28 / 30)
_GRID = 264
_RECORD = {False: 3761 * fm.TILE * 4, True: 8012 * fm.TILE * 4}
_GEMM_TILES = {False: 28, True: 30}


@pytest.mark.parametrize("budget", [fm.RECORD_BUDGET, 50 << 20])
@pytest.mark.parametrize("with_color", [False, True])
@pytest.mark.parametrize("ntiles", [1, 63, 64, 65, 100, 264, 1055, 1057, 2377, 11_000])
def test_wgrad_plan_covers_every_tile_once(ntiles, with_color, budget):
    """The float32 backward's plan (`wgrad_plan`, `wgrad_shares`) for a
    ragged and a whole last tile: every tile of points in one share of one
    chunk, in order; the shares of a chunk contiguous, one a split; at least
    one split, no more than two waves of the grid hold or the chunk has tiles;
    each chunk's records within the budget, in whole waves of the grid where
    more than a wave fits; two or more chunks where the tiles outgrow the
    budget."""
    record, gemm_tiles = _RECORD[with_color], _GEMM_TILES[with_color]
    for n in (ntiles * fm.TILE - fm.TILE + 1, ntiles * fm.TILE):
        chunk, splits = fm.wgrad_plan(n, _GRID, record, gemm_tiles, budget)
        assert 1 <= splits <= min(chunk, max(1, 2 * _GRID // gemm_tiles))
        assert chunk * record <= budget
        if budget // record >= _GRID and chunk < ntiles:
            assert chunk % _GRID == 0
        shares = fm.wgrad_shares(n, chunk, splits)
        assert len(shares) == -(-ntiles // chunk)
        assert len(shares) > 1 or ntiles * record <= budget
        assert all(len(split) == splits for split in shares)
        walked = [(a, b) for split in shares for a, b in split]
        assert all(b == a2 for (_, b), (a2, _) in zip(walked, walked[1:]))
        assert walked[0][0] == 0 and walked[-1][1] == ntiles
