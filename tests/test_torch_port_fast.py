"""The port's bfloat16 options on the CPU against the JAX package:

- `MODEL.FUSED_FAST`: the fused SpaceNet functions with ``fast=True``
  (`ops/fused_mlp.py`, the plain versions on the CPU: every product's
  operands rounded to bfloat16, float32 sums) against the JAX package's
  Pallas pair in interpret mode with ``fast=True``, forward and the full
  gradient, on the trained fixture and on random weights, ~300 points as
  the JAX package's own `tests/test_fused_mlp.py` runs its fast test;
- `MODEL.MATMUL_PRECISION: "bf16"`: `DualSpaceNeRF(compute_dtype=
  torch.bfloat16)` against the JAX package's `DualSpaceNeRF(compute_dtype=
  jnp.bfloat16)`, float32 parameters kept, and its checkpoint against a
  float32 model's.

Bands, relative to the reference's max-abs scale. The fast pair: both sides
multiply the same bfloat16 operands exactly and sum in float32 in another
order, so they agree as the float32 pair does (forward 1e-5, per-point
gradients 2e-5; measured 1.8e-7 and 9e-8) except where a bfloat16 rounding
flips (see the test). The bf16 networks: each Dense rounds its product
and then its sum with the bias to bfloat16 on both sides (torch's CPU
bfloat16 matmul and XLA's sum in float32 and round once), so the two agree
to a fraction of a bfloat16 ulp (2^-8) of each output's scale: band 1 ulp
(measured 0.086 for the essence, 0.068 for the density, 3e-5 for the
lighting and 1.6e-5 for the autograd normal).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dual_space_nerf_tpu.models import DualSpaceNeRF as JaxNeRF
from dual_space_nerf_tpu.ops import fused_mlp as jfm
from dual_space_nerf_tpu.ops.posenc import posenc as jax_posenc
from dual_space_nerf_tpu_torch.cli.common import build_model, compute_dtype
from dual_space_nerf_tpu_torch.config import get_cfg_defaults
from dual_space_nerf_tpu_torch.models import DualSpaceNeRF, state_dict_from_flax
from dual_space_nerf_tpu_torch.ops import fused_mlp as fm
from dual_space_nerf_tpu_torch.training import Checkpointer, create_train_state
from torch_port_common import MAX_FRAMES, jax_model_and_params, torch_model

FWD_TOL, GRAD_TOL = 1e-5, 2e-5
WGRAD_TOL = 1e-3      # the fast weight gradients (see the fast test)
FLIP_POINTS = 15      # of N: points that a bfloat16 rounding flip may move
ORACLE_CEILING = 0.05  # share of points beyond the bands against the fast oracle
BF16_ULP = 2.0 ** -8
BF16_BAND = 1         # bfloat16 ulps of scale: the bf16 networks against JAX's
N = 300


def _flat(tree) -> dict:
    return {"/".join(str(p.key) for p in path): np.array(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def weights():
    """(JAX params, torch model) for the trained fixture and for random
    flax weights carried across."""
    jm, jp = jax_model_and_params()
    rand = jm.init(jax.random.key(11), jnp.zeros((4, 3)), jnp.zeros((4,), jnp.int32),
                   jnp.zeros((4, 16)))
    tm_rand = DualSpaceNeRF(max_frames=MAX_FRAMES)
    tm_rand.load_state_dict(state_dict_from_flax(_flat(rand)))
    return {"trained": (jp, torch_model()), "random": (rand, tm_rand)}


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = np.abs(want).max() + 1e-12
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{name}: max abs err {err:.3g} > {tol} x {scale:.3g}"


def _inputs(n, seed=1):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)
    code = rng.standard_normal(8).astype(np.float32)
    pose = (rng.standard_normal(16) * 0.3).astype(np.float32)
    cp = np.concatenate([np.broadcast_to(code * 0.7, (n, 8)), np.broadcast_to(pose, (n, 16))], 1)
    return np.array(jax_posenc(jnp.asarray(pts), 10)), np.ascontiguousarray(cp, dtype=np.float32)


# ---------------------------------------------------------------------------
# FUSED_FAST: the bfloat16-fed fused pair
# ---------------------------------------------------------------------------
def _per_point(got, want):
    """Per point, max |got - want| over the reference's max-abs scale."""
    got = np.asarray(got, np.float64).reshape(N, -1)
    want = np.asarray(want, np.float64).reshape(N, -1)
    return np.abs(got - want).max(1) / (np.abs(want).max() + 1e-12)


@pytest.mark.parametrize("which", ["trained", "random"])
@pytest.mark.parametrize("with_color", [True, False])
def test_fast_fused_matches_jax_interpret(weights, which, with_color):
    """sigma / essence / normal and the gradient in every weight, in pe and
    in cp, against `fused_sigma_essence_normal(..., interpret=True,
    fast=True)` (block 64, so 300 points are ragged): `_match_jax_fast`."""
    _match_jax_fast(weights, which, with_color)


@pytest.mark.parametrize("which", ["trained", "random"])
@pytest.mark.parametrize("with_color", [True, False])
def test_fast_oracle_matches_jax_interpret(weights, which, with_color, monkeypatch):
    """The fast kernels' oracle, the plain versions with ``order="exact"``
    (every sum in float64, rounded once to float32), through the same
    autograd function against the same JAX pair, held as
    `_match_jax_fast` holds the plain versions in torch's order: the oracle
    rounds where both float32 orders round, so it agrees with the JAX
    kernels as they do."""
    for name in ("fused_fwd_plain", "fused_bwd_plain"):
        monkeypatch.setattr(fm, name, functools.partial(getattr(fm, name), order="exact"))
    _match_jax_fast(weights, which, with_color)


def _match_jax_fast(weights, which, with_color):
    """The fast autograd function (on the CPU: its plain versions) against
    the JAX package's fast pair in interpret mode.

    Where the two float32 orders of a sum round an operand to neighbouring
    bfloat16 values, that point's later operands move by a bfloat16 ulp: a
    point whose outputs or pe / cp gradients part by more than the bands
    is such a flip. At most FLIP_POINTS of the 300 may be (measured: 0
    with the trained weights, 6 with random ones); they are left out and
    their cotangents zeroed. A flip in the second-order chain (gb, which
    no per-point output shows) still moves a weight gradient: of 300
    points one term is a large share of the sum. So the weight gradients
    hold WGRAD_TOL (measured 3.0e-4, K4 of the trained weights with color;
    1.8e-4 with random ones), the per-point outputs FWD_TOL and GRAD_TOL."""
    jp, tm = weights[which]
    jw = jfm.extract_nerf_weights(jp["params"]["nerf"])
    pe_np, cp = _inputs(N)
    rng = np.random.default_rng(7)
    cots = [rng.standard_normal(s).astype(np.float32) for s in ((N,), (N, 3), (N, 3))]
    if with_color:
        fn = lambda w, pe, c: jfm.fused_sigma_essence_normal(w, pe, c, block=64, interpret=True, fast=True)
    else:
        fn = lambda w, pe, c: (jfm.fused_sigma(w, pe, c, block=64, interpret=True, fast=True),)
    outs_j, vjp = jax.vjp(fn, jw, jnp.asarray(pe_np), jnp.asarray(cp))
    params = tuple(p.detach().clone().requires_grad_(True) for p in fm.nerf_params(tm.nerf))
    pe = torch.from_numpy(pe_np).requires_grad_(True)
    cpt = torch.from_numpy(cp).requires_grad_(True)
    if with_color:
        outs_t = fm.fused_sigma_essence_normal(params, pe, cpt, fast=True)
    else:
        outs_t = (fm.fused_sigma(params, pe, cpt, fast=True),)

    def grads(cs):
        cs = cs[:len(outs_j)]
        gj = vjp(tuple(jnp.asarray(c) for c in cs))
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs_t, cs))
        return torch.autograd.grad(loss, (*params, pe, cpt), retain_graph=True), gj

    (gt, (wbar_j, pebar_j, cpbar_j)) = grads(cots)
    flipped = _per_point(gt[-2].numpy(), pebar_j) > GRAD_TOL
    flipped |= _per_point(gt[-1].numpy(), cpbar_j) > GRAD_TOL
    for a, b in zip(outs_t, outs_j):
        flipped |= _per_point(a.detach().numpy(), b) > FWD_TOL
    assert flipped.sum() <= FLIP_POINTS, int(flipped.sum())
    keep = ~flipped
    for name, a, b in zip(("sigma", "essence", "normal"), outs_t, outs_j):
        _close(a.detach().numpy()[keep], np.asarray(b)[keep], FWD_TOL, name)
    kept = [c * keep.reshape(-1, *([1] * (c.ndim - 1))).astype(np.float32) for c in cots]
    gt, (wbar_j, pebar_j, cpbar_j) = grads(kept)
    _close(gt[-2].numpy()[keep], np.asarray(pebar_j)[keep], GRAD_TOL, "pe")
    _close(gt[-1].numpy()[keep], np.asarray(cpbar_j)[keep], GRAD_TOL, "cp")
    for i, (g, gj) in enumerate(zip(gt[:20], wbar_j)):
        gj = np.asarray(gj)
        if i < 10:  # kernels: flax (in, out) against nn.Linear (out, in)
            gj = gj.T
        _close(g.numpy(), gj, WGRAD_TOL, f"{'Kb'[i // 10]}{i % 10 + 1}")


def test_fast_rounds_only_the_products(weights):
    """The fast plain version differs from the float32 one by bfloat16
    rounding (~1e-2 of scale, not 1e-7), and rounding the weights first
    changes nothing: it rounds them itself. Biases are not rounded: a bias
    off the bfloat16 grid moves sigma by exactly its own change."""
    _, tm = weights["trained"]
    w = {k: v.detach() for k, v in fm.pack(fm.nerf_params(tm.nerf)).items()}
    pe_np, cp = _inputs(N)
    x = fm.build_x(torch.from_numpy(pe_np), torch.from_numpy(cp))
    fast = fm.fused_fwd_plain(w, x, True, fast=True)
    exact = fm.fused_fwd_plain(w, x, True)
    rel = float((fast[0] - exact[0]).abs().max() / exact[0].abs().max())
    assert 1e-4 < rel < 1e-1, rel
    pre = {k: (fm.bf16_round(v) if k.startswith("k") else v) for k, v in w.items()}
    again = fm.fused_fwd_plain(pre, x, True, fast=True)
    assert all(torch.equal(a, b) for a, b in zip(fast, again))
    shifted = dict(w, b8=w["b8"] + 2.0 ** -20)
    moved = fm.fused_fwd_plain(shifted, x, False, fast=True)[0]
    assert torch.equal(moved, fast[0] + 2.0 ** -20) or float((moved - fast[0] - 2.0 ** -20).abs().max()) < 1e-6


def _f32_nearest(v) -> np.float32:
    """The float32 nearest to the exact rational ``v`` (ties to even)."""
    from fractions import Fraction

    c = np.float32(float(v))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(cand)) - v)
        even = (int(np.array(cand).view(np.int32)) & 1) == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, cand)
    return best[1]


def test_fma_rounds_once():
    """`_fma` (the in-order plain version's `fmaf`) rounds a * b + c once:
    on random float32 values against the exact sum, and on a planted sum
    whose float64 rounding lands on a float32 tie (a + b * c rounded twice
    goes the wrong way there)."""
    from fractions import Fraction

    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((2, 500)).astype(np.float32)
    c = (rng.standard_normal(500) * np.exp2(rng.integers(-30, 30, 500))).astype(np.float32)
    a = np.append(a, np.float32((1 - 2.0 ** -15) * 2.0 ** -24))
    b = np.append(b, np.float32(1 + 2.0 ** -15))
    c = np.append(c, np.float32(1 + 2.0 ** -23))
    got = fm._fma(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = [_f32_nearest(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r))) for p, q, r in zip(a, b, c)]
    assert np.array_equal(got, np.array(want, np.float32))
    assert got[-1] == np.float32(1 + 2.0 ** -23)
    assert np.float32(np.float64(a[-1]) * np.float64(b[-1]) + np.float64(c[-1])) != got[-1]


@pytest.mark.parametrize("which", ["trained", "random"])
@pytest.mark.parametrize("with_color", [True, False])
def test_in_order_plain_parts_from_plain_only_at_order_flips(weights, which, with_color):
    """The fast plain versions in the order of an FMA chain (`in_order`)
    against the same in torch's order: apart from the points that `order_flips` names (an operand
    rounded to another bfloat16 value, or a mask taken the other way; at
    most FLIP_POINTS of the 300), forward within FWD_TOL and xbar / gpe
    within GRAD_TOL, and with those points' cotangents zeroed every weight
    gradient within GRAD_TOL: the rest multiply the same operands. On the
    float32 variant no such order exists: it raises."""
    _, tm = weights[which]
    w = {k: v.detach() for k, v in fm.pack(fm.nerf_params(tm.nerf)).items()}
    pe_np, cp = _inputs(N)
    x = fm.build_x(torch.from_numpy(pe_np), torch.from_numpy(cp))
    g = torch.Generator().manual_seed(9)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float32)
    sbar = rnd(N)
    ebar, gbar = (rnd(N, 3), rnd(N, fm.PE)) if with_color else (None, None)
    flips = fm.order_flips(w, x, sbar, ebar, gbar, with_color)
    assert int(flips.sum()) <= FLIP_POINTS
    keep = (~flips).numpy()
    ordered = fm.fused_fwd_plain(w, x, with_color, True, order="in_order")
    for name, a, b in zip(("sigma", "essence", "gpe"), fm.fused_fwd_plain(w, x, with_color, True), ordered):
        if b is not None:
            _close(a.numpy()[keep], b.numpy()[keep], FWD_TOL, name)
    zero = lambda c: c * torch.from_numpy(keep).reshape(-1, *([1] * (c.dim() - 1))) if c is not None else None
    cots = (zero(sbar), zero(ebar), zero(gbar))
    xb, gp, gr = fm.fused_bwd_plain(w, x, *cots, with_color, True)
    xb_o, gp_o, gr_o = fm.fused_bwd_plain(w, x, *cots, with_color, True, order="in_order")
    _close(xb.numpy()[keep], xb_o.numpy()[keep], GRAD_TOL, "xbar")
    if with_color:
        _close(gp.numpy()[keep], gp_o.numpy()[keep], GRAD_TOL, "gpe")
    for k, t in gr_o.items():
        _close(gr[k].numpy(), t.numpy(), GRAD_TOL, k)
    with pytest.raises(ValueError):
        fm.fused_fwd_plain(w, x, with_color, False, order="in_order")


@pytest.mark.parametrize("with_color", [True, False])
def test_fast_plain_orders_against_oracle(weights, with_color):
    """The two float32 orders of the fast plain versions, torch's and
    ``in_order``, against the oracle (``order="exact"``) on the trained
    fixture: the points where a per-point output parts from the oracle by
    more than the float32 pair's bands (forward 1e-5, backward 2e-5 of
    scale; `beyond_band`) are bfloat16 rounding flips, under ORACLE_CEILING
    of the points, the share above which the card's check calls a fast
    kernel wrong. With those points' cotangents zeroed the weight
    gradients agree within WGRAD_TOL: a flip that no per-point output
    shows (a gb operand, a mask at a kink) still moves a gradient by
    ~1e-4 of its scale (measured 3.0e-4 at these 300 points, 1e-4-1e-3 at
    3,000-12,000), so the card's check holds a kernel's gradients to
    twice the plain orders' own error, not to 2e-5."""
    _, tm = weights["trained"]
    w = {k: v.detach() for k, v in fm.pack(fm.nerf_params(tm.nerf)).items()}
    pe_np, cp = _inputs(N)
    x = fm.build_x(torch.from_numpy(pe_np), torch.from_numpy(cp))
    g = torch.Generator().manual_seed(13)
    rnd = lambda *shape: torch.randn(*shape, generator=g, dtype=torch.float32)
    cots = (rnd(N), *((rnd(N, 3), rnd(N, fm.PE)) if with_color else (None, None)))
    f_ex = fm.fused_fwd_plain(w, x, with_color, True, order="exact")
    b_ex = fm.fused_bwd_plain(w, x, *cots, with_color, True, order="exact")
    for order in ("torch", "in_order"):
        f = fm.fused_fwd_plain(w, x, with_color, True, order=order)
        b = fm.fused_bwd_plain(w, x, *cots, with_color, True, order=order)
        far = fm.beyond_band(zip(f, f_ex), FWD_TOL) | fm.beyond_band(zip(b[:2], b_ex[:2]), GRAD_TOL)
        assert float(far.float().mean()) < ORACLE_CEILING, (order, int(far.sum()))
        keep = ~far
        zero = lambda c: c * keep.reshape(-1, *([1] * (c.dim() - 1))) if c is not None else None
        kept = tuple(zero(c) for c in cots)
        _, _, gr = fm.fused_bwd_plain(w, x, *kept, with_color, True, order=order)
        _, _, gr_ex = fm.fused_bwd_plain(w, x, *kept, with_color, True, order="exact")
        for k, t in gr_ex.items():
            _close(gr[k].numpy(), t.numpy(), WGRAD_TOL, f"{order} {k}")


def test_oracle_rounds_each_sum_once():
    """``order="exact"`` sums in float64 and rounds once: on a planted sum
    whose float32 partial sums lose every small term (1 + 2^-25 rounds to 1
    in float32, 2^12 times over) it returns the exact total 1 + 2^-13,
    where the FMA chain (``in_order``) stays at 1; on small exact sums
    every order agrees."""
    n = 1 << 12
    a = torch.ones((1, n + 1))
    b = torch.full((n + 1, 1), 2.0 ** -25)
    b[0, 0] = 1.0
    assert float(fm._mms([(a, b)], True, "exact")) == 1.0 + 2.0 ** -13
    assert float(fm._mms([(a, b)], True, "in_order")) == 1.0
    small = torch.tensor([[1.0, 2.0], [0.5, -1.0]])
    for order in fm.ORDERS:
        assert torch.equal(fm._mms([(small, small)], True, order), small @ small)


def test_fast_weights_are_the_rounded_layout():
    """The fast kernels' bfloat16 weight buffer (`fast_weights`): every
    entry of every matrix equals `bf16_round` of its entry in the float32
    layout (`flat_weights`), and every pad is zero."""
    tm = torch_model()
    w = {k: v.detach() for k, v in fm.pack(fm.nerf_params(tm.nerf)).items()}
    wb = fm.fast_weights(w)
    assert wb.dtype == torch.bfloat16 and wb.shape == (fm.WB_ELEMS,)
    flat, offs, o = fm.flat_weights(w), {}, 0
    for name, shape in fm._W_LAYOUT:
        offs[name] = (o, shape)
        o += fm._numel(shape)
    o = 0
    for name, shape in fm._WB_LAYOUT:
        got = wb[o:o + fm._numel(shape)].view(shape).float()
        o += fm._numel(shape)
        src_o, src_shape = offs[name]
        want = fm.bf16_round(flat[src_o:src_o + fm._numel(src_shape)].view(src_shape))
        r, c = src_shape
        assert torch.equal(got[:r, :c], want), name
        assert not got[r:].any() and not got[:, c:].any(), name
    assert o == fm.WB_ELEMS


# ---------------------------------------------------------------------------
# MATMUL_PRECISION bf16: the networks in bfloat16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("which", ["trained", "random"])
def test_bf16_networks_match_jax(weights, which):
    """sigma_essence (density, essence) and the lighting of a
    compute_dtype=bfloat16 model against the JAX package's, within
    BF16_BAND bfloat16 ulps of each output's scale, parameters kept
    float32. With random weights (the JAX package's own
    `tests/test_models.py:174-200` setting) both also stay within that
    test's bands of their float32 forwards: 0.05 essence, 0.15 density, 0.1
    lighting."""
    jp, tm32 = weights[which]
    jm16 = JaxNeRF(max_frames=MAX_FRAMES, compute_dtype=jnp.bfloat16)
    jm32 = JaxNeRF(max_frames=MAX_FRAMES)
    tm16 = DualSpaceNeRF(max_frames=MAX_FRAMES, compute_dtype=torch.bfloat16)
    tm16.load_state_dict(tm32.state_dict())
    assert all(p.dtype == torch.float32 for p in tm16.parameters())

    rng = np.random.default_rng(3)
    x = (rng.standard_normal((256, 3)) * 0.3).astype(np.float32)
    pf = (rng.standard_normal((256, 16)) * 0.3).astype(np.float32)
    n = rng.standard_normal((256, 3)).astype(np.float32)
    code = np.asarray(jm32.apply(jp, jnp.asarray(2), method="frame_code"))
    out = {}
    for tag, jm, tm in (("bf16", jm16, tm16), ("f32", jm32, tm32)):
        ej, dj = jm.apply(jp, jnp.asarray(x), None, jnp.asarray(pf), 0.7,
                          method="sigma_essence", code=jnp.asarray(code))
        with torch.no_grad():
            et, dt = tm.sigma_essence(torch.from_numpy(x), torch.from_numpy(code),
                                      torch.from_numpy(pf), 0.7)
            ct = tm.lighting(torch.from_numpy(n), torch.from_numpy(x), torch.from_numpy(n),
                             torch.from_numpy(np.asarray(ej)))
        cj = jm.apply(jp, jnp.asarray(n), jnp.asarray(x), jnp.asarray(n), ej, method="lighting")
        assert et.dtype == dt.dtype == ct.dtype == torch.float32
        out[tag] = {"essence": (et.numpy(), np.asarray(ej)), "density": (dt.numpy(), np.asarray(dj)),
                    "lighting": (ct.numpy(), np.asarray(cj))}
    for k, (a, b) in out["bf16"].items():
        _close(a, b, BF16_BAND * BF16_ULP, f"bf16 {k}")
        # bfloat16 moved the outputs: not the float32 model by another name
        assert np.abs(a - out["f32"][k][0]).max() > 1e-5 * np.abs(a).max(), k
    if which == "random":
        for k, tol in (("essence", 0.05), ("density", 0.15), ("lighting", 0.1)):
            for side in (0, 1):
                np.testing.assert_allclose(out["bf16"][k][side], out["f32"][k][side], atol=tol, err_msg=k)


def test_bf16_normal_gradient_matches_jax(weights):
    """The autograd density normal (the renderer's d(sum sigma)/d(pos)) of
    the bfloat16 networks: cotangents run through bfloat16 on both sides;
    within 2 x BF16_BAND bfloat16 ulps of its scale."""
    jp, tm32 = weights["trained"]
    jm16 = JaxNeRF(max_frames=MAX_FRAMES, compute_dtype=jnp.bfloat16)
    tm16 = DualSpaceNeRF(max_frames=MAX_FRAMES, compute_dtype=torch.bfloat16)
    tm16.load_state_dict(tm32.state_dict())
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((128, 3)) * 0.3).astype(np.float32)
    pf = np.broadcast_to((rng.standard_normal(16) * 0.3).astype(np.float32), (128, 16)).copy()
    code = np.asarray(jm16.apply(jp, jnp.asarray(1), method="frame_code"))

    def dens(p):
        return jm16.apply(jp, p, None, jnp.asarray(pf), 1.0, True, method="sigma_essence",
                          code=jnp.asarray(code))[1]

    dj, pull = jax.vjp(dens, jnp.asarray(x))
    nj = pull(jnp.ones_like(dj))[0]
    pc = torch.from_numpy(x).requires_grad_(True)
    _, dt = tm16.sigma_essence(pc, torch.from_numpy(code), torch.from_numpy(pf), 1.0, density_only=True)
    (nt,) = torch.autograd.grad(dt.sum(), pc)
    _close(nt.numpy(), np.asarray(nj), 2 * BF16_BAND * BF16_ULP, "normal")


def test_bf16_linear_rounds_the_product_then_the_sum():
    """`models/layers.Linear` at bfloat16: flax's order, the product rounded
    to bfloat16, then the bias added and the sum rounded again. A fused
    bfloat16 addmm (one rounding) is not that function: it differs on a
    large share of the outputs (measured 30% of 4096 x 256)."""
    from dual_space_nerf_tpu_torch.models.layers import Linear

    g = torch.Generator().manual_seed(0)
    lin = Linear(256, 256, torch.bfloat16)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(256, 256, generator=g) / 16)
        lin.bias.copy_(torch.randn(256, generator=g))
    x = torch.randn(4096, 256, generator=g)
    with torch.no_grad():
        got = lin(x)
    xb, wb, bb = x.to(torch.bfloat16), lin.weight.to(torch.bfloat16), lin.bias.to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and lin.weight.dtype == torch.float32
    assert torch.equal(got, torch.nn.functional.linear(xb, wb) + bb)
    one_rounding = torch.nn.functional.linear(xb, wb, bb)
    assert float((got != one_rounding).float().mean()) > 0.05


def test_matmul_precision_builds_and_checkpoints(tmp_path):
    """`cli.common.build_model` reads MATMUL_PRECISION ("f32" or "bf16"; other
    values raise); a bf16-compute model's checkpoint loads into a float32
    model and back, with float32 parameters and optimizer state."""
    cfg = get_cfg_defaults()
    cfg.MODEL.MAX_FRAMES = MAX_FRAMES
    cfg.MODEL.MATMUL_PRECISION = "bf16"
    m16 = build_model(cfg)
    assert m16.compute_dtype is torch.bfloat16 and m16.nerf.stage1[0].compute_dtype is torch.bfloat16
    assert m16.nerf.density_net[0].compute_dtype is None  # the heads stay float32
    state = create_train_state(m16, cfg)
    for p in m16.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    ck = Checkpointer(str(tmp_path))
    ck.save("model_epoch_0000001", state, epoch=1)
    cfg32 = cfg.clone()
    cfg32.MODEL.MATMUL_PRECISION = "f32"
    m32 = build_model(cfg32, seed=1)
    assert m32.compute_dtype is None
    loaded, epoch = ck.load(str(tmp_path / "model_epoch_0000001.ckpt"), create_train_state(m32, cfg32))
    assert epoch == 1
    for (n, a), b in zip(m16.state_dict().items(), m32.state_dict().values()):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b), n
    exp_avg = [s["exp_avg"] for s in loaded.optimizer.state.values()]
    assert exp_avg and all(t.dtype == torch.float32 for t in exp_avg)
    back = build_model(cfg, seed=2)
    ck.load_params_only(str(tmp_path / "model_epoch_0000001.ckpt"), back)
    assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(), m16.state_dict().values()))
    assert compute_dtype(cfg32) is None
    cfg32.MODEL.MATMUL_PRECISION = "f16"
    with pytest.raises(ValueError):
        build_model(cfg32)
