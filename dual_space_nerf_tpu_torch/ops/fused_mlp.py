"""Fused SpaceNet chain: the CUDA kernels' wrappers, their plain versions
and the autograd functions around them.

Replaces the TPU kernels `dual_space_nerf_tpu/ops/fused_mlp.py:_fwd_kernel`
(forward: sigma, essence and gpe = d(sigma)/d(pe), the "g-recursion") and
`:_bwd_kernel` (recompute, first-order backprop of the sigma and essence
cotangents, second-order vjp of the g-recursion, weight-gradient
accumulation). The kernels are `csrc/fused_mlp_fwd.cu` and
`csrc/fused_mlp_bwd.cu`; their plain PyTorch versions are `fused_fwd_plain`
and `fused_bwd_plain`, the same algebra as torch matmuls.

``fast=True`` is the JAX kernels' bfloat16 feed (`MODEL.FUSED_FAST`): every
operand of every product rounded to bfloat16, the sums in float32. On the
card it runs the `_fast` entry points of the same two sources
(`FWD_FAST_KERNEL`, `BWD_FAST_KERNEL`, each with its own launch count),
whose products run on the tensor cores (`csrc/fused_mlp_tc.cuh`) on a bf16
copy of the weights (`fast_weights`). A tensor core's order and rounding
of a sum have no plain counterpart, so the fast kernels are held to an
oracle: the plain versions with ``order="exact"``, every sum taken in
float64 and rounded once to float32 (`beyond_band` counts the points
where a result parts from it; two float32 orders of the plain version,
torch's and ``order="in_order"``, give the yardstick).

Math (flax (in, out) kernels, row-vector points), with x = [pe 63 | code 8 |
pose 16] (87 lanes) and K1's rows permuted to that order, K5 split into K5a
(the h4 rows) and K5b (the pe rows):

  h1 = relu(x K1 + b1), h2..h4 likewise, h5 = relu(h4 K5a + pe K5b + b5),
  h6, h7; sigma = h7 . k8 + b8; e1 = relu(h7 K9 + b9); essence = e1 K10 + b10
  u7 = m7 * k8,  u_{l-1} = m_{l-1} * (u_l K_l^T),  u4 = m4 * (u5 K5a^T)
  gpe = (u1 K1^T)[:, :63] + u5 K5b^T          (m_l = h_l > 0)

The gpe cotangent gbar runs the recursion upward:
  gb1 = m1 * (gbar K1[:63]), Kbar_l += gb_{l-1}^T u_l, gb_l = m_l * (gb_{l-1} K_l),
  Kbar5a += gb4^T u5, Kbar5b += gbar^T u5, gb5 = m5 * (gb4 K5a + gbar K5b),
  k8bar += sum_p gb7.

Bound on the H100 (the float32 pair: FP32, no tensor cores): operations.
Per point ~0.43 M multiply-adds for the density-only forward, ~0.89 M with
color, ~1.3 M and ~2.7 M for the backward; the inputs and outputs move
0.3-1 KB per point. The float32 forward keeps every activation of a tile
of points in the block's own scratch (device memory, never a whole-batch
activation); the backward writes each tile's rows into a record that its
weight-gradient pass sums over the points, a chunk of records at a time
under `RECORD_BUDGET` (`wgrad_plan`). Both read the 2.1 MB of weights from
L2 and run their products on one tiled core, `csrc/fused_mlp_tiled.cuh`
(shared-memory slabs, register micro-tiles), the fast pair on
`csrc/fused_mlp_tc.cuh`; each pair shares its core's backbone and
g-recursion routines, so a forward's gpe is its backward's recomputed gpe
bit for bit; see the sources' headers.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, stream_ptr

W = 256          # backbone width
PE = 63          # posenc width of xyz at 10 frequencies
CP = 24          # frame code (8) + pose feature (16)
IN = PE + CP     # kernel input lanes: [pe | code | pose]
NF = 10          # posenc frequencies
F32 = torch.float32

#: SpaceNet's Linear layers in the JAX package's order K1..K10
LINEARS = ("stage1.0", "stage1.2", "stage1.4", "stage1.6", "stage2.0", "stage2.2",
           "stage2.4", "density_net.0", "rgb_net.1", "rgb_net.3")

#: the kernels' flat weight buffer: (name, shape), in order; "<name>t" are
#: the transposes the backward passes read with unit stride
_W_LAYOUT = (
    ("k1", (IN, W)), ("k2", (W, W)), ("k3", (W, W)), ("k4", (W, W)), ("k5a", (W, W)),
    ("k5b", (PE, W)), ("k6", (W, W)), ("k7", (W, W)), ("k8", (W,)),
    ("b1", (W,)), ("b2", (W,)), ("b3", (W,)), ("b4", (W,)), ("b5", (W,)), ("b6", (W,)),
    ("b7", (W,)), ("b8", (1,)), ("k9", (W, 128)), ("b9", (128,)), ("k10", (128, 3)),
    ("b10", (3,)),
    ("k1t", (W, IN)), ("k2t", (W, W)), ("k3t", (W, W)), ("k4t", (W, W)), ("k5at", (W, W)),
    ("k5bt", (W, PE)), ("k6t", (W, W)), ("k7t", (W, W)), ("k9t", (128, W)),
    ("k10t", (3, 128)),
)
#: the kernels' flat gradient buffer, in order (the color heads stay zero
#: in the density-only variant)
_G_LAYOUT = _W_LAYOUT[:21]
#: the fast kernels' bfloat16 weight buffer (`csrc/fused_mlp_tc.cuh`):
#: (name, padded shape), in order; every matrix a layer product reads, its
#: rows padded to a multiple of 32 and its columns to 128 or 256 with zeros
_WB_LAYOUT = (
    ("k1", (96, W)), ("k2", (W, W)), ("k3", (W, W)), ("k4", (W, W)), ("k5a", (W, W)),
    ("k5b", (64, W)), ("k6", (W, W)), ("k7", (W, W)), ("k9", (W, 128)),
    ("k1t", (W, 128)), ("k2t", (W, W)), ("k3t", (W, W)), ("k4t", (W, W)), ("k5at", (W, W)),
    ("k5bt", (W, 128)), ("k6t", (W, W)), ("k7t", (W, W)), ("k9t", (128, W)),
)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


TILE = 64        # both kernels' tile of points
W_FLOATS = sum(_numel(s) for _, s in _W_LAYOUT)
G_FLOATS = sum(_numel(s) for _, s in _G_LAYOUT)
WB_ELEMS = sum(_numel(s) for _, s in _WB_LAYOUT)

_P = ctypes.c_void_p
_I = ctypes.c_int
_HEADERS = ("fused_mlp.cuh", "fused_mlp_tiled.cuh", "fused_mlp_tc.cuh")
FWD_KERNEL = CudaKernel(
    "fused_mlp_fwd.cu", "fused_mlp_fwd_launch",
    # x, weights, sigma, essence, gpe, scratch, n, with_color, blocks, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    includes=_HEADERS,
)
BWD_KERNEL = CudaKernel(
    "fused_mlp_bwd.cu", "fused_mlp_bwd_launch",
    # x, sbar, ebar, gbar, weights, xbar, gpe, small, gradient partials,
    # records, grads, n, with_color, blocks, chunk, splits, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    includes=_HEADERS,
)
# the bfloat16-fed variants: other launchers of the same libraries, on the
# tensor-core core, with sizes of their own
FWD_FAST_KERNEL = CudaKernel.entry_of(
    FWD_KERNEL, "fused_mlp_fwd_fast_launch", "fused_mlp_fwd_fast",
    # x, weights, bf16 weights, sigma, essence, gpe, scratch, n, with_color, blocks, stream
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
)
BWD_FAST_KERNEL = CudaKernel.entry_of(
    BWD_KERNEL, "fused_mlp_bwd_fast_launch", "fused_mlp_bwd_fast",
    # x, sbar, ebar, gbar, weights, bf16 weights, xbar, gpe, small, gradient
    # partials, records, grads, n, with_color, blocks, splits, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
)


#: device bytes that one call of the float32 backward may hold in per-tile
#: records; a call over more points walks them in chunks (`wgrad_plan`)
RECORD_BUDGET = 9 << 28  # 2.25 GiB


class WgradPassCount:
    """Plain integer counts of the float32 backward's weight-gradient pass,
    as `CudaKernel.launches`: ``launches`` of its kernels (one a chunk, then
    the reduce of the shares) and record ``chunks`` walked."""

    def __init__(self):
        self.launches = 0
        self.chunks = 0


WGRAD_PASS = WgradPassCount()


def wgrad_plan(n: int, blocks: int, record_bytes: int, gemm_tiles: int,
               budget: int = RECORD_BUDGET) -> tuple:
    """(tiles a chunk, splits) of the float32 backward over ``n`` points:
    the records of a chunk fit ``budget`` and, where more than a wave fit,
    fill whole waves of the chain's grid of ``blocks``; each chunk's pass
    runs its ``gemm_tiles`` gradient tiles in ``splits`` shares, as many as
    two waves of the grid hold (at least 1, at most the chunk's tiles): 30
    tiles fill 240 of an H100's 264 resident blocks in one wave, 510 of 528
    in two."""
    ntiles = -(-n // TILE)
    cap = max(1, budget // record_bytes)
    if cap >= blocks:
        cap -= cap % blocks
    chunk = max(1, min(ntiles, cap))
    return chunk, max(1, min(chunk, 2 * blocks // gemm_tiles))


def wgrad_shares(n: int, chunk: int, splits: int) -> list:
    """The tiles that the pass's split s sums in each chunk, as the launcher
    walks them: per chunk, [(first tile, end tile)] for s = 0..splits-1, in
    the call's tile numbers."""
    ntiles = -(-n // TILE)
    out = []
    for t0 in range(0, ntiles, chunk):
        m = min(chunk, ntiles - t0)
        out.append([(t0 + m * s // splits, t0 + m * (s + 1) // splits) for s in range(splits)])
    return out


# ---------------------------------------------------------------------------
# Weight packing
# ---------------------------------------------------------------------------
def nerf_params(nerf) -> tuple:
    """A SpaceNet's (K1..K10, b1..b10) as its nn.Linear tensors, (out, in)."""
    mods = [nerf.get_submodule(name) for name in LINEARS]
    return tuple(m.weight for m in mods) + tuple(m.bias for m in mods)


def pack(params) -> dict:
    """(K1..K10, b1..b10) in nn.Linear layout -> the kernels' named tensors,
    flax (in, out) layout, K1's rows in x's [pe | code | pose] order."""
    ks, bs = params[:10], params[10:]
    k1 = ks[0].t()                                        # rows [code | pe | pose]
    k5 = ks[4].t()                                        # rows [h4 | pe]
    return {
        "k1": torch.cat([k1[8:8 + PE], k1[:8], k1[8 + PE:]]),
        "k2": ks[1].t(), "k3": ks[2].t(), "k4": ks[3].t(),
        "k5a": k5[:W], "k5b": k5[W:], "k6": ks[5].t(), "k7": ks[6].t(),
        "k8": ks[7][0], "k9": ks[8].t(), "k10": ks[9].t(),
        **{f"b{i + 1}": bs[i] for i in range(10)},
    }


def flat_weights(w: dict) -> torch.Tensor:
    """The kernels' flat weight buffer (`_W_LAYOUT`) from `pack`'s dict."""
    parts = []
    for name, _ in _W_LAYOUT:
        t = w[name[:-1]].t() if name.endswith("t") else w[name]
        parts.append(t.detach().to(F32).reshape(-1))
    return torch.cat(parts)


def fast_weights(w: dict) -> torch.Tensor:
    """The fast kernels' bfloat16 weight buffer (`_WB_LAYOUT`) from
    `pack`'s dict: each matrix rounded to bfloat16 (to nearest even) and
    zero-padded to its shape."""
    parts = []
    for name, shape in _WB_LAYOUT:
        t = (w[name[:-1]].t() if name.endswith("t") else w[name]).detach().to(F32)
        pad = torch.zeros(shape, dtype=F32, device=t.device)
        pad[:t.shape[0], :t.shape[1]] = t
        parts.append(pad.reshape(-1))
    return torch.cat(parts).to(torch.bfloat16)


def split_grads(flat: torch.Tensor) -> dict:
    """The kernels' flat gradient buffer (`_G_LAYOUT`) -> named tensors."""
    out, o = {}, 0
    for name, shape in _G_LAYOUT:
        out[name] = flat[o:o + _numel(shape)].view(shape)
        o += _numel(shape)
    return out


def unpack_grads(g: dict) -> tuple:
    """Kernel-layout gradients -> (K1..K10, b1..b10) in nn.Linear layout."""
    k1 = g["k1"]                                          # rows [pe | code | pose]
    k1 = torch.cat([k1[PE:PE + 8], k1[:PE], k1[PE + 8:]])
    ks = (k1.t(), g["k2"].t(), g["k3"].t(), g["k4"].t(),
          torch.cat([g["k5a"], g["k5b"]]).t(), g["k6"].t(), g["k7"].t(),
          g["k8"][None], g["k9"].t(), g["k10"].t())
    return tuple(t.contiguous() for t in ks) + tuple(g[f"b{i}"] for i in range(1, 11))


def build_x(pe: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """[pe | code | pose] -> (N, 87) float32, the kernels' input."""
    if pe.shape[1] != PE or cp.shape[1] != CP:
        raise ValueError(f"fused SpaceNet: expected pe width {PE} and cp width {CP}, "
                         f"got {pe.shape[1]} and {cp.shape[1]}")
    return torch.cat([pe.to(F32), cp.to(F32)], dim=1).contiguous()


# ---------------------------------------------------------------------------
# posenc Jacobian partners
# ---------------------------------------------------------------------------
def _freq_coef(dtype, device) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(NF, dtype=dtype, device=device)
    return torch.stack([freqs, -freqs], dim=-1)           # (L, 2)


def dp_table(pe: torch.Tensor) -> torch.Tensor:
    """d(pe_j)/d(pos_d(j)) for each of the 63 slots, read off pe itself:
    1 for the identity slots, f cos(f x) for sin(f x), -f sin(f x) for
    cos(f x) (`ops/posenc.py` layout)."""
    n = pe.shape[0]
    sc = pe[:, 3:].reshape(n, NF, 2, 3)
    swapped = sc.flip(2) * _freq_coef(pe.dtype, pe.device)[None, :, :, None]
    return torch.cat([torch.ones((n, 3), dtype=pe.dtype, device=pe.device),
                      swapped.reshape(n, 2 * NF * 3)], dim=1)


def normal_from_gpe(gpe: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """n_d = sum over slots j of coordinate d of gpe_j * DP_j."""
    return (gpe * dp).reshape(gpe.shape[0], -1, 3).sum(dim=1)


def gbar_from_nbar(nbar: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """The gpe cotangent of a normal cotangent: DP * nbar per slot."""
    return dp * nbar.repeat(1, 1 + 2 * NF)


def pe_extra_from_nbar(gpe: torch.Tensor, nbar: torch.Tensor) -> torch.Tensor:
    """The pe cotangent of the Jacobian application itself (DP depends on pe)."""
    n = gpe.shape[0]
    dpbar = gpe * nbar.repeat(1, 1 + 2 * NF)
    sc = dpbar[:, 3:].reshape(n, NF, 2, 3)
    back = (sc * _freq_coef(gpe.dtype, gpe.device)[None, :, :, None]).flip(2)
    return torch.cat([torch.zeros((n, 3), dtype=gpe.dtype, device=gpe.device),
                      back.reshape(n, 2 * NF * 3)], dim=1)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest bfloat16 (ties to even) -> float32."""
    return t.to(torch.bfloat16).to(F32)


def _mm(a: torch.Tensor, b: torch.Tensor, fast: bool) -> torch.Tensor:
    """a @ b; fast: both operands rounded to bfloat16 first, the products
    (exact in float32) and their sums in float32, as the JAX kernels'
    `_dot`, `_dot_t` and `_dot_g` with fast=True."""
    return bf16_round(a) @ bf16_round(b) if fast else a @ b


#: the orders of the plain versions' sums: torch's; "in_order", one float32
#: sum from +0 over k increasing with one rounding a term (bfloat16-fed
#: only); "exact", the oracle of the fast kernels: each sum in float64,
#: rounded once to float32
ORDERS = ("torch", "in_order", "exact")


def _mms64(pairs, fast: bool) -> torch.Tensor:
    """The per-point sum over (a, b) in ``pairs`` of a @ b in float64, not
    rounded (fast: the operands rounded to bfloat16 first; their products
    are exact in float64 too)."""
    out = None
    for a, b in pairs:
        if fast:
            a, b = bf16_round(a), bf16_round(b)
        t = a.double() @ b.double()
        out = t if out is None else out + t
    return out


def _mms(pairs, fast: bool, order: str = "torch") -> torch.Tensor:
    """The per-point sum over (a, b) in ``pairs`` of a @ b, in ``order``
    (`ORDERS`): torch's, each pair's `_mm` added in turn; "in_order" (fast
    only), one float32 sum per output from +0 over the pairs' k in turn, k
    increasing, one rounding a term, the order of a chain of FMAs on the
    CUDA cores (a product of two bfloat16 values is exact in float32);
    "exact", the whole sum in float64, rounded once."""
    if order == "exact":
        return _mms64(pairs, fast).float()
    if order == "torch":
        out = _mm(*pairs[0], fast)
        for a, b in pairs[1:]:
            out = out + _mm(a, b, fast)
        return out
    if order != "in_order":
        raise ValueError(f"fused SpaceNet: order must be one of {ORDERS}, got {order!r}")
    if not fast:
        raise ValueError("fused SpaceNet: in_order is the bfloat16-fed variant's order")
    vec = pairs[0][1].dim() == 1
    n, j = pairs[0][0].shape[0], 1 if vec else pairs[0][1].shape[1]
    acc = torch.zeros((n, j), dtype=F32, device=pairs[0][0].device)
    for a, b in pairs:
        a_t = bf16_round(a).t().contiguous()
        b = bf16_round(b.reshape(b.shape[0], j))
        for k in range(a_t.shape[0]):
            acc.addcmul_(a_t[k][:, None], b[k])
    return acc[:, 0] if vec else acc


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as `fmaf`: the exact product and
    the sum in float64, the sum rounded to odd (its TwoSum error picks the
    odd neighbour), then to float32, which then rounds once."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    toward = torch.where(e > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s).float()


def _hidden(w: dict, x: torch.Tensor, fast: bool = False, order: str = "torch") -> list:
    """h1..h7 of the backbone (the skip layer's sum runs over h4, then pe)."""
    hs, h = [], x
    for i in range(1, 8):
        pairs = [(h, w["k5a"]), (x[:, :PE], w["k5b"])] if i == 5 else [(h, w[f"k{i}"])]
        h = torch.relu(_mms(pairs, fast, order) + w[f"b{i}"])
        hs.append(h)
    return hs


def _u_chain(w: dict, m: list, fast: bool = False, order: str = "torch") -> list:
    """u1..u7 of the g-recursion, from the masks m1..m7."""
    u = [None] * 7
    u[6] = m[6] * w["k8"]
    for i in (5, 4, 3, 2, 1, 0):                          # u6..u1; u4 through K5a
        k = w["k5a"] if i == 3 else w[f"k{i + 2}"]
        u[i] = m[i] * _mms([(u[i + 1], k.t())], fast, order)
    return u


def _gpe(w: dict, u: list, fast: bool = False, order: str = "torch") -> torch.Tensor:
    return _mms([(u[0], w["k1"].t()[:, :PE]), (u[4], w["k5b"].t())], fast, order)


def fused_fwd_plain(w: dict, x: torch.Tensor, with_color: bool, fast: bool = False,
                    order: str = "torch"):
    """(sigma (N,), essence (N, 3) | None, gpe (N, 63) | None). fast: every
    operand of every product rounded to bfloat16 (`_mm`); nothing else is
    rounded (biases, masks, u7 = m7 k8). order: the order of every
    per-point sum (`_mms`; "exact" is the fast kernels' oracle)."""
    hs = _hidden(w, x, fast, order)
    sigma = _mms([(hs[6], w["k8"])], fast, order) + w["b8"]
    if not with_color:
        return sigma, None, None
    e1 = torch.relu(_mms([(hs[6], w["k9"])], fast, order) + w["b9"])
    essence = _mms([(e1, w["k10"])], fast, order) + w["b10"]
    return sigma, essence, _gpe(w, _u_chain(w, [h > 0 for h in hs], fast, order), fast, order)


def fused_bwd_plain(w: dict, x, sbar, ebar, gbar, with_color: bool, fast: bool = False,
                    order: str = "torch", operands: dict | None = None):
    """(xbar (N, 87), gpe (N, 63) | None, kernel-layout gradients dict).
    fast: as `fused_fwd_plain`; the sums over the points that are no
    product in the JAX kernel (k8's first-order term, the biases, k8's
    second-order term) stay unrounded. order: the order of every per-point
    sum (the chains, xbar, gpe; `_mms`); the weight gradients' sums over the
    points run in torch's order, or with "exact" in float64, each gradient
    (both of its terms) rounded once. operands: filled with the per-point
    operands that a product rounds, and the activations whose signs are
    the ReLU masks (`order_flips`)."""
    exact = order == "exact"
    if exact:                                             # sums over the points, rounded at the end
        mm = lambda a, b: _mms64([(a, b)], fast)
        red = lambda t: t.double().sum(0)
    else:
        mm = lambda a, b: _mm(a, b, fast)
        red = lambda t: t.sum(0)
    chain = lambda *pairs: _mms(pairs, fast, order)       # per-point sums
    hs = _hidden(w, x, fast, order)
    m = [h > 0 for h in hs]
    g = {}
    g["k8"] = sbar.double() @ hs[6].double() if exact else sbar @ hs[6]
    g["b8"] = red(sbar)[None]
    dh7 = sbar[:, None] * w["k8"]
    e1 = de1 = None
    if with_color:
        z9 = chain((hs[6], w["k9"])) + w["b9"]
        e1 = torch.relu(z9)
        de1 = chain((ebar, w["k10"].t())) * (z9 > 0)
        g["k10"], g["b10"] = mm(e1.t(), ebar), red(ebar)
        g["k9"], g["b9"] = mm(hs[6].t(), de1), red(de1)
        if order == "in_order":  # an FMA epilogue: fmaf(sbar, k8, the sum)
            dh7 = _fma(sbar[:, None], w["k8"], chain((de1, w["k9"].t())))
        elif exact:
            dh7 = (sbar[:, None].double() * w["k8"].double() + _mms64([(de1, w["k9"].t())], fast)).float()
        else:
            dh7 = dh7 + m[6] * mm(de1, w["k9"].t())
    else:
        g["k9"] = torch.zeros_like(w["k9"])
        g["b9"] = torch.zeros_like(w["b9"])
        g["k10"] = torch.zeros_like(w["k10"])
        g["b10"] = torch.zeros_like(w["b10"])
    dzs = [None] * 7
    dzs[6] = m[6] * dh7
    for i in (7, 6, 5, 4, 3, 2):                          # dz6..dz1; dz4 through K5a
        k = w["k5a"] if i == 5 else w[f"k{i}"]
        dzs[i - 2] = m[i - 2] * chain((dzs[i - 1], k.t()))
    for i in range(2, 8):
        g[f"k5a" if i == 5 else f"k{i}"], g[f"b{i}"] = mm(hs[i - 2].t(), dzs[i - 1]), red(dzs[i - 1])
    g["k5b"] = mm(x[:, :PE].t(), dzs[4])
    g["k1"], g["b1"] = mm(x.t(), dzs[0]), red(dzs[0])
    k1t = w["k1"].t()
    xbar = torch.cat([chain((dzs[0], k1t[:, :PE]), (dzs[4], w["k5b"].t())), chain((dzs[0], k1t[:, PE:]))], dim=1)
    if operands is not None:
        operands.update(h=hs, dz=dzs, e1=[e1] if with_color else [], de1=[de1] if with_color else [])
    if not with_color:
        return xbar, None, {k: v.float() for k, v in g.items()} if exact else g

    u = _u_chain(w, m, fast, order)
    gpe = _gpe(w, u, fast, order)
    g["k1"] = g["k1"] + torch.cat([mm(gbar.t(), u[0]), torch.zeros_like(g["k1"][PE:])])
    gbs = [m[0] * chain((gbar, w["k1"][:PE]))]           # gb1..gb7
    for i in range(2, 8):
        g[f"k5a" if i == 5 else f"k{i}"] = g[f"k5a" if i == 5 else f"k{i}"] + mm(gbs[-1].t(), u[i - 1])
        if i == 5:
            g["k5b"] = g["k5b"] + mm(gbar.t(), u[4])
            gbs.append(m[4] * chain((gbs[-1], w["k5a"]), (gbar, w["k5b"])))
        else:
            gbs.append(m[i - 1] * chain((gbs[-1], w[f"k{i}"])))
    g["k8"] = g["k8"] + red(gbs[6])
    if operands is not None:
        operands.update(u=u, gb=gbs[:6])
    return xbar, gpe, {k: v.float() for k, v in g.items()} if exact else g


def order_flips(w: dict, x, sbar, ebar, gbar, with_color: bool) -> torch.Tensor:
    """(N,) the points where the bfloat16-fed plain version in the order
    ``"in_order"`` and in torch's part: an operand of a product that the
    two float32 orders of its sum round to different bfloat16 values, or a
    ReLU mask taken the other way. Everywhere else the two multiply the
    same operands and differ only by the float32 rounding of their sums."""
    ops = [{}, {}]
    for order, got in zip(("torch", "in_order"), ops):
        fused_bwd_plain(w, x, sbar, ebar, gbar, with_color, True, order, got)
    out = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    for key, ts in ops[0].items():
        for a, b in zip(ts, ops[1][key]):
            out |= (bf16_round(a) != bf16_round(b)).any(1) | ((a > 0) != (b > 0)).any(1)
    return out


def beyond_band(pairs, band: float) -> torch.Tensor:
    """(N,) the points where any (got, want) of ``pairs`` (None entries
    skipped) part by more than ``band`` of want's max-abs scale."""
    out = None
    for got, want in pairs:
        if got is None:
            continue
        n = want.shape[0]
        err = (got - want).abs().reshape(n, -1).amax(1)
        far = err > band * (float(want.abs().max()) + 1e-30)
        out = far if out is None else out | far
    return out


def kink_distances(w: dict, x: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """(N, 8) per point and ReLU (h1..h7, then the essence head), the
    smallest |z| / max|z| over the ReLU's pre-activations, each layer's max
    taken over the batch. Where a point's smallest is within rounding of 0,
    two correct float32 orders of the same sums can take that ReLU's mask
    either way, and the mask-dependent outputs (gpe, xbar, the gradients)
    jump there: a check of the kernels against their plain versions leaves
    those points out. The essence head's mask reaches only the with-color
    outputs through the essence cotangent. fast: the pre-activations of the
    bfloat16-fed chain."""
    cols = []
    h = x
    for i in range(1, 8):
        if i == 5:
            z = _mm(h, w["k5a"], fast) + _mm(x[:, :PE], w["k5b"], fast) + w["b5"]
        else:
            z = _mm(h, w[f"k{i}"], fast) + w[f"b{i}"]
        cols.append(z.abs().amin(1) / z.abs().max().clamp_min(1e-30))
        h = torch.relu(z)
    z = _mm(h, w["k9"], fast) + w["b9"]
    cols.append(z.abs().amin(1) / z.abs().max().clamp_min(1e-30))
    return torch.stack(cols, dim=1)


def record_rows(with_color: bool) -> dict:
    """The rows of one tile's record of the fast backward
    (`csrc/fused_mlp_tc.cuh::Rec`): where each operand starts, and ROWS."""
    x, h = 0, 96
    e1 = h + 7 * W
    u = e1 + 128
    dz = u + 7 * W if with_color else e1
    de1 = dz + 7 * W
    gbar = de1 + 128
    gb = gbar + 96
    return {"x": x, "h": h, "e1": e1, "u": u, "dz": dz, "de1": de1, "gbar": gbar, "gb": gb,
            "rows": gb + 6 * W if with_color else dz + 7 * W}


def record_wgrads(rows: torch.Tensor, n: int, with_color: bool) -> dict:
    """The weight gradients that the fast backward's weight-gradient pass
    computes (K1..K7, K5a, K5b and with color K9), as float64 sums over the
    points of the products of the kernel's own bf16 operands (``rows``:
    `fused_bwd(..., records=)`), rounded once to float32: the pass's
    oracle, free of the rounding flips that part the kernel's operands from
    a plain version's."""
    r = record_rows(with_color)
    t = rows.view(-1, r["rows"], TILE)

    def op(row: int, k: int) -> torch.Tensor:
        return t[:, row:row + k, :].permute(0, 2, 1).reshape(-1, k)[:n].double()

    names = {2: "k2", 3: "k3", 4: "k4", 5: "k5a", 6: "k6", 7: "k7"}
    g = {"k1": op(r["x"], IN).t() @ op(r["dz"], W),
         "k5b": op(r["x"], PE).t() @ op(r["dz"] + 4 * W, W)}
    for l, name in names.items():
        g[name] = op(r["h"] + (l - 2) * W, W).t() @ op(r["dz"] + (l - 1) * W, W)
    if with_color:
        g["k1"] = g["k1"] + op(r["gbar"], IN).t() @ op(r["u"], W)
        g["k5b"] = g["k5b"] + op(r["gbar"], PE).t() @ op(r["u"] + 4 * W, W)
        for l, name in names.items():
            g[name] = g[name] + op(r["gb"] + (l - 2) * W, W).t() @ op(r["u"] + (l - 1) * W, W)
        g["k9"] = op(r["h"] + 6 * W, W).t() @ op(r["de1"], 128)
    return {k: v.float() for k, v in g.items()}


def _max_rel(got: dict, want: dict) -> tuple:
    """(worst key, its max |got - want| over want's max-abs scale)."""
    errs = {k: float((got[k].reshape(t.shape) - t).abs().max()) / (float(t.abs().max()) + 1e-30)
            for k, t in want.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def check_fast_kernels(w: dict, x: torch.Tensor, cots: tuple, with_color: bool,
                       alt_blocks: int = 7, fwd_band: float = 1e-5, bwd_band: float = 2e-5,
                       ceiling: float = 0.05) -> dict:
    """The fast kernels on the card against the oracle (``order="exact"``);
    raises AssertionError with the report where they fail. A tensor core's
    order and rounding of a sum have no plain counterpart, so:

    - per point, the outputs (sigma, essence, gpe; xbar, gpe of the
      backward) beyond ``fwd_band`` / ``bwd_band`` of scale from the oracle
      (`beyond_band`: bfloat16 rounding flips and masks at kinks) are
      counted: at most twice the larger count m of the two float32 plain
      orders (torch's and "in_order"), plus three standard deviations of a
      Poisson count of 2m (so that a batch of a hundred points, where m is
      0 or 1, is not judged on one flip), and under ``ceiling`` of the
      points, which a wrong fragment layout (every point moved) fails;
    - with those points' cotangents zeroed, every weight gradient within
      the larger of ``bwd_band`` and twice the plain orders' own error
      against the oracle (a flip that no per-point output shows still
      moves a gradient by ~1e-4 of its scale);
    - the weight-gradient pass within ``bwd_band`` of `record_wgrads` on
      the kernel's own operands;
    - the forward's gpe equal to the backward's, two launches equal, and a
      grid of ``alt_blocks`` blocks: the per-point outputs equal, and the
      weight gradients held as above (the sums over the points run in
      other shares, so their float32 roundings differ: a bias sum over
      352,000 points with cancelling terms moves by ~2e-5 of its largest
      entry, reported as ``alt_grid_grads_max_rel_diff``)."""
    n = x.shape[0]
    wflat, wb = flat_weights(w), fast_weights(w)
    zero = lambda cs, keep: tuple(c * keep.reshape(-1, *([1] * (c.dim() - 1))) if c is not None
                                  else None for c in cs)
    f_ex = fused_fwd_plain(w, x, with_color, True, "exact")
    b_ex = fused_bwd_plain(w, x, *cots, with_color, True, "exact")

    def beyond(f, b):
        return beyond_band(zip(f, f_ex), fwd_band) | beyond_band(zip(b[:2], b_ex[:2]), bwd_band)

    got_f = fused_fwd(w, x, with_color, wflat, True, wb)
    got_b = fused_bwd(w, x, *cots, with_color, wflat, True, wb)
    far = {"kernel": beyond(got_f, got_b)}
    for order in ("torch", "in_order"):
        far[order] = beyond(fused_fwd_plain(w, x, with_color, True, order),
                            fused_bwd_plain(w, x, *cots, with_color, True, order))
    counts = {k: int(v.sum()) for k, v in far.items()}
    m = max(counts["torch"], counts["in_order"])
    allowed = int(2 * m + 3 * (2 * m + 1) ** 0.5)
    v = {"points": n, "with_color": with_color,
         "oracle_beyond_band_points": counts,
         "oracle_beyond_band_share": {k: c / n for k, c in counts.items()},
         "oracle_allowed_points": allowed}
    fail = []
    if counts["kernel"] > allowed or counts["kernel"] >= ceiling * n:
        fail.append("per-point outputs")
    keep = ~far["kernel"]
    for tag, pairs in (("fwd", zip(got_f, f_ex)), ("bwd", zip(got_b[:2], b_ex[:2]))):
        errs = [(float((a - b)[keep].abs().max()), float(b.abs().max()) + 1e-30)
                for a, b in pairs if a is not None and bool(keep.any())]
        v[f"{tag}_max_abs_err"] = max((e for e, _ in errs), default=0.0)
        v[f"{tag}_max_rel_err"] = max((e / sc for e, sc in errs), default=0.0)
    if with_color and not torch.equal(got_f[2], got_b[1]):
        fail.append("the forward's gpe is not the backward's")
    kept = zero(cots, keep)
    gr_ex = fused_bwd_plain(w, x, *kept, with_color, True, "exact")[2]
    v["plain_grads_max_rel_err"] = {
        order: _max_rel(fused_bwd_plain(w, x, *kept, with_color, True, order)[2], gr_ex)[1]
        for order in ("torch", "in_order")}
    v["grads_allowed"] = max(bwd_band, 2 * max(v["plain_grads_max_rel_err"].values()))
    grads = {}
    for tag, blocks in (("", None), ("alt_grid_", alt_blocks)):
        rec = {}
        _, _, gr = fused_bwd(w, x, *kept, with_color, wflat, True, wb, blocks=blocks, records=rec)
        grads[tag] = gr
        v[f"{tag}grads_worst"], v[f"{tag}grads_max_rel_err"] = _max_rel(gr, gr_ex)
        if v[f"{tag}grads_max_rel_err"] > v["grads_allowed"]:
            fail.append(f"{tag}weight gradients")
        _, v[f"{tag}wgrad_pass_max_rel_err"] = _max_rel(gr, record_wgrads(rec["rows"], n, with_color))
        if v[f"{tag}wgrad_pass_max_rel_err"] > bwd_band:
            fail.append(f"{tag}the weight-gradient pass on its own operands")
    _, v["alt_grid_grads_max_rel_diff"] = _max_rel(grads["alt_grid_"], grads[""])
    again_f = fused_fwd(w, x, with_color, wflat, True, wb)
    again_b = fused_bwd(w, x, *cots, with_color, wflat, True, wb)
    same = [torch.equal(a, b) for a, b in zip((*got_f, *got_b[:2]), (*again_f, *again_b[:2]))
            if a is not None] + [torch.equal(got_b[2][k], again_b[2][k]) for k in got_b[2]]
    v["two_launches_equal"] = all(same)
    if not all(same):
        fail.append("two launches")
    alt_f = fused_fwd(w, x, with_color, wflat, True, wb, blocks=alt_blocks)
    alt_b = fused_bwd(w, x, *cots, with_color, wflat, True, wb, blocks=alt_blocks)
    v["alt_blocks"] = alt_blocks
    v["alt_grid_points_equal"] = all(torch.equal(a, b) for a, b in zip(
        (*got_f, *got_b[:2]), (*alt_f, *alt_b[:2])) if a is not None)
    if not v["alt_grid_points_equal"]:
        fail.append(f"the per-point outputs on a grid of {alt_blocks} blocks")
    torch.cuda.synchronize()
    if fail:
        raise AssertionError(f"fast fused kernels against the oracle: {', '.join(fail)}: {v}")
    return v


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != F32:
        raise TypeError(f"fused SpaceNet: {name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"fused SpaceNet: {name} is on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused SpaceNet: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"fused SpaceNet: {name} must be contiguous")


def _check_bf16(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"fused SpaceNet: {name} must be bfloat16, got {t.dtype}")
    if t.device != device or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"fused SpaceNet: {name} must be a contiguous {shape} on {device}, "
                         f"got {tuple(t.shape)} on {t.device}")


def _blocks(kernel: CudaKernel, symbol: str, device: torch.device, with_color: bool) -> int:
    """Resident thread blocks of a persistent kernel on this card (SMs x
    blocks per SM from the occupancy calculator)."""
    fn = kernel.extra_function(symbol, [_I])
    with torch.cuda.device(device):
        n = fn(int(with_color))
    if n <= 0:
        raise RuntimeError(f"{symbol}: occupancy query failed ({n})")
    return n


def _scratch(blocks: int, per_block: int, device) -> torch.Tensor:
    return torch.empty((blocks * per_block,), dtype=F32, device=device)


def _query(kernel: CudaKernel, symbol: str, with_color: bool) -> int:
    return kernel.extra_function(symbol, [_I])(int(with_color))


def fused_fwd(w: dict, x: torch.Tensor, with_color: bool, wflat: torch.Tensor | None = None,
              fast: bool = False, wb: torch.Tensor | None = None, blocks: int | None = None):
    """The forward kernel on CUDA tensors, its plain version on CPU tensors.
    w: `pack`'s dict; x: (N, 87). wflat: `flat_weights(w)` if already built.
    fast: the bfloat16-fed variant; wb: `fast_weights(w)` if already built.
    blocks: the persistent grid's size (default: the blocks resident on the
    card)."""
    if x.device.type == "cpu":
        return fused_fwd_plain(w, x, with_color, fast)
    if x.device.type != "cuda":
        raise ValueError(f"fused SpaceNet: unsupported device {x.device}")
    dev, n = x.device, x.shape[0]
    wflat = flat_weights(w) if wflat is None else wflat
    _check("x", x, (n, IN), dev)
    _check("weights", wflat, (W_FLOATS,), dev)
    sigma = torch.empty((n,), dtype=F32, device=dev)
    essence = torch.empty((n, 3), dtype=F32, device=dev) if with_color else None
    gpe = torch.empty((n, PE), dtype=F32, device=dev) if with_color else None
    if n == 0:
        return sigma, essence, gpe
    kernel = FWD_FAST_KERNEL if fast else FWD_KERNEL
    blocks = _blocks(kernel, f"{kernel.name}_blocks", dev, with_color) if blocks is None else blocks
    if fast:
        wb = fast_weights(w) if wb is None else wb
        _check_bf16("bf16 weights", wb, (WB_ELEMS,), dev)
        per_block = _query(FWD_KERNEL, "fused_mlp_fwd_fast_scratch", with_color)
        scratch = torch.empty((blocks * per_block,), dtype=torch.bfloat16, device=dev)
        args = (x.data_ptr(), wflat.data_ptr(), wb.data_ptr())
    else:
        scratch = _scratch(blocks, _query(FWD_KERNEL, "fused_mlp_fwd_scratch", with_color), dev)
        args = (x.data_ptr(), wflat.data_ptr())
    with torch.cuda.device(dev):
        kernel.launch(
            *args, sigma.data_ptr(),
            essence.data_ptr() if with_color else None, gpe.data_ptr() if with_color else None,
            scratch.data_ptr(), n, int(with_color), blocks, stream_ptr(dev),
        )
    return sigma, essence, gpe


def fused_bwd(w: dict, x, sbar, ebar, gbar, with_color: bool,
              wflat: torch.Tensor | None = None, fast: bool = False,
              wb: torch.Tensor | None = None, blocks: int | None = None,
              records: dict | None = None):
    """The backward kernel on CUDA tensors, its plain version on CPU tensors.
    sbar (N,); ebar (N, 3) and gbar (N, 63) with color, else None. fast: the
    bfloat16-fed variant; wb and blocks as in `fused_fwd`. records (fast):
    given a dict, its "rows" is set to the kernel's per-tile bf16 rows
    (`record_wgrads` reads them)."""
    if x.device.type == "cpu":
        return fused_bwd_plain(w, x, sbar, ebar, gbar, with_color, fast)
    if x.device.type != "cuda":
        raise ValueError(f"fused SpaceNet: unsupported device {x.device}")
    dev, n = x.device, x.shape[0]
    wflat = flat_weights(w) if wflat is None else wflat
    _check("x", x, (n, IN), dev)
    _check("weights", wflat, (W_FLOATS,), dev)
    _check("sbar", sbar, (n,), dev)
    if with_color:
        _check("ebar", ebar, (n, 3), dev)
        _check("gbar", gbar, (n, PE), dev)
    xbar = torch.empty((n, IN), dtype=F32, device=dev)
    gpe = torch.empty((n, PE), dtype=F32, device=dev) if with_color else None
    kernel = BWD_FAST_KERNEL if fast else BWD_KERNEL
    blocks = _blocks(kernel, f"{kernel.name}_blocks", dev, with_color) if blocks is None else blocks
    cots = (sbar.data_ptr(), ebar.data_ptr() if with_color else None,
            gbar.data_ptr() if with_color else None)
    outs = (xbar.data_ptr(), gpe.data_ptr() if with_color else None)
    if fast:
        wb = fast_weights(w) if wb is None else wb
        _check_bf16("bf16 weights", wb, (WB_ELEMS,), dev)
        ntiles = -(-n // TILE)
        # the weight-gradient pass: each gradient tile's sum over the points
        # in `splits` shares, about as many blocks as the chain's grid
        tiles = _query(BWD_KERNEL, "fused_mlp_bwd_fast_gemm_tiles", with_color)
        splits = max(1, min(ntiles, -(-blocks // tiles)))
        # every block sums into its own slice and every split into its own
        # tile; the reduces add them in order, so two runs give the same bits
        small = torch.zeros((blocks * _query(BWD_KERNEL, "fused_mlp_bwd_fast_small", with_color),),
                            dtype=F32, device=dev)
        part = torch.empty((splits * tiles * 128 * 128,), dtype=F32, device=dev)
        rows = torch.empty((ntiles * _query(BWD_KERNEL, "fused_mlp_bwd_fast_record", with_color),),
                           dtype=torch.bfloat16, device=dev)
        grads = torch.zeros((G_FLOATS,), dtype=F32, device=dev)
        if records is not None:
            records["rows"] = rows
        args = (x.data_ptr(), *cots, wflat.data_ptr(), wb.data_ptr(), *outs, small.data_ptr(),
                part.data_ptr(), rows.data_ptr(), grads.data_ptr(), n, int(with_color), blocks,
                splits)
    else:
        # per chunk of records the chain, then the weight-gradient pass into
        # the splits' partial tiles; every block sums into its own slice of
        # `small` and every split into its own tiles, and the reduces add
        # them in order, so two runs give the same bits
        record = _query(BWD_KERNEL, "fused_mlp_bwd_record", with_color)
        tiles = _query(BWD_KERNEL, "fused_mlp_bwd_gemm_tiles", with_color)
        chunk, splits = wgrad_plan(n, blocks, 4 * record, tiles)
        small = torch.zeros((blocks * _query(BWD_KERNEL, "fused_mlp_bwd_small", with_color),),
                            dtype=F32, device=dev)
        part = torch.empty((splits * tiles * 128 * 128,), dtype=F32, device=dev)
        rec = torch.empty((chunk * record,), dtype=F32, device=dev)
        grads = torch.zeros((G_FLOATS,), dtype=F32, device=dev)
        args = (x.data_ptr(), *cots, wflat.data_ptr(), *outs, small.data_ptr(), part.data_ptr(),
                rec.data_ptr(), grads.data_ptr(), n, int(with_color), blocks, chunk, splits)
    with torch.cuda.device(dev):
        kernel.launch(*args, stream_ptr(dev))
    if not fast and n > 0:
        chunks = -(-n // (TILE * chunk))
        WGRAD_PASS.chunks += chunks
        WGRAD_PASS.launches += chunks + 1
    return xbar, gpe, split_grads(grads)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
def _device_weights(w: dict, x: torch.Tensor, fast: bool) -> tuple:
    """The kernels' weight buffers, built once per call on the card: the
    float32 one, and the bfloat16 one for the fast kernels."""
    if x.device.type != "cuda":
        return None, None
    return flat_weights(w), fast_weights(w) if fast else None


def _zeros_if_none(t, shape, like):
    if t is None:
        return torch.zeros(shape, dtype=F32, device=like.device)
    return t.to(F32).contiguous()


class _FusedSpaceNet(torch.autograd.Function):
    """(pe, cp, K1..K10, b1..b10) -> sigma (N,) [, essence (N, 3), normal
    (N, 3)]. The backward is the hand-derived one (first and second order).
    fast: the bfloat16-fed kernels, forward and backward."""

    @staticmethod
    def forward(ctx, with_color: bool, fast: bool, pe, cp, *params):
        w = pack(params)
        x = build_x(pe, cp)
        wflat, wb = _device_weights(w, x, fast)
        sigma, essence, gpe = fused_fwd(w, x, with_color, wflat, fast, wb)
        ctx.with_color, ctx.fast = with_color, fast
        ctx.save_for_backward(pe, cp, *params)
        if not with_color:
            return sigma
        normal = normal_from_gpe(gpe, dp_table(pe.to(F32)))
        return sigma, essence, normal

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cots):
        pe, cp, *params = ctx.saved_tensors
        with_color = ctx.with_color
        w = pack(params)
        x = build_x(pe, cp)
        n = x.shape[0]
        wflat, wb = _device_weights(w, x, fast=ctx.fast)
        sbar = _zeros_if_none(cots[0], (n,), x)
        ebar = gbar = nbar = dp = None
        if with_color:
            ebar = _zeros_if_none(cots[1], (n, 3), x)
            nbar = _zeros_if_none(cots[2], (n, 3), x)
            dp = dp_table(pe.to(F32))
            gbar = gbar_from_nbar(nbar, dp).contiguous()
        xbar, gpe, g = fused_bwd(w, x, sbar, ebar, gbar, with_color, wflat, ctx.fast, wb)
        pe_bar = xbar[:, :PE]
        if with_color:
            pe_bar = pe_bar + pe_extra_from_nbar(gpe, nbar)
        wgrads = unpack_grads(g)
        wgrads = tuple(gr.to(p.dtype).reshape(p.shape) for gr, p in zip(wgrads, params))
        return (None, None, pe_bar.to(pe.dtype), xbar[:, PE:].to(cp.dtype), *wgrads)


def fused_sigma_essence_normal(params, pe: torch.Tensor, cp: torch.Tensor, fast: bool = False):
    """sigma (N,), essence (N, 3), normal_local (N, 3) = d(sigma)/d(pos).

    params: `nerf_params(model.nerf)`; pe: (N, 63) posenc of the canonical
    points; cp: (N, 24) = [frame code * code_scale (8) | pose feature (16)].
    Differentiable in params, pe and cp, the second-order normal terms
    included (the JAX package's `fused_sigma_essence_normal` contract).
    fast: bfloat16 operands in every product, float32 sums (the JAX
    package's ``fast``)."""
    return _FusedSpaceNet.apply(True, bool(fast), pe, cp, *params)


def fused_sigma(params, pe: torch.Tensor, cp: torch.Tensor, fast: bool = False) -> torch.Tensor:
    """Density-only: sigma (N,). Same contract as above."""
    return _FusedSpaceNet.apply(False, bool(fast), pe, cp, *params)
