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
card it runs the `_fast` entry points of the same two sources, the same
kernels built with the tiled core's FAST flag (`FWD_FAST_KERNEL`,
`BWD_FAST_KERNEL`, each with its own launch count). Their plain versions
with ``in_order=True`` sum in the kernels' order and give their bits;
`order_flips` names the points where torch's order rounds otherwise.

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

Bound on the H100 (FP32, no tensor cores): operations. Per point ~0.43 M
multiply-adds for the density-only forward, ~0.89 M with color, ~1.3 M and
~2.7 M for the backward; the inputs and outputs move 0.3-1 KB per point. The
kernels keep every activation of a tile of points in the block's own scratch
(device memory, never a whole-batch activation) and read the 2.1 MB of
weights from L2. Both run their products on one tiled core,
`csrc/fused_mlp_tiled.cuh` (shared-memory slabs, register micro-tiles), and
share its backbone and g-recursion routines, so the forward's gpe is the
backward's recomputed gpe bit for bit; see the sources' headers.
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


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


W_FLOATS = sum(_numel(s) for _, s in _W_LAYOUT)
G_FLOATS = sum(_numel(s) for _, s in _G_LAYOUT)

_P = ctypes.c_void_p
_I = ctypes.c_int
FWD_KERNEL = CudaKernel(
    "fused_mlp_fwd.cu", "fused_mlp_fwd_launch",
    # x, weights, sigma, essence, gpe, scratch, n, with_color, blocks, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    includes=("fused_mlp.cuh", "fused_mlp_tiled.cuh"),
)
BWD_KERNEL = CudaKernel(
    "fused_mlp_bwd.cu", "fused_mlp_bwd_launch",
    # x, sbar, ebar, gbar, weights, xbar, gpe, partials, grads, scratch, n,
    # with_color, blocks, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    includes=("fused_mlp.cuh", "fused_mlp_tiled.cuh"),
)
# the bfloat16-fed variants: other launchers of the same libraries (their
# scratch, tile and shared memory are the float32 kernels')
FWD_FAST_KERNEL = CudaKernel.entry_of(FWD_KERNEL, "fused_mlp_fwd_fast_launch", "fused_mlp_fwd_fast")
BWD_FAST_KERNEL = CudaKernel.entry_of(BWD_KERNEL, "fused_mlp_bwd_fast_launch", "fused_mlp_bwd_fast")


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


def _mms(pairs, fast: bool, in_order: bool = False) -> torch.Tensor:
    """The per-point sum over (a, b) in ``pairs`` of a @ b: each pair's
    `_mm`, added in turn. in_order (fast only): in the fast kernels' order
    instead, as `layer` of `csrc/fused_mlp_tiled.cuh` runs it: one float32
    sum per output from +0 over the pairs' k in turn, k increasing, one
    rounding a term. A product of two bfloat16 values is exact in float32,
    so these are the kernels' bits (a float32 product rounds: no such order
    exists for the float32 kernels)."""
    if not in_order:
        out = _mm(*pairs[0], fast)
        for a, b in pairs[1:]:
            out = out + _mm(a, b, fast)
        return out
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


def _hidden(w: dict, x: torch.Tensor, fast: bool = False, in_order: bool = False) -> list:
    """h1..h7 of the backbone (the skip layer's sum runs over h4, then pe)."""
    hs, h = [], x
    for i in range(1, 8):
        pairs = [(h, w["k5a"]), (x[:, :PE], w["k5b"])] if i == 5 else [(h, w[f"k{i}"])]
        h = torch.relu(_mms(pairs, fast, in_order) + w[f"b{i}"])
        hs.append(h)
    return hs


def _u_chain(w: dict, m: list, fast: bool = False, in_order: bool = False) -> list:
    """u1..u7 of the g-recursion, from the masks m1..m7."""
    u = [None] * 7
    u[6] = m[6] * w["k8"]
    for i in (5, 4, 3, 2, 1, 0):                          # u6..u1; u4 through K5a
        k = w["k5a"] if i == 3 else w[f"k{i + 2}"]
        u[i] = m[i] * _mms([(u[i + 1], k.t())], fast, in_order)
    return u


def _gpe(w: dict, u: list, fast: bool = False, in_order: bool = False) -> torch.Tensor:
    return _mms([(u[0], w["k1"].t()[:, :PE]), (u[4], w["k5b"].t())], fast, in_order)


def fused_fwd_plain(w: dict, x: torch.Tensor, with_color: bool, fast: bool = False,
                    in_order: bool = False):
    """(sigma (N,), essence (N, 3) | None, gpe (N, 63) | None). fast: every
    operand of every product rounded to bfloat16 (`_mm`); nothing else is
    rounded (biases, masks, u7 = m7 k8). in_order (with fast): every
    per-point sum in the fast kernel's order (`_mms`), its bits."""
    hs = _hidden(w, x, fast, in_order)
    sigma = _mms([(hs[6], w["k8"])], fast, in_order) + w["b8"]
    if not with_color:
        return sigma, None, None
    e1 = torch.relu(_mms([(hs[6], w["k9"])], fast, in_order) + w["b9"])
    essence = _mms([(e1, w["k10"])], fast, in_order) + w["b10"]
    return sigma, essence, _gpe(w, _u_chain(w, [h > 0 for h in hs], fast, in_order), fast, in_order)


def fused_bwd_plain(w: dict, x, sbar, ebar, gbar, with_color: bool, fast: bool = False,
                    in_order: bool = False, operands: dict | None = None):
    """(xbar (N, 87), gpe (N, 63) | None, kernel-layout gradients dict).
    fast: as `fused_fwd_plain`; the sums over the points that are no
    product in the JAX kernel (k8's first-order term, the biases, k8's
    second-order term) stay unrounded. in_order (with fast): every
    per-point sum (the chains, xbar, gpe) in the fast kernel's order, its
    bits; the weight gradients' sums over the points in torch's. operands:
    filled with the per-point operands that a product rounds, and the
    activations whose signs are the ReLU masks (`order_flips`)."""
    mm = lambda a, b: _mm(a, b, fast)                     # sums over the points
    chain = lambda *pairs: _mms(pairs, fast, in_order)    # per-point sums
    hs = _hidden(w, x, fast, in_order)
    m = [h > 0 for h in hs]
    g = {}
    g["k8"] = sbar @ hs[6]
    g["b8"] = sbar.sum()[None]
    dh7 = sbar[:, None] * w["k8"]
    e1 = de1 = None
    if with_color:
        z9 = chain((hs[6], w["k9"])) + w["b9"]
        e1 = torch.relu(z9)
        de1 = chain((ebar, w["k10"].t())) * (z9 > 0)
        g["k10"], g["b10"] = mm(e1.t(), ebar), ebar.sum(0)
        g["k9"], g["b9"] = mm(hs[6].t(), de1), de1.sum(0)
        if in_order:  # the kernel's epilogue: fmaf(sbar, k8, the sum)
            dh7 = _fma(sbar[:, None], w["k8"], chain((de1, w["k9"].t())))
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
        g[f"k5a" if i == 5 else f"k{i}"], g[f"b{i}"] = mm(hs[i - 2].t(), dzs[i - 1]), dzs[i - 1].sum(0)
    g["k5b"] = mm(x[:, :PE].t(), dzs[4])
    g["k1"], g["b1"] = mm(x.t(), dzs[0]), dzs[0].sum(0)
    k1t = w["k1"].t()
    xbar = torch.cat([chain((dzs[0], k1t[:, :PE]), (dzs[4], w["k5b"].t())), chain((dzs[0], k1t[:, PE:]))], dim=1)
    if operands is not None:
        operands.update(h=hs, dz=dzs, e1=[e1] if with_color else [], de1=[de1] if with_color else [])
    if not with_color:
        return xbar, None, g

    u = _u_chain(w, m, fast, in_order)
    gpe = _gpe(w, u, fast, in_order)
    g["k1"] = g["k1"] + torch.cat([mm(gbar.t(), u[0]), torch.zeros_like(g["k1"][PE:])])
    gbs = [m[0] * chain((gbar, w["k1"][:PE]))]           # gb1..gb7
    for i in range(2, 8):
        g[f"k5a" if i == 5 else f"k{i}"] = g[f"k5a" if i == 5 else f"k{i}"] + mm(gbs[-1].t(), u[i - 1])
        if i == 5:
            g["k5b"] = g["k5b"] + mm(gbar.t(), u[4])
            gbs.append(m[4] * chain((gbs[-1], w["k5a"]), (gbar, w["k5b"])))
        else:
            gbs.append(m[i - 1] * chain((gbs[-1], w[f"k{i}"])))
    g["k8"] = g["k8"] + gbs[6].sum(0)
    if operands is not None:
        operands.update(u=u, gb=gbs[:6])
    return xbar, gpe, g


def order_flips(w: dict, x, sbar, ebar, gbar, with_color: bool) -> torch.Tensor:
    """(N,) the points where the bfloat16-fed plain version in the fast
    kernels' order (`in_order`) and in torch's part: an operand of a
    product that the two float32 orders of its sum round to different
    bfloat16 values, or a ReLU mask taken the other way. Everywhere else
    the two multiply the same operands and differ only by the float32
    rounding of their sums."""
    ops = [{}, {}]
    for in_order, got in zip((False, True), ops):
        fused_bwd_plain(w, x, sbar, ebar, gbar, with_color, True, in_order, got)
    out = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    for key, ts in ops[0].items():
        for a, b in zip(ts, ops[1][key]):
            out |= (bf16_round(a) != bf16_round(b)).any(1) | ((a > 0) != (b > 0)).any(1)
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


def bf16_tie_ulps(w: dict, x: torch.Tensor) -> torch.Tensor:
    """(N,) per point, the least distance, in float32 ulps, of a rounded
    operand of the bfloat16-fed forward (x and h1..h7) from a bfloat16
    rounding tie (the float32 values halfway between two bfloat16 ones).
    Where it is small, two float32 orders of the same sums can round the
    operand to neighbouring bfloat16 values: the fast kernel and its plain
    version then part at that point by one bfloat16 ulp of one operand,
    far more than the float32 rounding of their sums."""
    out = None
    for t in [x] + _hidden(w, x, fast=True):
        low = (t.contiguous().view(torch.int32) & 0xFFFF).to(torch.int64)
        d = (low - 0x8000).abs().amin(1)
        out = d if out is None else torch.minimum(out, d)
    return out


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


def fused_fwd(w: dict, x: torch.Tensor, with_color: bool, wflat: torch.Tensor | None = None,
              fast: bool = False):
    """The forward kernel on CUDA tensors, its plain version on CPU tensors.
    w: `pack`'s dict; x: (N, 87). wflat: `flat_weights(w)` if already built.
    fast: the bfloat16-fed variant."""
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
    blocks = _blocks(kernel, f"{kernel.name}_blocks", dev, with_color)
    per_block = FWD_KERNEL.extra_function("fused_mlp_fwd_scratch", [_I])(int(with_color))
    scratch = _scratch(blocks, per_block, dev)
    with torch.cuda.device(dev):
        kernel.launch(
            x.data_ptr(), wflat.data_ptr(), sigma.data_ptr(),
            essence.data_ptr() if with_color else None, gpe.data_ptr() if with_color else None,
            scratch.data_ptr(), n, int(with_color), blocks, stream_ptr(dev),
        )
    return sigma, essence, gpe


def fused_bwd(w: dict, x, sbar, ebar, gbar, with_color: bool,
              wflat: torch.Tensor | None = None, fast: bool = False):
    """The backward kernel on CUDA tensors, its plain version on CPU tensors.
    sbar (N,); ebar (N, 3) and gbar (N, 63) with color, else None. fast: the
    bfloat16-fed variant."""
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
    grads = torch.empty((G_FLOATS,), dtype=F32, device=dev)
    kernel = BWD_FAST_KERNEL if fast else BWD_KERNEL
    blocks = _blocks(kernel, f"{kernel.name}_blocks", dev, with_color)
    per_block = BWD_KERNEL.extra_function("fused_mlp_bwd_scratch", [_I])(int(with_color))
    # every block accumulates into its own slice; a second kernel sums the
    # slices in block order, so two runs give the same bits
    partials = torch.zeros((blocks * G_FLOATS,), dtype=F32, device=dev)
    scratch = _scratch(blocks, per_block, dev)
    with torch.cuda.device(dev):
        kernel.launch(
            x.data_ptr(), sbar.data_ptr(),
            ebar.data_ptr() if with_color else None, gbar.data_ptr() if with_color else None,
            wflat.data_ptr(), xbar.data_ptr(), gpe.data_ptr() if with_color else None,
            partials.data_ptr(), grads.data_ptr(), scratch.data_ptr(), n, int(with_color),
            blocks, stream_ptr(dev),
        )
    return xbar, gpe, split_grads(grads)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
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
        wflat = flat_weights(w) if x.device.type == "cuda" else None
        sigma, essence, gpe = fused_fwd(w, x, with_color, wflat, fast)
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
        wflat = flat_weights(w) if x.device.type == "cuda" else None
        sbar = _zeros_if_none(cots[0], (n,), x)
        ebar = gbar = nbar = dp = None
        if with_color:
            ebar = _zeros_if_none(cots[1], (n, 3), x)
            nbar = _zeros_if_none(cots[2], (n, 3), x)
            dp = dp_table(pe.to(F32))
            gbar = gbar_from_nbar(nbar, dp).contiguous()
        xbar, gpe, g = fused_bwd(w, x, sbar, ebar, gbar, with_color, wflat, ctx.fast)
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
