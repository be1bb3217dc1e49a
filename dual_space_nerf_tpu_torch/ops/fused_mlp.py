"""Fused SpaceNet chain: the CUDA kernels' wrappers, their plain versions
and the autograd functions around them.

Replaces the TPU kernels `dual_space_nerf_tpu/ops/fused_mlp.py:_fwd_kernel`
(forward: sigma, essence and gpe = d(sigma)/d(pe), the "g-recursion") and
`:_bwd_kernel` (recompute, first-order backprop of the sigma and essence
cotangents, second-order vjp of the g-recursion, weight-gradient
accumulation). The kernels are `csrc/fused_mlp_fwd.cu` and
`csrc/fused_mlp_bwd.cu`; their plain PyTorch versions are `fused_fwd_plain`
and `fused_bwd_plain`, the same algebra as torch matmuls.

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
def _hidden(w: dict, x: torch.Tensor) -> list:
    """h1..h7 of the backbone."""
    hs, h = [], x
    for i in (1, 2, 3, 4):
        h = torch.relu(h @ w[f"k{i}"] + w[f"b{i}"])
        hs.append(h)
    h = torch.relu(h @ w["k5a"] + x[:, :PE] @ w["k5b"] + w["b5"])
    hs.append(h)
    for i in (6, 7):
        h = torch.relu(h @ w[f"k{i}"] + w[f"b{i}"])
        hs.append(h)
    return hs


def _u_chain(w: dict, m: list) -> list:
    """u1..u7 of the g-recursion, from the masks m1..m7."""
    u = [None] * 7
    u[6] = m[6] * w["k8"]
    u[5] = m[5] * (u[6] @ w["k7"].t())
    u[4] = m[4] * (u[5] @ w["k6"].t())
    u[3] = m[3] * (u[4] @ w["k5a"].t())
    for i in (2, 1, 0):                                   # u3, u2, u1
        u[i] = m[i] * (u[i + 1] @ w[f"k{i + 2}"].t())
    return u


def _gpe(w: dict, u: list) -> torch.Tensor:
    return (u[0] @ w["k1"].t())[:, :PE] + u[4] @ w["k5b"].t()


def fused_fwd_plain(w: dict, x: torch.Tensor, with_color: bool):
    """(sigma (N,), essence (N, 3) | None, gpe (N, 63) | None)."""
    hs = _hidden(w, x)
    sigma = hs[6] @ w["k8"] + w["b8"]
    if not with_color:
        return sigma, None, None
    e1 = torch.relu(hs[6] @ w["k9"] + w["b9"])
    essence = e1 @ w["k10"] + w["b10"]
    return sigma, essence, _gpe(w, _u_chain(w, [h > 0 for h in hs]))


def fused_bwd_plain(w: dict, x, sbar, ebar, gbar, with_color: bool):
    """(xbar (N, 87), gpe (N, 63) | None, kernel-layout gradients dict)."""
    hs = _hidden(w, x)
    m = [h > 0 for h in hs]
    g = {}
    g["k8"] = sbar @ hs[6]
    g["b8"] = sbar.sum()[None]
    dh7 = sbar[:, None] * w["k8"]
    if with_color:
        z9 = hs[6] @ w["k9"] + w["b9"]
        e1 = torch.relu(z9)
        de1 = (ebar @ w["k10"].t()) * (z9 > 0)
        g["k10"], g["b10"] = e1.t() @ ebar, ebar.sum(0)
        g["k9"], g["b9"] = hs[6].t() @ de1, de1.sum(0)
        dh7 = dh7 + m[6] * (de1 @ w["k9"].t())
    else:
        g["k9"] = torch.zeros_like(w["k9"])
        g["b9"] = torch.zeros_like(w["b9"])
        g["k10"] = torch.zeros_like(w["k10"])
        g["b10"] = torch.zeros_like(w["b10"])
    dz = m[6] * dh7
    for i in (7, 6):
        g[f"k{i}"], g[f"b{i}"] = hs[i - 2].t() @ dz, dz.sum(0)
        dz = m[i - 2] * (dz @ w[f"k{i}"].t())
    g["k5a"], g["k5b"], g["b5"] = hs[3].t() @ dz, x[:, :PE].t() @ dz, dz.sum(0)
    ds_b = dz @ w["k5b"].t()
    dz = m[3] * (dz @ w["k5a"].t())
    for i in (4, 3, 2):
        g[f"k{i}"], g[f"b{i}"] = hs[i - 2].t() @ dz, dz.sum(0)
        dz = m[i - 2] * (dz @ w[f"k{i}"].t())
    g["k1"], g["b1"] = x.t() @ dz, dz.sum(0)
    xbar = dz @ w["k1"].t()
    xbar = torch.cat([xbar[:, :PE] + ds_b, xbar[:, PE:]], dim=1)
    if not with_color:
        return xbar, None, g

    u = _u_chain(w, m)
    gpe = _gpe(w, u)
    g["k1"] = g["k1"] + torch.cat([gbar.t() @ u[0], torch.zeros_like(g["k1"][PE:])])
    gb = m[0] * (gbar @ w["k1"][:PE])
    for i in (2, 3, 4):
        g[f"k{i}"] = g[f"k{i}"] + gb.t() @ u[i - 1]
        gb = m[i - 1] * (gb @ w[f"k{i}"])
    g["k5a"] = g["k5a"] + gb.t() @ u[4]
    g["k5b"] = g["k5b"] + gbar.t() @ u[4]
    gb = m[4] * (gb @ w["k5a"] + gbar @ w["k5b"])
    for i in (6, 7):
        g[f"k{i}"] = g[f"k{i}"] + gb.t() @ u[i - 1]
        gb = m[i - 1] * (gb @ w[f"k{i}"])
    g["k8"] = g["k8"] + gb.sum(0)
    return xbar, gpe, g


def kink_distances(w: dict, x: torch.Tensor) -> torch.Tensor:
    """(N, 8) per point and ReLU (h1..h7, then the essence head), the
    smallest |z| / max|z| over the ReLU's pre-activations, each layer's max
    taken over the batch. Where a point's smallest is within rounding of 0,
    two correct float32 orders of the same sums can take that ReLU's mask
    either way, and the mask-dependent outputs (gpe, xbar, the gradients)
    jump there: a check of the kernels against their plain versions leaves
    those points out. The essence head's mask reaches only the with-color
    outputs through the essence cotangent."""
    cols = []
    h = x
    for i in range(1, 8):
        if i == 5:
            z = h @ w["k5a"] + x[:, :PE] @ w["k5b"] + w["b5"]
        else:
            z = h @ w[f"k{i}"] + w[f"b{i}"]
        cols.append(z.abs().amin(1) / z.abs().max().clamp_min(1e-30))
        h = torch.relu(z)
    z = h @ w["k9"] + w["b9"]
    cols.append(z.abs().amin(1) / z.abs().max().clamp_min(1e-30))
    return torch.stack(cols, dim=1)


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


def fused_fwd(w: dict, x: torch.Tensor, with_color: bool, wflat: torch.Tensor | None = None):
    """The forward kernel on CUDA tensors, its plain version on CPU tensors.
    w: `pack`'s dict; x: (N, 87). wflat: `flat_weights(w)` if already built."""
    if x.device.type == "cpu":
        return fused_fwd_plain(w, x, with_color)
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
    blocks = _blocks(FWD_KERNEL, "fused_mlp_fwd_blocks", dev, with_color)
    per_block = FWD_KERNEL.extra_function("fused_mlp_fwd_scratch", [_I])(int(with_color))
    scratch = _scratch(blocks, per_block, dev)
    with torch.cuda.device(dev):
        FWD_KERNEL.launch(
            x.data_ptr(), wflat.data_ptr(), sigma.data_ptr(),
            essence.data_ptr() if with_color else None, gpe.data_ptr() if with_color else None,
            scratch.data_ptr(), n, int(with_color), blocks, stream_ptr(dev),
        )
    return sigma, essence, gpe


def fused_bwd(w: dict, x, sbar, ebar, gbar, with_color: bool,
              wflat: torch.Tensor | None = None):
    """The backward kernel on CUDA tensors, its plain version on CPU tensors.
    sbar (N,); ebar (N, 3) and gbar (N, 63) with color, else None."""
    if x.device.type == "cpu":
        return fused_bwd_plain(w, x, sbar, ebar, gbar, with_color)
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
    blocks = _blocks(BWD_KERNEL, "fused_mlp_bwd_blocks", dev, with_color)
    per_block = BWD_KERNEL.extra_function("fused_mlp_bwd_scratch", [_I])(int(with_color))
    # every block accumulates into its own slice; a second kernel sums the
    # slices in block order, so two runs give the same bits
    partials = torch.zeros((blocks * G_FLOATS,), dtype=F32, device=dev)
    scratch = _scratch(blocks, per_block, dev)
    with torch.cuda.device(dev):
        BWD_KERNEL.launch(
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
    (N, 3)]. The backward is the hand-derived one (first and second order)."""

    @staticmethod
    def forward(ctx, with_color: bool, pe, cp, *params):
        w = pack(params)
        x = build_x(pe, cp)
        wflat = flat_weights(w) if x.device.type == "cuda" else None
        sigma, essence, gpe = fused_fwd(w, x, with_color, wflat)
        ctx.with_color = with_color
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
        xbar, gpe, g = fused_bwd(w, x, sbar, ebar, gbar, with_color, wflat)
        pe_bar = xbar[:, :PE]
        if with_color:
            pe_bar = pe_bar + pe_extra_from_nbar(gpe, nbar)
        wgrads = unpack_grads(g)
        wgrads = tuple(gr.to(p.dtype).reshape(p.shape) for gr, p in zip(wgrads, params))
        return (None, pe_bar.to(pe.dtype), xbar[:, PE:].to(cp.dtype), *wgrads)


def fused_sigma_essence_normal(params, pe: torch.Tensor, cp: torch.Tensor):
    """sigma (N,), essence (N, 3), normal_local (N, 3) = d(sigma)/d(pos).

    params: `nerf_params(model.nerf)`; pe: (N, 63) posenc of the canonical
    points; cp: (N, 24) = [frame code * code_scale (8) | pose feature (16)].
    Differentiable in params, pe and cp, the second-order normal terms
    included (the JAX package's `fused_sigma_essence_normal` contract)."""
    return _FusedSpaceNet.apply(True, pe, cp, *params)


def fused_sigma(params, pe: torch.Tensor, cp: torch.Tensor) -> torch.Tensor:
    """Density-only: sigma (N,). Same contract as above."""
    return _FusedSpaceNet.apply(False, pe, cp, *params)
