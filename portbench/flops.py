"""Model FLOPs and bytes of the networks, from the published widths.

Counted per point and pass, as multiply-adds of the products the
architecture needs (an FMA is two FLOPs), whatever implements them:

- density pass (the gated path's pass over every sample): SpaceNet's
  backbone and density head;
- colour pass: the backbone and density head again, the essence head, the
  density normal (the backbone's input gradient, taken through the
  positional encoding only: the frame code and pose feature are constants
  of a point) and the lighting MLP.

With the fine pass (``FINE_RAY_SAMPLING`` > 0) a ray is rendered twice:
the coarse pass over its S samples and the fine pass over S + n_fine,
each gated or fully shaded as the configuration says (`render_points`).

A training step adds the backward of each pass, twice its forward less the
input gradients that no parameter needs (the encoding's parts of the two
stage inputs, and the lighting input's point and view parts).
Recomputation, padding rays and the once-per-chunk pose MLP are not
counted, so a roofline or utilisation share read against these counts is
never above what the program could reach.

Bytes: the passes' per-point inputs and outputs (encoding, code and pose
in; density, essence and normal out) and the weights, each once a render
pass: the least any implementation moves.
"""

from __future__ import annotations

PE, CP, W, E_HID, LIGHT = 63, 24, 256, 128, 128
WEIGHT_FLOATS = 500_021   # every parameter of the model, the 500 x 8 frame codes included


def density_macs() -> int:
    """Backbone (87 -> 256, 3 x 256 -> 256, 319 -> 256, 2 x 256 -> 256) and
    the density head (256 -> 1)."""
    return (PE + CP) * W + 3 * W * W + (W + PE) * W + 2 * W * W + W


def essence_macs() -> int:
    return W * E_HID + E_HID * 3


def normal_macs() -> int:
    """d(density)/d(point): the density head's and every backbone layer's
    input gradient, the stage inputs' through the encoding only."""
    return W + 2 * W * W + (W + PE) * W + 3 * W * W + PE * W


def lighting_macs() -> int:
    return 9 * LIGHT + LIGHT * LIGHT + LIGHT


def color_macs() -> int:
    return density_macs() + essence_macs() + normal_macs() + lighting_macs()


def _unneeded_input_grads(color: bool) -> int:
    return 2 * PE * W + (6 * LIGHT if color else 0)


def pass_flops(n_density: int, n_color: int, train: bool) -> float:
    """FLOPs of a density pass over ``n_density`` points and a colour pass
    over ``n_color``; with ``train`` their backward too."""
    d, c = density_macs(), color_macs()
    if train:
        d = 3 * d - _unneeded_input_grads(False)
        c = 3 * c - _unneeded_input_grads(True)
    return 2.0 * (n_density * d + n_color * c)


def pass_bytes(n_density: int, n_color: int, train: bool) -> float:
    """Bytes of the same passes: per point its inputs and outputs once (in
    training also the output gradients in and the input gradients out of
    the code and pose), and the weights (and their gradients) once."""
    per_d = PE + CP + 1
    per_c = PE + CP + 1 + 3 + 3 + 9 + 3
    if train:
        per_d, per_c = per_d + 1 + CP, per_c + 1 + 3 + 3 + CP
    floats = n_density * per_d + n_color * per_c + WEIGHT_FLOATS * (2 if train else 1)
    return 4.0 * floats


def points(n_rays: int, n_samples: int, shade_topk: int) -> tuple[int, int]:
    """(density-pass points, colour-pass points) of ``n_rays`` rays: the
    gated path takes the density of every sample and colours the top
    ``shade_topk``; full shading colours every sample."""
    if 0 < shade_topk < n_samples:
        return n_rays * n_samples, n_rays * shade_topk
    return 0, n_rays * n_samples


def render_points(n_rays: int, n_samples: int, n_fine: int, shade_topk: int) -> list:
    """`points` of each render pass over ``n_rays`` rays: the coarse pass
    over ``n_samples`` samples a ray and, with ``n_fine`` > 0, the fine
    pass over ``n_samples + n_fine``."""
    out = [points(n_rays, n_samples, shade_topk)]
    if n_fine > 0:
        out.append(points(n_rays, n_samples + n_fine, shade_topk))
    return out


def render_counts(n_rays: int, n_samples: int, n_fine: int, shade_topk: int,
                  train: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of rendering ``n_rays`` rays, every pass of
    `render_points`; with ``train`` the backward too."""
    passes = render_points(n_rays, n_samples, n_fine, shade_topk)
    return (sum(pass_flops(*p, train=train) for p in passes),
            sum(pass_bytes(*p, train=train) for p in passes))


def bound_s(flops: float, n_bytes: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, n_bytes / peak_bytes)
