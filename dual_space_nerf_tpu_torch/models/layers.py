"""Torch-default initialization with an explicit generator, and the Linear
layer with an optional compute dtype.

The reference relies on PyTorch's default `nn.Linear` init, U(+-1/sqrt(fan_in))
for weight and bias, and `nn.Embedding`'s N(0, 1); the JAX package
reproduces it (`models/layers.py`). Here the same draws take an explicit
`torch.Generator`, so a seeded model does not depend on the global RNG. Used
only when no weights are loaded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    """`nn.Linear` with float32 parameters ("master weights") and an
    optional compute dtype, as the JAX package's `Dense` (flax's
    `nn.Dense(dtype=..., param_dtype=float32)`). With ``compute_dtype``
    (torch.bfloat16) the input, the weight and the bias are cast to it, and
    the product is rounded to it before the bias is added and the sum is
    rounded again: flax's `dot_general` then `y + bias`, two roundings. One
    bfloat16 `addmm` (`F.linear` with the bias) rounds once and is another
    function: on 4096 x 256 seeded rows it differs from the two roundings
    in 30% of the outputs (`tests/test_torch_port_fast.py`). Without a
    compute dtype, `nn.Linear` as it is. The parameter names do not change."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype | None = None):
        super().__init__(in_features, out_features, dtype=torch.float32)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every Linear and Embedding below ``module`` in place."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / float(m.in_features) ** 0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)


def mlp(in_dim: int, widths: list[int], activate_final: bool = False,
        compute_dtype: torch.dtype | None = None) -> nn.Sequential:
    """Plain ReLU MLP as an `nn.Sequential` [Linear, ReLU, Linear, ...]:
    Linear layers sit at the even indices, as in the reference's state
    dicts. Float32 parameters; ``compute_dtype`` as `Linear`'s."""
    layers: list[nn.Module] = []
    for i, w in enumerate(widths):
        layers.append(Linear(in_dim, w, compute_dtype))
        if i < len(widths) - 1 or activate_final:
            layers.append(nn.ReLU())
        in_dim = w
    return nn.Sequential(*layers)
