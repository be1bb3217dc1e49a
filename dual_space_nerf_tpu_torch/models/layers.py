"""Torch-default initialization with an explicit generator.

The reference relies on PyTorch's default `nn.Linear` init, U(+-1/sqrt(fan_in))
for weight and bias, and `nn.Embedding`'s N(0, 1); the JAX package
reproduces it (`models/layers.py`). Here the same draws take an explicit
`torch.Generator`, so a seeded model does not depend on the global RNG. Used
only when no weights are loaded.
"""

from __future__ import annotations

import torch
from torch import nn


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


def mlp(in_dim: int, widths: list[int], activate_final: bool = False) -> nn.Sequential:
    """Plain float32 ReLU MLP as an `nn.Sequential` [Linear, ReLU, Linear,
    ...]: Linear layers sit at the even indices, as in the reference's state
    dicts."""
    layers: list[nn.Module] = []
    for i, w in enumerate(widths):
        layers.append(nn.Linear(in_dim, w, dtype=torch.float32))
        if i < len(widths) - 1 or activate_final:
            layers.append(nn.ReLU())
        in_dim = w
    return nn.Sequential(*layers)
