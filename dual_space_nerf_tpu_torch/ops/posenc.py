"""NeRF positional encoding.

Log-spaced frequencies 2^0..2^(L-1), features ordered
[x, sin(x*f0), cos(x*f0), sin(x*f1), cos(x*f1), ...] as in the JAX
package's `ops/posenc.py`, so weights port layer for layer.
"""

from __future__ import annotations

import torch


def posenc_dim(input_dim: int, n_freqs: int, include_input: bool = True) -> int:
    return input_dim * (int(include_input) + 2 * n_freqs)


def gaussian_fourier_features(x: torch.Tensor, b_matrix: torch.Tensor) -> torch.Tensor:
    """Random Fourier-feature mapping [sin(x B^T), cos(x B^T)], as the JAX
    package's `ops/posenc.py::gaussian_fourier_features` (the reference's
    unused `Gaussian_Kernel`). b_matrix: (dim_embed, dim_in), typically
    N(0, ffm_scale^2); returns (..., 2 * dim_embed)."""
    y = x @ b_matrix.T
    return torch.cat([torch.sin(y), torch.cos(y)], dim=-1)


def posenc(x: torch.Tensor, n_freqs: int, include_input: bool = True) -> torch.Tensor:
    """x: (..., D) -> (..., D * (include_input + 2*n_freqs))."""
    if n_freqs == 0:
        return x if include_input else x[..., :0]
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)  # (L,)
    xb = x[..., None, :] * freqs[:, None]                                 # (..., L, D)
    # interleave per-frequency [sin, cos] to match the reference layout
    sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)              # (..., L, 2, D)
    sc = sc.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])
    if include_input:
        return torch.cat([x, sc], dim=-1)
    return sc
