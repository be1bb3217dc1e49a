"""Device choice for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Asking for CUDA (explicitly or by default) on a machine without
    a usable card raises; nothing falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        if dev.index is None:  # tensors report "cuda:N", never bare "cuda"
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextlib.contextmanager
def true_fp32():
    """Float32 matmuls and convolutions in IEEE float32 inside the block,
    whatever the process-wide TF32 flags say (cuDNN convolutions default to
    TF32 on the card); the flags are restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
