"""Dual-Space NeRF in PyTorch, with hand-written CUDA kernels for Hopper.

A port of `dual_space_nerf_tpu` (JAX/Pallas), which stays the reference.
This package imports neither JAX nor the JAX package. Its entry points
(`evaluation.ImageRenderer`, `renderer.render_rays`) run on the CUDA card
unless the caller passes `device="cpu"`; each kernel's plain PyTorch version
serves CPU tensors.
"""
