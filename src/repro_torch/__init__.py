"""PyTorch + CUDA port of the Elastic Gossip system (``src/repro``).

The JAX package is the reference; this package reproduces it module by
module with the same names, in PyTorch, and replaces each Pallas TPU kernel
with a kernel written by hand for NVIDIA Hopper (``kernels/csrc``). It never
imports ``jax`` or any ``repro`` module: what it needs from the reference is
copied.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
CPU runs each kernel's plain PyTorch version instead of the kernel.
"""
