"""Costs and peaks, frozen.

- :func:`b1_cost`: copied from ``src/repro_torch/analysis/roofline.py`` at
  commit 0f5df9a. Kernel B1 (the fused elastic NAG update) on W rows of n
  f32: 9 operations an element; theta, peer and g read and theta written,
  v read and written, the [W, 3] f32 scalars read: 24 bytes an element.
- The NVIDIA H100 SXM peaks: copied from
  ``src/repro_torch/common/hardware.py::H100_SXM`` at commit 0f5df9a (NVIDIA
  H100 Tensor Core GPU data sheet): f32 67 TFLOP/s outside the tensor
  cores, HBM3 3.35 TB/s.
"""
from __future__ import annotations

from typing import Tuple

TB = 1e12
PEAK_F32_FLOPS = 67 * TB
HBM_BYTES_PER_S = 3.35 * TB


def b1_cost(W: int, n: int, t_size: int = 4, v_size: int = 4) -> Tuple[int, int]:
    """(operations, bytes) of B1 on W rows of n."""
    return 9 * W * n, W * n * (4 * t_size + 2 * v_size) + W * 12
