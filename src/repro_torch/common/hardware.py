"""The card's figures for the roofline (the port's counterpart of
``repro.common.hardware``, which holds a TPU v5e's).

A :class:`ChipSpec` holds what the three roofline terms divide by: the
dense tensor-core peak for 16-bit operands, the f32 peak on the CUDA cores
(the port runs with TF32 off), HBM bandwidth and capacity, the NVLink
bandwidth a GPU has per direction over its links (the counterpart of the
TPU's ICI link), the inter-node bandwidth a GPU gets (the counterpart of
DCN) and shared memory per SM (the counterpart of VMEM). Every figure is
NVIDIA's data sheet's, cited beside it; the dense peaks are half the
sparsity figures the sheets print.

:func:`chip_spec` maps a card name as ``nvidia-smi`` or
``torch.cuda.get_device_name`` prints it to its spec; :data:`H100_SXM` is
the default.
"""
from __future__ import annotations

import dataclasses

import torch

GB = 1e9
TB = 1e12


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float        # FLOP/s, dense tensor cores, bf16 / f16 operands
    peak_f32_flops: float         # FLOP/s, f32 on the CUDA cores (no TF32)
    hbm_bandwidth: float          # bytes/s
    hbm_capacity: float           # bytes
    nvlink_bandwidth: float       # bytes/s a GPU sends over NVLink, one direction
    nvlink_links: int             # NVLink links a GPU has
    internode_bandwidth: float    # bytes/s a GPU sends to another node
    smem_bytes_per_sm: int        # shared memory per SM

    def peak_flops(self, dtype=torch.bfloat16) -> float:
        """The peak for operands of ``dtype``: the tensor cores' for bf16 and
        f16, the CUDA cores' f32 peak for every other dtype."""
        return self.peak_bf16_flops if dtype in (torch.bfloat16, torch.float16) \
            else self.peak_f32_flops


# H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet): FP32 67 TFLOPS,
# BF16 Tensor Core 1,979 TFLOPS with sparsity, GPU memory 80GB at 3.35TB/s,
# NVLink 900GB/s (18 fourth-generation links, half each way), NVIDIA
# ConnectX-7 400Gb/s (50 GB/s) a GPU in the DGX H100 / HGX H100 (DGX H100
# data sheet); 228 KB of shared memory per SM (NVIDIA Hopper tuning guide)
H100_SXM = ChipSpec(
    name="H100 SXM",
    peak_bf16_flops=989 * TB,
    peak_f32_flops=67 * TB,
    hbm_bandwidth=3.35 * TB,
    hbm_capacity=80 * 1024 ** 3,
    nvlink_bandwidth=450 * GB,
    nvlink_links=18,
    internode_bandwidth=50 * GB,
    smem_bytes_per_sm=228 * 1024,
)

# H100 NVL (the same data sheet): FP32 60 TFLOPS, BF16 1,671 TFLOPS with
# sparsity, 94GB at 3.9TB/s, NVLink bridge 600GB/s (12 links)
H100_NVL = dataclasses.replace(
    H100_SXM, name="H100 NVL", peak_bf16_flops=835 * TB, peak_f32_flops=60 * TB,
    hbm_bandwidth=3.9 * TB, hbm_capacity=94 * 1024 ** 3, nvlink_bandwidth=300 * GB,
    nvlink_links=12)

# H100 PCIe (the same data sheet): FP32 51 TFLOPS, BF16 1,513 TFLOPS with
# sparsity, 80GB at 2.0TB/s, NVLink bridge 600GB/s (12 links)
H100_PCIE = dataclasses.replace(
    H100_SXM, name="H100 PCIe", peak_bf16_flops=756 * TB, peak_f32_flops=51 * TB,
    hbm_bandwidth=2.0 * TB, nvlink_bandwidth=300 * GB, nvlink_links=12)

# H200 SXM (NVIDIA H200 Tensor Core GPU data sheet): FP32 67 TFLOPS, BF16
# 1,979 TFLOPS with sparsity, 141GB at 4.8TB/s, NVLink 900GB/s
H200 = dataclasses.replace(H100_SXM, name="H200", hbm_bandwidth=4.8 * TB,
                           hbm_capacity=141 * 1024 ** 3)

# by a substring of the card's name, the more specific names first
CARDS = (("H200", H200), ("H100 NVL", H100_NVL), ("H100 PCIe", H100_PCIE),
         ("H100", H100_SXM))


def chip_spec(name: str = "") -> ChipSpec:
    """The spec of the card named ``name`` (e.g. "NVIDIA H100 80GB HBM3");
    :data:`H100_SXM` when ``name`` is empty. Raises ValueError for a card
    it has no figures for."""
    if not name:
        return H100_SXM
    for key, spec in CARDS:
        if key in name:
            return spec
    raise ValueError(f"no memory / compute figures known for {name!r}; known: "
                     + ", ".join(k for k, _ in CARDS))


def compute_time_s(flops: float, chips: int, spec: ChipSpec = H100_SXM,
                   dtype=torch.bfloat16) -> float:
    return flops / (chips * spec.peak_flops(dtype))


def memory_time_s(bytes_: float, chips: int, spec: ChipSpec = H100_SXM) -> float:
    return bytes_ / (chips * spec.hbm_bandwidth)


def collective_time_s(bytes_: float, chips: int, spec: ChipSpec = H100_SXM) -> float:
    # bytes_ is what the program's collectives send; a GPU moves its share
    # over its NVLink
    return bytes_ / (chips * spec.nvlink_bandwidth)
