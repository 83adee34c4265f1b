"""Three-term roofline over the card's spec (port of
``repro.analysis.roofline``), and the cost of every kernel of the port.

    compute    = counted FLOPs            / (peak FLOP/s at the program's dtype)
    memory     = counted bytes            / HBM bandwidth
    collective = counted collective bytes / NVLink bandwidth

The counts come from :mod:`repro_torch.analysis.opcount`, which runs one
device's program on the ``meta`` device, so they are per device already;
``chips`` scales only the model-FLOPs comparison, a global count, as in
the reference.

The kernel cost functions (:func:`b1_cost` ... :func:`b9_cost`) give
``(flops, bytes)`` of one launch at any shape: the bytes each input is
read and each output written once, the operations the function does on
these inputs. They are the one source of the bound column of the port's
kernel table: ``chip_smoke.py`` and the counter's ``meta`` branch of
:mod:`repro_torch.kernels.ops` both call them, and :func:`bound_ms` turns
a cost into the least time the card could take.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import InputShape, ModelConfig
from repro_torch.common.hardware import H100_SXM, ChipSpec


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    program: str
    chips: int
    # per-device quantities (counted on one device's program)
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_breakdown: Dict[str, float]
    model_flops: float          # 6*N(_active)*D, global
    peak_memory_bytes: Optional[float] = None
    spec: ChipSpec = H100_SXM
    dtype: torch.dtype = torch.bfloat16     # the program's compute dtype

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.spec.peak_flops(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.spec.hbm_bandwidth

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / self.spec.nvlink_bandwidth

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / total counted FLOPs: catches redundant work."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """model FLOPs / (chips x peak x step-time lower bound)."""
        denom = self.chips * self.spec.peak_flops(self.dtype) * self.step_time_lower_bound
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "program": self.program,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_upper_bound": self.mfu_upper_bound,
            "peak_memory_bytes": self.peak_memory_bytes,
        }


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D for training; 2*N*D_tokens for inference (per program invocation)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch * 1   # decode: one token per request


def analyze_program(arch: str, shape: InputShape, program: str, costs,
                    cfg: ModelConfig, chips: int, peak_memory: Optional[float] = None,
                    spec: ChipSpec = H100_SXM, dtype=torch.bfloat16) -> Roofline:
    """The roofline of one counted program (``costs``: an
    :class:`~repro_torch.analysis.opcount.Costs`)."""
    return Roofline(
        arch=arch, shape=shape.name, program=program, chips=chips,
        flops_per_chip=costs.flops, bytes_per_chip=costs.bytes_accessed,
        collective_bytes_per_chip=costs.collective_bytes,
        collective_breakdown=dict(costs.collective_breakdown),
        model_flops=model_flops(cfg, shape), peak_memory_bytes=peak_memory,
        spec=spec, dtype=dtype)


# ---------------------------------------------------------------------------
# kernel costs: (flops, bytes) of one launch
# ---------------------------------------------------------------------------

def bound_ms(flops: float, nbytes: float, flop_rate: float, bandwidth: float
             ) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the compute rate."""
    bytes_ms = nbytes / bandwidth * 1e3
    ops_ms = flops / flop_rate * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def b1_cost(W: int, n: int, t_size: int = 4, v_size: int = 4) -> Tuple[int, int]:
    """B1 on W rows of n: 9 operations an element (4 multiplies, 5 adds);
    theta, peer and g read and theta written in theta's dtype, v read and
    written in its own, the [W, 3] f32 scalars read."""
    return 9 * W * n, W * n * (4 * t_size + 2 * v_size) + W * 12


def b2_cost(W: int, n: int, t_size: int = 4, v_size: int = 4) -> Tuple[int, int]:
    """B2 (B1 without the peer): 6 operations an element; theta and g read
    and theta written, v read and written, the [W, 2] scalars read."""
    return 6 * W * n, W * n * (3 * t_size + 2 * v_size) + W * 8


def b3_cost(numel: int, t_size: int = 4, v_size: int = 4) -> Tuple[int, int]:
    """B3 on one array: B1's operations; theta, peer, g and v read, new
    theta' and v' written."""
    return 9 * numel, numel * (4 * t_size + 2 * v_size)


def q8_encode_cost(W: int, n: int, block: int) -> Tuple[int, int]:
    """B4: ~20 operations a padded element (hash, abs / max, divide, add,
    floor, clamp, convert); x read, the [W] seeds read, int8 values and f32
    block scales written."""
    nb = -(-n // block)
    npad = W * nb * block
    return 20 * npad, W * n * 4 + W * 8 + npad + W * nb * 4


def q8_decode_cost(W: int, n: int, block: int) -> Tuple[int, int]:
    """B5: 2 operations an element; int8 values and scales read, f32 out."""
    nb = -(-n // block)
    return 2 * W * n, W * nb * block + W * nb * 4 + W * n * 4


def topk_encode_cost(W: int, n: int, block: int, k: int) -> Tuple[int, int]:
    """B6: 4 operations a padded element (add, abs, a comparison, select); x
    and the residual read, the residual written, k (value, index) pairs a
    block written."""
    nb = -(-n // block)
    return 4 * W * nb * block, 2 * W * n * 4 + W * n * 4 + W * nb * k * 8


def topk_decode_cost(W: int, n: int, block: int, k: int) -> Tuple[int, int]:
    """B7: 2 operations an element; the pairs read, f32 out."""
    nb = -(-n // block)
    return 2 * W * n, W * nb * k * 8 + W * n * 4


def b8_cost(W: int, n: int, t_size: int = 4, chunks: int = 1) -> Tuple[int, int]:
    """B8 over W rows of n in ``chunks`` launches: 4 operations an element
    (|d| <= thr, d * keep, scale * (...), t + (...)); theta and the f32
    delta read, theta' written, the [W, 2] scalars read once a chunk."""
    return 4 * W * n, W * n * (2 * t_size + 4) + chunks * W * 8


def _causal_pairs(Sq: int, visible: int, window: int) -> int:
    """(query row, key) pairs a causal attention visits: query i sits at
    position ``visible - Sq + i`` and sees the keys up to it, the last
    ``window`` of them when ``window`` > 0."""
    first = visible - Sq + 1                  # keys the first query row sees
    if window <= 0:
        return Sq * (first - 1) + Sq * (Sq + 1) // 2
    last = visible
    if first >= window:
        return Sq * window
    if last <= window:
        return (first + last) * Sq // 2
    ramp = window - first                     # rows below the window's width
    return (first + window - 1) * ramp // 2 + (Sq - ramp) * window


def b9_cost(B: int, Sq: int, H: int, Hkv: int, hd: int, visible: int, *,
            dv: Optional[int] = None, size: int = 2, causal: bool = True,
            window: int = 0, v_own: Optional[bool] = None) -> Tuple[int, int]:
    """B9 over q ``[B, Sq, H, hd]`` and ``visible`` key rows of ``[B, *, Hkv,
    hd]`` (values ``dv`` wide, default ``hd``), ``size`` bytes an element:
    2 (hd + dv) operations a (query row, visible key) pair (scores and the
    weighted values); q and the output written once, every key row a query
    sees read once, the value rows too unless they are the keys' prefix
    (MLA: ``v_own`` False; by default a value narrower than its key is its
    prefix). A causal query sees the keys up to its position (the rows
    end-aligned: a decode's one row sees ``visible``), the last ``window``
    of them when ``window`` > 0; a non-causal one all ``visible``."""
    dv = hd if dv is None else dv
    if v_own is None:
        v_own = dv >= hd
    if causal:
        pairs = _causal_pairs(Sq, visible, window)
        keys = visible - max(0, visible - Sq - window + 1) if window > 0 else visible
    else:
        pairs, keys = Sq * visible, visible
    flops = 2 * (hd + dv) * H * B * pairs
    nbytes = size * (B * Sq * H * hd + B * keys * Hkv * (hd + (dv if v_own else 0))
                     + B * Sq * H * dv)
    return flops, nbytes
