"""What a traced window holds, for the per-layer readers
(``bench/metrics/<name>.py``): the device's kernels, their time by part
(``bench/frozen/lm_split.py``), the union of their intervals, and the
breakdown the result line carries."""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from bench.frozen.lm_split import _busy_us, _lm_split


@dataclasses.dataclass
class Trace:
    steps: int                       # training steps in the traced window
    window_s: float                  # host time of those steps, synchronised
    event_s: Optional[float]         # CUDA events around them (None on the CPU)
    kernels: list                    # device events (no user annotations)
    parts_us: Dict[str, float]       # device time by part over the window
    busy_s: float                    # union of the kernels' intervals
    flops_per_step: int              # the model's FLOPs a step (all workers)
    workers: int
    plane_width: int                 # columns of the [W, N] parameter plane
    gaps: List[Tuple[str, float]]    # the longest idle gaps, by the host's op


def _kernel_events(events) -> list:
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events if e.device_type == cuda and not e.is_user_annotation]


def _idle_gaps(events, kernels, n: int = 10) -> List[Tuple[str, float]]:
    """The n longest gaps between the kernels' merged intervals, each named
    by the innermost host op running when the device went idle."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:])), reverse=True)[:n]
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    out = []
    for length, at in gaps:
        inside = [e for e in cpu if e.time_range.start <= at < e.time_range.end]
        name = min(inside, key=lambda e: e.time_range.end - e.time_range.start).name \
            if inside else "(no host op)"
        out.append((name, length / 1e6))
    return out


def read(events, *, steps: int, window_s: float, event_s, flops_per_step: int,
         workers: int, plane_width: int) -> Trace:
    kernels = _kernel_events(events)
    return Trace(steps=steps, window_s=window_s, event_s=event_s, kernels=kernels,
                 parts_us=dict(_lm_split(events)),
                 busy_s=_busy_us([(e.time_range.start, e.time_range.end)
                                  for e in kernels]) / 1e6,
                 flops_per_step=flops_per_step, workers=workers, plane_width=plane_width,
                 gaps=_idle_gaps(events, kernels))


def device_ops(t: Trace, n: int = 10) -> List[Tuple[str, float]]:
    by = defaultdict(float)
    for k in t.kernels:
        by[k.name] += (k.time_range.end - k.time_range.start) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]
