"""The LM step's device time by part, copied from
``src/repro_torch/launch/profile_sim.py`` (``RANGES``, ``_lm_split``,
``_busy_us``) at commit 0f5df9a, unchanged. It splits a profiler trace's
device time by the port's ``record_function`` ranges; a backward kernel goes
to its forward's range by autograd sequence number."""
from __future__ import annotations

from collections import defaultdict

import torch


def _busy_us(intervals):
    """Length of the union of [start, end) intervals (µs)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# record_function ranges of the LM step -> the part their kernels (and
# their backward nodes' kernels) are counted under
RECOMPUTE = "remat recompute"
RANGES = {RECOMPUTE: "remat recompute (the layers' forward again)",
          "online_softmax_attention": "attention (fwd + bwd)",
          "moe expert matmuls": "MoE expert bmms (fwd + bwd)",
          "moe route": "MoE dispatch: route (fwd + bwd)",
          "moe sort + scatter": "MoE dispatch: sort + scatter (fwd + bwd)",
          "moe gather + combine": "MoE dispatch: gather + combine (fwd + bwd)",
          "gla_chunked": "chunked GLA: Mamba2 / mLSTM core (fwd + bwd)",
          "slstm loop": "sLSTM loop (fwd + bwd)"}


def _lm_split(events) -> dict:
    """The LM step's device time (us) by part: B1; each of :data:`RANGES`
    (kernels launched by ops inside the range, and by backward nodes whose
    forward op ran there, matched by autograd sequence number); the flat
    views' backward (the ``_Views`` backward node); the remaining matmuls
    and the remaining elementwise / reduction kernels. A kernel goes by
    the op that launched it (the op's ``kernels``); those launched outside
    any op (the hand-written kernels, through ctypes) go by name. The
    layers' recompute (``cfg.remat``, ``common/remat.py``) is its own part
    whatever range it holds (the attention's forward in it too); the
    backward of what it recomputed goes to the part of its own range, and
    the key chunks' recompute inside the attention's backward to the
    attention."""
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    def by_name(n):
        n = n.lower()
        if "fused_flat_elastic_nag" in n:
            return "B1 fused update"
        if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n or "matmul" in n:
            return "matmuls (model + mixing)"
        if "memcpy" in n:
            return "host <-> device copies"
        return "elementwise / reductions / copies"

    def innermost_range(chain):
        return next((a.name for a in chain if a.name in RANGES and a.name != RECOMPUTE), None)

    ops = [e for e in events if e.device_type == CPU]
    seq_range = {}
    for e in ops:
        if e.sequence_nr >= 0:
            r = innermost_range(ancestors(e.cpu_parent))
            if r is not None:
                seq_range[e.sequence_nr] = r
    out = defaultdict(float)
    unlinked = defaultdict(float)
    for k in events:
        if k.device_type == CUDA and not k.is_user_annotation:
            unlinked[k.name] += k.time_range.end - k.time_range.start
    # a kernel listed under more than one op is counted once: no name is
    # given more time than its kernels took on the device
    left = dict(unlinked)
    for e in ops:
        if not e.kernels:
            continue
        chain = list(ancestors(e))
        names = [a.name for a in chain]
        r = RECOMPUTE if RECOMPUTE in names else innermost_range(chain)
        if r is None:
            r = next((seq_range[a.sequence_nr] for a in chain
                      if "evaluate_function" in a.name and a.sequence_nr in seq_range), None)
        for k in e.kernels:
            if k.name in RANGES:
                continue
            us = min(k.duration, max(left.get(k.name, 0.0), 0.0))
            left[k.name] = left.get(k.name, 0.0) - us
            unlinked[k.name] -= us
            if any("_Views" in a and "Backward" in a for a in names):
                part = "views backward"
            elif r is not None:
                part = RANGES[r]
            else:
                part = by_name(k.name)
            out[part] += us
    for name, us in unlinked.items():
        if us > 0:
            out[by_name(name)] += us
    return out
