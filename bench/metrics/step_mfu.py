"""The whole step's share of the card's f32 peak: the model's FLOPs of the
traced steps (the configuration's closed-form count, no recompute) over
their time by CUDA events x 67 TFLOP/s (``bench/frozen/costs.py``)."""
from bench.frozen.costs import PEAK_F32_FLOPS


def read(t):
    if not t.event_s:
        return None
    return 100.0 * t.flops_per_step * t.steps / (t.event_s * PEAK_F32_FLOPS)
