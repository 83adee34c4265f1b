"""Kernel B1's share of its roofline: the bytes it must move
(``bench/frozen/costs.py::b1_cost``, 24 B an element of the [W, N] f32
plane) at 3.35 TB/s, over its device time a call in the trace."""
from bench.frozen.costs import HBM_BYTES_PER_S, b1_cost


def read(t):
    calls = [k for k in t.kernels if "fused_flat_elastic_nag" in k.name.lower()]
    if not calls:
        return None
    seconds = sum(k.time_range.end - k.time_range.start for k in calls) / len(calls) / 1e6
    return 100.0 * b1_cost(t.workers, t.plane_width)[1] / HBM_BYTES_PER_S / seconds
