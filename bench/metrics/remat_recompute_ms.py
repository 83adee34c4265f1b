"""Device ms a step in rematerialisation (``common/remat.py``): the layers'
forward run again in the backward, the ``remat recompute`` range."""
from bench.frozen.lm_split import RANGES, RECOMPUTE


def read(t):
    us = t.parts_us.get(RANGES[RECOMPUTE], 0.0)
    return us / t.steps / 1e3 if us > 0 else None
