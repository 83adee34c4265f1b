"""Device ms a step of the training attention (``models/attention.py``):
the ``online_softmax_attention`` range's forward, its backward and the key
chunks' recompute (``bench/frozen/lm_split.py``)."""
from bench.frozen.lm_split import RANGES


def read(t):
    us = t.parts_us.get(RANGES["online_softmax_attention"], 0.0)
    return us / t.steps / 1e3 if us > 0 else None
