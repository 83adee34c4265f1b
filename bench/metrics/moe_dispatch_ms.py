"""Device ms a step in the MoE dispatch (``models/moe.py``): the ``moe
route``, ``moe sort + scatter`` and ``moe gather + combine`` ranges,
forward and backward (the expert matmuls are not in it)."""
from bench.frozen.lm_split import RANGES

_PARTS = ("moe route", "moe sort + scatter", "moe gather + combine")


def read(t):
    us = sum(t.parts_us.get(RANGES[r], 0.0) for r in _PARTS)
    return us / t.steps / 1e3 if us > 0 else None
