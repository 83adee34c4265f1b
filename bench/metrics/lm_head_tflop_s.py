"""The LM head's matmul rate: the ``flops`` count of the program's ``lm
head + loss`` span (6 x tokens x d x V, counted from the shapes at the
span; the forward part carries it) over the span's device time, forward
and backward parts (``bench/program_spans.py``). A rate, not a share of a
peak."""
from bench.program_spans import records


def read(t):
    recs = [r for r in records(t, "lm head + loss") if r.device_ms is not None]
    ms = sum(r.device_ms for r in recs)
    flops = sum(r.counts["flops"] for r in recs if not r.grad)
    return flops / ms / 1e9 if ms > 0 else None
