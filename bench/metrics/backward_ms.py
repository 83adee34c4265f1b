"""Device ms a step of the backward (autograd from the end of the forward
to the flat gradients, remat's recompute inside): the program's
``backward`` span (``bench/program_spans.py``)."""
from bench.program_spans import device_ms


def read(t):
    return device_ms(t, "backward")
