"""Device ms a step of the LM head and its cross-entropy
(``models/transformer.py::chunked_ce_loss``): the program's ``lm head +
loss`` span, its forward part and its backward part (``bench/program_spans.py``)."""
from bench.program_spans import device_ms


def read(t):
    return device_ms(t, "lm head + loss")
