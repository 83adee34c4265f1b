"""Device ms a step of the forward (``core/gossip_sim.py::SimTrainer._grads``:
the loss of every worker under ``vmap``, the model and its head): the
program's ``forward`` span (``bench/program_spans.py``)."""
from bench.program_spans import device_ms


def read(t):
    return device_ms(t, "forward")
