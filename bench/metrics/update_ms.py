"""Device ms a step of the gossip update (``core/gossip_sim.py``: the
gradient transform, the gate and peer draws, ``protocols.comm_update``'s
mixing and kernel B1): the program's ``update`` span
(``bench/program_spans.py``)."""
from bench.program_spans import device_ms


def read(t):
    return device_ms(t, "update")
