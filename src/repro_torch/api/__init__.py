"""The port's public API (``repro.api`` counterpart): the trainer facade,
the flat-resident state and the protocol registry."""
from repro_torch.api.protocols import (CommCost, PairwiseGossip, Protocol,  # noqa: F401
                                       ProtocolState)
from repro_torch.api.registry import (available_protocols, get_protocol,  # noqa: F401
                                      register_protocol)
from repro_torch.api.state import FlatState  # noqa: F401
from repro_torch.api.trainer import GossipTrainer  # noqa: F401


def __getattr__(name):
    # the serving entry point, re-exported as the reference's repro.api does
    # (lazily: repro_torch.serving.engine itself imports repro_torch.api.state)
    if name == "make_serve_program":
        from repro_torch.serving.engine import make_serve_program
        return make_serve_program
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
