"""The port's public API (``repro.api`` counterpart): the trainer facade,
the flat-resident state and the protocol registry."""
from repro_torch.api.protocols import (CommCost, PairwiseGossip, Protocol,  # noqa: F401
                                       ProtocolState)
from repro_torch.api.registry import (available_protocols, get_protocol,  # noqa: F401
                                      register_protocol)
from repro_torch.api.state import FlatState  # noqa: F401
from repro_torch.api.trainer import GossipTrainer  # noqa: F401
