"""repro_torch.faults — deterministic message-level fault injection (port of
``repro.faults``).

Hash-seeded (restart-exact) fault models, wire checksums for corruption
detection, and the robust mixing protocols (``clipped_gossip`` /
``trimmed_gossip``, registered in :mod:`repro_torch.api.robust`) that
survive them. The delay models of the async engine's message mode come with
that engine.
"""
from repro_torch.common.config import FaultConfig  # noqa: F401
from repro_torch.faults.models import (FaultModel,  # noqa: F401
                                       available_fault_models, bernoulli,
                                       bernoulli_np, fault_descriptor,
                                       fault_hash, get_fault_model,
                                       register_fault_model,
                                       resolve_fault_model,
                                       unregister_fault_model)
from repro_torch.faults.wire import (append_checksum, checksum_u8,  # noqa: F401
                                     corrupt_roundtrip_bufs, corrupt_wire,
                                     verify_strip)

__all__ = [
    "FaultConfig", "FaultModel",
    "register_fault_model", "available_fault_models", "get_fault_model",
    "unregister_fault_model", "resolve_fault_model",
    "fault_hash", "bernoulli_np", "bernoulli", "fault_descriptor",
    "checksum_u8", "append_checksum", "verify_strip", "corrupt_wire",
    "corrupt_roundtrip_bufs",
]
