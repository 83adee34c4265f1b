"""repro_torch.faults — deterministic message-level fault injection (port of
``repro.faults``).

Hash-seeded (restart-exact) fault and delay models, wire checksums for
corruption detection, and the robust mixing protocols (``clipped_gossip`` /
``trimmed_gossip``, registered in :mod:`repro_torch.api.robust`) that
survive them. The delay models drive the async engine's message mode.
"""
from repro_torch.common.config import FaultConfig  # noqa: F401
from repro_torch.faults.models import (DelayModel, FaultModel,  # noqa: F401
                                       available_delay_models,
                                       available_fault_models, bernoulli,
                                       bernoulli_np, delays_active,
                                       fault_descriptor, fault_hash,
                                       get_delay_model, get_fault_model,
                                       register_delay_model,
                                       register_fault_model,
                                       resolve_delay_model,
                                       resolve_fault_model,
                                       unregister_delay_model,
                                       unregister_fault_model)
from repro_torch.faults.wire import (append_checksum, checksum_u8,  # noqa: F401
                                     corrupt_roundtrip_bufs, corrupt_wire,
                                     verify_strip)

__all__ = [
    "FaultConfig", "FaultModel", "DelayModel",
    "register_fault_model", "register_delay_model",
    "available_fault_models", "available_delay_models",
    "get_fault_model", "get_delay_model",
    "unregister_fault_model", "unregister_delay_model",
    "resolve_fault_model", "resolve_delay_model",
    "fault_hash", "bernoulli_np", "bernoulli", "fault_descriptor", "delays_active",
    "checksum_u8", "append_checksum", "verify_strip", "corrupt_wire",
    "corrupt_roundtrip_bufs",
]
