"""repro_torch.fleet — mega-fleet gossip: partitioned exchanges, token-account
flow control and the host-resident plane (port of ``repro.fleet``).

- :mod:`repro_torch.fleet.partition`: each exchange ships ONE
  hash-scheduled contiguous chunk of the flat plane (``partition=P``), with
  exact per-chunk byte accounting and per-chunk robust mixing (kernel B8 on
  the chunk's columns);
- :mod:`repro_torch.fleet.flow`: ``@register_flow_control`` token-account
  models gating which workers may initiate an exchange each step;
- :mod:`repro_torch.fleet.hostplane`: the async engine's plane in pinned
  host memory, only the event window's rows on the card (``plane="host"``);
- :mod:`repro_torch.fleet.memory`: up-front W-against-memory validation.

``FleetConfig()`` (partition=1, flow_control="none", plane="device") is
inert: the engines add no work and reproduce the non-fleet runs bit for bit.
"""
from repro_torch.common.config import FleetConfig
from repro_torch.fleet.flow import (
    SALT_FLOW,
    SALT_PARTITION,
    FlowControl,
    available_flow_controls,
    get_flow_control,
    register_flow_control,
    resolve_flow_control,
    unregister_flow_control,
)
from repro_torch.fleet.memory import (
    DEVICE_RESIDENT_FACTOR,
    HOST_RESIDENT_FACTOR,
    available_host_bytes,
    plane_bytes,
    validate_fleet_memory,
)
from repro_torch.fleet.partition import (
    PartitionPlan,
    build_plan,
    chunk_bounds,
    partition_ids,
    partition_ids_np,
    partitioned_comm_update,
)

__all__ = [
    "FleetConfig",
    "SALT_FLOW",
    "SALT_PARTITION",
    "FlowControl",
    "available_flow_controls",
    "get_flow_control",
    "register_flow_control",
    "resolve_flow_control",
    "unregister_flow_control",
    "DEVICE_RESIDENT_FACTOR",
    "HOST_RESIDENT_FACTOR",
    "available_host_bytes",
    "plane_bytes",
    "validate_fleet_memory",
    "PartitionPlan",
    "build_plan",
    "chunk_bounds",
    "partition_ids",
    "partition_ids_np",
    "partitioned_comm_update",
]
