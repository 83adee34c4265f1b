"""The sharded flat plane (port of ``repro.shard``): each dtype bucket's
``total`` dim split into equal column shards, so gossip wire bytes scale
per device instead of per model. See :mod:`repro_torch.shard.layout`."""
from repro_torch.shard.layout import (ShardLayout, build_layout, pad_bufs, padded_spec,
                                      shard_descriptor, shard_manifest, shard_quantum,
                                      shard_wire_bytes, slice_bufs, wire_per_device)

__all__ = [
    "ShardLayout", "build_layout", "padded_spec", "pad_bufs", "slice_bufs",
    "shard_manifest", "shard_wire_bytes", "wire_per_device",
    "shard_descriptor", "shard_quantum",
]
