"""repro_torch.comm — the pluggable gossip-compression plane (port of
``repro.comm``).

- the codec registry (:mod:`repro_torch.comm.registry`): every compression
  scheme is a :class:`Codec` class registered under a name
  (``@register_codec``; ``ProtocolConfig(codec=...)`` /
  ``GossipTrainer(codec=...)`` then work in the sim engine);
- the codec classes (:mod:`repro_torch.comm.codecs`): ``none``, ``q8``
  (stochastic-rounding int8, per-block scales; kernels B4/B5) and ``topk``
  (magnitude top-k + error-feedback residual; kernels B6/B7);
- wire-byte accounting: ``wire_param_bytes`` is what ``comm_bytes`` and
  ``Protocol.comm_cost`` report when a codec is active;
  ``wire_partition_bytes`` the per-chunk wire of the partition plane.
"""
from repro_torch.comm.registry import (  # noqa: F401
    available_codecs,
    get_codec,
    register_codec,
    resolve_codec,
    unregister_codec,
)
from repro_torch.comm.codecs import (  # noqa: F401
    Codec,
    CommState,
    active_codec,
    codec_seeds,
    init_comm_state,
    roundtrip_bufs,
    wire_param_bytes,
    wire_partition_bytes,
)
