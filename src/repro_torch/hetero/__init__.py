"""repro_torch.hetero — heterogeneous-worker virtual time for the async
engine (port of ``repro.hetero``).

The compute-time model registry (:mod:`repro_torch.hetero.models`): every
fleet-speed model is a :class:`ComputeTimeModel` registered under a name
(``constant`` | ``lognormal`` | ``slow_node`` | ``fail_rejoin``), selected
by :class:`~repro_torch.common.config.HeteroConfig` through
``GossipTrainer(engine="async", hetero=HeteroConfig(...))``. Every duration
is a pure hash of ``(seed, worker, step)``, so virtual time is
bit-reproducible across restarts.
"""
from repro_torch.common.config import HeteroConfig  # noqa: F401  (re-export)
from repro_torch.hetero.models import (  # noqa: F401
    ComputeTimeModel,
    available_time_models,
    get_time_model,
    hetero_hash,
    hetero_normal,
    hetero_uniform,
    register_time_model,
    resolve_time_model,
    unregister_time_model,
)
