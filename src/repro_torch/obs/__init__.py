"""The telemetry plane (port of ``repro.obs``): typed event tracing
(:class:`TraceRecorder`, exported as a Perfetto/Chrome timeline), a metrics
registry (:class:`MetricsSink`, a JSONL stream), the one step-metrics and
event schema (:mod:`repro_torch.obs.schema`), the program's device-timed
spans (:mod:`repro_torch.obs.spans`) and the :class:`Observer` that the
facade attaches to an engine::

    trainer = GossipTrainer(engine="async", ..., obs=ObsConfig(
        trace_path="run.json", metrics_path="run.jsonl"))
    ...
    trainer.export_obs()          # writes run.json and run.jsonl
    # python -m repro_torch.obs.report run.jsonl --trace run.json

The all-default ``ObsConfig()`` is inert: no observer is built. A
recording run is bit-exact against a plain one: the observer reads what
the engines already hold and adds no device work to a step (while it
traces, the step's spans record CUDA events, no kernels).
"""
from repro_torch.obs import spans
from repro_torch.obs.metrics import MetricsSink
from repro_torch.obs.observer import Observer
from repro_torch.obs.schema import (ASYNC_MESSAGE_KEYS, ASYNC_STEP_KEYS, CORE_STEP_KEYS,
                                    EVENT_TYPES, SERVE_STEP_KEYS, normalize_step_metrics,
                                    validate_event, validate_trace)
from repro_torch.obs.trace import TraceRecorder

__all__ = ["MetricsSink", "Observer", "TraceRecorder", "spans",
           "CORE_STEP_KEYS", "ASYNC_STEP_KEYS", "ASYNC_MESSAGE_KEYS",
           "SERVE_STEP_KEYS", "EVENT_TYPES",
           "normalize_step_metrics", "validate_event", "validate_trace"]
