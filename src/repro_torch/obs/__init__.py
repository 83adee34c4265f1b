"""Telemetry (the parts of ``repro.obs`` ported so far): the per-step
metrics schema and the metrics sink the serving side records into."""
from repro_torch.obs.metrics import MetricsSink  # noqa: F401
