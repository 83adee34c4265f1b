"""Checkpoint v2 files, interchangeable with the reference's (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint import io  # noqa: F401
