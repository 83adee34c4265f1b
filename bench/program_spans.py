"""The program's spans in a traced window, for the per-layer readers
(``bench/metrics/<name>.py``): the device time a step of one span, from the
process-wide table of ``repro_torch.obs.spans``, which records while the
window's profiler does. The records kept are those of the newest
``t.steps`` host step indices; the checked steps run before the profiler
starts, so none of theirs is there. Nothing is read (None) from a program
without that module, from a table that dropped records, or where the span
has no device time (a CPU run)."""
from __future__ import annotations

from typing import List, Optional


def records(t, name: str) -> list:
    """The records named ``name`` of the traced steps, both parts of a
    span with a backward part; [] where the program has no span table."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return []
    if spans.TABLE.dropped:
        return []
    steps: List[int] = []
    kept = []
    for r in reversed(spans.TABLE.read()):
        if r.step < 0:
            continue
        if r.step not in steps:
            if len(steps) == t.steps:
                break
            steps.append(r.step)
        if r.name == name:
            kept.append(r)
    return kept


def device_ms(t, name: str) -> Optional[float]:
    """Device ms a step of the span ``name``, or None."""
    recs = [r for r in records(t, name) if r.device_ms is not None]
    return sum(r.device_ms for r in recs) / t.steps if recs else None
