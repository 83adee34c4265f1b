"""Spans: named ranges of the program, timed on the device from inside it.

The one span mechanism of the port. ``span(name, **counts)`` is a context
manager that always opens ``torch.profiler.record_function(name)``, so a
profiler trace shows every span as a range, and records while a
``torch.profiler`` is recording or while a trainer's ``Observer`` traces
(the sim engine opens its ``step`` span with ``force=True`` then)::

    with spans.span("lm head + loss") as rec:   # rec is None when not recording
        ...

While recording, each span appends one :class:`Span` to the process-wide
bounded :data:`TABLE` (overflow counts as dropped): its name, the span
around it, the engine's host step index (set by the ``step`` span and
inherited), host start and end, a pair of ``torch.cuda.Event`` on the
current stream where the span's device is CUDA (given by ``device=`` or
inherited from the span around it), and the caller's counts. A span never
synchronises: :meth:`SpanTable.read` resolves the events, after the caller
has synchronised. A span on a CPU device records host time only, and no
device figure is derived from it. When nothing records, a span costs the
``record_function`` call and one flag check.

The span stack is one per process, not per thread: the autograd engine
runs a CUDA backward on its own device thread while the thread that called
it waits, so spans opened there (the layers' recompute, the grad marks)
nest under the ``backward`` span that runs them. Spans opened concurrently
by two threads may name a wrong parent.

A span's backward: :func:`mark_inputs` and :func:`mark_output` place
identity marks (a ``torch.autograd.Function`` with ``setup_context`` and
``generate_vmap_rule``, so they run under the engines'
``vmap(grad_and_value(...))`` as ``common/remat.py``'s checkpoint does) on
the span's input and output tensors while it records, and nothing
otherwise. The output mark's backward opens a second record of the span
(``grad=True``), the input marks' backward closes it. Gradients pass
through unchanged.

Host clock: ``CLOCK_REALTIME`` in Unix ns (``time.time_ns``), the clock of
``torch.profiler``'s timeline. x86 builds of torch (2.11 and 2.13 alike)
stamp host events with the CPU's time-stamp counter
(``c10::getApproximateTime``) and convert them to Unix ns at the end of
each profiling session, by a fit of the counter to ``CLOCK_REALTIME`` over
that session (``ApproximateClockToUnixTimeConverter``). Stamping
``CLOCK_REALTIME`` itself puts the table on that timeline with no fit of
its own (a fit kept for the life of a process drifted from the profiler's
by ~0.7 ms within minutes). So the table, the profiler's trace and its
device kernels share one timeline: ``Span.start_ns`` less the profiler's
``trace_start_ns`` is its events' ``time_range.start`` in ns.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

_forced = 0     # open spans with force=True (an Observer that traces)


def recording() -> bool:
    """Whether spans record now."""
    return _forced > 0 or torch.autograd._profiler_enabled()


@dataclasses.dataclass
class Span:
    """One recorded span (see the module docstring)."""
    id: int
    name: str
    parent: int                      # the enclosing span's id, -1 at the top
    step: int                        # the engine's host step index, -1 outside a step
    grad: bool                       # the backward part, recorded by the grad marks
    counts: Dict[str, float]
    start_ns: int                    # host start and end, Unix ns
    end_ns: int = 0
    events: Optional[tuple] = None   # (start, end) torch.cuda.Event
    device: Optional[torch.device] = None
    marks: Optional["_GradPart"] = dataclasses.field(default=None, repr=False)
    device_ms: Optional[float] = None    # resolved by SpanTable.read


class SpanTable:
    """The bounded process-wide table of recorded spans."""

    def __init__(self, max_spans: int = 100_000):
        self.max_spans = int(max_spans)
        self.spans: List[Span] = []
        self.dropped = 0        # spans refused by the bound
        self.stack: List[Span] = []
        self._next_id = 0

    def next_id(self) -> int:
        """The id the next recorded span gets."""
        return self._next_id

    def open(self, name: str, step: Optional[int], device, counts: dict, start_ns: int,
             grad: bool = False) -> Span:
        """Record the start of a span stamped ``start_ns`` on the host (its
        device start now); the table keeps it at :meth:`keep`."""
        top = self.stack[-1] if self.stack else None
        if step is None:
            step = top.step if top is not None else -1
        if device is None and top is not None:
            device = top.device
        device = torch.device(device) if device is not None else None
        rec = Span(self._next_id, name, top.id if top is not None else -1, int(step), grad,
                   dict(counts), start_ns, device=device)
        self._next_id += 1
        if device is not None and device.type == "cuda":
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        if not grad:
            self.stack.append(rec)
        return rec

    def close(self, rec: Span) -> None:
        """Record the span's device end now and take it off the stack."""
        if rec.events is not None:
            rec.events[1].record()
        for i in range(len(self.stack) - 1, -1, -1):
            if self.stack[i] is rec:
                del self.stack[i]
                break

    def keep(self, rec: Span) -> None:
        """Stamp the span's host end now and keep it (or count it dropped)."""
        rec.end_ns = time.time_ns()
        if len(self.spans) >= self.max_spans:
            self.dropped += 1
            return
        self.spans.append(rec)

    def read(self, since: int = 0) -> List[Span]:
        """The closed spans with ``id >= since``, their device times
        resolved (``device_ms``; None without CUDA events). Call after
        synchronising the device."""
        out = []
        for rec in self.spans:
            if rec.id < since:
                continue
            if rec.events is not None and rec.device_ms is None:
                rec.events[1].synchronize()
                rec.device_ms = rec.events[0].elapsed_time(rec.events[1])
            out.append(rec)
        return out


TABLE = SpanTable()


class span:
    """``with span(name, **counts) as rec``: a profiler range, recorded in
    :data:`TABLE` while spans record (``rec`` is the :class:`Span`, else
    None). ``step`` sets the engine's host step index of this span and the
    spans inside it, ``device`` their device; ``force`` makes them record
    whether or not a profiler does. :meth:`open` / :meth:`close` do the
    same where the range's start and end lie in different functions."""

    __slots__ = ("name", "counts", "step", "device", "force", "_rf", "rec")

    def __init__(self, name: str, *, step: Optional[int] = None, device=None,
                 force: bool = False, **counts):
        self.name, self.counts = name, counts
        self.step, self.device, self.force = step, device, force
        self._rf = self.rec = None

    def open(self) -> "span":
        global _forced
        self._rf = torch.profiler.record_function(self.name)
        if self.force:
            _forced += 1
        if not recording():
            self._rf.__enter__()
            return self
        # the profiler stamps the range inside the call that opens it: the
        # host start is that call's midpoint, the host end follows the
        # call that closes it (:meth:`SpanTable.keep`)
        t0 = time.time_ns()
        self._rf.__enter__()
        t0 = (t0 + time.time_ns()) // 2
        self.rec = TABLE.open(self.name, self.step, self.device, self.counts, t0)
        return self

    def close(self) -> None:
        global _forced
        if self.rec is not None:
            TABLE.close(self.rec)
        if self.force:
            _forced -= 1
        self._rf.__exit__(None, None, None)
        if self.rec is not None:
            TABLE.keep(self.rec)

    def __enter__(self) -> Optional[Span]:
        return self.open().rec

    def __exit__(self, *exc) -> None:
        self.close()


class _Mark(torch.autograd.Function):
    """Identity on its tensors; its backward calls ``hook()`` once."""

    generate_vmap_rule = True

    @staticmethod
    def forward(hook, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hook = inputs[0]

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook()
        return (None,) + grads


class _GradPart:
    """The backward part of a recorded span: opened by the output mark's
    backward, closed by the input marks'."""

    def __init__(self, rec: Span):
        self.rec, self.part = rec, None

    def begin(self) -> None:
        self.part = TABLE.open(self.rec.name, self.rec.step, self.rec.device,
                               self.rec.counts, time.time_ns(), grad=True)

    def end(self) -> None:
        if self.part is not None:
            TABLE.close(self.part)
            TABLE.keep(self.part)
            self.part = None


def mark_inputs(rec: Optional[Span], *tensors):
    """The span's input tensors, marked so that the end of their backward
    closes the span's backward part (the tensors as they are when ``rec``
    is None). Returns a tuple."""
    if rec is None:
        return tensors
    rec.marks = _GradPart(rec)
    return _Mark.apply(rec.marks.end, *tensors)


def mark_output(rec: Optional[Span], tensor):
    """The span's output, marked so that its backward opens the span's
    backward part (after :func:`mark_inputs`; ``tensor`` itself when
    ``rec`` is None)."""
    if rec is None:
        return tensor
    return _Mark.apply(rec.marks.begin, tensor)[0]


def physical_numel(t: torch.Tensor) -> int:
    """Elements of ``t`` with every ``torch.func`` level around it: a
    tensor seen inside ``vmap`` counts each mapped row."""
    from torch._C import _functorch
    while _functorch.is_functorch_wrapped_tensor(t):
        t = _functorch.get_unwrapped(t)
    return t.numel()
