"""LiveServer — a ServeProgram that hot-swaps weights between decode batches
(port of ``repro.serve.live``).

- **hot swap**: :meth:`maybe_swap` polls the
  :class:`~repro_torch.serve.snapshot.SnapshotBus` and, when a newer snapshot
  exists, builds the served parameter tree as ``FlatSpec`` views of the
  snapshot cast to the serving dtype on the serving device (a leaf already
  in that dtype stays a view; nothing writes the served params in place).
  The time of each swap is recorded in the server's
  :class:`repro_torch.obs.MetricsSink` (``swap_pause_s``); on a CUDA device
  the span is synchronised at both ends, so it holds the casts' device
  time.
- **provenance**: :attr:`seq` / :attr:`train_step` of the weights being
  served.
- **decode routing**: :meth:`decode` runs the program's plain decode when no
  per-slot bounds are given and ``decode_slots_fn`` (per-row ``kv_start``)
  when they are.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, List, Optional

from repro_torch.obs import MetricsSink
from repro_torch.serve.loop import device_sync
from repro_torch.serve.snapshot import snapshot_valid

PyTree = Any


class LiveServer:
    """Serving half of the train-while-serve loop (see module docstring)."""

    def __init__(self, program, bus, params: Optional[PyTree] = None, metrics=None):
        self.program = program
        self.bus = bus
        self.params: Optional[PyTree] = (
            None if params is None else program.place_params(params))
        self.seq: int = 0            # bus seq of the weights being served
        self.train_step: int = -1    # train-step provenance (-1: initial params)
        self.metrics = metrics if metrics is not None else MetricsSink()
        self._bad_seq: int = 0       # last refused seq (skip re-checking it)
        self._sync = device_sync(getattr(program, "device", None))

    @property
    def swap_pauses(self) -> List[float]:
        """Live view of the sink's ``swap_pause_s`` observations."""
        return self.metrics.samples("swap_pause_s")

    @property
    def rejected_swaps(self) -> int:
        return int(self.metrics.counters.get("rejected_swaps", 0))

    # ------------------------------------------------------------------- swap
    def maybe_swap(self) -> bool:
        """Swap to the bus's latest snapshot if it is newer than what is
        being served; True when a swap happened. Call it BETWEEN decode
        batches, so every token batch is computed under exactly one
        parameter version (tokens before a swap boundary are bit-identical
        whether or not the swap happens)."""
        snap = self.bus.latest()
        if snap is None or snap.seq <= self.seq or snap.seq == self._bad_seq:
            return False
        # defensive re-validation: a bad snapshot PINS the last good weights
        ok, why = snapshot_valid(snap.bufs, snap.spec)
        if not ok:
            self.metrics.counter_add("rejected_swaps", 1)
            self._bad_seq = snap.seq
            warnings.warn(
                f"LiveServer refused snapshot seq={snap.seq}: {why} — "
                f"pinned to seq={self.seq}", RuntimeWarning, stacklevel=2)
            return False
        # on a CUDA device the span is synchronised at both ends, so the
        # pause holds the casts' device time and nothing queued before it
        self._sync()
        t0 = time.perf_counter()
        self.params = self.program.place_params(snap.spec.unflatten(snap.bufs))
        self._sync()
        self.metrics.observe("swap_pause_s", time.perf_counter() - t0)
        self.metrics.counter_add("swaps", 1)
        self.metrics.gauge_set("served_seq", snap.seq)
        self.seq = snap.seq
        self.train_step = snap.train_step
        return True

    # ----------------------------------------------------------------- decode
    def _require_params(self) -> PyTree:
        if self.params is None:
            raise RuntimeError(
                "LiveServer has no parameters yet: publish a snapshot onto "
                "the bus and call maybe_swap(), or pass initial params")
        return self.params

    def decode(self, cache, tokens, cond=None, kv_start=None):
        """One decode step under the CURRENT weights; ``kv_start`` ([B]
        per-slot first valid cache position) selects the continuous-batching
        program. Returns (logits, cache)."""
        p = self._require_params()
        if kv_start is None:
            return self.program.decode_fn(p, cache, tokens, cond)
        return self.program.decode_slots_fn(p, cache, tokens, cond, kv_start)

    def prefill(self, tokens, cond=None):
        """Full-sequence prefill under the current weights (the program must
        have been built ``with_prefill=True``)."""
        if self.program.prefill_fn is None:
            raise RuntimeError("ServeProgram was built without prefill")
        return self.program.prefill_fn(self._require_params(), tokens, cond)

    def init_cache(self):
        return self.program.init_cache()

    # ------------------------------------------------------------- accounting
    def swap_stats(self) -> dict:
        """Swap count + mean/max pause seconds (0s when no swap happened)."""
        pauses = self.metrics.samples("swap_pause_s")
        n = len(pauses)
        return {"swaps": n,
                "swap_pause_mean_s": (sum(pauses) / n) if n else 0.0,
                "swap_pause_max_s": max(pauses) if n else 0.0,
                "rejected_swaps": self.rejected_swaps}
