"""TrainServeLoop: training slices interleaved with serving boundaries (port
of ``repro.serve.loop``).

One host loop, two workloads: each decode boundary runs (1) a training slice
(``train_fn``, typically a few ``GossipTrainer.step`` calls with the
``publish_every`` snapshot hook armed), (2) ``LiveServer.maybe_swap`` (pick up
any snapshot the slice published), then (3) one continuous-batching decode
boundary. Because the swap sits BETWEEN boundaries, every token batch is
computed under exactly one parameter version.

The loop measures the two quantities the reference's benchmark claims:

- **boundary interval**: wall seconds per decode boundary (the swap-pause
  budget: a swap must cost less than one boundary or serving visibly
  stalls);
- **snapshot staleness**: trainer step now minus the train step of the
  weights being served, sampled each boundary once the server has swapped
  at least once (before that the server runs its initial weights and
  staleness is undefined).

On a CUDA serving device the loop synchronises the card before it starts
the boundary's clock (and ``LiveServer.maybe_swap`` around its timed span):
the training slice only enqueues its kernels, and the batcher's per-boundary
argmax read would otherwise bill the training step's device time to the
decode boundary. On the CPU the loop is the reference's.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch


def device_sync(device) -> Callable[[], None]:
    """A function that waits for ``device``'s queued work: the CUDA
    synchronise of a CUDA device, nothing elsewhere."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return lambda: torch.cuda.synchronize(dev)
    return lambda: None


class TrainServeLoop:
    """Drive a ContinuousBatcher with a training slice per boundary.

    ``train_fn(boundary) -> int`` runs this boundary's training slice and
    returns the trainer's CURRENT host step count (used for staleness). None
    serves frozen weights (no training, no swaps beyond what is already on
    the bus).
    """

    def __init__(self, server, batcher, train_fn: Optional[Callable[[int], int]] = None):
        self.server = server
        self.batcher = batcher
        self.train_fn = train_fn
        # both loop quantities ride the server's MetricsSink (repro_torch.obs):
        # boundary intervals and snapshot staleness are histogram
        # observations; the attributes below are live views
        self.metrics = server.metrics
        self._sync = device_sync(getattr(server.program, "device", None))

    @property
    def boundary_times(self) -> List[float]:
        return self.metrics.samples("boundary_interval_s")

    @property
    def staleness(self) -> List[int]:
        return self.metrics.samples("snapshot_staleness_steps")

    def run(self, boundaries: int) -> None:
        for _ in range(boundaries):
            if self.batcher.pos >= self.batcher.max_len:
                break
            t = self.batcher.boundaries_run
            step_now = self.train_fn(t) if self.train_fn is not None else None
            self.server.maybe_swap()
            if step_now is not None and self.server.train_step >= 0:
                self.metrics.observe("snapshot_staleness_steps",
                                     step_now - self.server.train_step)
            # time the DECODE boundary alone (train slice + swap excluded):
            # the swap-pause claim budgets against this interval, so folding
            # the training slice in would flatter it
            self._sync()
            t0 = time.perf_counter()
            self.batcher.step(t)
            self.metrics.observe("boundary_interval_s", time.perf_counter() - t0)

    def summary(self) -> dict:
        bt = np.array(self.boundary_times or [0.0], np.float64)
        out = {"boundaries": len(self.boundary_times),
               "boundary_interval_mean_s": float(bt.mean()),
               "boundary_interval_p50_s": float(np.percentile(bt, 50))}
        out.update(self.server.swap_stats())
        if self.staleness:
            st = np.array(self.staleness, np.float64)
            out["staleness_mean_steps"] = float(st.mean())
            out["staleness_max_steps"] = int(st.max())
        return out
