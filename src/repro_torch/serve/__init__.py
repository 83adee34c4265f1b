"""The train-while-serve loop (port of ``repro.serve``).

Training and serving share one process: training publishes consensus
snapshots of the resident flat buffers onto a :class:`SnapshotBus` (the
``publish_every`` hook of ``repro_torch.api.GossipTrainer``), a
:class:`LiveServer` hot-swaps a ``ServeProgram`` to the latest one between
decode batches, and a :class:`ContinuousBatcher` keeps the decode batch full
against a hash-seeded, restart-exact request stream (:class:`TrafficGen`).
:class:`TrainServeLoop` interleaves the two and measures the swap pause,
the decode-boundary interval and the snapshot staleness.
"""
from repro_torch.serve.live import LiveServer
from repro_torch.serve.loop import TrainServeLoop
from repro_torch.serve.snapshot import Snapshot, SnapshotBus, snapshot_valid
from repro_torch.serve.traffic import ContinuousBatcher, Request, TrafficGen

__all__ = ["Snapshot", "SnapshotBus", "snapshot_valid", "LiveServer",
           "TrainServeLoop", "ContinuousBatcher", "Request", "TrafficGen"]
