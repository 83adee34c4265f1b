"""The serving side of train-while-serve (port of ``repro.serve``).

Consensus snapshots travel on a :class:`SnapshotBus`; a :class:`LiveServer`
hot-swaps a ``ServeProgram`` to the latest one between decode batches; a
:class:`ContinuousBatcher` keeps the decode batch full against a
hash-seeded, restart-exact request stream (:class:`TrafficGen`). The
reference's ``TrainServeLoop`` (training the LM while serving it) comes
with a later slice (ROADMAP.md).
"""
from repro_torch.serve.live import LiveServer
from repro_torch.serve.snapshot import Snapshot, SnapshotBus, snapshot_valid
from repro_torch.serve.traffic import ContinuousBatcher, Request, TrafficGen

__all__ = ["Snapshot", "SnapshotBus", "snapshot_valid", "LiveServer",
           "ContinuousBatcher", "Request", "TrafficGen"]
