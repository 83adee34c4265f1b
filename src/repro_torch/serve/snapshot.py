"""SnapshotBus — atomic, double-buffered consensus snapshots for serving
(port of ``repro.serve.snapshot``).

Training publishes the consensus (worker-averaged) parameters; the serving
side (:class:`repro_torch.serve.LiveServer`) hot-swaps to the latest
snapshot between decode batches. The bus is the only coupling between the
two loops.

- **Consensus on the flat plane.** :meth:`SnapshotBus.publish_state` reduces
  the resident ``{bucket: [W, total]}`` buffers with
  :func:`repro_torch.serving.engine.consensus_bufs` into fresh
  single-replica buffers; pytree views appear only when a consumer asks
  (:attr:`Snapshot.params`).
- **Atomic double buffering.** Publishes alternate between two slots: the new
  snapshot is fully built in the non-head slot, then the head index flips
  in one assignment. A reader holding a snapshot keeps it intact across
  later publishes: the buffers are fresh tensors that nothing writes.
- ``Snapshot.save``/``load`` is the checkpoint-v2 file form
  (``theta::<bucket>`` planes, the FlatSpec manifest and a ``snapshot``
  provenance block, :mod:`repro_torch.checkpoint.io`), the reference's
  file.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import io
from repro_torch.checkpoint.io import flat_spec_manifest
from repro_torch.common.flat import FlatSpec

PyTree = Any
Buffers = Dict[str, torch.Tensor]


FINITE_CHUNK = 1 << 26   # elements a finiteness check looks at at once


def all_finite(v: torch.Tensor) -> bool:
    """``torch.isfinite(v).all()`` over chunks of ``FINITE_CHUNK`` elements:
    a whole-bucket check would make a bool temporary as long as the bucket
    (15.7 GB for DeepSeek-V2-Lite's 15.7e9 bf16 parameters)."""
    flat = v.reshape(-1)
    oks = [torch.isfinite(flat[i:i + FINITE_CHUNK]).all()
           for i in range(0, flat.numel(), FINITE_CHUNK)]
    return bool(torch.stack(oks).all()) if oks else True


def snapshot_valid(bufs: Buffers, spec0: FlatSpec) -> Tuple[bool, str]:
    """(ok, reason): is this a servable consensus snapshot? Checks the
    manifest (every spec bucket present with its exact flat length) and that
    every float buffer is fully finite: a diverged or fault-corrupted
    training state must never reach the decode engine (the bus and the
    server pin the last good snapshot instead)."""
    totals = spec0.totals
    if set(bufs) != set(totals):
        return False, (f"bucket mismatch: snapshot has {sorted(bufs)}, "
                       f"spec expects {sorted(totals)}")
    for k, v in bufs.items():
        if tuple(v.shape) != (totals[k],):
            return False, (f"bucket {k!r} shape {tuple(v.shape)} != "
                           f"({totals[k]},)")
        if v.dtype.is_floating_point and not all_finite(v):
            return False, f"bucket {k!r} contains non-finite values"
    return True, ""


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published consensus snapshot (immutable).

    seq:        monotonic publish sequence number (bus-wide)
    train_step: facade train step that produced the parameters
    bufs:       single-replica consensus flat buffers, ``{bucket: [total]}``
    manifest:   JSON FlatSpec manifest (checkpoint-v2 metadata form)
    spec:       the lead-() FlatSpec the buffers unflatten through
    """
    seq: int
    train_step: int
    bufs: Buffers
    manifest: dict
    spec: FlatSpec

    @property
    def params(self) -> PyTree:
        """Parameter tree as slice/reshape views of the flat buffers."""
        return self.spec.unflatten(self.bufs)

    def save(self, path: str) -> None:
        """Persist atomically in checkpoint format v2 (``theta::<bucket>``
        planes, the FlatSpec manifest, ``snapshot`` provenance)."""
        io.save(path, {"theta": self.bufs},
                meta={"format": io.FLAT_FORMAT, "flat_spec": self.manifest,
                      "snapshot": {"seq": self.seq, "train_step": self.train_step}})

    @staticmethod
    def load(path: str, spec: FlatSpec, device="cuda") -> "Snapshot":
        """Read a saved snapshot back against ``spec`` (any lead shape: the
        lead-() layout is what is checked and loaded) onto ``device``. A
        manifest that differs from the spec's refuses, as
        ``restore_state`` does."""
        spec0 = spec.with_lead(())
        meta = io.load_meta(path) or {}
        io.check_manifest(meta, spec0, path)
        prefix = "theta" + io.SEP
        bufs = {k[len(prefix):]: io.to_tensor(v, device)
                for k, v in io.load_payload(path).items() if k.startswith(prefix)}
        if set(bufs) != set(spec0.totals):
            raise ValueError(f"snapshot payload buckets {sorted(bufs)} do not match the "
                             f"spec's {sorted(spec0.totals)}: {path}")
        prov = meta.get("snapshot", {})
        return Snapshot(seq=int(prov.get("seq", 0)),
                        train_step=int(prov.get("train_step", 0)),
                        bufs=bufs, manifest=flat_spec_manifest(spec0), spec=spec0)


class SnapshotBus:
    """Single-producer, many-reader snapshot mailbox (double-buffered).

    The producer is a training loop (:meth:`publish_state`) or a caller with
    a parameter tree (:meth:`publish_params`); readers call :meth:`latest`
    whenever they want the freshest consensus, typically
    ``LiveServer.maybe_swap`` between decode batches.
    """

    def __init__(self):
        self._slots: list = [None, None]
        self._head: int = -1     # index of the slot holding the latest publish
        self._seq: int = 0       # last published sequence number (0 = none)
        self.rejected: int = 0   # publishes refused by validation

    def _publish(self, bufs: Buffers, spec0: FlatSpec,
                 train_step: int) -> Optional[Snapshot]:
        ok, why = snapshot_valid(bufs, spec0)
        if not ok:
            # a bad publish never flips the head: every reader keeps the
            # last good snapshot
            self.rejected += 1
            warnings.warn(
                f"SnapshotBus rejected publish at train step {train_step}: "
                f"{why} — serving keeps snapshot seq={self._seq}",
                RuntimeWarning, stacklevel=3)
            return None
        snap = Snapshot(seq=self._seq + 1, train_step=int(train_step),
                        bufs=bufs, manifest=flat_spec_manifest(spec0), spec=spec0)
        back = 1 - self._head if self._head >= 0 else 0
        self._slots[back] = snap     # fully built before the flip
        self._head = back            # the atomic publish: one int assignment
        self._seq = snap.seq
        return snap

    def publish_state(self, state, train_step: int = 0) -> Optional[Snapshot]:
        """Publish the consensus of a flat-resident trainer state
        (:class:`repro_torch.api.FlatState`): the mean over the ``W``
        replica rows, computed on the flat plane into fresh buffers. Returns
        None (and counts :attr:`rejected`) when validation refuses it."""
        from repro_torch.serving.engine import consensus_bufs
        return self._publish(consensus_bufs(state.theta),
                             state.spec.with_lead(()), train_step)

    def publish_bufs(self, bufs: Buffers, spec, train_step: int = 0) -> Optional[Snapshot]:
        """Publish single-replica consensus buffers ``{bucket: [total]}``
        already reduced by the caller (the dist engine's sum over its ranks)
        under ``spec`` (lead shape ``()``). The buffers are taken as they
        are: nothing may write them afterwards."""
        return self._publish(bufs, spec, train_step)

    def publish_params(self, params: PyTree, train_step: int = 0) -> Optional[Snapshot]:
        """Publish a single-replica parameter tree directly (no trainer in
        the loop: the serve_decode entry point, or restored weights). The
        tree is flattened into fresh buffers."""
        spec0 = FlatSpec.build(params, leading=0)
        return self._publish(spec0.flatten(params), spec0, train_step)

    def latest(self) -> Optional[Snapshot]:
        """The most recently published snapshot, or None before the first
        publish. Holding it across later publishes is safe."""
        head = self._head
        return self._slots[head] if head >= 0 else None

    @property
    def seq(self) -> int:
        """Sequence number of the latest publish (0 before any)."""
        return self._seq
