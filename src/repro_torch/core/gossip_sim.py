"""Simulation engine: exact Algorithms 1-6 on stacked replicas (port of
``repro.core.gossip_sim``).

Replicas live RESIDENT on the flat parameter plane: the state is a
:class:`repro_torch.api.state.FlatState` whose params and velocity are ONE
lane-aligned ``[W, total]`` buffer per dtype bucket, flattened once at
:meth:`SimTrainer.init`. One step does: per-worker losses and gradients
(``torch.func.vmap`` of ``grad_and_value`` over the buffer rows; the loss
reads slice views, so gradients arrive flat), the protocol's gradient
transform, the participation gate and peer draw, the mixing matmul per
bucket, and the optimizer update. On the fused path (pairwise protocols with
NAG) the update is kernel B1 (:mod:`repro_torch.kernels.fused_update`): one
pass for Alg. 5 lines 3, 7 and 9 that writes theta and velocity in place.
The unfused path is kept as its parity target.

With a codec (:mod:`repro_torch.comm`, ``ProtocolConfig(codec="q8" |
"topk")``) peers mix against ``decode(encode(theta))``: kernels B4/B5 or
B6/B7 on the card, once per bucket on every step (see
:meth:`SimTrainer._codec_transmit`).

With a fault plane (``faults=FaultConfig(...)``, :mod:`repro_torch.faults`)
the wire boundary of the step injects the fault model's faults: Byzantine
rows garble what they publish, corrupted wires go through the checksummed
uint8 wire and fail verification, and the drop and corrupt masks reach
``comm_update`` as a :class:`~repro_torch.api.protocols.WireFaults`, which
discards those wires. Every mask is a hash of the device step counter: no
host sync. The robust protocols (``clipped_gossip``/``trimmed_gossip``)
run kernel B8 inside their ``comm_update``.

With a fleet plane (``fleet=FleetConfig(...)``, :mod:`repro_torch.fleet`)
a token-account flow control masks who may initiate, and ``partition=P``
mixes one hash-scheduled chunk of the plane per exchange
(:func:`repro_torch.fleet.partition.partitioned_comm_update`; the robust
protocols run B8 once per chunk on its column slice). The all-default
config adds no work.

With a sharded plane (``shard=ShardConfig(n_shards=S)``,
:mod:`repro_torch.shard`) every bucket is padded at its tail to S equal
codec-block-aligned shards; the codec encodes the ``[W * S, shard_size]``
shard rows (a view of the plane), row ``w * S + s`` seeded by
``w * S + s`` as a sharded dist rank does, and ``comm_bytes`` counts the
per-device wire (the whole wire over S). The all-default config adds no
work.

The step updates ``state.theta`` and ``state.opt.mu`` IN PLACE (the
reference donates the state to its jitted step instead) and advances the
state's generator. Its ``worker_mask`` and ``defer_comm`` hooks are the
async engine's (:mod:`repro_torch.core.gossip_async`): only in-window
workers initiate and commit (B1 runs on the window's rows only), and in
message mode the in-step mixing is skipped.

An observer (:mod:`repro_torch.obs`, ``self.obs``, attached by the facade)
records each step from host values: the draws the step consumed
(:attr:`SimTrainer.last_draws`) and the pre-step flow balances. Without
one the step does no host work for it.
"""
from __future__ import annotations

import inspect
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch import comm
from repro_torch.api import registry
from repro_torch.api.state import FlatState
from repro_torch.common import flat as flat_plane
from repro_torch.common.config import OptimizerConfig, ProtocolConfig
from repro_torch.common.precision import full_f32
from repro_torch.common.pytree import tree_take_leading
from repro_torch.core import protocols
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import (OptState, _clip, make_optimizer,
                                          param_update, velocity_update)
from repro_torch.optim.schedule import lr_at
from repro_torch.serving.engine import consensus_params

PyTree = Any


def _store(bufs: dict, k: str, new: torch.Tensor) -> None:
    """Write ``new`` into the resident buffer ``bufs[k]`` in place. Where the
    reference's promotion changed the dtype (on the unfused path a bf16
    bucket's params and velocity come out f32, see
    :func:`repro_torch.optim.optimizers._scaled`), the buffer is replaced,
    as the reference's state changes dtype there too."""
    if new.dtype == bufs[k].dtype:
        bufs[k].copy_(new)
    else:
        bufs[k] = new


class SimTrainer:
    """Single-controller trainer over W simulated workers.

    loss_fn(params, x, y) -> scalar loss for ONE worker's replica/batch
    (``params`` is the single-replica pytree view of the resident plane).
    """

    # the host-resident plane (repro_torch.fleet.hostplane) needs the async
    # engine's event windows
    _supports_host_plane = False

    def __init__(self, loss_fn: Callable, num_workers: int,
                 protocol: ProtocolConfig, optimizer: OptimizerConfig,
                 fused_update: bool = True, faults=None, fleet=None, shard=None):
        self.loss_fn = loss_fn
        self.num_workers = num_workers
        self.protocol = protocol
        self.optimizer_cfg = optimizer
        self.optimizer = make_optimizer(optimizer)
        self._impl = registry.resolve(protocol)
        # fused flat-plane path (one pass for Alg. 5 lines 3/7/9): pairwise
        # protocols + NAG only
        self.fused_update = (fused_update and optimizer.name == "nag"
                             and self._impl.pairwise)
        # gossip-compression codec: pairwise protocols only (enforced by
        # Protocol.__init__); None when cfg.codec == "none"
        self.codec = comm.active_codec(protocol)
        # message-level fault plane: hash-seeded drop/corrupt masks and
        # Byzantine garbling at the wire boundary; None adds no work
        self.faults = faults
        self.fault_model = None
        if faults is not None:
            from repro_torch.faults import resolve_fault_model
            self.fault_model = resolve_fault_model(faults)
        # a registered protocol may override comm_update without the
        # wire_faults kwarg; one that discards wires then cannot honour the
        # fault plane, so it is refused here rather than over-counted later
        try:
            params = inspect.signature(self._impl.comm_update).parameters.values()
            self._pass_wire_faults = any(
                p.name == "wire_faults" or p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params)
        except (TypeError, ValueError):
            self._pass_wire_faults = False
        fm = self.fault_model
        if (fm is not None and (fm.injects_drop or fm.injects_corrupt)
                and self._impl.pairwise and not self._pass_wire_faults):
            raise ValueError(
                f"fault model {fm.name!r} discards wires, but protocol "
                f"{protocol.method!r} overrides comm_update without a "
                "wire_faults kwarg — it cannot honor the discard")
        # fleet plane: partitioned exchanges and token-account flow control
        # (the all-default FleetConfig is inert)
        self.fleet = fleet
        self.flow = None
        self.partition = 1
        self._plans: dict = {}
        self._col_chunks: dict = {}
        if fleet is not None and fleet.enabled():
            from repro_torch.fleet import flow as fleet_flow
            self.flow = fleet_flow.resolve_flow_control(fleet)
            self.partition = int(fleet.partition)
            if self.partition < 1:
                raise ValueError(f"partition must be >= 1, got {fleet.partition}")
            if self.partition > 1 and not self._impl.pairwise:
                raise ValueError(
                    f"partitioned exchanges need a pairwise protocol; "
                    f"{protocol.method!r} is not pairwise")
            if fleet.plane == "host" and not self._supports_host_plane:
                raise ValueError(
                    "plane='host' (host-resident FlatState) requires the "
                    "async engine — use GossipTrainer(engine='async')")
        # sharded plane: bucket totals split into equal column shards; the
        # all-default ShardConfig builds no layout and adds no work
        self.shard = shard
        self.shard_layout = None
        if shard is not None and shard.enabled():
            if not self._impl.pairwise:
                raise ValueError(
                    f"sharded plane (repro.shard) needs a pairwise protocol; "
                    f"{protocol.method!r} is not pairwise")
            if faults is not None:
                raise ValueError(
                    "the fault plane (repro.faults) garbles/checksums whole "
                    "replica wires; it does not compose with the sharded "
                    "plane (repro.shard) yet")
            if fleet is not None and fleet.enabled() and fleet.plane == "host":
                raise ValueError(
                    "plane='host' streams whole host rows; it does not "
                    "compose with the sharded plane (repro.shard) yet")
        # the (gate, peers) the last step drew, before any window or flow
        # mask: the async engine's clock program, dispatcher and host plane
        # read them, as the reference re-derives them from the pre-step key
        self.last_draws = None
        # telemetry plane: attached by the facade; None does no host work
        self.obs = None

    def _wire_bytes(self, spec: flat_plane.FlatSpec) -> float:
        """Exact per-replica wire bytes: raw, the unpadded slot sizes (the
        resident buffers carry lane padding, which never ships); with a
        codec, its wire of the padded plane (what actually ships). Under a
        sharded plane, the per-device wire: the whole wire over S (equal
        quantum-aligned shards; raw shards sum exactly to the whole)."""
        if self.codec is None:
            wire = float(sum(s.size * s.dtype.itemsize for s in spec.slots))
        else:
            wire = float(comm.wire_param_bytes(self.codec, spec))
        if self.shard_layout is not None:
            wire /= self.shard_layout.n_shards
        return wire

    def _fleet_plan(self, spec: flat_plane.FlatSpec):
        """Static PartitionPlan for ``spec`` (cached per spec). Chunks lie
        on the whole (shard-padded) totals; under a sharded plane each
        device ships its 1/S of the chunk, so the chunk wires scale by 1/S."""
        plan = self._plans.get(spec)
        if plan is None:
            import dataclasses
            from repro_torch.fleet.partition import build_plan
            plan = build_plan(spec, self.partition, self.codec)
            if self.shard_layout is not None:
                S = self.shard_layout.n_shards
                plan = dataclasses.replace(plan, wire_bytes=tuple(w / S for w in plan.wire_bytes))
            self._plans[spec] = plan
        return plan

    def _col_gate(self, state: FlatState, part_ids: torch.Tensor) -> dict:
        """{bucket: bool[W, N]}: column j of worker w is in the chunk w ships
        this step (the codec residual advances only there)."""
        plan = self._fleet_plan(state.spec)
        out = {}
        for b, buf in state.theta.items():
            cols = self._col_chunks.get((state.spec, b))
            if cols is None or cols.device != buf.device:
                cols = torch.as_tensor(plan.col_chunks(b, buf.shape[1]), device=buf.device)
                self._col_chunks[(state.spec, b)] = cols
            out[b] = part_ids[:, None] == cols[None, :]
        return out

    def _fleet_proto_seed(self, proto, device):
        """Seed the fleet-plane ProtocolState fields (the step replaces them)."""
        if self.flow is not None:
            proto = proto._replace(
                tokens=self.flow.init_tokens(self.num_workers, device),
                flow_skipped=torch.zeros((), dtype=torch.int32, device=device))
        if self.partition > 1:
            proto = proto._replace(
                chunk_units=torch.zeros(self.partition, dtype=torch.int32, device=device))
        return proto

    def init(self, params_stack: PyTree, seed: int = 0) -> FlatState:
        """Flatten ONCE into fresh resident buffers on the params' device;
        the generator for the gate and peer draws is seeded with ``seed``."""
        spec = flat_plane.FlatSpec.build(params_stack, leading=1)
        theta = spec.flatten(params_stack)
        if self.shard is not None and self.shard.enabled():
            # pad every bucket's tail to S equal quantum-aligned shards and
            # bind the spec to the padded totals: the optimizer, protocol
            # and residual buffers follow the padded widths
            from repro_torch import shard as shard_plane
            self.shard_layout = shard_plane.build_layout(spec, self.shard, self.codec)
            spec = shard_plane.padded_spec(spec, self.shard_layout)
            theta = shard_plane.pad_bufs(theta, self.shard_layout)
        dev = next(iter(theta.values())).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        proto = self._impl.init_state(theta)
        if self.fault_model is not None:
            # seed the fault counters so the state's fields are stable
            # across steps (comm_update replaces them)
            proto = proto._replace(
                wire_dropped=torch.zeros((), dtype=torch.int32, device=dev),
                wire_corrupt=torch.zeros((), dtype=torch.int32, device=dev))
        proto = self._fleet_proto_seed(proto, dev)
        return FlatState(
            spec=spec,
            theta=theta,
            opt=self.optimizer.init(theta),
            proto=proto,
            comm=comm.init_comm_state(self.codec, theta),
            key=gen,
            step=torch.zeros((), dtype=torch.int32, device=dev))

    def _codec_transmit(self, state: FlatState, active: torch.Tensor, publish=None,
                        col_gate=None):
        """decode(encode(publish)) on the resident plane: what peers RECEIVE
        this round, plus the advanced error-feedback residual. ``publish``
        is what the workers put on the wire (``state.theta``, or the fault
        model's Byzantine garbling of it). Seeds derive from (comm round
        counter before this step, worker index), as in the reference.

        The reference skips the pass with ``lax.cond`` when nobody fires;
        here it runs on every step, since branching on ``active.any()``
        would sync the host each step. Nothing changes for that: on a step
        where nobody fires the identity mix has a zero off-diagonal, so
        ``apply_mix_split`` returns theta, and the residual advances only
        for rows whose own gate fired (``roundtrip_bufs(gate=)``), so it is
        carried unchanged. ``col_gate`` (``{bucket: bool[W, N]}``, the
        partition plane) restricts the residual advance to the columns of
        the chunk each worker shipped. Returns (transmit, CommState').

        Under a sharded plane the codec runs per SHARD: the buffers are
        viewed as ``[W * S, shard_size]`` rows (block-aligned, so the block
        layout is that of the whole-plane encode), row ``w * S + s`` seeded
        by ``w * S + s``, the stream a sharded dist rank uses."""
        codec = self.codec
        layout = self.shard_layout
        if publish is None:
            publish = state.theta
        rows = self.num_workers
        res = state.comm.residual if codec.stateful else None
        gate = active
        if layout is not None:
            rows *= layout.n_shards
            publish = layout.shard_rows(publish)
            res = layout.shard_rows(res) if res is not None else None
            gate = torch.repeat_interleave(active, layout.n_shards)
            if col_gate is not None:
                col_gate = layout.shard_rows(col_gate)
        seeds = comm.codec_seeds(state.proto.comm_rounds,
                                 torch.arange(rows, device=active.device))
        gate = gate.reshape(-1, 1)
        if col_gate is not None:
            gate = {k: gate & col_gate[k] for k in publish}
        hat, new_res = comm.roundtrip_bufs(codec, publish, seeds, res, gate=gate)
        if layout is not None:
            hat = layout.unshard_rows(hat)
            new_res = layout.unshard_rows(new_res) if new_res is not None else None
        # decode reconstructs in f32; the wire mixes in the storage dtype
        hat = {k: v.to(state.theta[k].dtype) for k, v in hat.items()}
        return hat, (comm.CommState(new_res) if codec.stateful else state.comm)

    def _codec_transmit_checked(self, state: FlatState, active: torch.Tensor,
                                publish, corrupt_mask: torch.Tensor, col_gate=None):
        """:meth:`_codec_transmit` through the PACKED uint8 wire with a
        checksum tail and in-flight corruption: per bucket (sorted order,
        salt ``SALT_BYTE + i``), encode -> pack -> append checksum ->
        corrupt -> verify -> unpack -> decode. Returns (transmit,
        CommState', ok bool[W]); rows failing verification are zeroed (the
        mix discards them; zeroing keeps NaN bytes out of the matmul).

        Like :meth:`_codec_transmit` it runs on every step, where the
        reference skips it with ``lax.cond`` when nobody fires. On such a
        step the result cannot differ: the identity mix ignores the
        transmit, ``discard_lost`` of the identity is the identity, the
        residual advances only for fired rows, and the fault counters count
        only ``active & mask``, so a corrupted row that nobody engaged adds
        nothing."""
        from repro_torch.faults import wire as fwire
        from repro_torch.faults.models import SALT_BYTE
        codec = self.codec
        if publish is None:
            publish = state.theta
        seeds = comm.codec_seeds(state.proto.comm_rounds,
                                 torch.arange(self.num_workers, device=active.device))
        gate = active.reshape(-1, 1)
        res_bufs = (state.comm.residual if codec.stateful else None) or {}
        hat, new_res, ok = {}, {}, None
        for i, k in enumerate(sorted(publish)):
            b = publish[k]
            r = res_bufs.get(k)
            if r is None and codec.stateful:
                r = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
            wire_arrays, r2 = codec.encode(b, seeds, r)
            packed = fwire.append_checksum(codec.pack(wire_arrays))
            packed = fwire.corrupt_wire(packed, corrupt_mask, self.faults.seed,
                                        state.step, SALT_BYTE + i)
            payload, ok_b = fwire.verify_strip(packed)
            dec = codec.decode(codec.unpack(payload, b.shape[1]), b.shape[1])
            dec = torch.where(ok_b[:, None], dec, torch.zeros((), dtype=dec.dtype,
                                                              device=dec.device))
            hat[k] = dec.to(state.theta[k].dtype)
            ok = ok_b if ok is None else ok & ok_b
            if codec.stateful:
                g = gate if col_gate is None else gate & col_gate[k]
                new_res[k] = torch.where(g, r2, r)
        comm_new = comm.CommState(new_res) if codec.stateful else state.comm
        return hat, comm_new, ok

    def _wire_faults(self, state: FlatState, active: torch.Tensor, col_gate=None):
        """The wire boundary of a step under a fault plane: Byzantine rows
        garble what they publish, corrupted wires cross the checksummed
        uint8 wire, drop and corrupt masks are hashes of the device step
        counter. Returns (transmit or None, CommState', WireFaults or
        None)."""
        from repro_torch.api.protocols import WireFaults
        fm, W = self.fault_model, self.num_workers
        publish = corrupt_mask = dropped = detected = None
        if fm.injects_byzantine and fm.num_byzantine(W) > 0:
            publish = fm.garble_bufs(state.theta, state.step, W)
        if fm.injects_corrupt:
            corrupt_mask = fm.corrupt_mask_dev(state.step, W)
        if fm.injects_drop:
            dropped = fm.drop_mask_dev(state.step, W)

        comm_new = state.comm
        if self.codec is not None:
            if corrupt_mask is not None:
                transmit, comm_new, ok = self._codec_transmit_checked(
                    state, active, publish, corrupt_mask, col_gate)
                detected = ~ok
            else:
                transmit, comm_new = self._codec_transmit(state, active, publish, col_gate)
        elif corrupt_mask is not None:
            # uncompressed wire: bitcast -> checksum -> corrupt -> verify
            from repro_torch.faults import wire as fwire
            transmit, ok = fwire.corrupt_roundtrip_bufs(
                publish if publish is not None else state.theta,
                corrupt_mask, self.faults.seed, state.step)
            detected = ~ok
        else:
            # Byzantine garbage (or nothing) rides the uncompressed wire
            transmit = publish
        wire_faults = None
        if dropped is not None or detected is not None:
            wire_faults = WireFaults(dropped=dropped, corrupt=detected)
        return transmit, comm_new, wire_faults

    # -- one synchronous step across all workers ---------------------------
    def _grads(self, state: FlatState, x, y):
        """Per-worker (loss, flat gradients): the loss reads the single-
        replica views of its buffer row."""
        row_spec = state.spec.with_lead(())

        def one_loss(bufs, xi, yi):
            return self.loss_fn(row_spec.views(bufs), xi, yi)

        with full_f32():   # forward and backward: no TF32 in between
            grads, losses = vmap(grad_and_value(one_loss))(state.theta, x, y)
        return losses, {k: g.contiguous() for k, g in grads.items()}

    def step(self, state: FlatState, x, y, draws: Optional[Tuple[Any, Any]] = None):
        """One synchronous step over the stacked workers; returns (state',
        metrics). See :meth:`_step`. With an observer attached, it records
        the step from what the step consumed (the draws, the pre-step step
        counter and flow balances; the step replaces both, never writes
        them), without a host sync."""
        if self.obs is None:
            return self._step(state, x, y, draws=draws)
        t_start = self.obs.now()
        step0, tokens0 = state.step, state.proto.tokens
        state, m = self._step(state, x, y, draws=draws)
        self.obs.on_sim_step(self, t_start, step0, tokens0)
        return state, m

    def _step(self, state: FlatState, x, y,
              draws: Optional[Tuple[Any, Any]] = None, worker_mask=None,
              defer_comm: bool = False):
        """One step over the stacked workers; returns (state', metrics).

        ``draws=(gate, peers)`` replaces this step's own gate and peer draws
        (the parity hook the tests use to inject the reference's draws);
        without it both come from ``state.key``, gate first. Either way they
        are kept in :attr:`last_draws`.

        ``worker_mask`` (bool[W], host or device) is the async engine's
        event window: only in-window workers may initiate an exchange
        (``active &= mask``, before the flow gate) and commit their update;
        out-of-window rows of theta and velocity keep their bits (B1 runs on
        the window's rows only), ``loss_mean`` is over the window and
        ``loss_max`` is -inf outside it. ``defer_comm`` (message mode) skips
        the in-step mixing: exchanges ride the async engine's wire queue.
        With neither, this is the synchronous step."""
        cfg = self.protocol
        W = self.num_workers
        dev = state.step.device
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev)
        mask = rows = None
        if worker_mask is not None:
            m = worker_mask.cpu() if isinstance(worker_mask, torch.Tensor) else worker_mask
            m = np.asarray(m, bool).reshape(W)
            mask = torch.as_tensor(m, device=dev)
            rows = torch.as_tensor(np.flatnonzero(m).astype(np.int32), device=dev)

        # gradient-related component (Alg. 5 line 2), per worker
        losses, grads = self._grads(state, x, y)
        # the mixing matmul in f32 too, whatever the process allows
        with torch.no_grad(), full_f32():
            grads = protocols.gradient_transform(cfg, grads)
            if draws is None:
                active = protocols.comm_gate(cfg, state.key, state.step, W)
                peers = (self._impl.sample_peers(state.key, W)
                         if self._impl.pairwise else None)
            else:
                active = torch.as_tensor(draws[0], device=dev).bool()
                peers = torch.as_tensor(draws[1], device=dev)
            self.last_draws = (active, peers)
            if mask is not None:
                # only in-window workers INITIATE; out-of-window workers
                # still respond passively with their last published row
                active = active & mask

            # token-account flow control: a worker whose gate fired but
            # whose account cannot cover the spend skips the initiation
            proto0 = state.proto
            if self.flow is not None:
                allowed = self.flow.allow(state.step, proto0.tokens)
                skipped = torch.sum((active & ~allowed).to(torch.int32)).to(torch.int32)
                active = active & allowed
                stepped = mask if mask is not None else torch.ones(W, dtype=torch.bool,
                                                                   device=dev)
                proto0 = proto0._replace(
                    tokens=self.flow.update(proto0.tokens, stepped, active),
                    flow_skipped=proto0.flow_skipped + skipped)
            if defer_comm:
                # message mode: the step keeps its draws and the local
                # update, and mixes nothing
                return self._step_epilogue(state, state.theta, proto0, state.comm,
                                           grads, losses, active, mask, rows)

            # partition plane: the hash-scheduled chunk of each initiator
            part_ids = col_gate = None
            if self.partition > 1:
                from repro_torch.fleet.partition import partition_ids
                part_ids = partition_ids(self.fleet.seed, state.step, W, self.partition)
                if self.codec is not None:
                    col_gate = self._col_gate(state, part_ids)

            # communication-related component (lines 4-8), one mixing matmul
            # per dtype bucket on the resident buffers; peers read the
            # codec's reconstruction when a codec rides the wire, and the
            # fault plane garbles, corrupts or drops wires at this boundary
            transmit, comm_new, wire_faults = None, state.comm, None
            if self.fault_model is not None:
                transmit, comm_new, wire_faults = self._wire_faults(state, active, col_gate)
            elif self.codec is not None:
                transmit, comm_new = self._codec_transmit(state, active, col_gate=col_gate)
            if part_ids is not None:
                from repro_torch.fleet.partition import partitioned_comm_update
                theta_comm, proto_new = partitioned_comm_update(
                    self._impl, active, state.theta, proto0, peers=peers, step=state.step,
                    transmit=transmit, wire_faults=wire_faults, part_ids=part_ids,
                    plan=self._fleet_plan(state.spec))
            else:
                theta_comm, proto_new = protocols.comm_update(
                    cfg, state.key, active, state.theta, proto0, step=state.step,
                    transmit=transmit, wire_bytes=self._wire_bytes(state.spec),
                    peers=peers, wire_faults=wire_faults)
            return self._step_epilogue(state, theta_comm, proto_new, comm_new,
                                       grads, losses, active, mask, rows)

    def _step_epilogue(self, state, theta_comm, proto_new, comm_new, grads,
                       losses, active, mask=None, rows=None):
        """Optimizer update + metrics; writes state.theta / state.opt.mu (on
        a window, only the rows in ``mask`` / ``rows``)."""
        ocfg = self.optimizer_cfg
        if self.fused_update:
            # lines 3, 7 and 9 in ONE in-place pass per dtype bucket. peer :=
            # theta_comm with coef := 1 makes the elastic term exactly the
            # comm displacement theta_comm - theta, for ANY pairwise mixing.
            grads_c = _clip(ocfg, grads)
            eta = lr_at(ocfg, state.opt.step)
            ops.fused_bufs_elastic_nag(
                state.theta, theta_comm, state.opt.mu, grads_c,
                torch.ones(self.num_workers, dtype=torch.float32,
                           device=state.step.device),
                eta, ocfg.momentum, rows=rows)
            opt_new = OptState(state.opt.step + 1, state.opt.mu, {})
        else:
            # per-bucket reference path (the fused path's parity target)
            comm_delta = {k: theta_comm[k] - state.theta[k] for k in state.theta}
            if ocfg.name == "nag":
                v_new, opt_new = velocity_update(ocfg, state.opt, grads)
                # the -eta*g term takes the clipped grads too, as
                # make_optimizer("nag") and the fused path do
                theta_grad = param_update(ocfg, state.opt.step, state.theta,
                                          _clip(ocfg, grads), v_new)
            else:
                theta_grad, opt_new = self.optimizer.update(grads, state.opt, state.theta)
            keep = None if mask is None else mask.reshape(-1, 1)
            for k in state.theta:
                new = theta_grad[k] + comm_delta[k].to(theta_grad[k].dtype)
                if keep is not None:
                    new = torch.where(keep, new, state.theta[k])
                _store(state.theta, k, new)
            # the moments stay resident: velocity / first moment in opt.mu,
            # adamw's second moment in opt.nu
            for field in ("mu", "nu"):
                new = getattr(opt_new, field)
                if new:
                    old = getattr(state.opt, field)
                    for k in old:
                        _store(old, k, new[k] if keep is None
                               else torch.where(keep, new[k], old[k]))
                    opt_new = opt_new._replace(**{field: old})

        if mask is None:
            loss_mean, loss_max = torch.mean(losses), torch.max(losses)
        else:
            wm = mask.to(torch.float32)
            loss_mean = torch.sum(losses * wm) / torch.clamp(torch.sum(wm), min=1.0)
            loss_max = torch.max(torch.where(mask, losses, float("-inf")))
        metrics = {
            "loss_mean": loss_mean,
            "loss_max": loss_max,
            "comm_active": torch.sum(active.to(torch.int32), dtype=torch.int32),
        }
        return state.replace(opt=opt_new, proto=proto_new, comm=comm_new,
                             step=state.step + 1), metrics

    # -- evaluation helpers (pytree boundary: lazy views) --------------------
    def rank0_params(self, state: FlatState) -> PyTree:
        return tree_take_leading(state.params, 0)

    def aggregate_params(self, state: FlatState) -> PyTree:
        """Parameter average across workers (paper 'Aggregate Accuracy')."""
        return consensus_params(state)
