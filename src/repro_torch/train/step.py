"""Dist training step: one process per gossip worker (port of
``repro.train.step``).

Each rank's :class:`DistTrainer` holds the rank's row of the flat-resident
state: a :class:`~repro_torch.api.state.FlatState` whose params and
velocity are ONE ``[1, total]`` buffer per dtype bucket (the reference
holds the ``[W, total]`` plane sharded over its workers; the rank's row is
what one of its shards sees). The two programs of the reference become two
methods, selected per step by the facade from the host schedule:

- :meth:`DistTrainer._train_step`, the gradient component only: for
  ``allreduce`` the gradient mean over the group (Alg. 1); for ``easgd``
  the center exchange, its sum over workers a group all-reduce; for the
  pairwise protocols with ``fused_update`` the NAG update as kernel B2,
  in place (Alg. 5 lines 3 and 9).
- :meth:`DistTrainer._train_gossip_step`, the gradient and ONE matching
  gossip round composed simultaneously from the step-t state: the exchange
  of :mod:`repro_torch.core.gossip_dist` and, fused, the whole update as
  kernel B1.

With a sharded plane (``shard=``, a
:class:`~repro_torch.common.config.ShardConfig`) the rank's row is padded
to the layout's totals and exchanged as S shard rows
(:mod:`repro_torch.core.gossip_dist`); the mesh's product over the shard
axes must equal S. Without one, the mesh's ``fsdp`` and ``model`` sizes
change nothing: the reference replicates the plane over them, and the
rank computes it once.

``grad_accum = A`` splits the rank's batch into A contiguous microbatches
and takes the mean of their losses and gradients, accumulated in f32
(the reference's ``lax.scan``), so only one microbatch's activations are
live at a time.

Every collective is gloo through the rank's
:class:`~repro_torch.launch.mesh.WorkerGroup`. The loss metric is the fleet
mean: the rank's loss, all-reduced (a host sync each step). As the sim
engine, the step updates ``theta`` and the velocity IN PLACE.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch import comm
from repro_torch.api import registry
from repro_torch.api.state import FlatState
from repro_torch.common import flat as flat_plane
from repro_torch.common.config import MeshConfig, ModelConfig, TrainConfig
from repro_torch.common.precision import full_f32
from repro_torch.common.pytree import tree_map
from repro_torch.core import gossip_dist
from repro_torch.core.gossip_sim import _store
from repro_torch.kernels import ops
from repro_torch.launch.mesh import check_shard_mesh
from repro_torch.optim.optimizers import OptState, _scaled
from repro_torch.optim.schedule import lr_at
from repro_torch.train import losses

PyTree = Any
Buffers = Dict[str, torch.Tensor]


class DistTrainer:
    """One rank of the dist engine. ``loss_fn(params, x, y)`` -> scalar loss
    for ONE worker's replica and batch (the sim engine's signature); without
    one, the LM loss of ``model_cfg`` (:func:`repro_torch.train.losses.lm_loss_fn`,
    x the tokens and y the labels), as the reference's default."""

    def __init__(self, group, mesh_cfg: MeshConfig, train_cfg: TrainConfig,
                 loss_fn: Optional[Callable] = None, shard=None,
                 model_cfg: Optional[ModelConfig] = None, grad_accum: int = 1):
        if isinstance(grad_accum, bool) or int(grad_accum) != grad_accum or grad_accum < 1:
            raise ValueError(f"grad_accum must be a positive integer, got {grad_accum!r}")
        if mesh_cfg.num_workers != group.world:
            raise ValueError(f"mesh has {mesh_cfg.num_workers} workers, the group "
                             f"{group.world} ranks")
        if loss_fn is None and model_cfg is None:
            raise ValueError("DistTrainer needs loss_fn or model_cfg (the LM loss)")
        self.group = group
        self.mesh_cfg = mesh_cfg
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.loss_fn = loss_fn or losses.lm_loss_fn(model_cfg)
        self.grad_accum = int(grad_accum)
        self.W = mesh_cfg.num_workers
        self.opt = train_cfg.optimizer
        # TrainConfig.codec overrides the protocol's codec for this run
        self.protocol = (dataclasses.replace(train_cfg.protocol, codec=train_cfg.codec)
                         if train_cfg.codec else train_cfg.protocol)
        self._impl = registry.resolve(self.protocol)
        self._codec = comm.active_codec(self.protocol) if self._impl.pairwise else None
        self._codec_stateful = self._codec is not None and self._codec.stateful
        if self.opt.name != "nag":
            raise ValueError("the dist engine implements the paper's NAG (Alg. 5); "
                             f"got optimizer {self.opt.name!r}")
        # fused flat-plane update (kernels B1/B2): pairwise protocols only
        self.fused_update = bool(train_cfg.fused_update) and self._impl.pairwise
        # sharded plane: the layout is built from the params at init_state;
        # the mesh's fsdp must equal n_shards (check_shard_mesh)
        self.shard = shard
        self.shard_layout = None
        sharded = shard is not None and shard.enabled()
        if sharded and not self._impl.pairwise:
            raise ValueError(
                f"sharded plane (repro.shard) needs a pairwise protocol; "
                f"{self.protocol.method!r} is not pairwise")
        check_shard_mesh(mesh_cfg, shard if sharded else None)
        self._programs: Dict[tuple, Callable] = {}
        # host seconds of the last step's fleet-mean loss all-reduce
        self.last_loss_reduce_s = 0.0

    # ------------------------------------------------------------------ init
    def init_state(self, params: PyTree) -> FlatState:
        """Flatten ONCE into the rank's resident ``[1, total]`` row; every
        rank starts from the same single-replica ``params``."""
        dev = self.group.device
        row = tree_map(lambda x: x.to(dev)[None], params)
        spec = flat_plane.FlatSpec.build(row, leading=1)
        theta = spec.flatten(row)
        if self.shard is not None and self.shard.enabled():
            from repro_torch import shard as shard_plane
            self.shard_layout = shard_plane.build_layout(spec, self.shard, self._codec)
            spec = shard_plane.padded_spec(spec, self.shard_layout)
            theta = shard_plane.pad_bufs(theta, self.shard_layout)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        center = ({k: b[0].clone() for k, b in theta.items()}
                  if self._impl.uses_center else None)
        residual = ({k: torch.zeros(b.shape, dtype=torch.float32, device=dev)
                     for k, b in theta.items()} if self._codec_stateful else None)
        return FlatState(spec=spec, theta=theta,
                         opt=OptState(zero, {k: torch.zeros_like(b) for k, b in theta.items()},
                                      {}),
                         center=center, comm=comm.CommState(residual), step=zero.clone())

    # ------------------------------------------- shapes (the planning tools)
    def state_shapes(self, params: Optional[PyTree] = None) -> FlatState:
        """The fleet's state as the reference's ``DistTrainer.state_shapes``
        gives it, on the ``meta`` device (no allocation): theta and the
        velocity ``[W, total]`` per bucket of ``params`` (a single replica;
        default ``abstract_lm(model_cfg)``), the EASGD center ``[total]``
        and a stateful codec's f32 residual where the protocol uses them,
        the counters 0-d int32. A rank holds row ``group.rank`` of each
        plane."""
        if params is None:
            from repro_torch.models import transformer as tr
            params = tr.abstract_lm(self.model_cfg)[0]
        row = tree_map(lambda x: torch.empty((1,) + tuple(x.shape), dtype=x.dtype,
                                             device="meta"), params)
        spec = flat_plane.FlatSpec.build(row, leading=1)
        meta = torch.device("meta")

        def planes(dtype=None):
            return {k: torch.empty((self.W, n), dtype=dtype or getattr(torch, k), device=meta)
                    for k, n in spec.totals.items()}

        scalar = torch.empty((), dtype=torch.int32, device=meta)
        center = ({k: torch.empty((n,), dtype=getattr(torch, k), device=meta)
                   for k, n in spec.totals.items()} if self._impl.uses_center else None)
        return FlatState(spec=spec.with_lead((self.W,)), theta=planes(),
                         opt=OptState(scalar, planes(), {}), center=center,
                         comm=comm.CommState(planes(torch.float32) if self._codec_stateful
                                             else None),
                         step=scalar)

    def set_shape(self, global_batch: int, seq_len: int) -> None:
        self._gb, self._seq = global_batch, seq_len

    def batch_shapes(self, global_batch: Optional[int] = None, seq_len: int = 4096):
        """The fleet's batch ``{name: [W, per-worker batch, ...]}`` on the
        ``meta`` device, as the reference's ``batch_shapes``; the global
        batch defaults to :meth:`set_shape`'s."""
        gb = global_batch or getattr(self, "_gb", None)
        if gb is None:
            raise ValueError("batch_shapes needs global_batch or set_shape first")
        shapes = losses.batch_shapes(self.model_cfg, gb // self.W, seq_len)
        return {k: torch.empty((self.W,) + s, dtype=dt, device="meta")
                for k, (s, dt) in shapes.items()}

    # ------------------------------------------------------- gradient engine
    def _grads_and_loss(self, state: FlatState, x, y):
        """The rank's (loss [1], flat gradients [1, total]): the loss reads
        the single-replica views of its row, as the sim engine's. With
        ``grad_accum = A`` the batch's rows ``[a B/A, (a+1) B/A)`` are
        microbatch a: the losses and gradients are summed in f32 from
        zeros, out of place, and divided by A (the mean of the
        microbatches' means, as the reference's), the gradient cast back
        to each bucket's dtype."""
        row_spec = state.spec.with_lead(())

        def one_loss(bufs, xi, yi):
            return self.loss_fn(row_spec.views(bufs), xi, yi)

        dev = self.group.device
        x = tree_map(lambda t: torch.as_tensor(t, device=dev), x)
        y = torch.as_tensor(y, device=dev)
        A = self.grad_accum
        if y.shape[0] % A:
            raise ValueError(f"grad_accum={A} does not divide the rank's batch of "
                             f"{y.shape[0]} rows")
        step = vmap(grad_and_value(one_loss))
        with full_f32():   # forward and backward: no TF32 in between
            if A == 1:
                grads, loss = step(state.theta, tree_map(lambda t: t[None], x), y[None])
                return loss, {k: g.contiguous() for k, g in grads.items()}
            rows = y.shape[0] // A
            loss = torch.zeros((1,), dtype=torch.float32, device=dev)
            acc = {k: torch.zeros(b.shape, dtype=torch.float32, device=dev)
                   for k, b in state.theta.items()}
            for a in range(A):
                mb = slice(a * rows, (a + 1) * rows)
                g, l_a = step(state.theta, tree_map(lambda t: t[mb][None], x), y[mb][None])
                loss = loss + l_a.float()
                acc = {k: acc[k] + g[k] for k in acc}
                del g, l_a      # this microbatch's activations go before the next
        return loss / A, {k: (acc[k] / A).to(state.theta[k].dtype) for k in acc}

    def _nag(self, theta: Buffers, velocity: Buffers, grads: Buffers, step):
        """The unfused NAG of the reference's DistTrainer (no gradient
        clipping), returning new buffers."""
        eta = lr_at(self.opt, step)
        mu = self.opt.momentum
        v_new = {k: mu * velocity[k] - _scaled(eta, grads[k].to(velocity[k].dtype))
                 for k in velocity}
        p_new = {k: theta[k] - _scaled(eta, grads[k].to(theta[k].dtype))
                 + mu * v_new[k].to(theta[k].dtype) for k in theta}
        return p_new, v_new

    def _finish(self, state: FlatState, loss, **kw):
        """Advance the counters and reduce the loss to the fleet mean (None
        on the ``meta`` device, where no value is read)."""
        t0 = time.perf_counter()
        total = self.group.all_reduce_sum(loss.detach().float().reshape(1))
        loss_mean = None if total.device.type == "meta" else float(total[0]) / self.W
        self.last_loss_reduce_s = time.perf_counter() - t0
        opt = OptState(state.opt.step + 1, state.opt.mu, {})
        return state.replace(opt=opt, step=state.step + 1, **kw), {"loss": loss_mean}

    # ------------------------------------------------------------- programs
    def _train_step(self, state: FlatState, x, y, active):
        """Gradient component only; ``active`` is the shared EASGD gate
        (0.0 for the others)."""
        loss, grads = self._grads_and_loss(state, x, y)
        with torch.no_grad():
            grads = self._impl.gradient_transform(grads, group=self.group)
            center_new, comm_delta = state.center, None
            if self._impl.uses_center:
                # center exchange (Alg. 2 lines 5-7), gated by the host schedule
                gate = torch.full((), float(active), dtype=torch.float32,
                                  device=self.group.device)
                comm_delta, center_new = self._impl.center_step(
                    state.theta, state.center, gate, group=self.group)
            if self.fused_update and comm_delta is None:
                # kernel B2: velocity and parameter update in ONE in-place pass
                self.fused_nag(state.theta, state.opt.mu, grads,
                               lr_at(self.opt, state.step), self.opt.momentum)
            else:
                p_new, v_new = self._nag(state.theta, state.opt.mu, grads, state.step)
                for k in state.theta:
                    d = comm_delta[k] if comm_delta is not None else None
                    _store(state.theta, k, p_new[k] if d is None else p_new[k] + d)
                    _store(state.opt.mu, k, v_new[k])
        return self._finish(state, loss, center=center_new)

    def _train_gossip_step(self, state: FlatState, x, y, active, round_idx: int):
        """Simultaneous composition: grads and the elastic move both read the
        step-t resident buffers (paper §2.3). ``active`` is the host's [W]
        mask, ``round_idx`` the schedule's round."""
        loss, grads = self._grads_and_loss(state, x, y)
        comm_new = state.comm
        with torch.no_grad():
            if self.fused_update:
                # the exchange, then kernel B1 with the pair's gate*coef
                eta, mu = lr_at(self.opt, state.step), self.opt.momentum
                if self._codec_stateful:
                    _, _, res = self.fused_gossip(state.theta, state.opt.mu, grads,
                                                  state.comm.residual, active, round_idx,
                                                  eta, mu)
                    comm_new = comm.CommState(res)
                else:
                    self.fused_gossip(state.theta, state.opt.mu, grads, active, round_idx,
                                      eta, mu)
            else:
                if self._codec_stateful:
                    exchanged, res = self.apply_gossip(state.theta, state.comm.residual,
                                                       active, round_idx)
                    comm_new = comm.CommState(res)
                else:
                    exchanged = self.apply_gossip(state.theta, active, round_idx)
                comm_delta = {k: exchanged[k] - state.theta[k] for k in state.theta}
                p_new, v_new = self._nag(state.theta, state.opt.mu, grads, state.step)
                for k in state.theta:
                    _store(state.theta, k, p_new[k] + comm_delta[k].to(p_new[k].dtype))
                    _store(state.opt.mu, k, v_new[k])
        return self._finish(state, loss, comm=comm_new)

    def _program(self, mode: str, layout=None):
        key = (mode, layout)
        if key not in self._programs:
            self._programs[key] = gossip_dist.make_gossip_step(
                self.group, self.mesh_cfg, self.protocol,
                schedule_kind="hypercube" if self.protocol.topology == "matching" else "random",
                mode=mode, codec=self._codec, layout=layout)
        return self._programs[key]

    @property
    def apply_gossip(self):
        """The mode="apply" exchange over the rank's buffers; with a stateful
        codec (bufs, residual, active, round) -> (exchanged, residual')."""
        return self._program("apply", self.shard_layout)

    @property
    def fused_gossip(self):
        """The mode="fused" exchange + kernel B1, in place."""
        return self._program("fused", self.shard_layout)

    @staticmethod
    def fused_nag(theta: Buffers, velocity: Buffers, grads: Buffers, eta, mu):
        """Kernel B2 per bucket, in place on theta and velocity."""
        return ops.fused_bufs_nag(theta, velocity, grads, eta, mu)

    def gossip_exchange(self, params_stack: PyTree, active, round_idx: int) -> PyTree:
        """ONE communication round on a stacked ``[W, ...]`` params pytree,
        the facade's parity surface: every rank passes the same stack, sends
        its own row, and gets the exchanged stack back (all-gathered), as
        the reference's global view. Stateful codecs run against a zero
        residual here. Under a sharded plane the rows are padded to the
        layout's totals on entry and sliced back after."""
        spec = flat_plane.FlatSpec.build(params_stack, leading=1)
        bufs = {k: b[self.group.rank:self.group.rank + 1].to(self.group.device)
                for k, b in spec.flatten(params_stack).items()}
        layout = None
        if self.shard is not None and self.shard.enabled():
            from repro_torch import shard as shard_plane
            layout = shard_plane.build_layout(spec, self.shard, self._codec)
            bufs = shard_plane.pad_bufs(bufs, layout)
        step = self._program("apply", layout)
        with torch.no_grad():
            if self._codec_stateful:
                zeros = {k: torch.zeros(b.shape, dtype=torch.float32, device=b.device)
                         for k, b in bufs.items()}
                out, _ = step(bufs, zeros, active, round_idx)
            else:
                out = step(bufs, active, round_idx)
        if layout is not None:
            out = shard_plane.slice_bufs(out, spec.totals)
        return spec.unflatten(self.gather_bufs(out))

    # -------------------------------------------------------- global views
    def gather_bufs(self, bufs: Buffers) -> Buffers:
        """``{bucket: [1, total]}`` rows of every rank -> ``{bucket: [W,
        total]}`` on every rank (for evaluation and tests only)."""
        return {k: self.group.all_gather(b) for k, b in bufs.items()}

    def gather_theta(self, state: FlatState) -> Buffers:
        """The whole ``[W, total]`` plane, the reference's global view."""
        return self.gather_bufs(state.theta)

    def gather_state(self, state: FlatState) -> FlatState:
        """The fleet's whole state as the reference's dist engine holds it:
        theta, the velocity and any codec residual as ``[W, total]``
        planes; the counters and the EASGD center (equal on every rank) as
        this rank's. Every rank must call it (one all-gather per plane)."""
        res = state.comm.residual
        return state.replace(
            spec=state.spec.with_lead((self.W,)), theta=self.gather_bufs(state.theta),
            opt=state.opt._replace(mu=self.gather_bufs(state.opt.mu)),
            comm=comm.CommState(None if res is None else self.gather_bufs(res)))

