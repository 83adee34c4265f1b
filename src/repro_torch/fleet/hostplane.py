"""Host-resident plane for the async engine: W bounded by host RAM, not by
the card's memory (port of ``repro.fleet.hostplane``).

theta and velocity live in pinned host tensors ``[W, total]`` (plain host
tensors on a CPU run); the generator, the counters and the step stay on the
compute device. One event window:

- **gather + h2d**: the window's rows, padded to the next power of two with
  copies of its first row, are gathered into a pinned staging buffer and
  copied to the card;
- **local step**: the engines' ``vmap(grad_and_value)`` on those rows, then
  kernel B1 over the gathered ``[pad, total]`` rows with ``coef = 0`` and
  ``peer = theta`` (the elastic term vanishes);
- **host exchanges** (while the card computes): per partition chunk, in
  f32, from the window's step-t rows; an active in-window initiator moves
  toward its partner's published row, and the partner moves symmetrically
  ONLY if it is also in the window. Robust protocols go through
  ``robust_pair_apply`` on the chunk slices (its plain version, on the
  host);
- **d2h + scatter**: the updated rows come back through the pinned staging
  buffers and are scattered into the plane, then the exchange
  displacements are added.

Gate and peers are drawn from the state's generator on the compute device,
as the device plane draws them, so the two planes consume the same draws.
Clocks, staleness, token balances and the exact applied-exchange and
per-chunk byte accounting run in host numpy and are mirrored into the
state's ``ProtocolState`` each window.

Composition limits (the trainer refuses the rest): NAG, pairwise
protocols, no codec, no fault plane, no message mode.
"""
from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import comm
from repro_torch.api.protocols import ProtocolState
from repro_torch.api.state import FlatState
from repro_torch.common import flat as flat_plane
from repro_torch.common.pytree import tree_map, tree_take_leading
from repro_torch.fleet.partition import partition_ids_np
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import OptState, _clip
from repro_torch.optim.schedule import lr_at

PyTree = Any


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class HostPlane:
    """Host-resident execution of one
    :class:`~repro_torch.core.gossip_async.AsyncTrainer`'s windows.
    ``split_ms`` holds the last window's phase times (host clock, the card
    synchronised at each boundary only when ``timed`` is set)."""

    def __init__(self, trainer):
        self.tr = trainer
        self._staging: Dict[tuple, torch.Tensor] = {}
        self.timed = False
        self.split_ms: Dict[str, float] = {}

    # ------------------------------------------------------------------ init
    def init_state(self, params_stack: PyTree, seed: int = 0) -> FlatState:
        """A FlatState whose theta and velocity are host tensors (pinned on
        a CUDA run). One replica is flattened on the device and tiled on the
        host, so the card never holds ``[W, total]``."""
        tr = self.tr
        W = tr.num_workers
        spec = flat_plane.FlatSpec.build(params_stack, leading=1)
        row = spec.with_lead(()).flatten(tree_take_leading(params_stack, 0))
        dev = next(iter(row.values())).device
        pin = dev.type == "cuda"
        theta, mu = {}, {}
        for b, v in row.items():
            theta[b] = torch.empty((W,) + tuple(v.shape), dtype=v.dtype, pin_memory=pin)
            theta[b].copy_(v.cpu().expand(W, -1))
            mu[b] = torch.zeros_like(theta[b], pin_memory=pin)
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        proto = ProtocolState(None, zero_i, zero_i.clone(),
                              torch.zeros((), dtype=torch.float32, device=dev))
        proto = tr._fleet_proto_seed(proto, dev)
        proto = proto._replace(
            clocks=torch.zeros(W, dtype=torch.float32, device=dev),
            worker_steps=torch.zeros(W, dtype=torch.int32, device=dev),
            stale_time=torch.zeros((), dtype=torch.float32, device=dev),
            stale_steps=zero_i.clone(), stale_events=zero_i.clone())
        tr.anchor(np.zeros((W,)), np.zeros((W,), np.int64))
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return FlatState(spec=spec, theta=theta, opt=OptState(zero_i.clone(), mu, {}),
                         proto=proto, comm=comm.init_comm_state(None, theta), key=gen,
                         step=zero_i.clone())

    def _ensure_host(self, state: FlatState) -> FlatState:
        """Planes restored from a checkpoint come back as plain host (or
        device) tensors: move them to pinned host memory once."""
        dev = state.step.device
        t0 = next(iter(state.theta.values()))
        if t0.device.type == "cpu" and (dev.type != "cuda" or t0.is_pinned()):
            return state

        def host(v):
            v = v.cpu()
            return v.pin_memory() if dev.type == "cuda" else v
        return state.replace(theta={b: host(v) for b, v in state.theta.items()},
                             opt=OptState(state.opt.step,
                                          {b: host(v) for b, v in state.opt.mu.items()},
                                          state.opt.nu))

    def _gather(self, bufs: dict, idx: torch.Tensor, pad: int, tag: str, dev) -> dict:
        """Rows ``idx`` of each host buffer through a pinned staging buffer
        to the device (a non-blocking copy; staging is reused per shape)."""
        out = {}
        for b, buf in bufs.items():
            key = (tag, b, pad)
            st = self._staging.get(key)
            if st is None:
                st = self._staging[key] = torch.empty((pad, buf.shape[1]), dtype=buf.dtype,
                                                      pin_memory=dev.type == "cuda")
            torch.index_select(buf, 0, idx, out=st)
            out[b] = st.to(dev, non_blocking=True)
        return out

    def _mark(self, name: str, t0: float, dev) -> float:
        if self.timed:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            self.split_ms[name] = (t1 - t0) * 1e3
            return t1
        return t0

    # ---------------------------------------------------------- event window
    def window_step(self, state: FlatState, x, y, t, mask, nxt, draws=None):
        tr = self.tr
        W = tr.num_workers
        state = self._ensure_host(state)
        dev = state.step.device
        proto = state.proto
        step0 = int(state.step)
        t0 = time.perf_counter()

        # draws: the device plane's, from the state's generator
        if draws is None:
            gate_d = tr._impl.comm_gate(state.key, state.step, W)
            peers_d = tr._impl.sample_peers(state.key, W)
        else:
            gate_d = torch.as_tensor(draws[0], device=dev).bool()
            peers_d = torch.as_tensor(draws[1], device=dev)
        tr.last_draws = (gate_d, peers_d)
        gate, peers = gate_d.cpu().numpy(), peers_d.cpu().numpy()
        active = gate & mask

        # flow control (the numpy mirror of the device model)
        tokens_np = None
        skipped = 0
        if tr.flow is not None:
            tokens_np = proto.tokens.cpu().numpy()
            allowed = tr.flow.allow_np(step0, tokens_np)
            skipped = int(np.sum(active & ~allowed))
            active = active & allowed
            tokens_np = tr.flow.update(tokens_np, mask, active)

        # ---- gather the window's rows to the card ---------------------------
        idx = np.nonzero(mask)[0]
        n = len(idx)
        pad = min(_next_pow2(n), W)
        idx_pad = np.concatenate([idx, np.full(pad - n, idx[0], idx.dtype)])
        idx_h = torch.as_tensor(idx_pad, dtype=torch.int64)
        theta_rows = self._gather(state.theta, idx_h, pad, "theta", dev)
        mu_rows = self._gather(state.opt.mu, idx_h, pad, "mu", dev)
        t0 = self._mark("gather_h2d", t0, dev)

        # ---- local step on the gathered rows (the card; asynchronous) -------
        idx_d = idx_h.to(dev)
        xb = tree_map(lambda t: torch.as_tensor(t, device=dev)[idx_d], x)
        yb = torch.as_tensor(y, device=dev)[idx_d]
        ocfg = tr.optimizer_cfg
        losses, grads = tr._grads(state.replace(theta=theta_rows), xb, yb)
        with torch.no_grad():
            grads = _clip(ocfg, grads)
            ops.fused_bufs_elastic_nag(theta_rows, theta_rows, mu_rows, grads,
                                       torch.zeros(pad, dtype=torch.float32, device=dev),
                                       lr_at(ocfg, state.opt.step), ocfg.momentum)
        t0 = self._mark("gradient_b1", t0, dev)

        # ---- exchange displacements from the step-t rows (host, per chunk) --
        part = tr.partition
        plan = tr._fleet_plan(state.spec) if part > 1 else None
        pids = partition_ids_np(tr.fleet.seed, step0, W, part) if part > 1 else None
        coef = float(tr._impl.alpha_at(state.step))
        robust_pair = getattr(tr._impl, "robust_pair_apply", None)
        new_clocks = np.where(mask, nxt, tr.clocks)
        wsteps_new = tr.steps_done + mask

        def bounds(b, c):
            return plan.bounds[b][c] if part > 1 else (0, state.theta[b].shape[1])

        def chunk_rows(row, c):
            out = {}
            for b, buf in state.theta.items():
                lo, hi = bounds(b, c)
                out[b] = buf[row, lo:hi].to(torch.float32)
            return out

        deltas = []          # (row, chunk, {bucket: f32 delta over the chunk})
        chunk_counts = np.zeros((max(part, 1),), np.int64)
        seen = set()         # mutual initiations i<->k on one chunk are ONE
        n_engaged = stale_s = 0   # undirected edge of the device plane's
        stale_t = 0.0             # mixing matrix: applied once
        with torch.no_grad():
            for i in np.nonzero(active)[0]:
                i = int(i)
                k = int(peers[i])
                c = int(pids[i]) if part > 1 else 0
                # every active initiator is an engaged participation, as on
                # the device plane
                n_engaged += 1
                chunk_counts[c] += 1
                gap = abs(int(wsteps_new[i]) - int(wsteps_new[k]))
                stale_t += abs(float(new_clocks[i]) - float(new_clocks[k]))
                stale_s += gap
                if k == i:
                    continue
                edge = (min(i, k), max(i, k), c)
                if edge in seen:
                    continue
                seen.add(edge)
                loc_i, loc_k = chunk_rows(i, c), chunk_rows(k, c)
                if robust_pair is not None:
                    d_i = {b: v - loc_i[b]
                           for b, v in robust_pair(loc_i, loc_k, coef, gap=gap).items()}
                    d_k = {b: v - loc_k[b]
                           for b, v in robust_pair(loc_k, loc_i, coef, gap=gap).items()}
                else:
                    d_i = {b: coef * (loc_k[b] - loc_i[b]) for b in loc_i}
                    d_k = {b: coef * (loc_i[b] - loc_k[b]) for b in loc_i}
                deltas.append((i, c, d_i))
                if mask[k]:
                    # the partner's row moves only at its OWN window
                    deltas.append((k, c, d_k))
        t0 = self._mark("host_exchanges", t0, dev)

        # ---- d2h + scatter: local rows, then the displacements ---------------
        idx_n = torch.as_tensor(idx, dtype=torch.int64)
        for rows_d, bufs, tag in ((theta_rows, state.theta, "theta"),
                                  (mu_rows, state.opt.mu, "mu")):
            for b, buf in bufs.items():
                st = self._staging[(tag, b, pad)]      # pinned: a direct copy
                st.copy_(rows_d[b])
                buf.index_copy_(0, idx_n, st[:n])
        for row, c, d in deltas:
            for b, buf in state.theta.items():
                lo, hi = bounds(b, c)
                buf[row, lo:hi] = (buf[row, lo:hi].to(torch.float32) + d[b]).to(buf.dtype)
        losses = losses[:n].cpu().numpy()
        t0 = self._mark("d2h_scatter", t0, dev)

        # ---- exact accounting, mirrored into the state's ProtocolState ------
        units = min(int(proto.comm_units) + n_engaged, 2 ** 31 - 1)
        if part > 1:
            per_chunk = [tr._impl.comm_cost(bc, W).bytes_per_event for bc in plan.wire_bytes]
            cu = np.minimum(proto.chunk_units.cpu().numpy().astype(np.int64) + chunk_counts,
                            2 ** 31 - 1)
            bytes_ = float(np.dot(per_chunk, cu)) / W
        else:
            cu = None
            per_event = tr._impl.comm_cost(tr._wire_bytes(state.spec), W).bytes_per_event
            bytes_ = (per_event / W) * units

        def i32(v):
            return torch.as_tensor(np.asarray(v, np.int32), device=dev)

        upd = dict(
            comm_rounds=proto.comm_rounds + (1 if active.any() else 0),
            comm_units=i32(units),
            comm_bytes=torch.tensor(bytes_, dtype=torch.float32, device=dev),
            clocks=torch.as_tensor(new_clocks, dtype=torch.float32, device=dev),
            worker_steps=proto.worker_steps + i32(mask),
            stale_time=proto.stale_time + torch.tensor(stale_t, dtype=torch.float32,
                                                       device=dev),
            stale_steps=proto.stale_steps + stale_s,
            stale_events=proto.stale_events + n_engaged)
        if cu is not None:
            upd["chunk_units"] = i32(cu)
        if tr.flow is not None:
            upd["tokens"] = torch.as_tensor(tokens_np, device=dev)
            upd["flow_skipped"] = proto.flow_skipped + skipped
        proto = proto._replace(**upd)

        tr.clocks = new_clocks
        tr.steps_done = wsteps_new
        state = state.replace(proto=proto,
                              opt=OptState(state.opt.step + 1, state.opt.mu, state.opt.nu),
                              step=state.step + 1)
        m = {"loss_mean": float(np.mean(losses)) if n else float("nan"),
             "loss_max": float(np.max(losses)) if n else float("nan"),
             "comm_active": int(np.sum(active)),
             "virtual_time": t, "window_size": n,
             "stale_time": proto.stale_time,
             "stale_steps": proto.stale_steps,
             "stale_events": proto.stale_events}
        if tr.flow is not None:
            m["flow_skipped"] = int(proto.flow_skipped)
        return state, m
