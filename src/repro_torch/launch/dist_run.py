"""One dist-engine run of the §4.1 MLP: the body of each rank and the call
that spawns the fleet.

    from repro_torch.launch import dist_run
    results = dist_run.run_fleet(mesh_cfg, "cuda", job)

``job`` is a dict the parent builds once and every rank receives:

- ``model``: the MLP's widths (``in_dim``, ``hidden``, ``depth``,
  ``num_classes``);
- ``params``: the single-replica parameters as numpy arrays (every rank
  starts from them);
- ``x`` ``[steps, W, pw, in_dim]`` and ``y`` ``[steps, W, pw]``: the staged
  batches; rank r trains on row r;
- ``runs``: a list of runs, each ``{"kind": "train", "tag", "protocol":
  ProtocolConfig kwargs, "optimizer": OptimizerConfig kwargs, "codec",
  "fused_update", "steps", "seed", "gather"}``, ``{"kind": "exchange",
  "tag", "protocol", "codec", "params_stack": {name: [W, ...] numpy array or
  tensor}, "active": [W], "rounds": [...]}``, ``{"kind": "peer", ...}`` (the
  exchange run's keys) or ``{"kind": "resume", "tag",
  "protocol", "optimizer", "codec", "steps", "seed", "at", "path"}``. Any
  run may add ``"shard": S`` (a ``ShardConfig(n_shards=S)``, on the fleet's
  mesh with ``fsdp = S``) and a train run ``"obs": ObsConfig kwargs``
  (recorded in memory; rank 0 returns the events and the metrics rows).

Each rank runs the runs in order through ``GossipTrainer(engine="dist")``
and returns, per run: the per-step metrics, the launches of every kernel
wrapper (counts set to 0 just before the run, read just after), the sends
and receives of its group, the synchronised step times, the time of the
fleet-mean loss all-reduce, the exchange split into its device-to-host
copy, gloo and host-to-device copy, the same collectives timed once more
after a barrier (``probe``: without the wait for the slowest rank), and,
with ``gather``, the whole
``[W, total]`` theta and velocity (rank 0 only). Exchange runs return the
exchanged stack of every round (rank 0 only). A peer run returns, on every
rank and for every round, what ``make_gossip_step(mode="peer")`` gives on
the rank's row of the stack: the peer's decoded wire (bit for bit what
crossed it) and gate*coef. A resume run trains
``steps`` steps and saves a checkpoint to ``path`` at step ``at``; a fresh
trainer then loads it and takes the remaining steps. It returns, on every
rank, the entries that differ from the saved state after the load and from
the uninterrupted run at the end (both empty when the resume is exact),
whether every step's metrics equal, the save and load times, the kernel
launches of the resumed steps, and (rank 0) the file's entries.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.common.config import (MeshConfig, ObsConfig, OptimizerConfig,
                                       ProtocolConfig, ShardConfig)
from repro_torch.launch.mesh import spawn_workers


def _loss_fn(params, x, y):
    from repro_torch.models import simple
    return simple.xent_loss(simple.mlp_logits(params, x), y)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _numpy_tree(tree):
    """Tensors -> numpy arrays (bfloat16, which numpy lacks, as float32)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _trainer(group, run: Dict[str, Any]):
    from repro_torch.api import GossipTrainer
    shard = mesh_cfg = obs = None
    if "shard" in run:
        shard = ShardConfig(n_shards=run["shard"])
        mesh_cfg = dataclasses.replace(
            group.mesh_cfg, data=group.mesh_cfg.workers_per_pod * run["shard"])
    if "obs" in run:
        obs = ObsConfig(**run["obs"])
    return GossipTrainer(
        engine="dist", protocol=ProtocolConfig(**run["protocol"]),
        optimizer=OptimizerConfig(**run.get("optimizer", {})), loss_fn=_loss_fn,
        fused_update=run.get("fused_update", True), device=group.device,
        codec=run.get("codec"), group=group, seed=run.get("seed", 0), shard=shard,
        mesh_cfg=mesh_cfg, obs=obs)


def _train(group, job: Dict[str, Any], run: Dict[str, Any]) -> Dict[str, Any]:
    from repro_torch.kernels import ops
    from repro_torch.models.simple import params_from_jax
    dev = group.device
    tr = _trainer(group, run)
    state = tr.init_state(run.get("seed", 0), params=params_from_jax(job["params"], dev))
    steps = run["steps"]
    xs = torch.as_tensor(np.ascontiguousarray(job["x"][:steps, group.rank]), device=dev)
    ys = torch.as_tensor(np.ascontiguousarray(job["y"][:steps, group.rank]), device=dev)
    _sync(dev)
    group.barrier()
    ops.zero_launch_counts()
    group.sends = group.recvs = 0
    group.exchange_times()
    rec = {k: [] for k in ("loss", "fired", "comm_round", "comm_active", "comm_bytes",
                           "step_ms", "loss_reduce_ms")}
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = tr.step(state, (xs[i], ys[i]))
        _sync(dev)
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["loss_reduce_ms"].append(tr.dist.last_loss_reduce_s * 1e3)
        for k in ("loss", "fired", "comm_round", "comm_active", "comm_bytes"):
            rec[k].append(m[k])
    out = {"tag": run["tag"], "launches": ops.launch_counts(), "sends": group.sends,
           "recvs": group.recvs, "exchanges": group.exchange_times(),
           "wire_bytes": tr.comm_cost().bytes_per_event, "wire": tr._backend.wire_bytes(),
           "keys": sorted(m), **rec}
    if tr.observer is not None:
        tr.observer.flush()
        out["events"] = list(tr.observer.trace.events) if tr.observer.tracing else []
        out["rows"] = list(tr.observer.sink.records) if tr.observer.sink else []
    out["probe"] = _probe(group, tr, state)
    if run.get("gather"):
        theta = tr.dist.gather_theta(state)
        vel = tr.dist.gather_bufs(state.opt.mu)
        if group.rank == 0:
            out["theta"] = _numpy_tree(theta)
            out["velocity"] = _numpy_tree(vel)
    return out


def _probe(group, tr, state, reps: int = 5) -> Dict[str, float]:
    """The run's collectives without the ranks' skew: each one timed after
    a barrier, median of ``reps`` (in a step, the same operations also wait
    for the slowest rank). The one-float loss all-reduce; for a pairwise
    protocol one exchange of a wire of this run's size with the round-0
    partner (its parts as in ``exchange_times``); for allreduce the
    gradient all-reduce of the rank's plane."""
    dev = group.device
    med = lambda xs: float(np.median(xs))   # noqa: E731
    loss = torch.ones(1, device=dev)
    plane = next(iter(state.theta.values()))
    times: Dict[str, list] = {"loss_allreduce_ms": [], "plane_allreduce_ms": []}
    parts: List[Dict[str, Any]] = []
    for _ in range(reps):
        group.barrier()
        t0 = time.perf_counter()
        group.all_reduce_sum(loss)
        times["loss_allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
        if tr.impl.pairwise:
            wire = torch.zeros(1, int(tr.comm_cost().bytes_per_event) + 1, dtype=torch.uint8,
                               device=dev)
            group.barrier()
            group.exchange([wire], int(tr.matching_partners(0)[group.rank]))
            parts += group.exchange_times()
        elif tr.impl.name == "allreduce":
            group.barrier()
            t0 = time.perf_counter()
            group.all_reduce_sum(plane)
            _sync(dev)
            times["plane_allreduce_ms"].append((time.perf_counter() - t0) * 1e3)
    out = {k: med(v) for k, v in times.items() if v}
    for k in ("d2h_ms", "gloo_ms", "h2d_ms"):
        vals = [p[k] for p in parts if p[k] is not None]
        if vals:
            out["exchange_" + k] = med(vals)
    return out


def _exchange(group, job: Dict[str, Any], run: Dict[str, Any]) -> Dict[str, Any]:
    tr = _trainer(group, run)
    stack = {k: torch.as_tensor(v).to(group.device) for k, v in run["params_stack"].items()}
    group.sends = group.recvs = 0
    outs = []
    for r in run["rounds"]:
        got = tr.gossip_exchange(stack, run["active"], r)
        outs.append(_numpy_tree(got) if group.rank == 0 else None)
    return {"tag": run["tag"], "rounds": outs, "sends": group.sends, "recvs": group.recvs,
            "num_gossip_rounds": tr.num_gossip_rounds,
            "partners": [tr.matching_partners(r) for r in run["rounds"]]}


def _peer(group, job: Dict[str, Any], run: Dict[str, Any]) -> Dict[str, Any]:
    from repro_torch import shard as shard_plane
    from repro_torch.common.flat import FlatSpec
    tr = _trainer(group, run)
    stack = {k: torch.as_tensor(v) for k, v in run["params_stack"].items()}
    spec = FlatSpec.build(stack, leading=1)
    bufs = {k: b[group.rank:group.rank + 1].contiguous().to(group.device)
            for k, b in spec.flatten(stack).items()}
    layout = None
    if tr.shard is not None and tr.shard.enabled():
        layout = shard_plane.build_layout(spec, tr.shard, tr.codec)
        bufs = shard_plane.pad_bufs(bufs, layout)
    step = tr.dist._program("peer", layout)
    zeros = {k: torch.zeros(b.shape, dtype=torch.float32, device=b.device)
             for k, b in bufs.items()}
    out = []
    with torch.no_grad():
        for r in run["rounds"]:
            args = (bufs, zeros) if tr.dist._codec_stateful else (bufs,)
            got = step(*args, run["active"], r)
            peer, gc = got[0], got[1]
            out.append({**_numpy_tree(peer), "gc": gc.cpu().numpy()})
    return {"tag": run["tag"], "rounds": out}


def _differing(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> List[str]:
    """Entry names whose bytes differ (or that only one side has)."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes())


def _resume(group, job: Dict[str, Any], run: Dict[str, Any]) -> Dict[str, Any]:
    from repro_torch.checkpoint import io
    from repro_torch.kernels import ops
    from repro_torch.models.simple import params_from_jax
    dev = group.device
    steps, at, path = run["steps"], run["at"], run["path"]
    seed = run.get("seed", 0)
    xs = torch.as_tensor(np.ascontiguousarray(job["x"][:steps, group.rank]), device=dev)
    ys = torch.as_tensor(np.ascontiguousarray(job["y"][:steps, group.rank]), device=dev)
    keys = ("loss", "fired", "comm_round", "comm_active", "comm_bytes")

    tr = _trainer(group, run)
    state = tr.init_state(seed, params=params_from_jax(job["params"], dev))
    straight, saved, save_ms = [], None, None
    for i in range(steps):
        if i == at:
            saved = io.entries(state.state_dict())
            group.barrier()
            t0 = time.perf_counter()
            tr.save_checkpoint(path, state, meta={"step": at})
            save_ms = (time.perf_counter() - t0) * 1e3
        state, m = tr.step(state, (xs[i], ys[i]))
        if i >= at:
            straight.append([m[k] for k in keys])

    tr2 = _trainer(group, run)
    like = tr2.init_state(seed + 1, params=params_from_jax(job["params"], dev))
    _sync(dev)
    group.barrier()
    t0 = time.perf_counter()
    resumed, _ = tr2.load_checkpoint(path, like)
    _sync(dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    loaded_diff = _differing(saved, io.entries(resumed.state_dict()))
    ops.zero_launch_counts()
    again = []
    for i in range(at, steps):
        resumed, m = tr2.step(resumed, (xs[i], ys[i]))
        again.append([m[k] for k in keys])
    final_diff = _differing(io.entries(state.state_dict()), io.entries(resumed.state_dict()))
    out = {"tag": run["tag"], "launches": ops.launch_counts(), "loaded_diff": loaded_diff,
           "final_diff": final_diff, "metrics_equal": straight == again,
           "save_ms": save_ms, "load_ms": load_ms}
    if group.rank == 0:
        out["entries"] = {k: (list(v.shape), v.dtype.str)
                          for k, v in io.load_payload(path).items()}
        out["meta"] = io.load_meta(path)
        out["file_mb"] = os.path.getsize(path) / 1e6
    return out


def run_rank(group, job: Dict[str, Any]) -> Dict[str, Any]:
    """The body of one rank: every run of ``job`` in order."""
    kinds = {"train": _train, "exchange": _exchange, "peer": _peer, "resume": _resume}
    return {"rank": group.rank, "device": str(group.device),
            "runs": [kinds[run["kind"]](group, job, run) for run in job["runs"]]}


def run_fleet(mesh_cfg: MeshConfig, device, job: Dict[str, Any], **spawn_kw) -> List[Dict]:
    """Spawn one process per worker of ``mesh_cfg`` on ``device`` and run
    ``job`` on each; returns the ranks' results in rank order. The kernels
    must be built before (the ranks only load them)."""
    return spawn_workers(run_rank, mesh_cfg, device, args=(job,), **spawn_kw)
