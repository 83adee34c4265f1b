"""The process group of one gossip fleet: the port's counterpart of
``repro.launch.mesh``.

The reference is single-controller SPMD: one program spans a ``(pod,
worker, fsdp, model)`` device mesh and a gossip round is one ``ppermute``.
The port is multi-controller: one process per gossip worker under
``torch.distributed``, ranked row-major over ``(pod, worker)`` as the
reference's mesh (``rank = pod * workers_per_pod + worker``). Every rank
derives the same host schedule from the shared seed
(:class:`repro_torch.core.scheduler.GossipSchedule`).

The transport is gloo. On a CUDA device every rank computes on its own
device (several ranks may share one card: NCCL refuses two ranks on one
GPU, gloo does not care), and what crosses processes is staged through
pinned host buffers: a device-to-host copy, gloo, a host-to-device copy.
:class:`WorkerGroup` counts its sends and receives and logs the three parts
of every exchange.

    results = spawn_workers(fn, MeshConfig(data=8, model=1, pods=1,
                                           workers_per_pod=8), "cuda", args=(...,))

runs ``fn(group, *args)`` in 8 processes and returns their results by rank;
a rank that raises fails the whole call, and a group that outlives its
``join_timeout_s`` is killed. Tensor parallelism (``model > 1``) is not
ported (port slice 7b, with the transformer stack) and raises
NotImplementedError. The data axis' ``fsdp`` factor is the sharded plane's:
a rank holds its replica's S shards as S rows (one card, so no fsdp
processes inside a worker), and the dist trainer needs ``fsdp`` to equal
``ShardConfig.n_shards`` (:func:`check_shard_mesh`).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.common.config import MeshConfig

DEFAULT_TIMEOUT_S = 120.0       # every gloo operation
DEFAULT_JOIN_TIMEOUT_S = 600.0  # the whole group, spawn to exit


def check_mesh(mesh_cfg: MeshConfig) -> None:
    """The dist engine runs one process per gossip worker: tensor
    parallelism inside a worker (``model > 1``) is refused; ``data`` must
    split into whole workers."""
    if mesh_cfg.model != 1:
        raise NotImplementedError(
            f"MeshConfig(model={mesh_cfg.model}) asks for tensor parallelism; the "
            "port's dist engine takes model = 1 (tensor parallelism comes with "
            "the transformer stack, port slice 7b)")
    if mesh_cfg.workers_per_pod < 1 or mesh_cfg.data % mesh_cfg.workers_per_pod:
        raise ValueError(f"MeshConfig(data={mesh_cfg.data}) does not split into "
                         f"workers_per_pod={mesh_cfg.workers_per_pod} workers")
    if mesh_cfg.num_workers < 2:
        raise ValueError(f"a gossip fleet needs at least 2 workers, got "
                         f"{mesh_cfg.num_workers}")


def check_shard_mesh(mesh_cfg: MeshConfig, shard=None) -> None:
    """The mesh's product over the shard axes (``fsdp`` x ``model``, with
    ``model`` 1) must equal ``shard.n_shards``, or 1 without a sharded
    plane, as the reference's DistTrainer requires."""
    sizes = {"pod": mesh_cfg.pods, "worker": mesh_cfg.workers_per_pod,
             "fsdp": mesh_cfg.fsdp, "model": mesh_cfg.model}
    axes = tuple(shard.axes) if shard is not None else ("fsdp", "model")
    n = int(shard.n_shards) if shard is not None else 1
    got = 1
    for ax in axes:
        if ax not in sizes:
            raise ValueError(f"shard axis {ax!r} not in mesh axes {tuple(sizes)}")
        got *= sizes[ax]
    if got != n:
        raise ValueError(
            f"ShardConfig(n_shards={n}) needs the mesh product over axes {axes} to "
            f"match, got {got} (mesh shape {sizes})")


class WorkerGroup:
    """One rank's view of the fleet: its rank and ``(pod, worker)``
    coordinates, its device, and the gloo collectives the dist engine uses,
    each staged through pinned host memory when the device is a GPU.

    ``sends``/``recvs`` count point-to-point messages (one per bucket per
    exchange); ``exchange_log`` holds the parts of each exchange until
    :meth:`exchange_times` reads them."""

    def __init__(self, rank: int, mesh_cfg: MeshConfig, device,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        check_mesh(mesh_cfg)
        self.rank = int(rank)
        self.mesh_cfg = mesh_cfg
        self.world = mesh_cfg.num_workers
        self.pod, self.worker = divmod(self.rank, mesh_cfg.workers_per_pod)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.timeout_s = float(timeout_s)
        self.sends = 0
        self.recvs = 0
        self.exchange_log: List[tuple] = []
        self._host: Dict[tuple, torch.Tensor] = {}

    # ----------------------------------------------------------- staging
    @property
    def staged(self) -> bool:
        return self.device.type == "cuda"

    def _pinned(self, key: str, like: torch.Tensor) -> torch.Tensor:
        """A reusable pinned host buffer of ``like``'s shape and dtype."""
        k = (key, tuple(like.shape), like.dtype)
        buf = self._host.get(k)
        if buf is None:
            buf = self._host[k] = torch.empty(like.shape, dtype=like.dtype,
                                              pin_memory=True)
        return buf

    def _to_host(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a contiguous host tensor gloo may write into."""
        if not self.staged:
            return t.detach().contiguous().clone()
        h = self._pinned(key, t)
        h.copy_(t)                      # device-to-host, synchronising
        return h

    # ----------------------------------------------------- point to point
    def exchange(self, tensors: Sequence[torch.Tensor], partner: int) -> List[torch.Tensor]:
        """Send every tensor to ``partner`` and receive its tensors of the
        same shapes and dtypes: one send and one recv per tensor, posted
        together (``batch_isend_irecv``) so that two partners never wait on
        each other. A rank that is its own partner gets its tensors back
        and sends nothing. Returns new tensors on this rank's device."""
        if partner == self.rank:
            return [t.clone() for t in tensors]
        if self.staged:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            send = []
            for i, t in enumerate(tensors):
                h = self._pinned(f"send{i}", t)
                h.copy_(t, non_blocking=True)
                send.append(h)
            ev[1].record()
            ev[1].synchronize()
            recv = [self._pinned(f"recv{i}", t) for i, t in enumerate(tensors)]
        else:
            send = [t.detach().contiguous() for t in tensors]
            recv = [torch.empty_like(t) for t in send]
        t0 = time.perf_counter()
        ops = [dist.P2POp(dist.isend, s, partner, tag=i) for i, s in enumerate(send)]
        ops += [dist.P2POp(dist.irecv, r, partner, tag=i) for i, r in enumerate(recv)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        gloo_s = time.perf_counter() - t0
        self.sends += len(send)
        self.recvs += len(recv)
        if not self.staged:
            self.exchange_log.append((None, gloo_s))
            return recv
        ev[2].record()
        out = [r.to(self.device, non_blocking=True) for r in recv]
        ev[3].record()
        self.exchange_log.append((ev, gloo_s))
        return out

    def exchange_times(self) -> List[Dict[str, Optional[float]]]:
        """The logged exchanges, oldest first, as ``{"d2h_ms", "gloo_ms",
        "h2d_ms"}`` (the copies are None off the GPU); clears the log."""
        out = []
        if self.staged and self.exchange_log:
            torch.cuda.synchronize(self.device)
        for ev, gloo_s in self.exchange_log:
            out.append({"d2h_ms": ev[0].elapsed_time(ev[1]) if ev else None,
                        "gloo_ms": gloo_s * 1e3,
                        "h2d_ms": ev[2].elapsed_time(ev[3]) if ev else None})
        self.exchange_log = []
        return out

    # -------------------------------------------------------- collectives
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's ``t`` (same shape on each), as a new tensor on
        this rank's device, equal on every rank."""
        h = self._to_host("allreduce", t)
        dist.all_reduce(h, op=dist.ReduceOp.SUM)
        return h.to(self.device, copy=True)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in rank order (a
        ``[1, N]`` row gives ``[W, N]``), on this rank's device."""
        h = self._to_host("gather", t)
        parts = [torch.empty_like(h, device="cpu") for _ in range(self.world)]
        dist.all_gather(parts, h)
        return torch.cat(parts, dim=0).to(self.device)

    def barrier(self) -> None:
        dist.barrier()


# ---------------------------------------------------------------------------
# spawning a fleet
# ---------------------------------------------------------------------------

def init_worker_group(rank: int, mesh_cfg: MeshConfig, device, init_method: str,
                      timeout_s: float = DEFAULT_TIMEOUT_S) -> WorkerGroup:
    """Join the gloo process group of ``mesh_cfg.num_workers`` ranks at
    ``init_method`` (``file://...`` or ``tcp://host:port``) as ``rank``."""
    check_mesh(mesh_cfg)
    # one host: gloo talks over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=mesh_cfg.num_workers, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return WorkerGroup(rank, mesh_cfg, device, timeout_s)


def _rank_main(rank: int, fn: Callable, mesh_cfg: MeshConfig, device: str,
               init_method: str, timeout_s: float, result_dir: str, threads: int,
               args: tuple) -> None:
    torch.set_num_threads(threads)
    try:
        group = init_worker_group(rank, mesh_cfg, device, init_method, timeout_s)
        try:
            out = fn(group, *args)
            group.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(result_dir, f"error-{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    path = os.path.join(result_dir, f"result-{rank}.pkl")
    with open(path + ".tmp", "wb") as fh:
        pickle.dump(out, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(path + ".tmp", path)


def spawn_workers(fn: Callable, mesh_cfg: MeshConfig, device, args: tuple = (), *,
                  timeout_s: float = DEFAULT_TIMEOUT_S,
                  join_timeout_s: float = DEFAULT_JOIN_TIMEOUT_S,
                  rendezvous_dir: Optional[str] = None, threads: int = 1) -> List[Any]:
    """Run ``fn(group, *args)`` on ``mesh_cfg.num_workers`` new processes
    (start method ``spawn``, so a parent that holds a CUDA context may call
    it) joined by a ``file://`` rendezvous in a fresh temporary directory
    (under ``rendezvous_dir`` when given). ``fn`` must be importable by name
    (a module-level function) and return something picklable; the results
    come back in rank order.

    Any rank's exception is raised here (the others are killed), and a
    group still running after ``join_timeout_s`` is killed and raises
    TimeoutError. ``timeout_s`` bounds each gloo operation; ``threads`` is
    each rank's intra-op thread count."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    check_mesh(mesh_cfg)
    W = mesh_cfg.num_workers
    with tempfile.TemporaryDirectory(prefix="gossip-fleet-", dir=rendezvous_dir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, mesh_cfg, str(device), init, float(timeout_s), tmp,
                              int(threads), tuple(args)),
            nprocs=W, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=max(0.05, min(1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"gossip fleet of {W} ranks still running after "
                                       f"{join_timeout_s:.0f} s; killed")
        except ProcessException as e:
            # every rank that raised, not only the first one joined: a rank
            # whose partner died reports a closed connection
            errors = []
            for r in range(W):
                path = os.path.join(tmp, f"error-{r}.txt")
                if os.path.exists(path):
                    with open(path) as fh:
                        errors.append(f"--- rank {r} ---\n{fh.read()}")
            raise RuntimeError(f"gossip fleet of {W} ranks failed:\n"
                               + "\n".join(errors or [str(e)])) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
        results = []
        for r in range(W):
            with open(os.path.join(tmp, f"result-{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results
