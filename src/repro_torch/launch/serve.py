"""Train-while-serve CLI, one process (port of ``repro.launch.serve``).

One process, two interleaved loops over the same model: a
:class:`repro_torch.api.GossipTrainer` (sim or async engine) trains W gossip
replicas of a transformer LM and publishes their consensus every
``--publish-every`` steps onto a :class:`~repro_torch.serve.SnapshotBus`; a
:class:`~repro_torch.serve.LiveServer` hot-swaps a ServeProgram to each
snapshot between decode boundaries while a
:class:`~repro_torch.serve.ContinuousBatcher` serves a hash-seeded Poisson
request stream (:class:`~repro_torch.serve.TrainServeLoop`). Prints the
memory it plans for and a final latency / swap / staleness summary.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \\
        --boundaries 120 --rate 0.3 --publish-every 5 --device cpu

The reference's ``--reduced`` is a flag that defaults to on, so its CLI
always runs the reduced config, and so does this one; full width goes
through ``run(..., reduced=False)``; ``--layers N`` cuts the depth. Dense,
MoE / MLA, SSM and hybrid models train and serve (``--arch
deepseek_v2_lite_16b``, ``xlstm_125m``, ``zamba2_2_7b --layers 18``); like
the reference's, the audio and vision models are refused (the traffic
harness serves plain token streams). On the card training runs kernel B1
once a sim step and serving kernel B9 once an attention layer in every
decode boundary (none for xLSTM, the shared sites for Zamba2);
``--device cpu`` runs their plain versions. Like the reference's,
``--engine dist`` is refused: this CLI is one process.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Optional

import torch

from repro_torch.api import GossipTrainer
from repro_torch.api.trainer import ENGINES, resolve_device
from repro_torch.common.config import ModelConfig, OptimizerConfig, ProtocolConfig
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.fleet import memory
from repro_torch.launch.train import activation_bytes, engine_batch, lm_batches, replica_bytes
from repro_torch.models import transformer as tr
from repro_torch.serve import ContinuousBatcher, LiveServer, TrafficGen, TrainServeLoop
from repro_torch.serving.engine import make_serve_program
from repro_torch.train.losses import lm_loss_fn

GiB = 2.0 ** 30


def cache_bytes(cfg: ModelConfig, slots: int, max_len: int) -> int:
    """The server's f32 cache of ``slots`` rows of ``max_len`` positions,
    from ``init_cache`` on the meta device (nothing allocated): K and V of
    every layer's kv heads (a hybrid's shared sites'), MLA's latent c_kv
    and k_rope, the recurrent layers' state and conv buffer."""
    cache, _ = tr.init_cache(cfg, slots, max_len, device="meta")
    return sum(t.numel() * t.element_size() for t in tree_leaves(cache))


def plan_memory(cfg: ModelConfig, *, workers: int, tokens: int, seq: int, slots: int,
                max_len: int, device) -> int:
    """What the run needs, checked before anything is allocated: the
    training planes' estimate (:func:`repro_torch.fleet.validate_fleet_memory`,
    which refuses on its own) and the step's activations
    (:func:`repro_torch.launch.train.activation_bytes`), and beside them the
    serving side: the bus's two slots of one f32 replica each, the server's
    initial consensus copy (held until its first swap) and the cache. Prints
    them and returns their sum in bytes; raises ValueError when the sum
    exceeds the device's free memory (the host's on the CPU)."""
    rb = replica_bytes(cfg)
    train = memory.validate_fleet_memory(workers, rb, "device", what=f"{cfg.name}",
                                         device=device)
    act = activation_bytes(cfg, tokens, seq)
    cache = cache_bytes(cfg, slots, max_len)
    serve = 3 * rb + cache
    avail = memory.available_bytes("device", device)
    total = train + act + serve
    print(f"memory: training planes (estimate, fleet/memory.py) {train / GiB:.2f} GiB for "
          f"W={workers} x {rb / GiB:.2f} GiB; activations (estimate) "
          f"{act / GiB:.2f} GiB for {tokens} tokens; serving: "
          f"bus 2 x {rb / GiB:.2f} + initial consensus {rb / GiB:.2f} + KV cache "
          f"{cache / GiB:.3f} = {serve / GiB:.2f} GiB; sum "
          f"{total / GiB:.2f} GiB"
          + ("" if avail is None else f" of {avail / GiB:.2f} GiB free"), flush=True)
    if avail is not None and total > avail:
        raise ValueError(
            f"train-while-serve of {cfg.name} at W={workers} needs ~{total / GiB:.1f} "
            f"GiB (training {(train + act) / GiB:.1f} + serving {serve / GiB:.1f}) but only "
            f"{avail / GiB:.1f} GiB is free; reduce --workers, --slots or --max-len")
    return total


@dataclasses.dataclass
class TrainServe:
    """A built train-while-serve run: the trainer and its state, the server
    on its bus, the batcher and the loop. :meth:`run` drives it."""
    cfg: ModelConfig
    trainer: Any
    state: Any
    server: LiveServer
    batcher: ContinuousBatcher
    loop: TrainServeLoop
    info: dict      # the summary's run fields

    def run(self, boundaries: int) -> dict:
        """``boundaries`` decode boundaries (fewer if the cache's write head
        reaches ``max_len`` first); the reference's summary."""
        self.loop.run(boundaries)
        self.batcher.check_invariants()
        return {**self.info, "bus_seq": self.trainer.snapshot_bus.seq,
                **self.batcher.latency_summary(), **self.loop.summary()}


def build(arch: str, *, reduced: bool = True, engine: str = "sim", workers: int = 4,
          method: str = "elastic_gossip", p: float = 0.25, alpha: float = 0.5,
          lr: float = 0.01, seq: int = 32, per_worker_batch: int = 2, slots: int = 4,
          max_len: int = 256, rate: float = 0.3, num_requests: int = 24,
          publish_every: int = 5, train_per_boundary: int = 1,
          traffic_mode: str = "poisson", seed: int = 0, device="cuda",
          layers: int = 0) -> TrainServe:
    """The run of :func:`run` before its loop; ``layers`` cuts the depth to
    that many layers (widths uncut; 0 keeps it)."""
    if engine == "dist":
        raise ValueError('engine="dist" needs one process per worker; train-while-serve '
                         'is one process (use engine="sim" or "async")')
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {sorted(ENGINES)}")
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    assert cfg.audio is None and cfg.vlm is None, (
        "the traffic harness serves plain-LM archs")
    dev = resolve_device(device)
    info = {"arch": cfg.name, "engine": engine, "workers": workers, "slots": slots,
            "publish_every": publish_every}
    plan_memory(cfg, workers=workers, tokens=workers * per_worker_batch * seq, seq=seq,
                      slots=slots, max_len=max_len, device=dev)

    # ---- training side: gossip trainer with the snapshot publish hook armed
    trainer = GossipTrainer(
        engine=engine,
        protocol=ProtocolConfig(method=method, comm_probability=p, moving_rate=alpha,
                                topology="uniform"),
        optimizer=OptimizerConfig(name="nag", learning_rate=lr, momentum=0.9),
        loss_fn=lm_loss_fn(cfg), num_workers=workers,
        init_fn=lambda gen: tr.init_lm(gen, cfg)[0], publish_every=publish_every,
        device=dev)
    state = trainer.init_state(seed)
    batches = lm_batches(cfg, workers, per_worker_batch, seq, seed, device=dev)

    # ---- serving side: LiveServer over the bus the trainer publishes onto
    prog = make_serve_program(cfg, batch=slots, max_len=max_len, param_dtype=torch.float32,
                              cache_dtype=torch.float32, device=dev)
    server = LiveServer(prog, trainer.snapshot_bus, params=trainer.consensus_params(state))
    gen = TrafficGen(seed + 1, rate=rate, num_requests=num_requests, vocab=cfg.vocab_size,
                     prompt_len=(1, 8), max_new=(4, 16), mode=traffic_mode)
    batcher = ContinuousBatcher(server, gen.requests())

    # ---- interleave
    def train_fn(_boundary: int) -> int:
        for _ in range(train_per_boundary):
            b = next(batches)
            ts.state, _ = trainer.step(ts.state, engine_batch(b))
        return trainer._host_steps

    ts = TrainServe(cfg, trainer, state, server, batcher,
                    TrainServeLoop(server, batcher, train_fn), info)
    return ts


def run(arch: str, *, reduced: bool = True, engine: str = "sim", workers: int = 4,
        method: str = "elastic_gossip", p: float = 0.25, alpha: float = 0.5, lr: float = 0.01,
        seq: int = 32, per_worker_batch: int = 2, slots: int = 4, max_len: int = 256,
        boundaries: int = 120, rate: float = 0.3, num_requests: int = 24,
        publish_every: int = 5, train_per_boundary: int = 1, traffic_mode: str = "poisson",
        seed: int = 0, device="cuda", layers: int = 0) -> dict:
    """The reference's ``run`` with its parameters, plus ``device`` ("cuda",
    or "cpu" for the plain versions) and ``layers`` (a depth cut, as in
    :func:`build`). Returns the reference's summary dict, with the same
    keys."""
    return build(arch, reduced=reduced, engine=engine, workers=workers, method=method, p=p,
                 alpha=alpha, lr=lr, seq=seq, per_worker_batch=per_worker_batch, slots=slots,
                 max_len=max_len, rate=rate, num_requests=num_requests,
                 publish_every=publish_every, train_per_boundary=train_per_boundary,
                 traffic_mode=traffic_mode, seed=seed, device=device,
                 layers=layers).run(boundaries)


def parser() -> argparse.ArgumentParser:
    """The reference's flags, names and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama_1_1b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--engine", default="sim", choices=tuple(sorted(ENGINES)))
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--method", default="elastic_gossip")
    ap.add_argument("--p", type=float, default=0.25)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--boundaries", type=int, default=120)
    ap.add_argument("--rate", type=float, default=0.3)
    ap.add_argument("--num-requests", type=int, default=24)
    ap.add_argument("--publish-every", type=int, default=5)
    ap.add_argument("--train-per-boundary", type=int, default=1)
    ap.add_argument("--traffic-mode", default="poisson", choices=["poisson", "staggered"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (widths uncut; 0 keeps it)")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain versions)')
    return ap


def main(argv: Optional[list] = None) -> None:
    a = parser().parse_args(argv)
    out = run(a.arch, reduced=a.reduced, engine=a.engine, workers=a.workers, method=a.method,
              p=a.p, alpha=a.alpha, lr=a.lr, slots=a.slots, max_len=a.max_len,
              boundaries=a.boundaries, rate=a.rate, num_requests=a.num_requests,
              publish_every=a.publish_every, train_per_boundary=a.train_per_boundary,
              traffic_mode=a.traffic_mode, seed=a.seed, device=a.device, layers=a.layers)
    print(json.dumps(out, indent=2, sort_keys=True))


if __name__ == "__main__":
    main()
