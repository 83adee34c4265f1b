"""Quickstart for the port's API (port of ``examples/quickstart.py``): train
the paper's MNIST MLP (§4.1) with Elastic Gossip across 4 simulated
workers, with and without the int8 wire codec, on the virtual-time async
engine under lognormal stragglers, and against the All-reduce SGD
baseline; report Rank-0 / Aggregate (consensus) accuracy and the measured
communication bytes:

    trainer = GossipTrainer(engine="sim", protocol=..., loss_fn=..., num_workers=4)
    state = trainer.init_state(seed)
    state, metrics = trainer.step(state, (x, y))     # scheduling is internal

    PYTHONPATH=src python -m repro_torch.launch.quickstart            # on the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu --steps 30

On the card the sim steps run kernel B1 (and B4 / B5 with ``codec="q8"``);
the async engine runs B1 once an event window on the window's rows. The
weights are random from a seed (a ``torch.Generator``), so the accuracies
are the port's own; the async half's virtual time and window count are pure
hashes of the time model, equal to the reference's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.api import GossipTrainer, available_protocols
from repro_torch.api.trainer import resolve_device
from repro_torch.common.config import HeteroConfig, OptimizerConfig, ProtocolConfig
from repro_torch.data.partition import batches_for_step, partition_iid
from repro_torch.data.synthetic import load_mnist
from repro_torch.models import simple

WORKERS, STEPS, BATCH = 4, 300, 128


def _params0(dev):
    return simple.init_mlp(torch.Generator(device=dev).manual_seed(0), in_dim=784,
                           hidden=128, depth=2, num_classes=10)[0]


def _loss_fn(params, x, y):
    return simple.xent_loss(simple.mlp_logits(params, x), y)


def _accuracy(params, test, dev) -> float:
    with torch.no_grad():
        xt, yt = torch.as_tensor(test.x, device=dev), torch.as_tensor(test.y, device=dev)
        return float(simple.accuracy(simple.mlp_logits(params, xt), yt))


def train_one(method: str, train, test, codec: str = "none", *, steps: int = STEPS,
              device="cuda", **proto_kw):
    """``steps`` sim steps of ``method``; prints and returns (aggregate
    accuracy, MB sent per worker)."""
    dev = resolve_device(device)
    proto = ProtocolConfig(method=method, topology="uniform", codec=codec, **proto_kw)
    trainer = GossipTrainer(engine="sim", protocol=proto,
                            optimizer=OptimizerConfig(name="nag", learning_rate=1e-3,
                                                      momentum=0.99),
                            loss_fn=_loss_fn, num_workers=WORKERS, device=dev)
    state = trainer.init_state(0, params=_params0(dev))
    shards = partition_iid(train, WORKERS, seed=0)
    for i in range(steps):
        x, y = batches_for_step(shards, i, BATCH // WORKERS)
        state, m = trainer.step(state, (torch.as_tensor(x, device=dev),
                                        torch.as_tensor(y, device=dev)))
    acc0 = _accuracy(trainer.rank0_params(state), test, dev)
    acca = _accuracy(trainer.consensus_params(state), test, dev)
    mb = float(m["comm_bytes"]) / 1e6
    label = method if codec == "none" else f"{method}+{codec}"
    print(f"{label:20s} rank0_acc={acc0:.4f} aggregate_acc={acca:.4f} "
          f"loss={float(m['loss']):.4f} comm={mb:8.2f} MB/worker")
    return acca, mb


def train_one_async(method: str, train, test, *, steps: int = STEPS, device="cuda",
                    **proto_kw) -> dict:
    """The same protocol on the virtual-time async engine under lognormal
    stragglers (sigma 0.6): one facade ``step`` is one event window, often a
    single worker, so the budget is ``WORKERS * steps`` worker-steps, not
    lockstep steps. Prints a line; returns the aggregate accuracy, the
    virtual time, the windows taken and the staleness accumulators."""
    dev = resolve_device(device)
    proto = ProtocolConfig(method=method, topology="uniform", **proto_kw)
    trainer = GossipTrainer(
        engine="async", protocol=proto,
        hetero=HeteroConfig(time_model="lognormal", sigma=0.6),
        optimizer=OptimizerConfig(name="nag", learning_rate=1e-3, momentum=0.99),
        loss_fn=_loss_fn, num_workers=WORKERS, device=dev)
    state = trainer.init_state(0, params=_params0(dev))
    shards = partition_iid(train, WORKERS, seed=0)
    windows = done = 0
    while done < WORKERS * steps:
        x, y = batches_for_step(shards, windows, BATCH // WORKERS)
        state, m = trainer.step(state, (torch.as_tensor(x, device=dev),
                                        torch.as_tensor(y, device=dev)))
        windows += 1
        done += int(m["window_size"])
    acca = _accuracy(trainer.consensus_params(state), test, dev)
    events = max(int(state.proto.stale_events), 1)
    out = {"aggregate_acc": acca, "virtual_time": float(m["virtual_time"]), "windows": windows,
           "worker_steps": done, "exchanges": events,
           "mean_staleness_s": float(state.proto.stale_time) / events,
           "mean_staleness_steps": int(state.proto.stale_steps) / events}
    print(f"{method + '+async':20s} aggregate_acc={acca:.4f} "
          f"virtual_time={out['virtual_time']:8.1f} "
          f"mean_staleness={out['mean_staleness_s']:.2f}s "
          f"({out['mean_staleness_steps']:.2f} steps) over {events} exchanges "
          f"in {windows} windows")
    return out


def main(steps: int = STEPS, device="cuda") -> None:
    print("registered protocols:", ", ".join(available_protocols()))
    train, test = load_mnist(num_train=25600, num_test=4000)
    print(f"\n== {WORKERS} workers, {steps} steps, effective batch {BATCH} ==")
    kw = dict(steps=steps, device=device)
    acc_eg, mb_eg = train_one("elastic_gossip", train, test, comm_probability=0.125,
                              moving_rate=0.5, **kw)
    # the int8 wire codec: ~4x fewer bytes again, comm_bytes the true egress
    acc_q8, mb_q8 = train_one("elastic_gossip", train, test, codec="q8",
                              comm_probability=0.125, moving_rate=0.5, **kw)
    # a heterogeneous fleet: the same protocol on the async engine
    train_one_async("elastic_gossip", train, test, comm_probability=0.125, moving_rate=0.5,
                    **kw)
    acc_ar, mb_ar = train_one("allreduce", train, test, **kw)
    print(f"\nElastic Gossip reaches {acc_eg:.1%} vs All-reduce {acc_ar:.1%} "
          f"while sending {mb_eg:.1f} MB vs {mb_ar:.1f} MB per worker "
          f"(~{mb_ar / max(mb_eg, 1e-9):.0f}x less communication, paper Tables 4.1/4.3); "
          f"the q8 wire codec keeps {acc_q8:.1%} at {mb_q8:.1f} MB "
          f"(~{mb_ar / max(mb_q8, 1e-9):.0f}x total).")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.steps, a.device)
