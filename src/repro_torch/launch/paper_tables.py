"""The paper's tables on the port: the counterpart of the reference's
``benchmarks/common.py`` (``run_config``, ``Result``, ``CSV_HEADER``) and
of the rows of its table scripts.

    python -m repro_torch.launch.paper_tables --table 4.3 --steps 20

runs Table 4.3's rows (the CIFAR-like CNN at W=4: all-reduce, elastic
gossip and gossiping SGD) on the card and prints the reference's CSV.
``--table`` takes ``4.1`` (MNIST: AR / NC / EG / GS at W = 4 and 8),
``4.2`` (the moving-rate sweep), ``4.3``, ``a.1`` (probability p against
period tau at the same expected cost) and ``alpha`` (constant against
annealed moving rate); ``--full`` takes the reference's full sweeps
instead of its quick ones.

Every row is ``GossipTrainer(engine="sim")`` with NAG on the synthetic
stand-ins (``data/synthetic.py``; real MNIST IDX files are read from
``$REPRO_DATA_DIR`` if present) at the paper's effective batch of 128.
MNIST runs the MLP (hidden ``$REPRO_BENCH_HIDDEN``, default 256) at lr
1e-3 / momentum 0.99, CIFAR the CNN at width 16, lr 0.01 / momentum 0.9.
Steps per row: ``steps=``, else ``$REPRO_BENCH_STEPS`` (default 400), as
the reference reads them.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import torch

from repro_torch.api import GossipTrainer
from repro_torch.api.trainer import resolve_device
from repro_torch.common.config import OptimizerConfig, ProtocolConfig
from repro_torch.data.partition import batches_for_step, partition_iid
from repro_torch.data.synthetic import Dataset, load_cifar_like, load_mnist
from repro_torch.models import simple

EFFECTIVE_BATCH = 128          # paper: effective batch 128 across workers


def bench_steps() -> int:
    return int(os.environ.get("REPRO_BENCH_STEPS", "400"))


def bench_hidden() -> int:
    return int(os.environ.get("REPRO_BENCH_HIDDEN", "256"))


@dataclasses.dataclass
class Result:
    label: str
    method: str
    workers: int
    p: float
    tau: int
    alpha: float
    rank0_acc: float
    aggregate_acc: float
    final_loss: float
    steps: int
    seconds: float
    comm_events: int
    comm_mb: float = 0.0     # measured cumulative egress per worker (MB)

    def csv(self) -> str:
        return (f"{self.label},{self.method},{self.workers},{self.p},{self.tau},"
                f"{self.alpha},{self.rank0_acc:.4f},{self.aggregate_acc:.4f},"
                f"{self.final_loss:.4f},{self.steps},{self.seconds:.1f},"
                f"{self.comm_events},{self.comm_mb:.2f}")


CSV_HEADER = ("label,method,workers,p,tau,alpha,rank0_acc,aggregate_acc,"
              "final_loss,steps,seconds,comm_events,comm_mb")


def _model(task: str, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if task == "mnist":
        params, _ = simple.init_mlp(gen, in_dim=784, hidden=bench_hidden(), depth=3,
                                    num_classes=10)
        return params, simple.mlp_logits
    params, _ = simple.init_cnn(gen, num_classes=10, width=16)
    return params, simple.cnn_logits


def run_config(method: str, workers: int, *, p: float = 0.0, tau: int = 0,
               alpha: float = 0.5, steps: int = 0, label: str = "",
               task: str = "mnist", seed: int = 0, lr: Optional[float] = None,
               momentum: Optional[float] = None, alpha_final: float = -1.0,
               alpha_decay_steps: int = 0,
               train: Optional[Dataset] = None, test: Optional[Dataset] = None,
               device="cuda") -> Result:
    """One table row: ``steps`` sim steps of ``method`` on ``workers``
    workers, then rank-0 and aggregate accuracy on the test set."""
    steps = steps or bench_steps()
    dev = resolve_device(device)
    if task == "mnist":
        if train is None:
            train, test = load_mnist(num_train=25600, num_test=4000)
        lr = 1e-3 if lr is None else lr
        momentum = 0.99 if momentum is None else momentum
    else:
        if train is None:
            train, test = load_cifar_like(num_train=12800, num_test=2000)
        lr = 0.01 if lr is None else lr
        momentum = 0.9 if momentum is None else momentum

    proto_kw = {}
    if method not in ("allreduce", "none"):
        proto_kw = {"comm_probability": p, "comm_period": tau}
    proto = ProtocolConfig(method=method, moving_rate=alpha, topology="uniform",
                           moving_rate_final=alpha_final,
                           alpha_decay_steps=alpha_decay_steps, **proto_kw)
    opt = OptimizerConfig(name="nag", learning_rate=lr, momentum=momentum)
    params0, apply_fn = _model(task, seed, dev)

    def loss_fn(prm, x, y):
        return simple.xent_loss(apply_fn(prm, x), y)

    trainer = GossipTrainer(engine="sim", protocol=proto, optimizer=opt,
                            loss_fn=loss_fn, num_workers=workers, device=dev)
    state = trainer.init_state(seed, params=params0)
    shards = partition_iid(train, workers, seed)
    per_worker = EFFECTIVE_BATCH // workers
    t0 = time.time()
    m = None
    for i in range(steps):
        x, y = batches_for_step(shards, i, per_worker)
        state, m = trainer.step(state, (torch.as_tensor(x, device=dev),
                                        torch.as_tensor(y, device=dev)))
    # one host read after the loop (it waits for the last step)
    last_loss, comm_bytes = float(m["loss"]), float(m["comm_bytes"])
    seconds = time.time() - t0

    with torch.no_grad():
        xt = torch.as_tensor(test.x, device=dev)
        yt = torch.as_tensor(test.y, device=dev)
        acc0 = float(simple.accuracy(apply_fn(trainer.rank0_params(state), xt), yt))
        acca = float(simple.accuracy(apply_fn(trainer.consensus_params(state), xt), yt))
    return Result(label or f"{method}-{workers}", method, workers, p, tau, alpha,
                  acc0, acca, last_loss, steps, seconds,
                  int(state.proto.comm_rounds), comm_bytes / 1e6)


# ---------------------------------------------------------------------------
# the rows of the reference's table scripts
# ---------------------------------------------------------------------------

ALPHAS = (0.05, 0.25, 0.5, 0.75, 0.95)


def table_rows(table: str, quick: bool = True, steps: int = 0):
    """(title, [(label, method, workers, run_config kwargs)]) of a table."""
    table = table.lower()
    rows = []
    if table == "4.1":
        title = "# Table 4.1 — MNIST(-like): AR vs NC vs EG vs GS"
        ps = [0.125, 0.03125] if quick else [0.125, 0.03125, 0.0078125, 0.001953125]
        rows += [("AR-4", "allreduce", 4, {}), ("NC-4", "none", 4, {})]
        for p in ps:
            rows.append((f"EG-4-{p:.3f}", "elastic_gossip", 4, dict(p=p)))
            rows.append((f"GS-4-{p:.3f}", "gossiping_pull", 4, dict(p=p)))
        rows.append((f"EG-8-{ps[-1]:.3f}", "elastic_gossip", 8, dict(p=ps[-1])))
        rows.append((f"GS-8-{ps[-1]:.3f}", "gossiping_pull", 8, dict(p=ps[-1])))
        rows = [(lb, m, w, dict(kw, alpha=0.5, task="mnist")) for lb, m, w, kw in rows]
    elif table == "4.2":
        title = "# Table 4.2 — moving-rate sweep (Elastic Gossip, W=4)"
        p = 0.03125
        for a in (ALPHAS if not quick else (0.05, 0.5, 0.95)):
            rows.append((f"EG-4-{p:.4f}-{a:.2f}", "elastic_gossip", 4,
                         dict(p=p, alpha=a, task="mnist")))
    elif table == "4.3":
        title = "# Table 4.3 — CIFAR-like CNN: AR vs EG vs GS (W=4)"
        rows.append(("AR-4", "allreduce", 4, dict(alpha=0.5, task="cifar")))
        for p in ([0.125] if quick else [0.125, 0.03125, 0.0078125]):
            rows.append((f"EG-4-{p:.3f}", "elastic_gossip", 4, dict(p=p, alpha=0.5,
                                                                    task="cifar")))
            rows.append((f"GS-4-{p:.3f}", "gossiping_pull", 4, dict(p=p, alpha=0.5,
                                                                    task="cifar")))
    elif table == "a.1":
        title = "# Table A.1 — p vs tau at matched expected communication"
        for tau in ([8] if quick else [8, 32, 128]):
            rows.append((f"GS-tau{tau}", "gossiping_pull", 4, dict(tau=tau, task="mnist")))
            rows.append((f"GS-p{1.0 / tau:.4f}", "gossiping_pull", 4,
                         dict(p=1.0 / tau, task="mnist")))
    elif table == "alpha":
        title = "# alpha schedule (beyond-paper, thesis §4.1.3): constant vs annealed"
        for lb, kw in (("EG-const-0.5", dict(alpha=0.5)), ("EG-const-0.9", dict(alpha=0.9)),
                       ("EG-anneal-0.9to0.1", dict(alpha=0.9, alpha_final=0.1,
                                                   alpha_decay_steps=steps or bench_steps()))):
            rows.append((lb, "elastic_gossip", 4, dict(kw, p=0.125, task="mnist")))
    else:
        raise ValueError(f"unknown table {table!r}; one of 4.1, 4.2, 4.3, a.1, alpha")
    return title, rows


def main(table: str = "4.3", quick: bool = True, steps: int = 0,
         device="cuda") -> List[Result]:
    """Run one table's rows and print its CSV; returns the results."""
    title, rows = table_rows(table, quick, steps)
    print(title)
    print(CSV_HEADER)
    results = []
    for label, method, workers, kw in rows:
        r = run_config(method, workers, label=label, steps=steps, device=device, **kw)
        print(r.csv(), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--table", default="4.3", help="4.1 | 4.2 | 4.3 | a.1 | alpha")
    ap.add_argument("--steps", type=int, default=0,
                    help="steps per row (default $REPRO_BENCH_STEPS or 400)")
    ap.add_argument("--full", action="store_true", help="the full sweeps, not the quick ones")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.table, quick=not a.full, steps=a.steps, device=a.device)
