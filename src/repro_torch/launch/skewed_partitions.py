"""Gossip under label-skewed data partitions (port of
``examples/skewed_partitions.py``, the future work of the paper's §5):
Dirichlet label skew across workers, gossip's consensus pressure against
heterogeneous local objectives.

    PYTHONPATH=src python -m repro_torch.launch.skewed_partitions            # on the card
    PYTHONPATH=src python -m repro_torch.launch.skewed_partitions --steps 5 --device cpu

Each skew runs Elastic Gossip (p 0.125) and no communication at W=4
through :func:`repro_torch.launch.paper_tables.run_config`, whose
partitioner is swapped for the run the way the reference's example swaps
its benchmarks' one, and prints the reference's CSV.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data.partition import partition_dirichlet
from repro_torch.data.synthetic import load_mnist
from repro_torch.launch import paper_tables
from repro_torch.launch.paper_tables import CSV_HEADER, run_config

SKEWS = (100.0, 0.5, 0.1)
STEPS = 200


def main(steps: int = STEPS, device="cuda", skews=SKEWS) -> list:
    """Print the CSV rows; return ``(Result, per-worker label counts)`` for
    every row."""
    train, test = load_mnist(num_train=12800, num_test=2000)
    print(CSV_HEADER)
    out = []
    for alpha_skew in skews:
        counts = []

        def skewed(ds, W, seed, alpha_skew=alpha_skew):
            shards = partition_dirichlet(ds, W, alpha_skew, seed)
            counts.append(np.stack([np.bincount(s.y, minlength=ds.num_classes)
                                    for s in shards]))
            return shards

        # swap the partitioner for this experiment
        orig = paper_tables.partition_iid
        paper_tables.partition_iid = skewed
        try:
            for label, method, p in [(f"EG-skew{alpha_skew}", "elastic_gossip", 0.125),
                                     (f"NC-skew{alpha_skew}", "none", 0.0)]:
                r = run_config(method, 4, p=p, alpha=0.5, label=label, task="mnist",
                               train=train, test=test, steps=steps, device=device)
                print(r.csv(), flush=True)
                out.append((r, counts[-1]))
        finally:
            paper_tables.partition_iid = orig
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.steps, a.device)
