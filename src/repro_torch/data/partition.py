"""Per-worker data partitioning.

The paper's data-parallel setting assigns each worker a disjoint partition
X^i. We support iid (shuffled round-robin, the paper's setting) and
Dirichlet label-skew (the paper's §5 'biased and skewed' future-work setting,
which our benchmarks also exercise).
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.data.synthetic import Dataset


def partition_iid(ds: Dataset, num_workers: int, seed: int = 0) -> List[Dataset]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(ds.y))
    shards = np.array_split(idx, num_workers)
    return [Dataset(ds.x[s], ds.y[s], ds.num_classes, f"{ds.name}-w{i}")
            for i, s in enumerate(shards)]


def partition_dirichlet(ds: Dataset, num_workers: int, alpha: float, seed: int = 0) -> List[Dataset]:
    """Label-skewed partition: for each class, split its instances across
    workers with Dirichlet(alpha) proportions. alpha->inf recovers iid;
    alpha->0 gives near single-class workers."""
    rng = np.random.RandomState(seed)
    per_worker: List[List[int]] = [[] for _ in range(num_workers)]
    for c in range(ds.num_classes):
        idx = np.where(ds.y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_workers)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for w, chunk in enumerate(np.split(idx, cuts)):
            per_worker[w].extend(chunk.tolist())
    out = []
    for w, ids in enumerate(per_worker):
        ids = np.array(ids, dtype=np.int64)
        rng.shuffle(ids)
        out.append(Dataset(ds.x[ids], ds.y[ids], ds.num_classes, f"{ds.name}-skew-w{w}"))
    return out


def batches_for_step(shards: List[Dataset], step: int, per_worker_batch: int):
    """Deterministic epoch-cycling minibatch for every worker at ``step``.
    Returns stacked arrays x:[W, b, ...], y:[W, b]."""
    xs, ys = [], []
    for ds in shards:
        n = (len(ds.y) // per_worker_batch) * per_worker_batch
        lo = (step * per_worker_batch) % max(n, per_worker_batch)
        hi = lo + per_worker_batch
        if hi <= len(ds.y):
            xs.append(ds.x[lo:hi])
            ys.append(ds.y[lo:hi])
        else:  # tiny shard: wrap
            sel = np.arange(lo, hi) % len(ds.y)
            xs.append(ds.x[sel])
            ys.append(ds.y[sel])
    return np.stack(xs), np.stack(ys)
