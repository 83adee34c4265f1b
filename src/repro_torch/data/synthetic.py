"""Deterministic synthetic datasets.

The container is offline, so the paper-reproduction benchmarks run on
synthetic stand-ins with the same shapes/cardinalities as MNIST (784-dim,
10 classes) and CIFAR-10 (3x32x32, 10 classes). The generator produces a
class-conditional Gaussian mixture with controllable difficulty so accuracy
curves are informative (near-separable but not trivial). If real IDX files
are present under ``data_dir`` they are used instead (see :func:`load_mnist`).
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Dataset:
    x: np.ndarray       # [N, ...] float32
    y: np.ndarray       # [N] int32
    num_classes: int
    name: str


def make_classification(name: str, num_train: int, num_test: int, dim: Tuple[int, ...],
                        num_classes: int = 10, seed: int = 0, noise: float = 2.2) -> Tuple[Dataset, Dataset]:
    """Class-conditional Gaussians on random unit prototypes + per-class
    low-rank structure. ``noise`` controls Bayes error."""
    rng = np.random.RandomState(seed)
    d = int(np.prod(dim))
    protos = rng.randn(num_classes, d).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    protos *= np.sqrt(d) * 0.5
    basis = rng.randn(num_classes, 8, d).astype(np.float32) * 0.3

    def sample(n, seed2):
        r = np.random.RandomState(seed2)
        y = r.randint(0, num_classes, size=n).astype(np.int32)
        coef = r.randn(n, 8).astype(np.float32)
        x = protos[y] + np.einsum("nk,nkd->nd", coef, basis[y]) + noise * r.randn(n, d).astype(np.float32)
        # normalize like the paper's preprocessing (zero-mean unit-variance)
        return x.reshape((n,) + dim), y

    xtr, ytr = sample(num_train, seed + 1)
    xte, yte = sample(num_test, seed + 2)
    mean, std = xtr.mean(), xtr.std()
    xtr = (xtr - mean) / std
    xte = (xte - mean) / std
    return (Dataset(xtr, ytr, num_classes, name + "-train"),
            Dataset(xte, yte, num_classes, name + "-test"))


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">i", f.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "i" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def load_mnist(data_dir: Optional[str] = None, num_train: int = 51200,
               num_test: int = 10000, seed: int = 0, noise: float = 4.5) -> Tuple[Dataset, Dataset]:
    """Real MNIST if IDX files exist, else the synthetic MNIST-like stand-in.

    Sizes default to the paper's effective training set (51200 = 400 updates x
    128 effective batch per epoch, §4.1 fn.4).
    """
    data_dir = data_dir or os.environ.get("REPRO_DATA_DIR", "")
    names = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]
    paths = []
    for n in (names if data_dir else ()):
        for cand in (os.path.join(data_dir, n), os.path.join(data_dir, n + ".gz")):
            if os.path.exists(cand):
                paths.append(cand)
                break
    if len(paths) == 4:
        xtr = _read_idx(paths[0]).astype(np.float32).reshape(-1, 784)
        ytr = _read_idx(paths[1]).astype(np.int32)
        xte = _read_idx(paths[2]).astype(np.float32).reshape(-1, 784)
        yte = _read_idx(paths[3]).astype(np.int32)
        mean, std = xtr.mean(), xtr.std()
        xtr, xte = (xtr - mean) / std, (xte - mean) / std
        return (Dataset(xtr[:num_train], ytr[:num_train], 10, "mnist-train"),
                Dataset(xte[:num_test], yte[:num_test], 10, "mnist-test"))
    return make_classification("mnist-like", num_train, num_test, (784,), 10, seed=seed, noise=noise)


def load_cifar_like(num_train: int = 44800, num_test: int = 5000, seed: int = 1) -> Tuple[Dataset, Dataset]:
    """CIFAR-10-shaped synthetic stand-in (paper §4.2: 44800 train = 350
    updates x 128 per epoch)."""
    return make_classification("cifar-like", num_train, num_test, (32, 32, 3), 10, seed=seed, noise=2.8)


def make_lm_tokens(num_tokens: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    """Synthetic token stream with Zipfian marginals + short-range structure
    (order-1 mixing) so LM loss decreases measurably during training."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=num_tokens, p=probs).astype(np.int32)
    # with prob 0.5 copy the previous token shifted by a fixed offset -> learnable bigram
    copy = (rng.rand(num_tokens) < 0.5)
    shifted = (np.roll(base, 1) + 7) % vocab_size
    return np.where(copy, shifted, base).astype(np.int32)
