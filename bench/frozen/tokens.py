"""The synthetic token stream, copied from
``src/repro_torch/data/synthetic.py::make_lm_tokens`` at commit 0f5df9a
(itself the JAX package's generator): Zipfian marginals with a learnable
bigram. The only change: the numpy seed is taken modulo 2**32, since the
benchmark's seeds may exceed what ``RandomState`` accepts."""
from __future__ import annotations

import numpy as np


def make_lm_tokens(num_tokens: int, vocab_size: int, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed % 2 ** 32)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=num_tokens, p=probs).astype(np.int32)
    # with prob 0.5 copy the previous token shifted by a fixed offset -> learnable bigram
    copy = (rng.rand(num_tokens) < 0.5)
    shifted = (np.roll(base, 1) + 7) % vocab_size
    return np.where(copy, shifted, base).astype(np.int32)
