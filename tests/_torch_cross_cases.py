"""Shared cases of ``test_torch_cross.py`` and ``test_torch_cross_train.py``:
the reduced ``musicgen_large`` and ``llama_3_2_vision_11b`` with the
reference's ``init_lm`` weights, every cross gate set to 0.5 (they are zero
at init, which would hide the cross path), and seeded numpy tokens and a
random ``cond``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as jtr
from repro_torch.configs import get_reduced
from repro_torch.models import transformer as tr

ARCHS = ["musicgen_large", "llama_3_2_vision_11b"]
TOL = dict(rtol=1e-4, atol=1e-5)
GATE = 0.5
W, PB, SEQ = 2, 2, 16            # workers, sequences per worker, tokens per sequence
B, PROMPT, DECODE, MAX_LEN = 2, 12, 4, 24


def open_gates(tree):
    """The numpy parameter tree with every cross gate set to GATE."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, GATE) if k in ("gate", "ffn_gate") else open_gates(v))
                for k, v in tree.items()}
    return tree


def cond_shape(cfg, batch):
    if cfg.audio is not None:
        return (batch, cfg.audio.num_cond_tokens, cfg.d_model)
    return (batch, cfg.vlm.num_image_tokens, cfg.vlm.image_embed_dim)


def tokens(cfg, rng, lead, seq):
    K = () if cfg.audio is None else (cfg.audio.num_codebooks,)
    return rng.randint(0, cfg.vocab_size, lead + K + (seq,)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(jcfg, cfg, reference params (gates open), their numpy tree, tokens
    [W, PB, (K,) SEQ], labels, cond [W, PB, T, e])."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp_np = open_gates(jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg)[0]))
    jp = jax.tree.map(jnp.asarray, jp_np)
    rng = np.random.RandomState(1)
    toks = tokens(cfg, rng, (W, PB), SEQ)
    labels = tokens(cfg, rng, (W, PB), SEQ)
    labels[(0, 0) + (0,) * (labels.ndim - 3) + (3,)] = -1
    cond = rng.randn(W, *cond_shape(cfg, PB)).astype(np.float32)
    return jcfg, cfg, jp, jp_np, toks, labels, cond


def port(jp_np, dtype=None):
    return tr.params_from_jax(jp_np, "cpu", dtype)


def np_(t):
    return t.detach().float().numpy()
