"""Per-architecture loss closures and batch layouts (port of
``repro.train.losses``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer as tr


def lm_loss_fn(cfg: ModelConfig):
    """Returns ``loss(params, batch)`` -> scalar, the reference's closure
    (batch keys ``tokens``, ``labels``, optionally ``cond``), which also
    takes the engines' ``loss(params, x, labels)`` with ``x`` the tokens or
    ``{"tokens", "cond"}`` (the audio and vision models' conditioning rides
    the engines' batch beside the tokens)."""

    def loss(params, batch, labels=None):
        if labels is not None:
            batch = dict(batch if isinstance(batch, dict) else {"tokens": batch},
                         labels=labels)
        total, _ = tr.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                              batch.get("cond"))
        return total

    return loss


def batch_shapes(cfg: ModelConfig, per_worker_batch: int, seq_len: int) -> Dict[str, tuple]:
    """Shapes of ONE worker's batch (no worker dim), with dtypes."""
    if cfg.audio is not None:
        K = cfg.audio.num_codebooks
        return {"tokens": ((per_worker_batch, K, seq_len), torch.int32),
                "labels": ((per_worker_batch, K, seq_len), torch.int32),
                "cond": ((per_worker_batch, cfg.audio.num_cond_tokens, cfg.d_model),
                         torch.bfloat16)}
    out = {"tokens": ((per_worker_batch, seq_len), torch.int32),
           "labels": ((per_worker_batch, seq_len), torch.int32)}
    if cfg.vlm is not None:
        out["cond"] = ((per_worker_batch, cfg.vlm.num_image_tokens, cfg.vlm.image_embed_dim),
                       torch.bfloat16)
    return out


def batch_axes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Logical axes of one worker's batch arrays (leading dim = batch)."""
    if cfg.audio is not None:
        return {"tokens": ("batch", None, "seq"), "labels": ("batch", None, "seq"),
                "cond": ("batch", "seq", "act_embed")}
    out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.vlm is not None:
        out["cond"] = ("batch", "seq", "act_embed")
    return out
