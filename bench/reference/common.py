"""Plain building blocks shared by the reference models."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm(w, x, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding on the last dim of x [B, S, H, d] at positions
    0..S-1, rotating the two halves of each head (the configuration as the
    program runs it)."""
    d, S = x.shape[-1], x.shape[1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, scale: float):
    """q, k: [B, S, H, dqk]; v: [B, S, H, dv] -> [B, S, H, dv]: softmax over
    the keys at or before each query, every score materialised."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def swiglu(p, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def gelu_mlp(p, x):
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def cross_entropy(hidden, head, labels):
    """Mean next-token cross-entropy over every position, logits in f32."""
    logits = hidden.reshape(-1, hidden.shape[-1]) @ head
    return F.cross_entropy(logits, labels.reshape(-1).long())


def layer(stacked: dict, i: int) -> dict:
    """Layer i of a stacked parameter dict ([count, ...] leaves)."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i]) for k, v in stacked.items()}
