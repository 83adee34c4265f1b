"""DeepSeek-V2 (arXiv:2405.04434) as a plain f32 reference: MLA attention in
its published, non-absorbed form (keys and values expanded from the
512-wide latent per head), a SwiGLU FFN in the leading dense layers, then
MoE layers of softmax-routed top-k experts beside the shared experts, with
the capacity rule and the load-balance loss. Every experts' product is
computed token by token on the slots that the capacity keeps.

Where the program departs from the published model, the reference follows
the configuration file's ``as_run`` group, as the program runs: plain RoPE
on the halves of each head (no YaRN scaling), the top-k weights
renormalised where ``norm_topk_prob`` is true, a batch-level (Switch)
load-balance loss scaled by ``router_aux_loss_coef`` in place of DeepSeek's
per-sequence one, and the capacity rule (slots taken in token order, an
expert's slots beyond ``C = int(T k / E cf)`` dropped).

Parameters use the program's names and shapes, so that the benchmark can
hand the same tensors to both sides.
"""
from __future__ import annotations

import torch

from bench.frozen import flops as F_
from bench.reference.common import (causal_attention, cross_entropy, layer, rmsnorm, rope,
                                    swiglu)

def _dims(c: dict) -> dict:
    return dict(d=c["hidden_size"], H=c["num_attention_heads"], r=c["kv_lora_rank"],
                nope=c["qk_nope_head_dim"], rope=c["qk_rope_head_dim"], dv=c["v_head_dim"],
                dff=c["intermediate_size"], f=c["moe_intermediate_size"],
                E=c["n_routed_experts"], k=c["num_experts_per_tok"], ns=c["n_shared_experts"],
                dense=c["first_k_dense_replace"], L=c["num_hidden_layers"], V=c["vocab_size"])


def _segments(c: dict):
    m = _dims(c)
    segs = []
    if m["dense"] > 0:
        segs.append(("seg0_attn", min(m["dense"], m["L"]), False))
    if m["L"] > m["dense"]:
        segs.append((f"seg{len(segs)}_attn_moe", m["L"] - m["dense"], True))
    return segs


def param_table(c: dict):
    """[(path, shape, init)] in draw order. init: ("normal", fan_in, scale)
    for std = scale * sqrt(2 / fan_in), or ("ones",)."""
    m = _dims(c)
    d, H, r, V = m["d"], m["H"], m["r"], m["V"]
    t = [(("embed",), (1, V, d), ("normal", d, 0.5))]
    for name, n, moe in _segments(c):
        s = ("segments", name)
        t += [(s + ("ln1",), (n, d), ("ones",)),
              (s + ("attn", "wq"), (n, d, H, m["nope"] + m["rope"]), ("normal", d, 1.0)),
              (s + ("attn", "kv_down"), (n, d, r + m["rope"]), ("normal", d, 1.0)),
              (s + ("attn", "k_up"), (n, r, H, m["nope"]), ("normal", r, 1.0)),
              (s + ("attn", "v_up"), (n, r, H, m["dv"]), ("normal", r, 1.0)),
              (s + ("attn", "wo"), (n, H, m["dv"], d), ("normal", H * m["dv"], 1.0)),
              (s + ("attn", "kv_norm"), (n, r), ("ones",)),
              (s + ("ln2",), (n, d), ("ones",))]
        f = s + ("ffn",)
        if moe:
            E, fe, sh = m["E"], m["f"], m["ns"] * m["f"]
            t += [(f + ("router",), (n, d, E), ("normal", d, 1.0)),
                  (f + ("w_gate",), (n, E, d, fe), ("normal", d, 1.0)),
                  (f + ("w_up",), (n, E, d, fe), ("normal", d, 1.0)),
                  (f + ("w_down",), (n, E, fe, d), ("normal", fe, 1.0))]
            if m["ns"]:
                t += [(f + ("shared", "w_gate"), (n, d, sh), ("normal", d, 1.0)),
                      (f + ("shared", "w_up"), (n, d, sh), ("normal", d, 1.0)),
                      (f + ("shared", "w_down"), (n, sh, d), ("normal", sh, 1.0))]
        else:
            t += [(f + ("w_gate",), (n, d, m["dff"]), ("normal", d, 1.0)),
                  (f + ("w_up",), (n, d, m["dff"]), ("normal", d, 1.0)),
                  (f + ("w_down",), (n, m["dff"], d), ("normal", m["dff"], 1.0))]
    t += [(("final_norm",), (d,), ("ones",)),
          (("lm_head",), (1, d, V), ("normal", d, 1.0))]
    return t


def _mla(p, h, c: dict):
    m = _dims(c)
    B, S, _ = h.shape
    q = torch.einsum("bsd,dhe->bshe", h, p["wq"])
    q_nope, q_rope = q[..., :m["nope"]], rope(q[..., m["nope"]:], c["rope_theta"])
    down = h @ p["kv_down"]
    c_kv = rmsnorm(p["kv_norm"], down[..., :m["r"]], c["rms_norm_eps"])
    k_rope = rope(down[..., m["r"]:][:, :, None, :], c["rope_theta"])
    k_nope = torch.einsum("bsr,rhn->bshn", c_kv, p["k_up"])
    v = torch.einsum("bsr,rhv->bshv", c_kv, p["v_up"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, m["H"], m["rope"])], dim=-1)
    o = causal_attention(q, k, v, (m["nope"] + m["rope"]) ** -0.5)
    return torch.einsum("bshv,hvd->bsd", o, p["wo"])


def capacity(c: dict, tokens: int) -> int:
    return max(int(tokens * c["num_experts_per_tok"] / c["n_routed_experts"]
                   * c["as_run"]["capacity_factor"]), 1)


def _moe(p, h, c: dict):
    """(y, aux): top-k of the softmax over the experts (the weights
    renormalised where ``as_run`` says so), each expert's slots beyond the
    capacity dropped in token order; the shared experts on every token; the
    Switch load-balance loss."""
    B, S, d = h.shape
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    T = B * S
    x = h.reshape(T, d)
    probs = torch.softmax(x @ p["router"], dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    if c["as_run"]["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    slot_e = ids.reshape(-1)                                    # slot t * k + j
    rank = torch.cumsum(torch.nn.functional.one_hot(slot_e, E), dim=0)
    rank = rank.gather(1, slot_e[:, None])[:, 0] - 1            # order within its expert
    keep = rank < capacity(c, T)
    slot_w = w.reshape(-1)
    y = torch.zeros_like(x)
    for e in range(E):
        slots = torch.nonzero((slot_e == e) & keep)[:, 0]
        tok = slots // k
        out = swiglu({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                      "w_down": p["w_down"][e]}, x[tok])
        y = y.index_add(0, tok, out * slot_w[slots][:, None])
    if "shared" in p:
        y = y + swiglu(p["shared"], x)
    frac_tokens = torch.bincount(ids[:, 0], minlength=E).to(probs.dtype) / T
    aux = E * torch.sum(frac_tokens * probs.mean(dim=0))
    return y.reshape(B, S, d), aux


def loss(params, tokens, labels, c: dict):
    """Next-token cross-entropy plus ``as_run``'s ``router_aux_loss_coef`` x the MoE
    layers' load-balance losses, for one worker's batch [B, S]."""
    eps = c["rms_norm_eps"]
    x = params["embed"][0][tokens.long()]
    aux = torch.zeros((), dtype=x.dtype, device=x.device)
    for name, n, moe in _segments(c):
        for i in range(n):
            p = layer(params["segments"][name], i)
            x = x + _mla(p["attn"], rmsnorm(p["ln1"], x, eps), c)
            h = rmsnorm(p["ln2"], x, eps)
            if moe:
                y, a = _moe(p["ffn"], h, c)
                aux = aux + a
            else:
                y = swiglu(p["ffn"], h)
            x = x + y
    x = rmsnorm(params["final_norm"], x, eps)
    coef = c["as_run"]["router_aux_loss_coef"]
    return cross_entropy(x, params["lm_head"][0], labels) + coef * aux


def model_flops(c: dict, batch: int, seq: int, pairs=F_.causal_pairs) -> int:
    """One worker's training step over ``batch`` sequences of ``seq``
    (``bench/frozen/flops.py``)."""
    m = _dims(c)
    d, H, r = m["d"], m["H"], m["r"]
    attn = (d * H * (m["nope"] + m["rope"]) + d * (r + m["rope"]) + r * H * m["nope"]
            + r * H * m["dv"] + H * m["dv"] * d)
    dense = 3 * d * m["dff"]
    moe = d * m["E"] + (m["k"] + m["ns"]) * 3 * d * m["f"]
    n_dense = min(m["dense"], m["L"])
    per_token = m["L"] * attn + n_dense * dense + (m["L"] - n_dense) * moe + d * m["V"]
    return (F_.matmul_flops(per_token, batch * seq)
            + m["L"] * F_.attention_flops(batch, seq, H, m["nope"] + m["rope"], m["dv"], pairs))
