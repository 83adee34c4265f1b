"""Gemma2-9B [arXiv:2408.00118]: alternating local(4096)/global attention,
attn softcap 50, final softcap 30, post-norms, GeGLU, head_dim=256."""
import dataclasses
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", arch_type="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8,
    d_ff=14336, vocab_size=256000, head_dim=256, activation="geglu",
    local_window=4096, attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_norms=True, sw_decode_window=4096, source="arXiv:2408.00118",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma2-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
        head_dim=64, local_window=16)
