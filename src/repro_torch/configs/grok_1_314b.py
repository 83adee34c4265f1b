"""Grok-1 314B [hf:xai-org/grok-1]: MoE 8 experts top-2, GQA kv=8."""
import dataclasses
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", arch_type="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072, activation="geglu",
    source="hf:xai-org/grok-1",
    moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=0,
                  d_ff_expert=32768, first_dense_layers=0),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="grok-reduced", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=512))
