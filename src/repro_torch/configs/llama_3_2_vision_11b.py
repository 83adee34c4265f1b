"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision]: 40 self-attn
layers + 8 gated cross-attention blocks to stubbed vision-patch embeddings
(ViT encoder + projector are the assignment's frontend stub)."""
import dataclasses
from repro_torch.common.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", arch_type="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, rope_theta=500000.0, activation="swiglu",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    vlm=VLMConfig(cross_attn_layers=(3, 8, 13, 18, 23, 28, 33, 38),
                  num_image_tokens=1601, image_embed_dim=4096),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llama-vision-reduced", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512,
        vlm=VLMConfig(cross_attn_layers=(0,), num_image_tokens=16,
                      image_embed_dim=256))
