"""MusicGen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens
(4 codebooks, vocab 2048 each), cross-attention to stubbed conditioning
frame embeddings (the text/melody encoder is the assignment's frontend stub).
"""
import dataclasses
from repro_torch.common.config import AudioConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048, activation="gelu", source="arXiv:2306.05284",
    audio=AudioConfig(num_codebooks=4, num_cond_tokens=64),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=256,
        audio=AudioConfig(num_codebooks=2, num_cond_tokens=8))
