"""Granite-20B code model [arXiv:2405.04324]: llama-arch, MQA (kv=1)."""
import dataclasses
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", arch_type="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, activation="gelu", source="arXiv:2405.04324",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite20b-reduced", num_layers=2, d_model=384,
        num_heads=6, num_kv_heads=1, d_ff=768, vocab_size=512)
