"""TinyLlama-1.1B [arXiv:2401.02385]: llama2-arch small, GQA kv=4."""
import dataclasses
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", arch_type="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000, rope_theta=10000.0,
    activation="swiglu", source="arXiv:2401.02385",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="tinyllama-reduced", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512)
