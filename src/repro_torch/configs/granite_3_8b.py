"""Granite-3.0 8B [hf:ibm-granite/granite-3.0-2b-base family]: GQA kv=8."""
import dataclasses
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", arch_type="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12800, vocab_size=49155, activation="swiglu",
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite3-reduced", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512)
