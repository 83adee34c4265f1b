"""Zamba2-2.7B [arXiv:2411.15242]: 54 Mamba2 layers + 2 alternating shared
attention+MLP blocks applied every 6 layers, ssm_state=64."""
import dataclasses
from repro_torch.common.config import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, activation="gelu", source="arXiv:2411.15242",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk_size=256),
    hybrid=HybridConfig(shared_attn_every=6, num_shared_blocks=2),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="zamba2-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_dim=4, chunk_size=16),
        hybrid=HybridConfig(shared_attn_every=1, num_shared_blocks=2))
