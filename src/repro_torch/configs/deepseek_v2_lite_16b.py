"""DeepSeek-V2-Lite 16B [arXiv:2405.04434]: MLA kv_lora=512, MoE 64 routed
top-6 + 2 shared experts, first layer dense.

Assignment note (DESIGN.md §5): the assignment line mixes V2-Lite (64e) and
V2 (160e) numbers; we implement the Lite spec matching the primary
"MoE 64e top-6" designation.
"""
import dataclasses
from repro_torch.common.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", arch_type="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=10944, vocab_size=102400, rope_theta=10000.0,
    activation="swiglu", source="arXiv:2405.04434",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                  d_ff_expert=1408, first_dense_layers=1),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-reduced", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=512,
        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
        moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1,
                      d_ff_expert=128, first_dense_layers=1))
