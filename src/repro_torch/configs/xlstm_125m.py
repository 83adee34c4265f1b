"""xLSTM-125M [arXiv:2405.04517]: sLSTM + mLSTM blocks, no separate FFN."""
import dataclasses
from repro_torch.common.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m", arch_type="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, activation="gelu", source="arXiv:2405.04517",
    xlstm=XLSTMConfig(slstm_every=6, slstm_offset=5, proj_factor=2.0, conv_dim=4),
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-reduced", num_layers=2, d_model=128,
        num_heads=2, num_kv_heads=2, vocab_size=512,
        xlstm=XLSTMConfig(slstm_every=2, slstm_offset=1, proj_factor=2.0, conv_dim=4))
