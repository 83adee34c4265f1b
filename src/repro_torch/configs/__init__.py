"""Architecture config registry (copied from ``repro.configs``).

Each assigned architecture is a module exposing ``CONFIG`` (the full,
assignment-exact ModelConfig) and ``reduced()`` (a smoke-test variant of the
same family: <=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.common.config import ModelConfig

ARCH_IDS = (
    "tinyllama_1_1b",
    "deepseek_v2_lite_16b",
    "xlstm_125m",
    "granite_20b",
    "grok_1_314b",
    "granite_3_8b",
    "musicgen_large",
    "gemma2_9b",
    "llama_3_2_vision_11b",
    "zamba2_2_7b",
)

# dashed aliases (assignment spelling) -> module name
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({
    "tinyllama-1.1b": "tinyllama_1_1b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "xlstm-125m": "xlstm_125m",
    "granite-20b": "granite_20b",
    "grok-1-314b": "grok_1_314b",
    "granite-3-8b": "granite_3_8b",
    "musicgen-large": "musicgen_large",
    "gemma2-9b": "gemma2_9b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "zamba2-2.7b": "zamba2_2_7b",
})


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ALIASES.get(name, name)}")
    return mod.CONFIG


def get_reduced(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ALIASES.get(name, name)}")
    return mod.reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
