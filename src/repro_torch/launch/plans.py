"""Per-(arch x shape) launch plans: mesh factoring and memory knobs (copied
from ``repro.launch.plans``, every field equal to the reference's).

The production mesh is fixed (16 x 16 per pod); what varies per
architecture is how the data axis factors into gossip workers x fsdp, the
gradient-accumulation depth (activation memory) and the decode-cache
policy for long_500k. The reference sized ``_ACCUM`` for a 16 GB TPU v5e;
the port keeps the numbers (the sweep of :mod:`repro_torch.launch.dryrun`
reports which programs fit an H100's 80 GB), so a plan means the same in
both packages.
"""
from __future__ import annotations

import dataclasses

from repro_torch.common.config import INPUT_SHAPES, InputShape, MeshConfig
from repro_torch.configs import ARCH_IDS, get_config


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    arch: str
    shape: InputShape
    workers_per_pod: int
    grad_accum: int
    decode_window: int          # 0 = full cache; >0 = ring buffer (sw variant)
    long_context_native: bool   # True: sub-quadratic/compact-cache arch
    notes: str = ""


# workers_per_pod by model scale: gossip wants many workers; HBM wants few.
_WPP = {
    "tinyllama_1_1b": 8,
    "deepseek_v2_lite_16b": 4,
    "xlstm_125m": 8,
    "granite_20b": 4,
    "grok_1_314b": 2,
    "granite_3_8b": 4,
    "musicgen_large": 8,
    "gemma2_9b": 4,
    "llama_3_2_vision_11b": 4,
    "zamba2_2_7b": 8,
}

_ACCUM = {  # train_4k: per-worker batch 256/wpp -> microbatch = pwb/accum
    # (the reference's, sized for a 16 GB TPU v5e)
    "tinyllama_1_1b": 2,
    "deepseek_v2_lite_16b": 8,
    "xlstm_125m": 2,
    "granite_20b": 16,
    "grok_1_314b": 32,
    "granite_3_8b": 8,
    "musicgen_large": 4,
    "gemma2_9b": 8,
    "llama_3_2_vision_11b": 16,
    "zamba2_2_7b": 8,
}

# long_500k policy
_NATIVE_LONG = {"xlstm_125m", "zamba2_2_7b", "deepseek_v2_lite_16b"}


def make_plan(arch: str, shape_name: str) -> LaunchPlan:
    """The plan of one cell. Raises ValueError for an arch or a shape it
    does not know."""
    if arch not in _WPP:
        raise ValueError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    if shape_name not in INPUT_SHAPES:
        raise ValueError(f"unknown input shape {shape_name!r}; known: "
                         + ", ".join(INPUT_SHAPES))
    shape = INPUT_SHAPES[shape_name]
    cfg = get_config(arch)
    window = 0
    notes = ""
    if shape.name == "long_500k":
        if arch in _NATIVE_LONG:
            window = 0
            notes = ("native long-context: recurrent state (ssm/hybrid) or "
                     "compact MLA latent cache")
        else:
            window = cfg.sw_decode_window
            notes = (f"sw-decode variant: ring-buffer KV window={window} "
                     "(full-attention arch; documented deviation)")
    return LaunchPlan(arch, shape, _WPP[arch], _ACCUM[arch] if shape.kind == "train" else 1,
                      window, arch in _NATIVE_LONG, notes)


def mesh_config(plan: LaunchPlan, *, multi_pod: bool = False) -> MeshConfig:
    return MeshConfig(data=16, model=16, pods=2 if multi_pod else 1,
                      workers_per_pod=plan.workers_per_pod)
