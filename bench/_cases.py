"""Small cells for the CPU tests: the benchmark's configuration file cut to
the program's reduced preset, a traffic mix of 2 x 32 tokens a
worker, limits, and a benchmark spec naming them. Written into a temporary
folder laid out as ``bench/`` is, so the harness finds them by name."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

TINY = {
    "ds-tiny": ("dsv2-lite-2l", dict(
        num_hidden_layers=2, hidden_size=256, num_attention_heads=4, intermediate_size=512,
        vocab_size=512, kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
        v_head_dim=32, n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1,
        moe_intermediate_size=128)),
}
# the program reads within ~1e-6 of the reference at these sizes in f32 on
# the CPU; the planted faults read 0.13 or more on change3_gap, 0.4 or more
# on grad1_gap (half the batch) and 1.6e-3 or more on loss_gap
LIMITS = {"loss_gap": 1e-3, "grad1_gap": 1e-2, "change3_gap": 5e-2}

def tiny_config(name: str) -> dict:
    base, sizes = TINY[name]
    c = json.loads((BENCH / "configs" / f"{base}.json").read_text())
    c.update(sizes, name=name)
    replace = {k: v for k, v in c["port"]["replace"].items() if k != "num_layers"}
    c["port"] = dict(c["port"], reduced=True, replace=replace)
    return c


def tiny_traffic() -> dict:
    t = json.loads((BENCH / "traffic" / "train-w2-8x1024.json").read_text())
    t.update(batch_per_worker=2, seq=32, batches=4, draws=64)
    return t


def make_bench(tmp: Path, configs=("ds-tiny",)) -> dict:
    """Lay out ``tmp`` as a benchmark folder with the tiny cells; returns the
    spec (the real one's metrics, these cells)."""
    shutil.copytree(BENCH / "metrics", tmp / "metrics")
    for sub in ("configs", "traffic", "limits"):
        (tmp / sub).mkdir()
    (tmp / "traffic" / "tiny.json").write_text(json.dumps(tiny_traffic()))
    spec = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    spec["workloads"] = []
    for name in configs:
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name)))
        cell = f"{name}.tiny"
        spec["workloads"].append({"name": cell, "config": name, "traffic": "tiny",
                                  "chips": 1, "why": "CPU test"})
        (tmp / "limits" / f"{cell}.json").write_text(
            json.dumps({k: {"limit": v} for k, v in LIMITS.items()}))
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    return spec
