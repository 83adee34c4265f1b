"""Where the serve path's time goes on the card: a model at full width
through ``make_serve_program`` (bf16, 8 slots, 512-token prompts,
``max_len`` 1024), one prefill and 10 decode steps under ``torch.profiler``.

    python -m repro_torch.launch.profile_serve                      # TinyLlama-1.1B
    python -m repro_torch.launch.profile_serve --arch deepseek_v2_lite_16b
    python -m repro_torch.launch.profile_serve --arch llama_3_2_vision_11b
    python -m repro_torch.launch.profile_serve --arch musicgen_large

Random weights from seed 0 (the cross-attention gates set to 0.5), and
for the audio and vision models a random ``cond`` from seed 1 (MusicGen's
prompts are [8, 4, 512]). For the prefill and for the decode window it
prints the synchronised host time, the kernels launched, the device-busy
share (the union of kernel intervals over the span from the first kernel's
start to the last one's end) and the device time by phase: attention (kernel
B9), the matmuls, elementwise kernels (norms, RoPE, residuals, casts),
reductions, the KV-cache writes and the rest; for an MoE model also the
device time under each of the dispatch's spans (routing, sort + scatter,
the expert matmuls, gather + combine); then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from collections import defaultdict

import torch

from repro_torch.launch.profile_sim import _busy_us

ARCH, BATCH, PROMPT_LEN, MAX_LEN, STEPS = "tinyllama_1_1b", 8, 512, 1024, 10
# models/moe.py's record_function spans
MOE_SPANS = ("moe route", "moe sort + scatter", "moe expert matmuls", "moe gather + combine")


def _phase(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "flash_attention" in n:
        return "B9 attention"
    if any(s in n for s in ("gemm", "xmma", "cutlass", "sm90_", "nvjet", "cublas")):
        return "matmul"
    if "index_copy" in n or "indexcopy" in n or "index_put" in n:
        return "cache write"
    if "reduce" in n:
        return "reduction"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def _summary(prof_events, n: int, host_s) -> dict:
    # the model's record_function spans (the MoE dispatch's) show on the
    # device too, as user annotations: they are not kernels
    kernels = [e for e in prof_events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    phases = defaultdict(float)
    for name, (us, _) in by_name.items():
        phases[_phase(name)] += us
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
            if kernels else 0.0)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    spans = defaultdict(float)        # device time of the kernels each span launched
    for e in prof_events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in MOE_SPANS:
            spans[e.name] += e.device_time_total
    return {"host_ms_median": statistics.median(host_s) * 1e3,
            "kernel_launches": len(kernels) / n,
            "device_busy_ms": busy / n / 1e3,
            "device_busy_share": (busy / span) if span else None,
            "phase_ms": {k: v / n / 1e3 for k, v in sorted(phases.items())},
            "moe_span_ms": {k: spans[k] / n / 1e3 for k in MOE_SPANS if k in spans},
            "top_kernels": [{"name": nm[:100], "ms": us / n / 1e3, "calls": c / n}
                            for nm, (us, c) in top]}


def profile(arch: str = ARCH) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve_decode import open_cross_gates
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import make_serve_program

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    cfg = get_config(arch)
    prog = make_serve_program(cfg, batch=BATCH, max_len=MAX_LEN, with_prefill=True, device=dev)
    with torch.no_grad():
        params = tr.init_lm(torch.Generator(device=dev).manual_seed(0), cfg, torch.bfloat16)[0]
        open_cross_gates(params, 0.5)
        params = prog.place_params(params)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, prog.token_shapes(PROMPT_LEN).shape,
                           generator=gen, device=dev, dtype=torch.int32)
    cond = None
    if prog.cond_shapes() is not None:
        cond = torch.randn(prog.cond_shapes().shape, generator=gen, device=dev).to(torch.bfloat16)
    logits, cache = prog.prefill_fn(params, prompt, cond)    # warm-up: cuBLAS, the build
    for _ in range(3):
        logits, cache = prog.decode_fn(params, cache, logits.argmax(-1).int()[..., None], cond)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = prog.prefill_fn(params, prompt, cond)
        sync()
        pre_s = [time.perf_counter() - t0]
    prefill = _summary(prof.events(), 1, pre_s)
    step_s = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            t0 = time.perf_counter()
            logits, cache = prog.decode_fn(params, cache, logits.argmax(-1).int()[..., None],
                                           cond)
            sync()
            step_s.append(time.perf_counter() - t0)
    decode = _summary(prof.events(), STEPS, step_s)
    return {"arch": arch, "batch": BATCH, "prompt_len": PROMPT_LEN, "max_len": MAX_LEN,
            "dtype": "bfloat16", "layers": cfg.num_layers,
            "device": torch.cuda.get_device_name(dev), "prefill": prefill, "decode_step": decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=ARCH, help="a full config's name (tinyllama_1_1b)")
    r = profile(ap.parse_args(argv).arch)
    for tag in ("prefill", "decode_step"):
        s = r[tag]
        print(f"{tag}: {s['host_ms_median']:.3f} ms synchronised, "
              f"{s['kernel_launches']:.0f} kernels, device busy {s['device_busy_ms']:.3f} ms "
              f"(share {s['device_busy_share'] or 0:.3f})")
        for ph, ms in sorted(s["phase_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {ph:<12} {ms:.3f} ms")
        for ph, ms in s["moe_span_ms"].items():
            print(f"  within {ph:<22} {ms:.3f} ms")
        for k in s["top_kernels"][:6]:
            print(f"    {k['ms']:.4f} ms x{k['calls']:.0f}  {k['name']}")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
