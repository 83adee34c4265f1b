"""Serve a transformer LM through the live-serving stack (port of
``examples/serve_decode.py``): publish random-init weights onto a
SnapshotBus, prefill a prompt batch, stream greedy tokens through a
LiveServer, and hot-swap to a newly published snapshot mid-stream.

    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch tinyllama_1_1b --full \\
        --batch 8 --prompt-len 512 --max-len 1024 --tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --reduced --device cpu

Attention runs through kernel B9 on the card (the plain version on the
CPU). Prints what the reference's example prints, plus the prefill time,
the median decode step and the kernel's launches per phase.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr
from repro_torch.serve import LiveServer, SnapshotBus
from repro_torch.serving.engine import make_serve_program

def _b9() -> int:
    return ops.launch_counts()["flash_attention"]


def serve_decode(cfg: ModelConfig, *, batch: int, prompt_len: int, tokens: int, max_len: int,
                 param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16, device="cuda",
                 seed: int = 0, swap_at: Optional[int] = None,
                 log: Callable[[str], None] = print) -> dict:
    """Publish ``init_lm(seed)`` (f32, as a trainer would), prefill random
    prompts [batch, prompt_len], decode ``tokens`` greedy steps, publish
    ``init_lm(seed + 42)`` and hot-swap before step ``swap_at`` (default
    tokens // 2). Each phase ends in a synchronise; returns its timings, the
    token stream, the mid-stream swap's pause (the first swap loads seq 1)
    and B9's launches per phase."""
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    swap_at = tokens // 2 if swap_at is None else swap_at
    prog = make_serve_program(cfg, batch=batch, max_len=max_len, param_dtype=param_dtype,
                              cache_dtype=cache_dtype, with_prefill=True, device=dev)
    bus = SnapshotBus()
    with torch.no_grad():
        bus.publish_params(tr.init_lm(torch.Generator(device=dev).manual_seed(seed), cfg)[0],
                           train_step=0)
    server = LiveServer(prog, bus)
    server.maybe_swap()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device=dev, dtype=torch.int32)

    sync()
    n0, t0 = _b9(), time.perf_counter()
    logits, cache = server.prefill(prompt)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = _b9() - n0
    log(f"prefilled batch={batch} under snapshot seq={server.seq}; decoding {tokens} tokens...")
    outs, step_ms, step_launches = [], [], []
    for t in range(tokens):
        if t == swap_at:
            # mid-stream a new version lands on the bus; the server picks it
            # up BETWEEN decode batches (tokens before this boundary are
            # unaffected: the hot-swap determinism contract)
            with torch.no_grad():
                bus.publish_params(
                    tr.init_lm(torch.Generator(device=dev).manual_seed(seed + 42), cfg)[0],
                    train_step=100)
            if server.maybe_swap():
                log(f"  hot-swapped to snapshot seq={server.seq} at token {t} "
                    f"({server.swap_pauses[-1] * 1e3:.1f} ms pause)")
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        sync()
        n0, t0 = _b9(), time.perf_counter()
        logits, cache = server.decode(cache, nxt[:, None])
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(_b9() - n0)
        outs.append(nxt)
    stream = torch.stack(outs, dim=-1).cpu()
    finite = bool(torch.isfinite(logits.float()).all())
    log("decoded token ids (request 0): " + str(stream[0][:16].tolist()))
    log(f"prefill {prefill_ms:.3f} ms, median decode step {statistics.median(step_ms):.3f} ms, "
        f"B9 launches: prefill {prefill_launches}, per decode step "
        f"{sorted(set(step_launches))}")
    log("OK — live batched KV-cache decode (with one hot swap) ran end to end.")
    return {"prefill_ms": prefill_ms, "step_ms": step_ms, "stream": stream,
            "swap_pause_s": server.swap_pauses[-1],
            "swaps": server.swap_stats()["swaps"], "prefill_launches": prefill_launches,
            "step_launches": step_launches, "final_logits_finite": finite,
            "cache_pos": int(cache["pos"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama_1_1b", choices=ARCH_IDS)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--reduced", dest="reduced", action="store_true", default=True,
                      help="the arch's reduced config (the default)")
    size.add_argument("--full", dest="reduced", action="store_false",
                      help="the arch's full published config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    # params and cache: f32 for the reduced config (as the reference's serve
    # tests), bf16 at full width
    dt = torch.float32 if args.reduced else torch.bfloat16
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    serve_decode(cfg, batch=args.batch, prompt_len=args.prompt_len, tokens=args.tokens,
                 max_len=args.max_len, param_dtype=dt, cache_dtype=dt, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
