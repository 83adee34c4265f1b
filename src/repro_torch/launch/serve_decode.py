"""Serve a transformer LM through the live-serving stack (port of
``examples/serve_decode.py``): publish random-init weights onto a
SnapshotBus, prefill a prompt batch, stream greedy tokens through a
LiveServer, and hot-swap to a newly published snapshot mid-stream.

    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch tinyllama_1_1b --full \\
        --batch 8 --prompt-len 512 --max-len 1024 --tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch deepseek_v2_lite_16b \\
        --full --batch 8 --prompt-len 512 --max-len 1024 --tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch zamba2_2_7b --full \\
        --batch 8 --prompt-len 512 --max-len 1024 --tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch llama_3_2_vision_11b \\
        --full --batch 8 --prompt-len 512 --max-len 1024 --tokens 64 --cross-gate 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch tinyllama_1_1b --full \
        --batch 8 --prompt-len 512 --max-len 1024 --tokens 64 --model 4

Attention runs through kernel B9 on the card (the plain version on the
CPU): every layer of a dense or MoE model, the shared blocks of a hybrid
(Zamba2), none of an SSM (xLSTM, whose recurrent blocks launch no
kernel), every self- and cross-attention of the audio and vision models
(MusicGen: two a layer; Llama-3.2-V: one a layer and one a cross block).
Those two read a seeded random conditioning ``cond`` (the stubbed
modality embeddings, :meth:`ServeProgram.cond_shapes`); their
cross-attention gates are zero at init, as the reference's, and
``--cross-gate g`` sets every gate to ``g`` so that the cross path shows
in the logits. MusicGen's prompts are ``[B, K, S]`` and its greedy
tokens the argmax per codebook.

Before anything is allocated it prints a memory plan and refuses a run
that does not fit: the published weights are f32 (as a trainer would
publish them) where that fits, else bf16, and the mid-stream swap, which
holds a second published replica and its flat copy beside the served one,
runs only where it fits (not for DeepSeek-V2-Lite-16B or
Llama-3.2-Vision-11B at full width on one 80 GB card). Prints what the
reference's example prints, plus the prefill time, the median decode step
and the kernel's launches per phase.

``--model M`` (M > 1, every arch) serves tensor-parallel over M
processes on the one card (``launch.mesh.spawn_model_group``,
``serving.tensor_parallel``): every rank draws ``init_lm(seed)`` in the
serving dtype keeping only its slice of each leaf as it is drawn (no rank
holds a whole tree), then prefills and decodes the same greedy stream
(with the same ``cond`` and ``--cross-gate``), with no snapshot bus and no
swap. Rank 0 prints the summary above, each rank's peak memory, the
collectives a decode step makes (by block kind) and their host time.

    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch deepseek_v2_lite_16b \
        --full --batch 8 --prompt-len 512 --max-len 1024 --tokens 16 --model 2
    PYTHONPATH=src python -m repro_torch.launch.serve_decode --arch zamba2_2_7b --reduced \
        --model 2 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from typing import Callable, Optional
from unittest import mock

import torch

from repro_torch.common.config import MeshConfig, ModelConfig
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.fleet import memory
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import transformer as tr
from repro_torch.serve import LiveServer, SnapshotBus
from repro_torch.serving.engine import make_serve_program

GiB = 2 ** 30


def _b9() -> int:
    return ops.launch_counts()["flash_attention"]


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _gla_bytes(tokens: int, seq: int, H: int, dk: int, dv: int, chunk: int) -> int:
    """The chunked GLA core's f32 temporaries over ``tokens`` tokens of
    sequences of ``seq``: per token the intra-chunk coefficients [H, Q]
    three times (scores, exponent, masked product), the upcast q and k
    [H, dk] and v and the two partial outputs [H, dv]; per chunk of Q
    tokens the chunk states [H, dk, dv]."""
    Q = min(chunk, seq)
    return 4 * (tokens * (3 * H * Q + 2 * H * dk + 3 * H * dv) + tokens // Q * H * dk * dv)


def prefill_transient_bytes(cfg: ModelConfig, tokens: int, dtype_bytes: int,
                            seq: int = 0) -> int:
    """An estimate of the largest layer's prefill temporaries over
    ``tokens`` tokens of sequences of ``seq`` (default ``tokens``). An
    attention block (the hybrid's shared ones too): the FFN (an MoE layer's
    dispatch buffer, its copy, the up / gate / hidden products and the
    expert output at capacity C, and the k gathered rows a token twice; a
    dense layer's three d_ff rows) and the attention's queries, keys and
    output (MLA: [H, r + rope] a token); with a cross-attention (audio,
    vision) also its queries and output and, per sequence, the
    conditioning's keys and values [T, Hkv, hd]. A recurrent block: its input
    projection and conv output, and the chunked GLA's f32 temporaries
    (:func:`_gla_bytes`; the sLSTM's four gate rows and its f32 hidden
    states instead)."""
    seq = seq or tokens
    plan = tr.make_plan(cfg)
    kinds = {s.kind for s in plan.segments} | ({"attn"} if plan.num_shared_blocks else set())
    d = cfg.d_model
    out = 0
    if kinds & {"attn", "attn_cross"} or plan.num_cross:
        ffn = 3 * tokens * cfg.d_ff
        if cfg.moe is not None:
            m = cfg.moe
            E, f, C = m.num_experts, m.d_ff_expert or cfg.d_ff, moe.capacity(cfg, tokens)
            ffn = max(ffn, 3 * E * C * d + 3 * E * C * f + 2 * tokens * m.top_k * d)
        if cfg.mla is not None:
            width = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
            att = tokens * (2 * cfg.num_heads * width + width)
        else:
            att = tokens * cfg.resolved_head_dim * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
        T = _cond_tokens(cfg)
        if T:
            att += (2 * tokens * cfg.num_heads * cfg.resolved_head_dim
                    + 2 * (tokens // seq) * T * cfg.num_kv_heads * cfg.resolved_head_dim)
        out = (ffn + att) * dtype_bytes
    if "mamba" in kinds:
        s = cfg.ssm
        d_inner = s.expand * d
        nheads = d_inner // s.head_dim
        conv_ch = d_inner + 2 * s.ngroups * s.state_dim
        proj = tokens * (2 * d_inner + 2 * s.ngroups * s.state_dim + nheads + conv_ch)
        out = max(out, proj * dtype_bytes + _gla_bytes(tokens, seq, nheads, s.state_dim,
                                                        s.head_dim, s.chunk_size))
    if "mlstm" in kinds or "slstm" in kinds:
        d_in = int(d * cfg.xlstm.proj_factor)
        H = cfg.num_heads
        dh = d_in // H
        out = max(out, tokens * 4 * d_in * dtype_bytes + _gla_bytes(tokens, seq, H, dh, dh + 1,
                                                                    256))
        out = max(out, tokens * (5 * d_in * dtype_bytes + 4 * d_in * 4))
    return out


def _cond_tokens(cfg: ModelConfig) -> int:
    """T of the conditioning ``[B, T, e]`` (0 where the model reads none)."""
    if cfg.audio is not None:
        return cfg.audio.num_cond_tokens
    return cfg.vlm.num_image_tokens if cfg.vlm is not None else 0


def cond_bytes(cfg: ModelConfig, batch: int, dtype_bytes: int) -> int:
    """The conditioning the audio and vision models read, ``[B, T, e]``."""
    e = cfg.vlm.image_embed_dim if cfg.vlm is not None else cfg.d_model
    return batch * _cond_tokens(cfg) * e * dtype_bytes


def plan_memory(cfg: ModelConfig, *, batch: int, prompt_len: int, max_len: int,
                param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16, device="cuda",
                log=print) -> dict:
    """The run's memory before anything is allocated, from ``abstract_lm``
    and ``init_cache`` on the meta device: the published replica in
    ``init_dtype`` and the bus's flat copy of it (both live while it is
    published), the served cast (none where ``param_dtype`` is
    ``init_dtype``: the server then serves views of the snapshot), the
    cache (KV; MLA: c_kv and k_rope; the recurrent kinds' f32 state and
    conv buffer; the hybrid's shared sites' KV), the conditioning of the
    audio and vision models (:func:`cond_bytes`; their cross blocks' weights
    are in the replica), the last position's f32 logits (K rows a request
    for MusicGen) and the prefill's temporaries (an estimate); a mid-stream
    swap adds a second published replica, its flat
    copy and its served cast. The published replica is f32 where that run
    fits, else bf16, and the swap runs where it fits. Prints the plan;
    raises ValueError when even the run without a swap does not fit the
    free memory (the card's; the host's on the CPU). Returns the plan: byte
    counts, ``init_dtype`` and ``swap``."""
    avail = memory.available_bytes("device", device)
    psize = torch.empty((), dtype=param_dtype).element_size()
    cache = _bytes(tr.init_cache(cfg, batch, max_len, dtype=cache_dtype, device="meta")[0])
    transient = prefill_transient_bytes(cfg, batch * prompt_len, psize, prompt_len)
    heads = cfg.audio.num_codebooks if cfg.audio is not None else 1
    io = cond_bytes(cfg, batch, psize) + batch * heads * cfg.vocab_size * 4

    def plan(dt):
        rep_b = _bytes(tr.abstract_lm(cfg, dt)[0])
        served = 0 if dt == param_dtype else _bytes(tr.abstract_lm(cfg, param_dtype)[0])
        steady = rep_b + served + cache + io + transient
        peak = max(2 * rep_b, steady)
        return dict(init_dtype=dt, replica=rep_b, flat=rep_b, served=served, cache=cache,
                    io=io, transient=transient, peak=peak,
                    swap_peak=steady + 2 * rep_b + served)

    def fits(n):
        return avail is None or n <= avail

    p = plan(torch.float32)
    if not fits(p["peak"]):
        p = plan(torch.bfloat16)
    p["swap"] = fits(p["swap_peak"])
    p["avail"] = avail
    log(f"memory plan ({cfg.name}): published replica {p['replica'] / GiB:.2f} GiB "
        f"({str(p['init_dtype']).split('.')[-1]}) + the bus's flat copy "
        f"{p['flat'] / GiB:.2f} GiB + served cast {p['served'] / GiB:.2f} GiB + cache "
        f"{cache / GiB:.3f} GiB + cond and logits {io / GiB:.3f} GiB + prefill temporaries "
        f"(estimate) {transient / GiB:.3f} GiB: "
        f"peak {p['peak'] / GiB:.2f} GiB, with a mid-stream swap {p['swap_peak'] / GiB:.2f} "
        f"GiB" + ("" if avail is None else f", of {avail / GiB:.2f} GiB free")
        + f"; mid-stream swap {'on' if p['swap'] else 'off'}")
    if not fits(p["peak"]):
        raise ValueError(f"serving {cfg.name} needs ~{p['peak'] / GiB:.1f} GiB but only "
                         f"{avail / GiB:.1f} GiB is free")
    return p


def open_cross_gates(params, value: float) -> int:
    """Set every cross-attention gate of ``params`` (``.../xattn/gate`` and
    the vision blocks' ``ffn_gate``) to ``value`` in place; returns how many
    leaves it set. At init they are zero, so the cross path adds nothing."""
    n = 0
    for key, sub in params.items():
        if isinstance(sub, dict):
            n += open_cross_gates(sub, value)
        elif key in ("gate", "ffn_gate"):
            sub.fill_(value)
            n += 1
    return n


def serve_decode(cfg: ModelConfig, *, batch: int, prompt_len: int, tokens: int, max_len: int,
                 param_dtype=torch.bfloat16, cache_dtype=torch.bfloat16, device="cuda",
                 seed: int = 0, swap_at: Optional[int] = None, cross_gate: float = 0.0,
                 log: Callable[[str], None] = print) -> dict:
    """Plan the memory (:func:`plan_memory`, which picks the published
    dtype and whether to swap), publish ``init_lm(seed)`` in that dtype
    (f32 as a trainer would, where it fits; its cross gates set to
    ``cross_gate`` when that is not 0), prefill random prompts [batch,
    prompt_len] (audio: [batch, K, prompt_len]) with a random ``cond``
    (audio and vision) from ``seed + 1``, decode ``tokens`` greedy steps
    (per codebook for audio) and, where the plan swaps, publish
    ``init_lm(seed + 42)`` (its gates set the same way) and hot-swap before
    step ``swap_at`` (default tokens // 2). Each phase ends in a
    synchronise; returns its timings, the token stream ([batch, tokens],
    audio [batch, K, tokens]), the last swap's pause (the first swap loads
    seq 1), B9's launches per phase and the plan."""
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prog = make_serve_program(cfg, batch=batch, max_len=max_len, param_dtype=param_dtype,
                              cache_dtype=cache_dtype, with_prefill=True, device=dev)
    plan = plan_memory(cfg, batch=batch, prompt_len=prompt_len, max_len=max_len,
                       param_dtype=param_dtype, cache_dtype=cache_dtype, device=dev, log=log)
    init_dtype = plan["init_dtype"]
    swap_at = (tokens // 2 if swap_at is None else swap_at) if plan["swap"] else None
    bus = SnapshotBus()

    def weights(s):
        params = tr.init_lm(torch.Generator(device=dev).manual_seed(s), cfg, init_dtype)[0]
        if cross_gate:
            open_cross_gates(params, cross_gate)
        return params

    with torch.no_grad():
        bus.publish_params(weights(seed), train_step=0)
    server = LiveServer(prog, bus)
    server.maybe_swap()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, prog.token_shapes(prompt_len).shape,
                           generator=gen, device=dev, dtype=torch.int32)
    cond = None
    if prog.cond_shapes() is not None:
        cond = torch.randn(prog.cond_shapes().shape, generator=gen, device=dev,
                           dtype=torch.float32).to(param_dtype)

    sync()
    n0, t0 = _b9(), time.perf_counter()
    logits, cache = server.prefill(prompt, cond)
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
                bus.publish_params(weights(seed + 42), train_step=100)
            if server.maybe_swap():
                log(f"  hot-swapped to snapshot seq={server.seq} at token {t} "
                    f"({server.swap_pauses[-1] * 1e3:.1f} ms pause)")
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)      # [B] (audio: [B, K])
        sync()
        n0, t0 = _b9(), time.perf_counter()
        logits, cache = server.decode(cache, nxt[..., None], cond)
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
            "cache_pos": int(cache["pos"]), "plan": plan}


@contextlib.contextmanager
def recorded_routes(on: bool):
    """With ``on``, every MoE layer called inside appends its routing ids
    (``[T, k]``, copied to the CPU, so it synchronises) to the yielded list
    in call order, through a spy on ``moe._route``; else the list stays
    empty."""
    routes = []
    if not on:
        yield routes
        return
    route = moe._route

    def spy(*args, **kwargs):
        out = route(*args, **kwargs)
        routes.append(out[2].cpu())
        return out

    with mock.patch.object(moe, "_route", spy):
        yield routes


def tp_rank(group, job: dict) -> dict:
    """One rank of tensor-parallel runs (module level, so ``spawn`` can
    import it). Each of ``job["runs"]`` (``tag``, ``cfg``, ``dtype``,
    ``batch``, ``prompt_len``, ``tokens``, ``max_len``, ``seed``; optional
    ``logits``, ``cross_gate``, ``routes``): the rank's slice of
    ``init_lm(seed)`` drawn in the serving dtype on its device
    (``init_params``: no whole tree; its cross gates set to ``cross_gate``
    when given), a random prompt and (audio, vision) ``cond`` from ``seed +
    1``, prefill and ``tokens`` greedy decode steps, each phase ended by a
    synchronise. Returns {tag: the timings, B9's launches (counts set to 0
    after the weights are placed), the collectives of the prefill and of
    each decode step with their host seconds and the counts the program
    expects of each (in all and by block kind), the rank's peak memory
    (stats reset before the weights are drawn) and the card's most used
    memory seen at the ends of the phases (every process's), the placed
    bytes, the greedy stream, the prefill's logits, on rank 0 with
    ``logits`` every step's logits (float32, float64 in an f64 run, on the
    CPU) and with ``routes`` every MoE layer's routing ids}. With
    :class:`OneRank` for ``group`` it is the one-device program, the same
    calls on the same inputs."""
    dev = group.device
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    kept = lambda t: t.to(torch.promote_types(t.dtype, torch.float32)).cpu()  # noqa: E731
    out = {}
    for run in job["runs"]:
        cfg, dt = run["cfg"], run["dtype"]
        card = []

        def card_used():
            if cuda:
                free, total = torch.cuda.mem_get_info(dev)
                card.append(total - free)

        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        prog = make_serve_program(cfg, batch=run["batch"], max_len=run["max_len"],
                                  param_dtype=dt, cache_dtype=dt, with_prefill=True,
                                  device=dev, mesh_cfg=group.mesh_cfg, group=group)
        with torch.no_grad():
            params = prog.init_params(torch.Generator(device=dev).manual_seed(run["seed"]))
            if run.get("cross_gate"):
                open_cross_gates(params, run["cross_gate"])
        if cuda:
            torch.cuda.empty_cache()
        sync()
        card_used()
        gen = torch.Generator(device=dev).manual_seed(run["seed"] + 1)
        prompt = torch.randint(0, cfg.vocab_size, prog.token_shapes(run["prompt_len"]).shape,
                               generator=gen, device=dev, dtype=torch.int32)
        cond = None
        if prog.cond_shapes() is not None:
            cond = torch.randn(prog.cond_shapes().shape, generator=gen, device=dev,
                               dtype=torch.float32).to(dt)
        group.barrier()
        ops.zero_launch_counts()
        group.reset_counts()
        sync()
        with recorded_routes(run.get("routes")) as routes:
            t0 = time.perf_counter()
            logits, cache = prog.prefill_fn(params, prompt, cond)
            sync()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            card_used()
            tp = group.world > 1
            rec = {"prefill_ms": prefill_ms, "prefill_collectives": group.counts(),
                   "prefill_logits": kept(logits),
                   "expected_per_step": (prog.collectives_per_decode_step() if tp
                                         else {"all_reduce": 0, "all_gather": 0}),
                   "expected_by_kind": prog.collectives_by_kind() if tp else None,
                   "placed_bytes": _bytes(params)}
            keep = [rec["prefill_logits"]] if run.get("logits") and group.rank == 0 else None
            outs, step_ms, per_step = [], [], []
            for _ in range(run["tokens"]):
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                group.reset_counts()
                sync()
                t0 = time.perf_counter()
                logits, cache = prog.decode_fn(params, cache, nxt[..., None], cond)
                sync()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(group.counts())
                outs.append(nxt.cpu())
                if keep is not None:
                    keep.append(kept(logits))
        card_used()
        rec.update(step_ms=step_ms, step_collectives=per_step, launches=ops.launch_counts(),
                   peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
                   card_bytes=max(card) if card else None,
                   stream=torch.stack(outs, dim=-1), logits=keep,
                   routes=[r.numpy() for r in routes] if run.get("routes") else None)
        out[run["tag"]] = rec
        del params, cache, logits
    return out


class OneRank:
    """:func:`tp_rank`'s group for ``model = 1``: the one-device program, no
    collective (its counts stay 0)."""

    def __init__(self, device):
        self.rank, self.world = 0, 1
        self.mesh_cfg = MeshConfig(data=1, model=1, pods=1, workers_per_pod=1)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())

    def barrier(self) -> None:
        pass

    def reset_counts(self) -> None:
        pass

    def counts(self) -> dict:
        return {"all_reduce": 0, "all_gather": 0, "host_s": 0.0}


def serve_tp(cfg: ModelConfig, model: int, *, batch: int, prompt_len: int, tokens: int,
             max_len: int, dtype=torch.bfloat16, device="cuda", seed: int = 0,
             cross_gate: float = 0.0, log: Callable[[str], None] = print) -> list:
    """Spawn ``model`` ranks of :func:`tp_rank` on ``device`` for one run and
    print rank 0's summary; returns every rank's result of it."""
    from repro_torch.launch.mesh import spawn_model_group
    mesh_cfg = MeshConfig(data=1, model=model, pods=1, workers_per_pod=1)
    run = dict(tag="serve", cfg=cfg, batch=batch, prompt_len=prompt_len, tokens=tokens,
               max_len=max_len, dtype=dtype, seed=seed, cross_gate=cross_gate)
    ranks = [r["serve"] for r in spawn_model_group(tp_rank, mesh_cfg, device,
                                                   args=(dict(runs=[run]),),
                                                   join_timeout_s=1800.0)]
    log("decoded token ids (request 0): " + str(ranks[0]["stream"][0][:16].tolist()))
    log(tp_summary(ranks, model))
    return ranks


def tp_summary(ranks: list, model: int) -> str:
    """Rank 0's line of a tensor-parallel run: prefill and median decode step
    ms, B9's launches, the collectives a decode step makes (by block kind)
    and their host time, and each rank's placed parameters and peak."""
    r0 = ranks[0]
    coll, pre = r0["step_collectives"], r0["prefill_collectives"]
    kinds = "; ".join(f"{k} {c['all_reduce']} + {c['all_gather']}"
                      for k, c in r0["expected_by_kind"].items())
    return (f"model={model} ranks: prefill {r0['prefill_ms']:.3f} ms, median decode step "
            f"{statistics.median(r0['step_ms']):.3f} ms, B9 launches per rank "
            f"{r0['launches']['flash_attention']}; collectives per decode step "
            f"{ {k: coll[0][k] for k in ('all_reduce', 'all_gather')} } (expected "
            f"{r0['expected_per_step']}; all-reduces + all-gathers by kind: {kinds}), "
            f"host time median "
            f"{statistics.median(c['host_s'] for c in coll) * 1e3:.3f} ms a step; prefill "
            f"{pre['all_reduce']} all-reduces + {pre['all_gather']} all-gathers, "
            f"{pre['host_s'] * 1e3:.3f} ms; per rank: placed params "
            + ", ".join(f"{r['placed_bytes'] / GiB:.3f}" for r in ranks) + " GiB, peak "
            + ", ".join("not measured" if r["peak_bytes"] is None else
                        f"{r['peak_bytes'] / GiB:.3f}" for r in ranks) + " GiB"
            + ("" if r0["card_bytes"] is None else
               f"; card used (every process) up to "
               f"{max(r['card_bytes'] for r in ranks) / GiB:.3f} GiB"))


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
    ap.add_argument("--cross-gate", type=float, default=0.0,
                    help="set every cross-attention gate to this value (audio, vision; "
                         "0, their init, leaves the cross path silent)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model", type=int, default=1,
                    help="serve tensor-parallel over this many ranks (one process each)")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    # params and cache: f32 for the reduced config (as the reference's serve
    # tests), bf16 at full width
    dt = torch.float32 if args.reduced else torch.bfloat16
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
    if args.model > 1:
        serve_tp(cfg, args.model, batch=args.batch, prompt_len=args.prompt_len,
                 tokens=args.tokens, max_len=args.max_len, dtype=dt, device=args.device,
                 cross_gate=args.cross_gate)
        return 0
    serve_decode(cfg, batch=args.batch, prompt_len=args.prompt_len, tokens=args.tokens,
                 max_len=args.max_len, param_dtype=dt, cache_dtype=dt, device=args.device,
                 cross_gate=args.cross_gate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
