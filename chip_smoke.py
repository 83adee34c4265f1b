#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. build   — the card's name and power limit, then the kernel sources built
             with nvcc for sm_90a into ``build/repro_torch/``, one nvcc per
             source, all started together: B1-B3 (``fused_update.cu``),
             B4-B7 (``codec.cu``) and B8 (``robust.cu``);
2. kernels — B1 held against its plain PyTorch version on the card at the
             main path's shapes ([8, 2913408], [4, 2913408] f32), a ragged
             N=1000 and bf16 / bf16+f32-velocity storage, scalar and [W] coef,
             and peer is theta; B4-B7 (q8 encode/decode, top-k
             encode/decode) held exactly against theirs at [8, 2913408]
             (block 512, k 26), a ragged [4, 1000] (block 128, k 13), an
             all-zero block and tied magnitudes, a block tied across its
             20th magnitude at k 20, k = 1 and k = block, blocks 128 to
             4096 at n % 4 = 1 and n % 4 = 0 with a partial last block, and
             40 rows; B4 on NaN, +-inf and -0.0 blocks (scales byte-equal,
             int8 equal at finite elements) and B7 on a corrupted wire
             (duplicate and out-of-block indices) against the plain version
             on the CPU; B8 (the robust
             apply) held byte for byte against its plain version at [8, 2913408] with
             [W] scale and thr = +inf (clipped) or finite [W] thr (trimmed),
             scalar scale and thr, a ragged [4, 1000], bf16 theta, and a
             delta holding +-inf, NaN and -0.0 beside a theta of -0.0; B2
             (pure NAG, in place) byte for byte at [8, 2913408] and
             [4, 2913408] f32, bf16 theta with f32 v, bf16 with bf16 v, a
             ragged [4, 1000], eta/mu as device scalars, its outputs
             aliasing its inputs; B3 (the per-array update) byte for byte at
             [1024, 1000] f32 and bf16 with a scalar coef_gate, its inputs
             unwritten; B1 on a row list (one row, unsorted, every row
             against the whole-plane launch, an empty list launching
             nothing, bf16, ragged N) and B8 on the column chunks of P = 4,
             7, 8 (offsets off multiples of four included, written in place
             into an output plane) byte for byte; then every kernel and its
             plain version timed with CUDA events (median of 60 launches)
             beside its bound (B4-B7, B9, B1's row list at 1, 4, 8 of 8 rows
             and B8 in 4 and 8 chunks, the latter against a contiguous copy
             per chunk, also by their device time under torch.profiler),
             and the fault plane's checksummed wire round trip timed at the
             main path's plane;
3. main    — GossipTrainer(engine="sim", method="elastic_gossip") with NAG on
             the §4.1 MLP at full width (784 -> 3x1024 -> 10, random weights
             from a seed) over the synthetic MNIST stand-in, 50 steps each,
             p=0.125, alpha=0.5, uniform peers: W=8 at batch 16 per worker,
             W=4 at batch 32, then W=8 with codec="q8" and with
             codec="topk". Every kernel's count is set to 0 just before a run
             and read just after: B1 must launch once per step, the codec's
             encode and decode kernels once per step (they run on every step,
             firing or not: no host sync decides), the others not at all.
             The loss must be finite (and falling, uncompressed and q8),
             comm_units must equal the gates drawn, the wire per event must
             be the reference's exact size and comm_bytes its f32 derivation.
             Then 10 steps of the fused path against the unfused (plain)
             path on the same draws, uncompressed and with q8.
4. faults  — four more full-width runs at W=8, batch 16, 50 steps, p=0.5,
             alpha 0.5, uniform peers, with gates and peers passed through
             the ``draws=`` hook: clipped_gossip (robust_clip 0.1) under the
             composite ``drop_byzantine`` model (drop 0.2, Byzantine 1/8,
             registered here through the public ``register_fault_model``),
             trimmed_gossip under byzantine_scale (1/8, scale 100),
             elastic_gossip under corrupt 0.2 uncompressed (the checksummed
             raw wire) and with codec="q8" (the checksummed q8 wire). B8
             must launch once per step in the first two and never in the
             others, B1 once per step in all four, B4/B5 once per step in
             the q8 run only. The host recomputes wire_dropped,
             wire_corrupt and comm_units from the gates and the port's
             numpy ``bernoulli_np``; they must equal the engine's counters
             exactly, and comm_bytes its f32 derivation. The loss and the
             honest workers' rows must be finite. Then the zero-fault
             anchor: FaultConfig(drop, rate 0) must reproduce the
             fault-free elastic_gossip run bit for bit on the same draws.
5. dist    — GossipTrainer(engine="dist"): 8 processes, one per gossip
             worker, all on this card, joined by gloo
             (``repro_torch.launch.dist_run``), the §4.1 MLP at full width
             from the same random weights, batch 16 per worker, p 0.125,
             alpha 0.5, random matchings, 50 steps each: elastic_gossip
             uncompressed, with codec="q8", and allreduce. The parent
             replays the host schedule (GossipSchedule from seed + 1): on
             every rank B1 must launch exactly once per firing step and B2
             once per other step, B4/B5 once per firing step in the q8 run
             only, one send and one recv per firing step, and comm_bytes must
             equal the host's float64 recomputation from the wire per event
             (11,653,160 B raw, 2,936,556 B q8). The loss must be finite and
             fall (elastic, q8), equal on every rank. Then 10 steps of the
             dist engine against the sim engine fed the same schedule's
             gates and partners through draws=, theta and velocity held
             within rtol 1e-4 / atol 1e-5. Logged: rank 0's median
             synchronised step for firing and non-firing steps, the exchange
             split into device-to-host copy, gloo and host-to-device copy,
             and the fleet-mean loss all-reduce. Last, a checkpoint: the
             10-step W=8 run saves at step 5 (rank 0 writes the whole
             [8, total] plane after a gather), fresh trainers on every rank
             load their rows and take steps 5-9; the loaded state and the
             end state must equal the uninterrupted run's bit for bit on
             every rank, with B1 / B2 on the resumed firing / other steps.
6. serve   — B9 (flash attention) held against its plain version in f32
             (2e-5) and bf16 (3e-2): causal prefill at G in {1, 4, 8} and
             hd in {64, 128, 256}, at Sq 77 and 513, MQA at G 48 and hd
             128, a q_offset suffix, decode over a [8, 1024, 4, 64] cache
             with kv_len 1 / 31 / 32 / 33 / 63 / 64 / 65 / 513 / 1024
             (causal at pos) and 1 / 513 / 1024 (the ring buffer's
             non-causal form), windows 1 / 7 / 4096, softcap 50 at hd 256
             (also with window 100), kv_start per row (also leaving whole
             32-row splits empty), a strided layer view of a stacked cache;
             NaN and inf below kv_start must give the bits of zeroed rows,
             in a decode and a prefill suffix; each of B9's three forms
             (mma, split, simt) must have run. B9, its plain version and
             SDPA timed at the prefill ([8, 512, 32, 64] causal, the mma
             form) and decode ([8, 1, 32, 64] over the cache at pos 512,
             the split form) shapes in bf16, with CUDA events back to
             back and, for B9 and SDPA, their device time alone under
             torch.profiler. Then TinyLlama-1.1B at full width (22 layers,
             d 2048, 32 / 4 heads, random weights from seed 0, bf16 params
             and cache, 8 slots,
             max_len 1024): the serve_decode entry point (512-token
             prompts, 64 greedy steps, a hot swap at step 32), B9 launched
             exactly 22 times in the prefill and in every step and no other
             kernel; a ContinuousBatcher over a TrafficGen stream (seed 1,
             rate 0.5, 32 requests, prompts 8-64, budgets 16-64) until it
             drains (at most 384 boundaries), invariants held and every
             admitted request complete, B9 22 times a boundary; and the same
             prefill and 8 decode steps in f32 through B9 and through the
             plain version (patched into the op), logits within 1e-3 of the
             largest logit.
7. paper   — the paper's CIFAR CNN at full width (``init_cnn`` width 32,
             307,306 parameters, NHWC, "SAME" padding) on the CIFAR
             stand-in: GossipTrainer(engine="sim", method="elastic_gossip"),
             NAG lr 0.01 / momentum 0.9, W=4, batch 32 a worker, p 0.125,
             alpha 0.5, 50 steps; B1 once a step and nothing else, the loss
             finite and falling, comm_units equal to the gates. Then 5 steps
             (batch 8) on the card and on the CPU, each from the card's
             state, on the same draws, with TF32 ALLOWED in the process:
             per element at rtol 1e-4 / atol 1e-6, at least 90% of the
             gradient and 99.9% of theta after the step (a ReLU input
             within rounding of 0 may take the kink on either side; the
             engine steps under ``common.precision.full_f32``; the same
             gradient under TF32 must leave more than 10% outside), after
             the f32 and TF32 gradients' distance from an f64 one at
             batch 32. The CNN step under
             ``profile_sim --model cnn`` (kernels a step, device busy share,
             the convolutions' share). Checkpoints of the MLP main path
             (W=8, batch 16, full width), uncompressed and with top-k: 10
             steps, save_checkpoint, load into a state from init_state(1),
             10 more steps on both; every entry (theta, velocity, residual,
             counters, the generator) bit-equal after the load and at the
             end; save and load ms and the file's MB. Last,
             ``paper_tables.main("4.3")`` at 20 steps a row, its CSV printed.
8. async   — GossipTrainer(engine="async") on the MLP at full width, p 0.125,
             alpha 0.5: (a) HeteroConfig(constant) at W=8, batch 16, 50
             windows, bit-equal to the sim run (theta, velocity, counters,
             the generator); (b) lognormal sigma 0.6 at W=8 until 400
             worker-steps, loss falling; (c) slow_node x4 at W=4, batch 32,
             p 0.25, 100 windows; half windows at W=8 (a ``two_groups``
             time model registered here); B1 once a window on the window's
             rows (rows outside a window keep their bits), comm_units equal
             to the host's count of in-window gates; (d) message mode:
             clipped_gossip at p 0.5, lognormal delay 0.5, timeout 1.0 with
             2 retries, drops 0.1, 150 windows: B8 once per applied
             exchange, every counter equal to the host's replay of the
             queue; (e) the sim engine at W=8 with partition=4, raw, q8 and
             clipped_gossip, 50 steps each at p 0.5: chunk_units equal to
             the host's count, comm_bytes the plan's exact bytes, B8 once
             per chunk per step; (f) the host plane at W=256 (5.97 GB of
             pinned theta and velocity), lognormal, partition 8,
             randomized_token_account, 50 windows, B1 once a window on the
             padded rows, the first 20 against the device plane (theta
             within 2e-5, counters, tokens and generator equal), a timed
             split of the window, and ``validate_fleet_memory`` for both
             planes at W=256 and W=1024.
9. shard+obs — the sharded plane (ShardConfig(n_shards=4)) and the
             telemetry plane (ObsConfig) at full width: B4-B7 byte-equal to
             their plain versions on the [32, 728576] shard rows of the padded
             plane (seeds w*4+s), B1 on the padded [8, 2914304] plane, B2 on a
             padded dist row, B8 on the padded raw plane, B4-B7 timed on the
             shard rows; (a) the sim engine at W=8, batch 16, p 0.5 with S=4:
             ShardConfig() bit-equal to the plain run, raw, q8 and top-k for
             50 steps and clipped_gossip for 20 (B1 once a step, the codec
             pair once a step, B8 once a step in the clipped run), wire per
             device 2,913,290 / 734,268 / 295,984 B and comm_bytes its f32
             derivation, the padding columns never written; (b) partition 4
             with S=4 (chunk_units = the host's count); (c) the async engine,
             lognormal, S=4 q8, 50 windows; (d) the dist engine with 4
             processes, fsdp = S = 2, q8, 20 steps (launches, sends = recvs =
             firing steps, comm_bytes the host's recomputation, every rank's
             decoded peer wire byte-equal to the sim engine's shard rows); (e)
             recording runs on the sim, async (faults, flow control) and dist
             engines bit-equal to the plain runs, traces valid, the report's
             totals equal to the accumulators, the sim step's recording
             overhead; (f) validate_fleet_memory at S in {1, 4} against the
             card's free memory. Every phase's seconds are printed.

The line before the last is a JSON object listing the kernels with their
launches on the main path, error, times and bounds; the last line is
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN, so the model and the mixing matmul run in full f32 (phase 7's
card-vs-CPU check turns it back on for its own span). Checkpoint files go
to ``build/chip_smoke_ckpt/`` and are removed after their check.
"""
import json
import os
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

STEPS = 50
FULL = dict(in_dim=784, hidden=1024, depth=3, num_classes=10)
N_FULL = 2913408                    # f32 elements of the full-width MLP plane
TOL = {"float32": 1e-6, "bfloat16": 2e-2}
FLOPS_PER_ELEMENT = 9               # B1: 4 multiplies + 5 adds/subtracts
NAG_FLOPS_PER_ELEMENT = 6           # B2: 3 multiplies + 3 adds/subtracts
B1, B2, B3 = "fused_flat_elastic_nag_update", "fused_flat_nag_update", "fused_elastic_nag_update"
BLOCK, TOPK = 512, 26               # the codecs' defaults: codec_block, round(0.05 * 512)
# exact wire bytes per event on the full-width plane (the reference's
# wire_param_bytes / SimTrainer._wire_bytes)
WIRE = {None: 11653160, "q8": 2936556, "topk": 1183728}
CODEC_KERNELS = {"q8": ("q8_encode", "q8_decode"), "topk": ("topk_encode", "topk_decode")}
B8 = "robust_flat_apply"
B8_FLOPS_PER_ELEMENT = 4            # |d| <= thr, d * keep, scale * (...), t + (...)
# the fault runs: (tag, method, FaultConfig kwargs, codec), after the
# reference's benchmarks/faults.py headline (p 0.5, alpha 0.5, uniform peers)
FAULT_STEPS, FAULT_P = 50, 0.5
FAULT_RUNS = (
    ("clipped drop_byzantine", "clipped_gossip",
     dict(fault_model="drop_byzantine", fault_rate=0.2, fault_frac=1 / 8, seed=5), None),
    ("trimmed byzantine_scale", "trimmed_gossip",
     dict(fault_model="byzantine_scale", fault_frac=1 / 8, scale=100.0, seed=5), None),
    ("elastic corrupt", "elastic_gossip", dict(fault_model="corrupt", fault_rate=0.2, seed=5), None),
    ("elastic corrupt q8", "elastic_gossip", dict(fault_model="corrupt", fault_rate=0.2, seed=5),
     "q8"),
)

# (memory bytes/s, f32 non-tensor FLOP/s, bf16 dense tensor-core FLOP/s) by
# card name, from NVIDIA's data sheets
CARDS = [("H200", 4.8e12, 67e12, 989e12), ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H100 PCIe", 2.0e12, 51e12, 756e12), ("H100", 3.35e12, 67e12, 989e12)]


def log(msg):
    print(msg, flush=True)


def card_rates(name):
    for key, bw, flops, bf16_flops in CARDS:
        if key in name:
            return bw, flops, bf16_flops
    raise RuntimeError(f"no memory/compute rates known for {name!r}")


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel B1 against its plain version
# ---------------------------------------------------------------------------

def b1_inputs(torch, W, n, tdt, vdt, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    t, p, v, gr = (torch.randn(W, n, generator=g, device=dev) for _ in range(4))
    coef = torch.rand(W, generator=g, device=dev)
    return t.to(tdt), p.to(tdt), v.to(vdt), gr.to(tdt), coef


def b1_bytes(W, n, t_size, v_size):
    """Least bytes B1 must move: read theta/peer/g (T) and v, write theta
    and v, read the [W, 3] f32 scalars."""
    return W * n * (4 * t_size + 2 * v_size) + W * 12


def check_b1(torch, fu, ref, dev):
    """Max abs error of B1 against the plain version over every case."""
    eta = torch.full((), 1e-3, device=dev)
    mu = 0.99
    worst = 0.0
    cases = []
    for W, n in ((8, N_FULL), (4, N_FULL), (8, 1000), (1, 1000)):
        for tdt, vdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
            for coef_kind in ("scalar", "per_row", "peer_is_theta"):
                cases.append((W, n, tdt, vdt, coef_kind))
    for i, (W, n, tdt, vdt, coef_kind) in enumerate(cases):
        t, p, v, g, coef = b1_inputs(torch, W, n, tdt, vdt, i, dev)
        c = 0.5 if coef_kind == "scalar" else coef
        if coef_kind == "peer_is_theta":
            p = t
        want_t, want_v = ref.fused_flat_elastic_nag_update(t, p, v, g, c, eta, mu)
        kt, kv = t.clone(), v.clone()
        kp = kt if coef_kind == "peer_is_theta" else p
        fu.fused_flat_elastic_nag_update(kt, kp, kv, g, c, eta, mu)
        torch.cuda.synchronize()
        for got, want in ((kt, want_t), (kv, want_v)):
            tol = TOL[str(want.dtype).split(".")[-1]]
            diff = (got.float() - want.float()).abs()
            if not bool((diff <= tol + tol * want.float().abs()).all()):
                raise AssertionError(f"B1 disagrees with its plain version: W={W} "
                                     f"N={n} {tdt}/{vdt} {coef_kind}: max abs err "
                                     f"{float(diff.max())} (rtol = atol = {tol})")
            worst = max(worst, float(diff.max()))
        del t, p, v, g, kt, kv, want_t, want_v
    log(f"[kernels] B1 vs plain version: {len(cases)} cases, max abs err {worst!r} "
        f"(rtol = atol = 1e-6 for f32, 2e-2 for bf16)")
    return worst


def time_launches(torch, fn, reps=60, warmup=10):
    """Median ms of one call: events between back-to-back launches (the
    queue stays full, so host launch gaps do not show)."""
    for _ in range(warmup):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def time_b1(torch, fu, ref, dev, W, bw, peak):
    t, p, v, g, _ = b1_inputs(torch, W, N_FULL, torch.float32, torch.float32, 100 + W, dev)
    ones = torch.ones(W, device=dev)
    eta = torch.full((), 1e-3, device=dev)
    ms = time_launches(torch, lambda: fu.fused_flat_elastic_nag_update(t, p, v, g, ones, eta, 0.99))
    plain_ms = time_launches(torch, lambda: ref.fused_flat_elastic_nag_update(t, p, v, g, ones, eta, 0.99))
    nbytes = b1_bytes(W, N_FULL, 4, 4)
    bytes_ms = nbytes / bw * 1e3
    ops_ms = FLOPS_PER_ELEMENT * W * N_FULL / peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"[kernels] B1 [{W}, {N_FULL}] f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved)")
    del t, p, v, g
    return ms, plain_ms, bound_ms, "bytes" if bytes_ms >= ops_ms else "operations"


def check_b1_rows(torch, fu, ref, dev):
    """B1 on a row list (the async engine's partial windows) byte for byte
    against its plain version: one row, unsorted rows, every row (also
    against the whole-plane launch), an empty list (no launch), bf16 and a
    ragged N; the rows not listed keep their bits. Returns the max abs
    error (0.0 when exact)."""
    eta = torch.full((), 1e-3, device=dev)
    worst = 0.0
    cases = [(8, N_FULL, torch.float32, torch.float32, [3]),
             (8, N_FULL, torch.float32, torch.float32, [6, 1, 3, 0]),
             (8, N_FULL, torch.float32, torch.float32, list(range(8))),
             (8, N_FULL, torch.float32, torch.float32, []),
             (8, N_FULL, torch.bfloat16, torch.float32, [5, 2]),
             (8, 1000, torch.bfloat16, torch.bfloat16, [7]),
             (4, 1000, torch.float32, torch.float32, [1, 3])]
    for i, (W, n, tdt, vdt, rows) in enumerate(cases):
        t, p, v, g, coef = b1_inputs(torch, W, n, tdt, vdt, 70 + i, dev)
        r = torch.tensor(rows, dtype=torch.int32, device=dev)
        want_t, want_v = ref.fused_flat_elastic_nag_update(t, p, v, g, coef, eta, 0.99, rows=r)
        kt, kv = t.clone(), v.clone()
        before = fu.LAUNCHES
        fu.fused_flat_elastic_nag_update(kt, p, kv, g, coef, eta, 0.99, rows=r)
        torch.cuda.synchronize()
        if fu.LAUNCHES != before + (1 if rows else 0):
            raise AssertionError(f"B1 row list {rows}: {fu.LAUNCHES - before} launches")
        for got, want in ((kt, want_t), (kv, want_v)):
            worst = max(worst, float((got.float() - want.float()).abs().max()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"B1 row list disagrees with its plain version: W={W} "
                                     f"N={n} {tdt}/{vdt} rows {rows}")
        if len(rows) == W:
            wt, wv = t.clone(), v.clone()
            fu.fused_flat_elastic_nag_update(wt, p, wv, g, coef, eta, 0.99)
            if not (bits_equal(torch, wt, kt) and bits_equal(torch, wv, kv)):
                raise AssertionError("B1 on every row listed != the whole-plane launch")
        del t, p, v, g, kt, kv, want_t, want_v
    log(f"[kernels] B1 row list vs plain version: {len(cases)} cases (one row, unsorted, all "
        f"rows = the whole-plane launch, empty = no launch, bf16, ragged N), byte-equal, "
        f"unlisted rows unwritten; max abs err {worst!r}")
    return worst


def time_b1_rows(torch, fu, ref, dev, bw, peak):
    """B1 on the first k of 8 rows of the [8, 2913408] f32 plane, k = 1, 4,
    8 (CUDA events, and the kernel's device time alone under the profiler:
    at one row the wrapper's host time shows in the events), and its plain
    version, beside the bound for k rows (k/8 of the plane's bytes).
    Returns {k: (ms, device ms, plain_ms, bound_ms)}."""
    t, p, v, g, _ = b1_inputs(torch, 8, N_FULL, torch.float32, torch.float32, 108, dev)
    ones = torch.ones(8, device=dev)
    eta = torch.full((), 1e-3, device=dev)
    out = {}
    for k in (1, 4, 8):
        r = torch.arange(k, dtype=torch.int32, device=dev)
        ms = time_launches(torch, lambda: fu.fused_flat_elastic_nag_update(
            t, p, v, g, ones, eta, 0.99, rows=r))
        plain_ms = time_launches(torch, lambda: ref.fused_flat_elastic_nag_update(
            t, p, v, g, ones, eta, 0.99, rows=r))
        dev_ms = device_ms(torch, lambda: fu.fused_flat_elastic_nag_update(
            t, p, v, g, ones, eta, 0.99, rows=r), match="fused_flat_elastic_nag_kernel")
        bytes_ms = b1_bytes(k, N_FULL, 4, 4) / bw * 1e3
        bound_ms = max(bytes_ms, FLOPS_PER_ELEMENT * k * N_FULL / peak * 1e3)
        out[k] = (ms, dev_ms, plain_ms, bound_ms)
        log(f"[kernels] B1 row list, {k} of 8 rows of [8, {N_FULL}] f32: kernel {ms:.4f} ms "
            f"(device alone {dev_ms:.4f}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({b1_bytes(k, N_FULL, 4, 4) / (dev_ms * 1e-3) / 1e12:.3f} TB/s achieved on "
            f"the device)")
    del t, p, v, g
    return out


# ---------------------------------------------------------------------------
# phase 2: kernels B2 and B3 against their plain versions
# ---------------------------------------------------------------------------

def check_b2(torch, fu, ref, dev):
    """B2 byte for byte against its plain version, in place: the outputs
    are the input tensors. Returns the max abs error (0.0 when exact)."""
    worst = 0.0
    cases = [(8, N_FULL, torch.float32, torch.float32, "python"),
             (4, N_FULL, torch.float32, torch.float32, "device"),
             (8, N_FULL, torch.bfloat16, torch.float32, "device"),
             (8, N_FULL, torch.bfloat16, torch.bfloat16, "python"),
             (4, 1000, torch.float32, torch.float32, "device"),
             (4, 1000, torch.bfloat16, torch.float32, "python")]
    for i, (W, n, tdt, vdt, scalars) in enumerate(cases):
        t, _, v, g, _ = b1_inputs(torch, W, n, tdt, vdt, 40 + i, dev)
        eta, mu = ((1e-3, 0.99) if scalars == "python" else
                   (torch.full((), 1e-3, device=dev), torch.full((), 0.99, device=dev)))
        want_t, want_v = ref.fused_flat_nag_update(t, v, g, eta, mu)
        kt, kv = t.clone(), v.clone()
        out = fu.fused_flat_nag_update(kt, kv, g, eta, mu)
        torch.cuda.synchronize()
        if out[0] is not kt or out[1] is not kv:
            raise AssertionError("B2 must update theta and v in place")
        for got, want in ((kt, want_t), (kv, want_v)):
            worst = max(worst, float((got.float() - want.float()).abs().max()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"B2 disagrees with its plain version: W={W} N={n} "
                                     f"{tdt}/{vdt}, eta/mu {scalars}: max abs err "
                                     f"{float((got.float() - want.float()).abs().max())!r}")
        del t, v, g, kt, kv, want_t, want_v
    log(f"[kernels] B2 vs plain version: {len(cases)} cases ([8|4, {N_FULL}] f32, bf16 "
        f"theta with f32 or bf16 v, ragged [4, 1000], eta/mu python or device scalars), "
        f"byte-equal, in place; max abs err {worst!r}")
    return worst


def check_b3(torch, fu, ref, dev):
    """B3 byte for byte against its plain version on [1024, 1000] f32 and
    bf16 arrays with a scalar coef_gate; its inputs must come back
    unwritten. Returns the max abs error (0.0 when exact)."""
    worst = 0.0
    for i, tdt in enumerate((torch.float32, torch.bfloat16)):
        g = torch.Generator(device=dev).manual_seed(50 + i)
        t, p, v, gr = (torch.randn(1024, 1000, generator=g, device=dev).to(tdt)
                       for _ in range(4))
        before = [x.clone() for x in (t, p, v, gr)]
        coef = torch.full((), 0.5, device=dev)
        want_t, want_v = ref.fused_elastic_nag_update(t, p, v, gr, coef, eta=1e-3, mu=0.99)
        got_t, got_v = fu.fused_elastic_nag_update(t, p, v, gr, coef, eta=1e-3, mu=0.99)
        torch.cuda.synchronize()
        for got, want in ((got_t, want_t), (got_v, want_v)):
            worst = max(worst, float((got.float() - want.float()).abs().max()))
            if not bits_equal(torch, got, want):
                raise AssertionError(f"B3 disagrees with its plain version: [1024, 1000] {tdt}")
        if not all(bits_equal(torch, a, b) for a, b in zip(before, (t, p, v, gr))):
            raise AssertionError(f"B3 wrote into an input ({tdt})")
    log(f"[kernels] B3 vs plain version: [1024, 1000] f32 and bf16, scalar coef_gate, "
        f"byte-equal, inputs unwritten; max abs err {worst!r}")
    return worst


def time_b2_b3(torch, fu, ref, dev, W, bw, peak):
    """B2 and B3 (on a [W, N] array) and their plain versions at
    [W, 2913408] f32 beside their bounds. B2 moves five streams (read
    theta/v/g, write theta/v) and the [W, 2] scalars; B3 six (read
    theta/peer/v/g, write theta'/v')."""
    t, p, v, g, _ = b1_inputs(torch, W, N_FULL, torch.float32, torch.float32, 60 + W, dev)
    eta = torch.full((), 1e-3, device=dev)
    out = {}
    calls = {
        B2: (lambda: fu.fused_flat_nag_update(t, v, g, eta, 0.99),
             lambda: ref.fused_flat_nag_update(t, v, g, eta, 0.99),
             W * N_FULL * 20 + W * 8, NAG_FLOPS_PER_ELEMENT),
        B3: (lambda: fu.fused_elastic_nag_update(t, p, v, g, 0.5, eta=1e-3, mu=0.99),
             lambda: ref.fused_elastic_nag_update(t, p, v, g, 0.5, eta=1e-3, mu=0.99),
             W * N_FULL * 24, FLOPS_PER_ELEMENT),
    }
    for kname, (kern, plain, nbytes, flops) in calls.items():
        ms = time_launches(torch, kern)
        plain_ms = time_launches(torch, plain)
        bytes_ms = nbytes / bw * 1e3
        ops_ms = flops * W * N_FULL / peak * 1e3
        out[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                          bound_ms=max(bytes_ms, ops_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        log(f"[kernels] {KERNELS[kname][0]} [{W}, {N_FULL}] f32: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB "
            f"at {bw / 1e12:.2f} TB/s; {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved)")
    out[B2]["library_ms"] = time_fused_sgd(torch, t, v, g, W)
    del t, p, v, g
    return out


def time_fused_sgd(torch, t, v, g, W):
    """Library time for B2: PyTorch's fused Nesterov SGD step
    (``torch._fused_sgd_``, one launch) on the same [W, N] f32 buffers. It
    keeps the velocity as buf = -v/eta (buf' = mu*buf + g; theta' = theta -
    eta*(g + mu*buf')), the same update in another parameterisation and the
    same five streams. Checked against B2's plain version on one step, then
    timed in place. The port never calls it."""
    from repro_torch.kernels import ref
    kw = dict(weight_decay=0.0, momentum=0.99, lr=1e-3, dampening=0.0, nesterov=True,
              maximize=False, is_first_step=False)
    lt, lbuf = t.clone(), (v / -1e-3).contiguous()
    torch._fused_sgd_([lt], [g], [lbuf], **kw)
    want_t, _ = ref.fused_flat_nag_update(t.clone(), v.clone(), g, 1e-3, 0.99)
    diff = float((lt - want_t).abs().max())
    if not diff <= 1e-5 * (1.0 + float(want_t.abs().max())):
        raise AssertionError(f"torch._fused_sgd_ is not B2's update: max abs diff {diff!r}")
    ms = time_launches(torch, lambda: torch._fused_sgd_([lt], [g], [lbuf], **kw))
    log(f"[kernels] library for B2 [{W}, {N_FULL}] f32: torch._fused_sgd_ (nesterov) "
        f"{ms:.4f} ms; theta after one step within {diff!r} of B2's plain version")
    del lt, lbuf, want_t
    return ms


# ---------------------------------------------------------------------------
# phase 2: kernels B4-B7 against their plain versions
# ---------------------------------------------------------------------------

def bits_equal(torch, a, b):
    """Exact equality, byte for byte (so -0.0 differs from +0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def codec_outputs(torch, mod, x, r, seeds, block, k):
    """{kernel: outputs} of B4-B7 through ``mod`` (the kernel wrappers or
    the plain versions); each decode reads the plain encode's wire."""
    from repro_torch.kernels import ref
    n = x.shape[1]
    out = {"q8_encode": mod.q8_encode(x, seeds, block=block),
           "topk_encode": mod.topk_encode(x, r, k=k, block=block)}
    pv, ps = ref.q8_encode(x, seeds, block=block)
    pvals, pidx, _ = ref.topk_encode(x, r, k=k, block=block)
    out["q8_decode"] = (mod.q8_decode(pv, ps, n, block=block),)
    out["topk_decode"] = (mod.topk_decode(pvals, pidx, n, k=k, block=block),)
    return out


def codec_case(torch, g, dev, W, n, block, k, name=None):
    """(name, x, r, block, k): random rows and a 0.1-scaled residual."""
    return (name or f"[{W}, {n}] block {block} k {k}",
            torch.randn(W, n, generator=g, device=dev),
            0.1 * torch.randn(W, n, generator=g, device=dev), block, k)


def check_codec(torch, ck, ref, codec_seeds, dev):
    """B4-B7 against their plain versions, exactly, on: the main path's
    [8, 2913408] at block 512 and k 26; a ragged [4, 1000] at block 128 and
    k 13; a block of zeros (scale 1) beside a block of tied magnitudes
    (including -0.0); a block tied across its k-th magnitude (k 20); k = 1
    and k = block; at blocks 128, 256, 512, 1024 and 4096 (past B4's
    registers) rows of n % 4 = 1 (the scalar paths) and of n % 4 = 0 with a
    partial last block; 40 rows over thousands of thread blocks. Then B4 on
    NaN, inf and -0.0 blocks and B7 on a corrupted wire
    (:func:`check_codec_faults`). Returns the max abs error per kernel (0.0
    when exact)."""
    g = torch.Generator(device=dev).manual_seed(11)
    special = torch.zeros(2, 2 * BLOCK, device=dev)
    special[:, BLOCK:] = torch.tensor([1.5, -1.5, 0.5, -0.0], device=dev).repeat(BLOCK // 4)
    # 40 entries of each row's first block tied at its 20th largest magnitude
    # (signs mixed), so k 20 keeps fewer than 20 above the tie and the
    # lowest-index ones of the 40
    straddle = torch.randn(2, 2 * BLOCK, generator=g, device=dev)
    for w in range(2):
        t = straddle[w, :BLOCK].abs().sort(descending=True).values[19]
        pos = torch.randperm(BLOCK, generator=g, device=dev)[:40]
        straddle[w, pos] = t * torch.where(torch.rand(40, generator=g, device=dev) < 0.5, -1.0, 1.0)
    cases = [codec_case(torch, g, dev, 8, N_FULL, BLOCK, TOPK, "[8, 2913408]"),
             codec_case(torch, g, dev, 4, 1000, 128, 13, "[4, 1000]"),
             ("zero block + ties [2, 1024]", special, torch.zeros_like(special), BLOCK, TOPK),
             ("tie straddling the 20th [2, 1024] k 20", straddle, torch.zeros_like(straddle),
              BLOCK, 20),
             codec_case(torch, g, dev, 4, 100000, BLOCK, 1, "[4, 100000] k 1"),
             codec_case(torch, g, dev, 4, 100000, BLOCK, BLOCK, "[4, 100000] k = block")]
    cases += [codec_case(torch, g, dev, 3, 3 * block + tail, block, round(0.05 * block))
              for block in (128, 256, 512, 1024, 4096) for tail in (37, 64)]
    cases.append(codec_case(torch, g, dev, 40, 20011, 256, 13))
    worst = dict.fromkeys(ck.LAUNCHES, 0.0)
    for name, x, r, block, k in cases:
        seeds = codec_seeds(3, torch.arange(x.shape[0], device=dev))
        got = codec_outputs(torch, ck, x, r, seeds, block, k)
        want = codec_outputs(torch, ref, x, r, seeds, block, k)
        torch.cuda.synchronize()
        for kname in got:
            for a, b in zip(got[kname], want[kname]):
                err = float((a.double() - b.double()).abs().max())
                worst[kname] = max(worst[kname], err)
                if not bits_equal(torch, a, b):
                    raise AssertionError(f"{kname} disagrees with its plain version on {name}: "
                                         f"max abs err {err!r} (must be exact)")
        if name.startswith("zero"):
            v, sc = got["q8_encode"]
            if float(sc[0, 0]) != 1.0 or bool(v[:, :BLOCK].any()):
                raise AssertionError(f"all-zero block: scale {float(sc[0, 0])}, values not 0")
        del got, want
    log(f"[kernels] B4-B7 vs plain versions: {len(cases)} cases ({', '.join(c[0] for c in cases)}), "
        f"int8 values, scales, top-k values, indices, residual and both decodes byte-equal; "
        f"max abs err {worst}")
    check_codec_faults(torch, ck, ref, codec_seeds, dev)
    return worst


def check_codec_faults(torch, ck, ref, codec_seeds, dev):
    """B4 on rows holding NaN, +-inf and -0.0 in different blocks (block 512
    and 4096): scales byte-equal to the plain version's (NaN block 1, inf
    block inf, all -0.0 block 1), int8 values equal at every finite element
    (NaN -> int8 is defined by neither side). B7 on a corrupted top-k wire
    (duplicate indices over twelve decades of values, so the sums depend on
    their order, and indices -5, block, 2**31 - 1, -2**31), byte-equal to
    the plain version run on the CPU, which sums in pair order
    (``scatter_add_`` on the card promises no order among duplicates)."""
    g = torch.Generator().manual_seed(13)
    for block in (BLOCK, 4096):
        x = torch.randn(2, 6 * block + 37, generator=g)
        x[0, 5], x[0, block + 9], x[0, 2 * block + 100] = float("nan"), float("inf"), -float("inf")
        x[0, 3 * block + 3] = -0.0
        x[0, 4 * block:5 * block] = -0.0
        x[1, 17], x[1, 20] = -float("nan"), float("inf")
        x[1, 6 * block + 18] = float("nan")
        x = x.to(dev)
        seeds = codec_seeds(3, torch.arange(2, device=dev))
        (v, sc), (pv, ps) = ck.q8_encode(x, seeds, block=block), ref.q8_encode(x, seeds, block=block)
        torch.cuda.synchronize()
        fin = torch.nn.functional.pad(torch.isfinite(x), (0, v.shape[1] - x.shape[1]), value=True)
        if not bits_equal(torch, sc, ps) or not torch.equal(v[fin], pv[fin]):
            raise AssertionError(f"B4 on NaN/inf blocks at block {block}: scales {sc.tolist()} "
                                 f"against the plain version's {ps.tolist()}")
        if sc[0, :5].tolist()[:3] != [1.0, float("inf"), float("inf")] or float(sc[0, 4]) != 1.0:
            raise AssertionError(f"B4 NaN/inf/-0.0 scales {sc[0, :5].tolist()}")
    W, nb, k, block = 4, 3000, TOPK, BLOCK
    n = nb * block - 3
    pool = torch.randint(0, block, (W, nb, 6), generator=g)
    idx = torch.gather(pool, 2, torch.randint(0, 6, (W, nb, k), generator=g))
    out = torch.rand(W, nb, k, generator=g) < 0.2
    bad = torch.tensor([-5, block, 2**31 - 1, -2**31])
    idx[out] = bad[torch.randint(0, 4, (int(out.sum()),), generator=g)]
    vals = torch.randn(W, nb, k, generator=g) * 10.0 ** torch.randint(-3, 9, (W, nb, k),
                                                                      generator=g)
    idx[0, 0, :3], vals[0, 0, :3] = 5, torch.tensor([1.0, 1e8, -1e8])
    vals, idx = vals.float().reshape(W, nb * k), idx.to(torch.int32).reshape(W, nb * k)
    d = ck.topk_decode(vals.to(dev), idx.to(dev), n, k=k, block=block)
    want = ref.topk_decode(vals, idx, n, k=k, block=block)
    if not bits_equal(torch, d.cpu(), want) or float(d[0, 5]) != 0.0:
        raise AssertionError(f"B7 on a corrupted top-k wire: max abs err "
                             f"{float((d.cpu().double() - want.double()).abs().max())!r}, "
                             f"column 5 {float(d[0, 5])} (pair order gives 0.0)")
    log(f"[kernels] B4 on NaN / +-inf / -0.0 blocks (block {BLOCK} and 4096): scales byte-equal "
        f"(NaN block 1.0, inf block inf), int8 equal at every finite element; B7 on a "
        f"corrupted top-k wire [{W}, {nb * k}] (duplicates, indices -5, {block}, 2**31 - 1, "
        f"-2**31) byte-equal to the plain version on the CPU")


# kernel -> the name its CUDA kernel carries in a profiler trace
CODEC_KERNEL_NAMES = {"q8_encode": "q8_encode_kernel", "q8_decode": "q8_decode_kernel",
                      "topk_encode": "topk_encode_kernel", "topk_decode": "topk_decode_kernel"}


def time_codec(torch, ck, ref, codec_seeds, dev, bw, peak):
    """Each of B4-B7 and its plain version at [8, 2913408], block 512, k 26,
    beside its bound: CUDA events back to back, and the kernel's device time
    alone under torch.profiler (the events of a ~0.04 ms kernel can show the
    wrapper's host cost instead). Beside B5 one torch.mul of the int8 values
    by the scales (int8 * f32 promotes to f32; checked byte-equal to B5's
    output first), beside B6 torch.topk over the block magnitudes (selection
    only: no residual, no tie rule). B4 and B7 have no single PyTorch call."""
    W, n, block, k = 8, N_FULL, BLOCK, TOPK
    nb = -(-n // block)
    npad = W * nb * block
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(W, n, generator=g, device=dev)
    r = 0.1 * torch.randn(W, n, generator=g, device=dev)
    seeds = codec_seeds(0, torch.arange(W, device=dev))
    v, sc = ck.q8_encode(x, seeds, block=block)
    vals, idx, _ = ck.topk_encode(x, r, k=k, block=block)
    mag = torch.abs(torch.nn.functional.pad(x + r, (0, nb * block - n))).reshape(W, nb, block)
    v3, sc3 = v.view(W, nb, block), sc[..., None]
    if not bits_equal(torch, torch.mul(v3, sc3).view(W, nb * block)[:, :n],
                      ck.q8_decode(v, sc, n, block=block)):
        raise AssertionError("torch.mul(values, scales) differs from B5's output")
    # least bytes: each input read once, each output written once
    nbytes = {"q8_encode": W * n * 4 + W * 8 + npad + W * nb * 4,
              "q8_decode": npad + W * nb * 4 + W * n * 4,
              "topk_encode": 2 * W * n * 4 + W * n * 4 + W * nb * k * 8,
              "topk_decode": W * nb * k * 8 + W * n * 4}
    # operations the function needs (counted at the f32 rate): q8 encode
    # ~20 per element (hash, abs/max, divide, add, floor, clamp, convert),
    # decode 2, top-k encode 4 (add, abs, one comparison, select), decode 2
    ops = {"q8_encode": 20 * npad, "q8_decode": 2 * W * n,
           "topk_encode": 4 * npad, "topk_decode": 2 * W * n}
    calls = {
        "q8_encode": (lambda: ck.q8_encode(x, seeds, block=block),
                      lambda: ref.q8_encode(x, seeds, block=block), None, None),
        "q8_decode": (lambda: ck.q8_decode(v, sc, n, block=block),
                      lambda: ref.q8_decode(v, sc, n, block=block),
                      lambda: torch.mul(v3, sc3), "torch.mul"),
        "topk_encode": (lambda: ck.topk_encode(x, r, k=k, block=block),
                        lambda: ref.topk_encode(x, r, k=k, block=block),
                        lambda: torch.topk(mag, k, dim=-1), "torch.topk (selection only)"),
        "topk_decode": (lambda: ck.topk_decode(vals, idx, n, k=k, block=block),
                        lambda: ref.topk_decode(vals, idx, n, k=k, block=block), None, None),
    }
    out = {}
    for kname, (kern, plain, lib, lib_name) in calls.items():
        ms = time_launches(torch, kern)
        dev_ms = device_ms(torch, kern, CODEC_KERNEL_NAMES[kname])
        plain_ms = time_launches(torch, plain)
        lib_ms = time_launches(torch, lib) if lib is not None else None
        lib_dev_ms = device_ms(torch, lib) if lib is not None else None
        bytes_ms = nbytes[kname] / bw * 1e3
        ops_ms = ops[kname] / peak * 1e3
        bound = max(bytes_ms, ops_ms)
        out[kname] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library=lib_name,
                          library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=bound,
                          bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        log(f"[kernels] {kname} [{W}, {n}] block {block} k {k}: kernel {ms:.4f} ms (device "
            f"alone {dev_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({nbytes[kname] / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; "
            f"{nbytes[kname] / (dev_ms * 1e-3) / 1e12:.3f} TB/s achieved on the device, "
            f"{bound / dev_ms:.0%} of the bound)"
            + (f", {lib_name} {lib_ms:.4f} ms (device {lib_dev_ms:.4f} ms; kernel "
               f"{dev_ms / lib_dev_ms:.2f}x on the device)" if lib is not None else ""))
    out["topk_decode"]["library_note"] = (
        "no single PyTorch call: a zeroed buffer plus scatter_add_, which on the card "
        "promises no order among duplicate indices")
    del x, r, v, sc, vals, idx, mag, v3, sc3
    return out


# ---------------------------------------------------------------------------
# phase 2: kernel B8 against its plain version
# ---------------------------------------------------------------------------

def b8_cases(torch, dev):
    """(name, theta, delta, scale, thr) for every B8 check."""
    g = torch.Generator(device=dev).manual_seed(21)
    W, n = 8, N_FULL
    theta = torch.randn(W, n, generator=g, device=dev)
    delta = 3 * torch.randn(W, n, generator=g, device=dev)
    scale = torch.rand(W, generator=g, device=dev)
    thr = 0.5 + 1.5 * torch.rand(W, generator=g, device=dev)
    inf = torch.full((W,), float("inf"), device=dev)
    rt = torch.randn(4, 1000, generator=g, device=dev)
    rd = 3 * torch.randn(4, 1000, generator=g, device=dev)
    st = torch.randn(4, 1024, generator=g, device=dev)
    sd = 3 * torch.randn(4, 1024, generator=g, device=dev)
    st[:, :8] = -0.0
    sd[:, 0], sd[:, 1], sd[:, 2] = float("inf"), float("-inf"), float("nan")
    sd[:, 3], sd[:, 4], sd[:, 5] = 5.0, -0.0, 0.25
    sthr = torch.tensor([float("inf"), 1.0, 0.1, 3.0], device=dev)
    return [("[8, 2913408] clipped ([W] scale, thr +inf)", theta, delta, scale, inf),
            ("[8, 2913408] trimmed (unit scale, [W] thr)", theta, delta,
             torch.ones(W, device=dev), thr),
            ("[8, 2913408] scalar scale and thr", theta, delta, 0.37, 1.25),
            ("[4, 1000] ragged", rt, rd, scale[:4], thr[:4]),
            ("[8, 2913408] bf16 theta, f32 delta", theta.to(torch.bfloat16), delta, scale, thr),
            ("[4, 1024] +-inf, NaN, -0.0", st, sd, scale[:4], sthr)]


def check_b8(torch, rb, ref, dev):
    """B8 against its plain version, byte for byte, on every case; theta
    must come back unwritten. Returns the max abs error over finite
    elements (0.0 when exact)."""
    worst = 0.0
    cases = b8_cases(torch, dev)
    for name, t, d, sc, thr in cases:
        t0 = t.clone()
        got = rb.robust_flat_apply(t, d, sc, thr)
        want = ref.robust_flat_apply(t, d, sc, thr)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        err = float((got.float() - want.float())[fin].abs().max())
        worst = max(worst, err)
        if not bits_equal(torch, got, want):
            raise AssertionError(f"B8 disagrees with its plain version on {name}: max abs err "
                                 f"{err!r} over finite elements (must be byte-equal)")
        if not bits_equal(torch, t, t0):
            raise AssertionError(f"B8 wrote into theta on {name}")
        if name.startswith("[4, 1024]"):
            row = got[2].cpu()
            if not (torch.isnan(row[2]) and float(row[3]) == 0.0
                    and not bool(torch.signbit(row[3]))):
                raise AssertionError(f"B8 specials: NaN stays NaN, a trimmed coordinate gives "
                                     f"+0.0 on -0.0; got {row[:6].tolist()}")
        del got, want, t0
    log(f"[kernels] B8 vs plain version: {len(cases)} cases ({'; '.join(c[0] for c in cases)}), "
        f"byte-equal, theta unwritten; max abs err {worst!r}")
    return worst


def time_b8(torch, rb, ref, dev, bw, peak):
    """B8 and its plain version at [8, 2913408] f32 (the trimmed case:
    [W] thr, unit scale) beside the bound: read theta and delta, write
    theta', read the [W, 2] scalars."""
    _, t, d, sc, thr = b8_cases(torch, dev)[1]
    W, n = t.shape
    ms = time_launches(torch, lambda: rb.robust_flat_apply(t, d, sc, thr))
    plain_ms = time_launches(torch, lambda: ref.robust_flat_apply(t, d, sc, thr))
    nbytes = W * n * 12 + W * 8
    bytes_ms = nbytes / bw * 1e3
    ops_ms = B8_FLOPS_PER_ELEMENT * W * n / peak * 1e3
    log(f"[kernels] B8 [{W}, {n}] f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved); no single PyTorch call computes it")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def check_b8_strided(torch, rb, ref, dev):
    """B8 on the column chunks ``x[:, lo:hi]`` of a [8, 2913408] plane (the
    partitioned mixing's calls, ``chunk_bounds`` for P = 4, 7 and 8: P = 7
    puts chunk offsets off multiples of four, so the scalar kernel runs),
    written into the same chunk of an output plane, byte for byte against
    its plain version; bf16 theta at P = 7. Returns the max abs error."""
    from repro_torch.fleet.partition import chunk_bounds
    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(8, N_FULL, generator=g, device=dev)
    scale = torch.rand(8, generator=g, device=dev)
    thr = 0.5 + 1.5 * torch.rand(8, generator=g, device=dev)
    worst, n_cases, odd = 0.0, 0, 0
    for P, dt in ((4, torch.float32), (8, torch.float32), (7, torch.float32),
                  (7, torch.bfloat16)):
        xt = x.to(dt)
        out = torch.zeros_like(xt)
        for c, (lo, hi) in enumerate(chunk_bounds(N_FULL, P)):
            d = 3 * torch.randn(8, hi - lo, generator=g, device=dev)
            rb.robust_flat_apply(xt[:, lo:hi], d, scale, thr, out=out[:, lo:hi])
            want = ref.robust_flat_apply(xt[:, lo:hi], d, scale, thr)
            torch.cuda.synchronize()
            got = out[:, lo:hi]
            worst = max(worst, float((got.float() - want.float()).abs().max()))
            if not bits_equal(torch, got.contiguous(), want):
                raise AssertionError(f"B8 on chunk {c} [{lo}, {hi}) of P={P} {dt} disagrees "
                                     f"with its plain version")
            n_cases += 1
            odd += lo % 4 != 0
        if bool((out == 0).all(dim=0).any()):
            raise AssertionError(f"B8 chunks of P={P} left a column unwritten")
        del xt, out
    log(f"[kernels] B8 on column chunks vs plain version: {n_cases} chunks (P = 4, 8, 7 f32, "
        f"7 bf16; {odd} at offsets off multiples of 4), byte-equal, written in place into "
        f"the output plane; max abs err {worst!r}")
    return worst


def time_b8_strided(torch, rb, dev, bw, peak):
    """The partitioned robust apply over a whole [8, 2913408] f32 plane in P
    chunks, P = 4 and 8: B8 on each chunk's column slice written in place
    (what the engine runs), against one contiguous copy per chunk, B8 on
    the copy and a copy of its result into the plane; CUDA events, and the
    device time alone (every kernel of the call, copies included). Returns
    {P: (strided ms, its device ms, copy ms, its device ms, bound ms)} per
    whole plane."""
    from repro_torch.fleet.partition import chunk_bounds
    g = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(8, N_FULL, generator=g, device=dev)
    scale, thr = torch.ones(8, device=dev), 0.5 + torch.rand(8, generator=g, device=dev)
    out = torch.empty_like(x)
    res = {}
    for P in (4, 8):
        chunks = chunk_bounds(N_FULL, P)
        ds = [3 * torch.randn(8, hi - lo, generator=g, device=dev) for lo, hi in chunks]

        def strided():
            for (lo, hi), d in zip(chunks, ds):
                rb.robust_flat_apply(x[:, lo:hi], d, scale, thr, out=out[:, lo:hi])

        def copied():
            for (lo, hi), d in zip(chunks, ds):
                out[:, lo:hi].copy_(rb.robust_flat_apply(x[:, lo:hi].contiguous(), d, scale, thr))
        ms, copy_ms = time_launches(torch, strided), time_launches(torch, copied)
        dev_ms, copy_dev_ms = device_ms(torch, strided), device_ms(torch, copied)
        nbytes = 8 * N_FULL * 12 + P * 8 * 8
        bound_ms = max(nbytes / bw * 1e3, B8_FLOPS_PER_ELEMENT * 8 * N_FULL / peak * 1e3)
        res[P] = (ms, dev_ms, copy_ms, copy_dev_ms, bound_ms)
        log(f"[kernels] B8 over [8, {N_FULL}] f32 in {P} column chunks: strided in place "
            f"{ms:.4f} ms (device alone {dev_ms:.4f}), contiguous copy + B8 + copy back "
            f"{copy_ms:.4f} ms (device {copy_dev_ms:.4f}), bound {bound_ms:.4f} ms "
            f"({nbytes / (dev_ms * 1e-3) / 1e12:.3f} TB/s achieved strided on the device)")
        del ds
    del x, out
    return res


def time_wire(torch, dev):
    """The fault plane's checksummed raw wire at the main path's plane
    ([8, 2913408] f32, 11,653,636 B per row with the tail): the checksum of
    one wire, and the whole round trip (bitcast, checksum, corrupt one byte
    per row, verify, bitcast back), CUDA events, median of 60 calls."""
    from repro_torch.faults import wire as fwire
    g = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn(8, N_FULL, generator=g, device=dev)
    wire = x.view(torch.uint8)
    mask = torch.ones(8, dtype=torch.bool, device=dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    cs_ms = time_launches(torch, lambda: fwire.checksum_u8(wire))
    rt_ms = time_launches(torch, lambda: fwire.corrupt_roundtrip_bufs({"float32": x}, mask, 5,
                                                                      step))
    out, ok = fwire.corrupt_roundtrip_bufs({"float32": x}, mask, 5, step)
    if bool(ok.any()) or bool(out["float32"].any()):
        raise AssertionError("wire round trip: a corrupted row verified, or was not zeroed")
    log(f"[kernels] checksummed raw wire [8, {N_FULL}] f32 ({wire.shape[1] + 4} B per row): "
        f"checksum {cs_ms:.4f} ms, full round trip {rt_ms:.4f} ms (device ops, no kernel of "
        f"its own; every corrupted row detected)")
    del x, wire, out
    return dict(checksum_ms=cs_ms, roundtrip_ms=rt_ms)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_trainer(torch, W, dev, fused=True, codec=None, method="elastic_gossip",
                 p=0.125, faults=None, engine="sim", hetero=None, fleet=None):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(prm, x, y):
        return simple.xent_loss(simple.mlp_logits(prm, x), y)

    return GossipTrainer(
        engine=engine, hetero=hetero, fleet=fleet,
        protocol=ProtocolConfig(method=method, moving_rate=0.5, comm_probability=p,
                                topology="uniform", robust_clip=0.1),
        optimizer=OptimizerConfig(name="nag", learning_rate=1e-3, momentum=0.99),
        loss_fn=loss_fn, num_workers=W, fused_update=fused, device=dev, codec=codec,
        faults=faults, init_fn=lambda gen: simple.init_mlp(gen, **FULL)[0])


def staged_batches(torch, train, W, batch, steps, dev):
    from repro_torch.data.partition import batches_for_step, partition_iid
    shards = partition_iid(train, W, 0)
    out = []
    for i in range(steps):
        x, y = batches_for_step(shards, i, batch)
        out.append((torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)))
    return out


def run_main_path(torch, train, test, W, batch, dev, codec=None):
    """One main-path run. Every kernel's launch count is set to 0 just
    before the run and read just after; returns ({kernel: launches},
    median step ms)."""
    from repro_torch.kernels import ops
    from repro_torch.models import simple
    trainer = make_trainer(torch, W, dev, codec=codec)
    state = trainer.init_state(0)
    batches = staged_batches(torch, train, W, batch, STEPS, dev)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    losses, active, step_s = [], [], []
    residual_checked = codec != "topk"
    for xb, yb in batches:
        t0 = time.perf_counter()
        state, m = trainer.step(state, (xb, yb))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        active.append(m["comm_active"])
        if not residual_checked and int(m["comm_active"]) > 0:
            # the error-feedback residual after the first firing step
            res = state.comm.residual["float32"]
            if not bool(torch.isfinite(res).all()) or float(res.abs().sum()) == 0.0:
                raise AssertionError(f"top-k residual after a firing step: finite "
                                     f"{bool(torch.isfinite(res).all())}, "
                                     f"L1 {float(res.abs().sum())}")
            residual_checked = True
    launches = ops.launch_counts()
    tag = f"W={W}" + (f" codec={codec}" if codec else "")
    losses = [float(x) for x in losses]
    gates = sum(int(a) for a in active)
    units = int(state.proto.comm_units)
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    head, tail = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    if codec != "topk" and not tail < head:
        raise AssertionError(f"{tag}: loss not falling: first 10 {head}, last 10 {tail}")
    for kname, n in launches.items():
        want = STEPS if (kname == "fused_flat_elastic_nag_update"
                         or kname in CODEC_KERNELS.get(codec, ())) else 0
        if n != want:
            raise AssertionError(f"{tag}: {kname} launched {n} times in {STEPS} steps, "
                                 f"expected {want}")
    if units != gates:
        raise AssertionError(f"{tag}: comm_units {units} != gates drawn {gates}")
    if not residual_checked:
        raise AssertionError(f"{tag}: no step fired, so the residual was never checked")
    wire = trainer.sim._wire_bytes(state.spec)
    per_event = trainer.comm_cost().bytes_per_event
    if wire != WIRE[codec] or per_event != WIRE[codec]:
        raise AssertionError(f"{tag}: wire per event {wire} / comm_cost {per_event}, "
                             f"expected {WIRE[codec]}")
    want_bytes = (torch.tensor(wire / W, dtype=torch.float32)
                  * torch.tensor(float(units), dtype=torch.float32))
    if not bits_equal(torch, state.proto.comm_bytes.cpu(), want_bytes):
        raise AssertionError(f"{tag}: comm_bytes {float(state.proto.comm_bytes)!r} != "
                             f"f32(wire/W) * f32(units) = {float(want_bytes)!r}")
    with torch.no_grad():
        xt = torch.as_tensor(test.x, device=dev)
        yt = torch.as_tensor(test.y, device=dev)
        agg = float(simple.accuracy(simple.mlp_logits(trainer.consensus_params(state), xt), yt))
        rank0 = float(simple.accuracy(simple.mlp_logits(trainer.rank0_params(state), xt), yt))
    step_ms = statistics.median(step_s) * 1e3
    log(f"[main] {tag} batch={batch}/worker: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first-10 mean {head:.4f}, last-10 mean {tail:.4f}), median step "
        f"{step_ms:.3f} ms (synchronised), launches {launches}, comm_units {units} = "
        f"gates {gates}, wire {wire:.0f} B/event, comm_bytes "
        f"{float(state.proto.comm_bytes)!r}, aggregate acc {agg:.4f}, rank-0 acc {rank0:.4f}")
    return launches, step_ms


def fused_vs_unfused(torch, train, dev, codec=None, W=8, batch=16, steps=10):
    """The fused path (B1) and the unfused (plain) path on the same draws.

    Uncompressed, the two run free. With q8 they run in lockstep: the
    unfused path starts every step from the fused path's theta and
    velocity, so both put the same theta on the wire. Free-running, an ulp
    of drift between the two paths can move some x/scale + u across an
    integer and flip one int8 value (a stochastic-rounding flip, not a
    fault); the free-running count of such elements is printed too."""
    from repro_torch.core import topology
    tol = dict(rtol=1e-4, atol=1e-5)
    modes = ("free",) if codec is None else ("lockstep", "free")
    for mode in modes:
        tr_f = make_trainer(torch, W, dev, fused=True, codec=codec)
        tr_u = make_trainer(torch, W, dev, fused=False, codec=codec)
        s_f, s_u = tr_f.init_state(1), tr_u.init_state(1)
        gen = torch.Generator(device=dev).manual_seed(7)
        worst = 0.0
        for xb, yb in staged_batches(torch, train, W, batch, steps, dev):
            draws = (topology.participation(gen, W, 0.5), topology.sample_uniform_peers(gen, W))
            if mode == "lockstep":
                s_u.theta["float32"].copy_(s_f.theta["float32"])
                s_u.opt.mu["float32"].copy_(s_f.opt.mu["float32"])
            s_f, _ = tr_f.step(s_f, (xb, yb), draws=draws)
            s_u, _ = tr_u.step(s_u, (xb, yb), draws=draws)
            if mode == "lockstep":
                for name, a, b in (("theta", s_f.theta, s_u.theta),
                                   ("velocity", s_f.opt.mu, s_u.opt.mu)):
                    torch.testing.assert_close(a["float32"], b["float32"], **tol,
                                               msg=lambda m: f"fused vs unfused {name}: {m}")
                worst = max(worst, float((s_f.theta["float32"] - s_u.theta["float32"])
                                         .abs().max()))
        a, b = s_f.theta["float32"], s_u.theta["float32"]
        tag = f"codec={codec}, " if codec else ""
        if mode == "free" and codec is None:
            # the two paths round the comm displacement differently
            for name, x, y in (("theta", a, b), ("velocity", s_f.opt.mu["float32"],
                                                 s_u.opt.mu["float32"])):
                torch.testing.assert_close(x, y, **tol,
                                           msg=lambda m: f"fused vs unfused {name}: {m}")
            worst = float((a - b).abs().max())
        if mode == "free" and codec is not None:
            off = ~torch.isclose(a, b, **tol)
            log(f"[main] fused vs unfused, {tag}{steps} free-running steps at W={W}: "
                f"{int(off.sum())} of {a.numel()} theta elements outside rtol 1e-4 / atol 1e-5 "
                f"(q8 rounding flips), max abs diff {float((a - b).abs().max())!r} (reported, "
                f"not asserted)")
        else:
            log(f"[main] fused vs unfused, {tag}{steps} {mode} steps at W={W}, same draws: "
                f"theta max abs diff {worst!r} (rtol 1e-4, atol 1e-5)")


# ---------------------------------------------------------------------------
# phase 4: the fault plane and robust mixing
# ---------------------------------------------------------------------------

def register_drop_byzantine():
    """The headline fault model of the reference's benchmarks/faults.py:
    drop AND Byzantine noise at once, registered through the public
    decorator as user code would; the engine composes the two planes
    without knowing this model exists."""
    from repro_torch.faults import available_fault_models, register_fault_model
    from repro_torch.faults.models import ByzantineNoise, DropFault
    if "drop_byzantine" in available_fault_models():
        return

    @register_fault_model("drop_byzantine")
    class DropByzantine(ByzantineNoise, DropFault):
        """fault_rate of wires dropped + the first round(fault_frac*W)
        workers publishing noise rows."""


def fault_draws(torch, W, steps, dev, seed):
    """Gates and peers for a fault run, drawn on the card from their own
    generator and passed through the draws= hook."""
    from repro_torch.core import topology
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(topology.participation(gen, W, FAULT_P), topology.sample_uniform_peers(gen, W))
            for _ in range(steps)]


def expected_fault_counters(fcfg, fm, gates, W):
    """Host recomputation of the fault counters from the gates the run was
    given and the port's numpy draws: wires dropped and detected-corrupt
    among engaged senders, and applied exchanges (comm_units)."""
    import numpy as np
    from repro_torch.faults.models import SALT_CORRUPT, SALT_DROP, bernoulli_np
    dropped = corrupt = units = 0
    workers = np.arange(W)
    for step, gate in enumerate(gates):
        drop = (bernoulli_np(fcfg.seed, workers, step, fcfg.fault_rate, SALT_DROP)
                if fm.injects_drop else np.zeros(W, bool))
        bad = (bernoulli_np(fcfg.seed, workers, step, fcfg.fault_rate, SALT_CORRUPT)
               if fm.injects_corrupt else np.zeros(W, bool))
        dropped += int((gate & drop).sum())
        corrupt += int((gate & bad).sum())
        units += int((gate & ~(drop | bad)).sum())
    return {"wire_dropped": dropped, "wire_corrupt": corrupt, "comm_units": units}


def run_fault_path(torch, train, dev, tag, method, fkw, codec, W=8, batch=16):
    """One full-width fault run. Every kernel's count is set to 0 just
    before the run and read just after; returns ({kernel: launches},
    median step ms)."""
    from repro_torch.common.config import FaultConfig
    from repro_torch.kernels import ops
    fcfg = FaultConfig(**fkw)
    trainer = make_trainer(torch, W, dev, codec=codec, method=method, p=FAULT_P, faults=fcfg)
    fm = trainer.sim.fault_model
    state = trainer.init_state(0)
    batches = staged_batches(torch, train, W, batch, FAULT_STEPS, dev)
    draws = fault_draws(torch, W, FAULT_STEPS, dev, seed=31)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    losses, step_s = [], []
    for (xb, yb), draw in zip(batches, draws):
        t0 = time.perf_counter()
        state, m = trainer.step(state, (xb, yb), draws=draw)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    launches = ops.launch_counts()
    robust = method in ("clipped_gossip", "trimmed_gossip")
    for kname, n in launches.items():
        want = FAULT_STEPS if (kname == "fused_flat_elastic_nag_update"
                               or (kname == B8 and robust)
                               or kname in CODEC_KERNELS.get(codec, ())) else 0
        if n != want:
            raise AssertionError(f"{tag}: {kname} launched {n} times in {FAULT_STEPS} steps, "
                                 f"expected {want}")
    gates = [d[0].cpu().numpy() for d in draws]
    want = expected_fault_counters(fcfg, fm, gates, W)
    got = {k: int(getattr(state.proto, k)) for k in want}
    if got != want:
        raise AssertionError(f"{tag}: engine counters {got} != host recomputation {want}")
    if fm.injects_corrupt and want["wire_corrupt"] == 0:
        raise AssertionError(f"{tag}: no engaged sender was corrupted, nothing was checked")
    if fm.injects_drop and want["wire_dropped"] == 0:
        raise AssertionError(f"{tag}: no engaged sender was dropped, nothing was checked")
    wire = trainer.sim._wire_bytes(state.spec)
    if wire != WIRE[codec]:
        raise AssertionError(f"{tag}: wire per event {wire}, expected {WIRE[codec]}")
    want_bytes = (torch.tensor(wire / W, dtype=torch.float32)
                  * torch.tensor(float(want["comm_units"]), dtype=torch.float32))
    if not bits_equal(torch, state.proto.comm_bytes.cpu(), want_bytes):
        raise AssertionError(f"{tag}: comm_bytes {float(state.proto.comm_bytes)!r} != "
                             f"f32(wire/W) * f32(units) = {float(want_bytes)!r}")
    losses = [float(x) for x in losses]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    honest = state.theta["float32"][fm.num_byzantine(W):]
    if not bool(torch.isfinite(honest).all()):
        raise AssertionError(f"{tag}: an honest worker's row is not finite")
    step_ms = statistics.median(step_s) * 1e3
    gate_sum = int(sum(g.sum() for g in gates))
    log(f"[faults] {tag} ({method}, {fcfg.fault_model}"
        + (f", codec={codec}" if codec else "") + f", W={W}): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, median step {step_ms:.3f} ms (synchronised), launches {launches}, "
        f"gates {gate_sum}, counters {got} = host recomputation, comm_bytes "
        f"{float(state.proto.comm_bytes)!r}, {fm.num_byzantine(W)} Byzantine, honest rows finite")
    return launches, step_ms


def zero_fault_anchor(torch, train, dev, W=8, batch=16, steps=10):
    """FaultConfig(drop, rate 0) runs the whole fault wiring and must give
    the fault-free elastic_gossip run's theta, velocity and counters bit for
    bit on the same draws."""
    from repro_torch.common.config import FaultConfig
    out = {}
    batches = staged_batches(torch, train, W, batch, steps, dev)
    for tag, faults in (("free", None), ("zero", FaultConfig(fault_model="drop", fault_rate=0.0))):
        tr = make_trainer(torch, W, dev, p=FAULT_P, faults=faults)
        st = tr.init_state(2)
        for (xb, yb), draw in zip(batches, fault_draws(torch, W, steps, dev, seed=41)):
            st, _ = tr.step(st, (xb, yb), draws=draw)
        out[tag] = st
    a, b = out["free"], out["zero"]
    for name, x, y in (("theta", a.theta["float32"], b.theta["float32"]),
                       ("velocity", a.opt.mu["float32"], b.opt.mu["float32"]),
                       *((k, getattr(a.proto, k), getattr(b.proto, k))
                         for k in ("comm_rounds", "comm_units", "comm_bytes"))):
        if not bits_equal(torch, x, y):
            raise AssertionError(f"zero-fault anchor: {name} differs from the fault-free run")
    if int(b.proto.wire_dropped) != 0 or int(a.proto.comm_units) == 0:
        raise AssertionError("zero-fault anchor: dropped wires, or no exchange at all")
    log(f"[faults] zero-fault anchor, W={W}, {steps} steps, same draws: theta, velocity, "
        f"comm_rounds/units/bytes bit-equal to the fault-free run (comm_units "
        f"{int(b.proto.comm_units)}, wire_dropped 0)")


# ---------------------------------------------------------------------------
# phase 5: the dist engine, one process per gossip worker
# ---------------------------------------------------------------------------

DIST_W, DIST_BATCH, DIST_STEPS, DIST_SEED, LOCK_STEPS, RESUME_AT = 8, 16, 50, 0, 10, 5
DIST_EG = dict(method="elastic_gossip", comm_probability=0.125, moving_rate=0.5,
               topology="uniform")
DIST_OPT = dict(name="nag", learning_rate=1e-3, momentum=0.99)
# (tag, protocol kwargs, codec, steps, gather the final plane)
DIST_RUNS = (("elastic", DIST_EG, None, DIST_STEPS, False),
             ("elastic q8", DIST_EG, "q8", DIST_STEPS, False),
             ("allreduce", dict(method="allreduce"), None, DIST_STEPS, False),
             ("lockstep", DIST_EG, None, LOCK_STEPS, True))


def dist_mesh():
    from repro_torch.common.config import MeshConfig
    return MeshConfig(data=DIST_W, model=1, pods=1, workers_per_pod=DIST_W)


def host_schedule(proto_kw, steps):
    """The dist engine's host schedule, replayed here: [(fire, active,
    round, partners)] per step, from GossipSchedule(seed + 1) as every rank
    polls it."""
    from repro_torch.common.config import ProtocolConfig
    from repro_torch.core.scheduler import GossipSchedule
    sched = GossipSchedule(ProtocolConfig(**proto_kw), DIST_W, seed=DIST_SEED + 1,
                           mesh_cfg=dist_mesh())
    out = []
    for i in range(steps):
        fire, active, rnd = sched.poll(i)
        out.append((fire, active, rnd, sched.partners(rnd)))
    return out


def expected_comm_bytes(proto_kw, codec, sched):
    """comm_bytes per step, recomputed on the host in float64 as the
    reference's dist backend accumulates it."""
    total, out = 0.0, []
    for fire, active, _, _ in sched:
        if proto_kw["method"] == "allreduce":
            total += 2.0 * (DIST_W - 1) / DIST_W * WIRE[None]
        elif fire:
            total += float(WIRE[codec]) * float(sum(active) / len(active))
        out.append(total)
    return out


def check_dist_run(ranks, tag, proto_kw, codec, steps):
    """One dist run against the host's replay of its schedule, on every
    rank. Returns ({kernel: launches summed over ranks}, rank 0's run)."""
    import numpy as np
    sched = host_schedule(proto_kw, steps)
    fires = [bool(f) for f, _, _, _ in sched]
    nfire = sum(fires)
    pairwise = proto_kw["method"] != "allreduce"
    want = dict.fromkeys(KERNELS, 0)
    if pairwise:
        want[B1], want[B2] = nfire, steps - nfire
        for kname in CODEC_KERNELS.get(codec, ()):
            want[kname] = nfire
    bytes_want = expected_comm_bytes(proto_kw, codec, sched)
    total = dict.fromkeys(KERNELS, 0)
    runs = [next(r for r in rk["runs"] if r["tag"] == tag) for rk in ranks]
    for rank, run in enumerate(runs):
        if run["fired"] != fires:
            raise AssertionError(f"[dist] {tag} rank {rank}: fired {run['fired']} != host "
                                 f"schedule {fires}")
        got = {k: run["launches"][k] for k in KERNELS}
        if got != want:
            raise AssertionError(f"[dist] {tag} rank {rank}: launches {got}, expected {want} "
                                 f"({nfire} firing of {steps} steps)")
        sr = nfire if pairwise else 0
        if run["sends"] != sr or run["recvs"] != sr:
            raise AssertionError(f"[dist] {tag} rank {rank}: {run['sends']} sends / "
                                 f"{run['recvs']} recvs, expected {sr} each (one per bucket "
                                 f"per firing step)")
        if run["comm_bytes"] != bytes_want:
            raise AssertionError(f"[dist] {tag} rank {rank}: comm_bytes {run['comm_bytes'][-1]!r} "
                                 f"!= host recomputation {bytes_want[-1]!r}")
        if pairwise and run["wire_bytes"] != WIRE[codec]:
            raise AssertionError(f"[dist] {tag}: wire {run['wire_bytes']} B per event, expected "
                                 f"{WIRE[codec]}")
        if run["loss"] != runs[0]["loss"]:
            raise AssertionError(f"[dist] {tag}: rank {rank} reports another fleet-mean loss")
        for k in KERNELS:
            total[k] += got[k]
    losses = runs[0]["loss"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[dist] {tag}: non-finite loss {losses}")
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if tag in ("elastic", "elastic q8") and not tail < head:
        raise AssertionError(f"[dist] {tag}: loss not falling: first 10 {head}, last 10 {tail}")
    r0 = runs[0]
    fire_ms = [ms for ms, f in zip(r0["step_ms"], fires) if f]
    quiet_ms = [ms for ms, f in zip(r0["step_ms"], fires) if not f]
    med = (lambda xs: statistics.median(xs) if xs else float("nan"))
    # (the copies are None off the card)
    split = {k: med([e[k] for e in r0["exchanges"] if e[k] is not None])
             for k in ("d2h_ms", "gloo_ms", "h2d_ms")}
    log(f"[dist] {tag} (W={DIST_W} processes on one card, batch {DIST_BATCH}/worker, "
        f"{steps} steps" + (f", codec={codec}" if codec else "") + f"): loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f} (first-10 mean {head:.4f}, last-10 mean {tail:.4f}), "
        f"{nfire} firing steps = host schedule, launches per rank {want} on every rank, "
        f"sends = recvs = {nfire if pairwise else 0} per rank, comm_bytes "
        f"{r0['comm_bytes'][-1]!r} = host recomputation, wire {r0['wire_bytes']:.0f} B/event")
    log(f"[dist] {tag} rank 0: median synchronised step {med(r0['step_ms']):.3f} ms (firing "
        f"{med(fire_ms):.3f} ms over {len(fire_ms)}, non-firing {med(quiet_ms):.3f} ms over "
        f"{len(quiet_ms)}); exchange median d2h {split['d2h_ms']:.3f} ms, gloo "
        f"{split['gloo_ms']:.3f} ms, h2d {split['h2d_ms']:.3f} ms; fleet-mean loss all-reduce "
        f"median {med(r0['loss_reduce_ms']):.3f} ms; after a barrier (no wait for the slowest "
        f"rank): " + ", ".join(f"{k} {v:.3f} ms" for k, v in r0["probe"].items()))
    return total, r0, dict(fire_ms=med(fire_ms), quiet_ms=med(quiet_ms),
                           loss_reduce_ms=med(r0["loss_reduce_ms"]), **split,
                           probe=r0["probe"])


def dist_vs_sim(torch, r0, params, x, y, dev):
    """The lockstep run: the sim engine fed the dist schedule's gates and
    partners through draws=, from the same params and batches; theta and
    velocity of every worker after LOCK_STEPS steps and each step's
    fleet-mean loss held within rtol 1e-4 / atol 1e-5 (the sim mixes with a
    matmul, the dist engine subtracts the peer inside B1; they round
    differently)."""
    from repro_torch.models.simple import params_from_jax
    tr = make_trainer(torch, DIST_W, dev)
    st = tr.init_state(0, params=params_from_jax(params, dev))
    losses = []
    for i, (fire, active, _, partners) in enumerate(host_schedule(DIST_EG, LOCK_STEPS)):
        draws = (torch.as_tensor(active > 0, device=dev), torch.as_tensor(partners, device=dev))
        st, m = tr.step(st, (torch.as_tensor(x[i], device=dev), torch.as_tensor(y[i], device=dev)),
                        draws=draws)
        losses.append(float(m["loss"]))
    worst = {}
    for name, got, want in (("theta", r0["theta"]["float32"], st.theta["float32"]),
                            ("velocity", r0["velocity"]["float32"], st.opt.mu["float32"])):
        got = torch.as_tensor(got, device=dev)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"dist vs sim {name}: {m}")
        worst[name] = float((got - want).abs().max())
    torch.testing.assert_close(torch.tensor(r0["loss"]), torch.tensor(losses), rtol=1e-4,
                               atol=0.0)
    log(f"[dist] dist vs sim, {LOCK_STEPS} steps at W={DIST_W} on the dist schedule's gates "
        f"and partners ({sum(r0['fired'])} firing): theta max abs diff {worst['theta']!r}, "
        f"velocity {worst['velocity']!r}, losses within rtol 1e-4 (rtol 1e-4, atol 1e-5)")


def run_dist_phase(torch, train, dev):
    """Spawn the 8 ranks once for every dist run; returns ({kernel:
    launches over all ranks and runs}, {tag: step summary})."""
    import numpy as np
    from repro_torch.data.partition import batches_for_step, partition_iid
    from repro_torch.launch import dist_run
    from repro_torch.models import simple
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    params = {k: v.cpu().numpy() for k, v in simple.init_mlp(gen, **FULL)[0].items()}
    shards = partition_iid(train, DIST_W, 0)
    xs, ys = zip(*(batches_for_step(shards, i, DIST_BATCH) for i in range(DIST_STEPS)))
    x, y = np.stack(xs).astype(np.float32), np.stack(ys)
    runs = [dict(kind="train", tag=tag, protocol=pkw, codec=codec, optimizer=DIST_OPT,
                 steps=steps, seed=DIST_SEED, gather=gather)
            for tag, pkw, codec, steps, gather in DIST_RUNS]
    os.makedirs(CKPT_DIR, exist_ok=True)
    ckpt = os.path.join(CKPT_DIR, "dist.npz")
    runs.append(dict(kind="resume", tag="resume", protocol=DIST_EG, codec=None,
                     optimizer=DIST_OPT, steps=LOCK_STEPS, seed=DIST_SEED, at=RESUME_AT,
                     path=ckpt))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist_run.run_fleet(dist_mesh(), dev, dict(params=params, x=x, y=y, runs=runs),
                               timeout_s=180, join_timeout_s=600)
    log(f"[dist] {DIST_W} ranks spawned on {ranks[0]['device']}, {len(runs)} runs, joined in "
        f"{time.perf_counter() - t0:.1f} s")
    launches, summary = dict.fromkeys(KERNELS, 0), {}
    for tag, pkw, codec, steps, _ in DIST_RUNS:
        got, r0, summary[tag] = check_dist_run(ranks, tag, pkw, codec, steps)
        for kname, n in got.items():
            launches[kname] += n
    dist_vs_sim(torch, next(r for r in ranks[0]["runs"] if r["tag"] == "lockstep"), params,
                x, y, dev)
    for kname, n in check_dist_resume(ranks).items():
        launches[kname] += n
    os.remove(ckpt)
    return launches, summary


def check_dist_resume(ranks):
    """The W=8 process run saved at step RESUME_AT (rank 0 writes the whole
    plane after a gather) and resumed on every rank from its own row: the
    loaded state equals the saved one and, after the remaining steps, the
    uninterrupted run's, bit for bit on every rank, metrics included; B1
    launches on the resumed firing steps and B2 on the others, as the
    host's replay of the schedule says. Returns {kernel: launches over the
    ranks' resumed steps}."""
    sched = host_schedule(DIST_EG, LOCK_STEPS)[RESUME_AT:]
    nfire = sum(bool(f) for f, _, _, _ in sched)
    want = dict.fromkeys(KERNELS, 0)
    want[B1], want[B2] = nfire, len(sched) - nfire
    total = dict.fromkeys(KERNELS, 0)
    runs = [next(r for r in rk["runs"] if r["tag"] == "resume") for rk in ranks]
    for rank, r in enumerate(runs):
        if r["loaded_diff"] or r["final_diff"] or not r["metrics_equal"]:
            raise AssertionError(f"[dist] resume rank {rank}: differ after the load "
                                 f"{r['loaded_diff']}, at the end {r['final_diff']}, metrics "
                                 f"equal {r['metrics_equal']}")
        got = {k: r["launches"][k] for k in KERNELS}
        if got != want:
            raise AssertionError(f"[dist] resume rank {rank}: launches {got}, expected {want}")
        for k in KERNELS:
            total[k] += got[k]
    r0 = runs[0]
    log(f"[dist] save at step {RESUME_AT} of {LOCK_STEPS} (W={DIST_W} processes, rank 0 writes "
        f"the gathered plane, {r0['file_mb']:.1f} MB, entries {sorted(r0['entries'])}), "
        f"resume on every rank: loaded state and the state after {len(sched)} more steps "
        f"bit-equal to the uninterrupted run on all {len(runs)} ranks, metrics equal; "
        f"rank 0 save {r0['save_ms']:.1f} ms, load {r0['load_ms']:.1f} ms; resumed launches "
        f"per rank {want}")
    return total


# ---------------------------------------------------------------------------
# phase 6: the serving path on TinyLlama-1.1B, kernel B9
# ---------------------------------------------------------------------------

B9 = "flash_attention"
B9_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # the reference's kernel tests'
# bf16 outputs are held tighter too: to 2^-6 of the case's max |plain|, two to
# four bf16 ulps at the largest output (kernel and plain both round one f32
# result, so they differ by at most one ulp of an element)
B9_BF16_REL = 2.0 ** -6
SERVE_ARCH = "tinyllama_1_1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN = 8, 512, 1024
SERVE_TOKENS, SERVE_SWAP_AT = 64, 32
TRAFFIC = dict(rate=0.5, num_requests=32, prompt_len=(8, 64), max_new=(16, 64))
TRAFFIC_SEED, TRAFFIC_BOUNDARIES = 1, 384
PARITY_STEPS, PARITY_TOL = 8, 1e-3   # f32 logits: max |kernel - plain| / max |plain|


def plain_attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
                    kv_len=None, kv_start=None):
    """B9's plain version behind the op's signature (patched into
    ``kernels.ops.attention`` for the plain runs of this phase only)."""
    from repro_torch.kernels import ref
    return ref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap,
                         q_offset=q_offset, kv_len=kv_len, kv_start=kv_start)


def b9_cases(torch, dev, dt):
    """(tag, q, k, v, kwargs) at the shapes of the checks: causal prefill
    over G and hd and at query counts off the 64-row tile (77, 200, 513),
    MQA at G = 48 and hd 128, a q_offset suffix, decode over a
    [8, 1024, 4, 64] cache with kv_len on and around the 32-row splits,
    windows, softcap (with a window at hd 256), kv_start per row (one
    leaving whole splits empty) and a strided layer view of a stacked cache."""
    g = torch.Generator(device=dev).manual_seed(31)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    cases = []
    for G in (1, 4, 8):
        for hd in (64, 128, 256):
            cases.append((f"prefill G={G} hd={hd}", rnd(2, 200, 2 * G, hd), rnd(2, 200, 2, hd),
                          rnd(2, 200, 2, hd), dict(causal=True)))
    for S in (77, 513):
        cases.append((f"prefill Sq={S} G=8 hd=64", rnd(2, S, 32, 64), rnd(2, S, 4, 64),
                      rnd(2, S, 4, 64), dict(causal=True)))
    cases.append(("MQA G=48 hd=128", rnd(2, 160, 48, 128), rnd(2, 160, 1, 128),
                  rnd(2, 160, 1, 128), dict(causal=True)))
    q, k, v = rnd(1, 256, 32, 64), rnd(1, 256, 4, 64), rnd(1, 256, 4, 64)
    cases.append(("q_offset 200", q[:, 200:], k, v, dict(causal=True, q_offset=i32(200))))
    ck, cv = rnd(SERVE_BATCH, SERVE_MAX_LEN, 4, 64), rnd(SERVE_BATCH, SERVE_MAX_LEN, 4, 64)
    qd = rnd(SERVE_BATCH, 1, 32, 64)
    for n in (1, 31, 32, 33, 63, 64, 65, 513, SERVE_MAX_LEN):
        cases.append((f"decode kv_len {n}", qd, ck, cv,
                      dict(causal=True, q_offset=i32(n - 1), kv_len=i32(n))))
    for n in (1, 513, SERVE_MAX_LEN):
        cases.append((f"ring kv_len {n}", qd, ck, cv, dict(causal=False, kv_len=i32(n))))
    qw, kw_, vw = rnd(1, 300, 8, 64), rnd(1, 300, 2, 64), rnd(1, 300, 2, 64)
    for w in (1, 7, 4096):
        cases.append((f"window {w}", qw, kw_, vw, dict(causal=True, window=w)))
    cases.append(("softcap 50 hd=256", rnd(1, 128, 4, 256), rnd(1, 128, 2, 256),
                  rnd(1, 128, 2, 256), dict(causal=True, softcap=50.0)))
    cases.append(("window 100 softcap 50 hd=256", rnd(1, 300, 8, 256), rnd(1, 300, 2, 256),
                  rnd(1, 300, 2, 256), dict(causal=True, window=100, softcap=50.0)))
    start = torch.tensor([0, 100, 512, 700, 3, 699, 250, 1], dtype=torch.int32, device=dev)
    cases.append(("kv_start", qd, ck, cv,
                  dict(causal=True, q_offset=i32(700), kv_len=i32(701), kv_start=start)))
    empty = torch.tensor([960, 64, 0, 1000, 1000, 500, 963, 700], dtype=torch.int32, device=dev)
    cases.append(("kv_start emptying splits", qd, ck, cv,
                  dict(causal=True, q_offset=i32(1000), kv_len=i32(1001), kv_start=empty)))
    stack = rnd(3, SERVE_BATCH, SERVE_MAX_LEN, 4, 64)
    cases.append(("strided layer view", qd, stack[1, :, :600], stack[2, :, :600],
                  dict(causal=True, q_offset=i32(599))))
    return cases, (qd, ck, cv, start)


def b9_garbage_cases(torch, dev, dt, qd, ck, cv, start):
    """(tag, q, kwargs) whose keys below kv_start get NaN / inf: the decode
    at pos 700 (split form) and a 100-query suffix at q_offset 600 (the mma
    form in bf16, simt in f32), both over the [8, 1024, 4, 64] cache."""
    g = torch.Generator(device=dev).manual_seed(33)
    qp = torch.randn(SERVE_BATCH, 100, 32, 64, generator=g, device=dev).to(dt)
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=dev))
    return [("decode", qd, dict(causal=True, q_offset=i32(700), kv_len=i32(701),
                                kv_start=start)),
            ("prefill suffix", qp, dict(causal=True, q_offset=i32(600), kv_len=i32(700),
                                        kv_start=start.clamp(max=599)))]


def b9_err(tag, got, want):
    """Max |B9 - plain| of one case, raising past the dtype's bound."""
    name = str(want.dtype).split(".")[-1]
    err = float((got.float() - want.float()).abs().max())
    tol = B9_TOL[name]
    if name == "bfloat16":
        tol = min(tol, B9_BF16_REL * float(want.float().abs().max()))
    if not err <= tol:
        raise RuntimeError(f"B9 {tag} {name}: max abs err {err} > {tol}")
    return err


def check_b9(torch, ops, fa, dev):
    """B9 against its plain version in every case, f32 and bf16; keys below
    kv_start holding garbage (NaN, inf) give the bits of zeroed ones, in
    every form. Returns (max abs err by dtype, the forms that ran)."""
    worst, forms = {}, dict.fromkeys(fa.FORM_LAUNCHES, 0)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        cases, (qd, ck, cv, start) = b9_cases(torch, dev, dt)
        worst[name] = 0.0
        before = dict(fa.FORM_LAUNCHES)
        for tag, q, k, v, kw in cases:
            n = fa.LAUNCHES
            got = ops.attention(q, k, v, **kw)
            want = plain_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if fa.LAUNCHES != n + 1:
                raise RuntimeError(f"B9 {tag}: the op did not launch the kernel")
            worst[name] = max(worst[name], b9_err(tag, got, want))
        rows = torch.arange(SERVE_MAX_LEN, device=dev)[None, :, None, None]
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        for tag, q, kw in b9_garbage_cases(torch, dev, dt, qd, ck, cv, start):
            below = rows < kw["kv_start"].reshape(-1, 1, 1, 1)
            zeroed = ops.attention(q, ck.masked_fill(below, 0), cv.masked_fill(below, 0), **kw)
            garbage = ops.attention(q, ck.masked_fill(below, float("nan")),
                                    cv.masked_fill(below, float("inf")), **kw)
            if not torch.equal(zeroed.view(bits), garbage.view(bits)):
                raise RuntimeError(f"B9 {name} {tag}: garbage below kv_start changed the output")
        ran = {f: fa.FORM_LAUNCHES[f] - before[f] for f in before}
        for f in ran:
            forms[f] += ran[f]
        log(f"[serve] B9 vs plain version, {name}: {len(cases)} cases, max abs err "
            f"{worst[name]:.3e} (tolerance {B9_TOL[name]}"
            + (", and 2^-6 max |plain| per case" if dt == torch.bfloat16 else "")
            + f"); garbage below kv_start = zeroed, bit for bit (decode and prefill "
            f"suffix); forms {ran}")
    missing = [f for f, n in forms.items() if not n]
    if missing:
        raise RuntimeError(f"B9 checks never ran the {missing} form(s): {forms}")
    return worst, forms


def b9_bound(B, Sq, H, Hkv, hd, visible, size, bw, peak):
    """(bound ms, by): q, the visible K/V rows and out moved once against 4 hd
    flops per (query row, visible key) at the bf16 tensor-core peak."""
    nbytes = (2 * B * Sq * H * hd + 2 * B * visible * Hkv * hd) * size
    flops = 4 * hd * H * B * (visible if Sq == 1 else Sq * (Sq + 1) // 2)
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / peak * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def device_ms(torch, fn, match="", n=20):
    """Device ms per call of fn: the summed durations of its kernels whose
    name holds ``match``, under torch.profiler (no host time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name)
    if not us:
        raise RuntimeError(f"the profiler saw no device time for {match!r}")
    return us / n / 1e3


def timed_form(torch, fa, fn):
    """(median ms of fn, the one B9 form its launches went through)."""
    before = dict(fa.FORM_LAUNCHES)
    ms = time_launches(torch, fn)
    ran = [f for f in before if fa.FORM_LAUNCHES[f] != before[f]]
    if len(ran) != 1:
        raise RuntimeError(f"B9 timing ran forms {ran}")
    return ms, ran[0]


def time_b9(torch, ops, fa, dev, bw, peak):
    """B9, its plain version and SDPA at the serve path's two shapes, bf16:
    prefill q [8, 512, 32, 64] causal (the mma form), and decode
    q [8, 1, 32, 64] over the [8, 1024, 4, 64] cache at pos 512 (the split
    form; SDPA gets K/V cut to the live rows). The kernel is first held
    against the plain version on those inputs. Returns (times by shape, max
    abs err)."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(32)
    dt, B, S, H, Hkv, hd = torch.bfloat16, SERVE_BATCH, SERVE_PROMPT, 32, 4, 64
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dt)
    k, v = (torch.randn(B, S, Hkv, hd, generator=g, device=dev).to(dt) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = {}
    err = b9_err("prefill [8, 512, 32, 64]", ops.attention(q, k, v, causal=True),
                 plain_attention(q, k, v, causal=True))
    ms, form = timed_form(torch, fa, lambda: ops.attention(q, k, v, causal=True))
    pre = dict(ms=ms, form=form,
               plain_ms=time_launches(torch, lambda: plain_attention(q, k, v, causal=True)),
               library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True)))
    pre["device_ms"] = device_ms(torch, lambda: ops.attention(q, k, v, causal=True),
                                 "flash_attention")
    pre["library_device_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pre["bound_ms"], pre["bound_by"] = b9_bound(B, S, H, Hkv, hd, S, 2, bw, peak)
    out["prefill"] = pre
    pos = SERVE_PROMPT
    ck, cv = (torch.randn(B, SERVE_MAX_LEN, Hkv, hd, generator=g, device=dev).to(dt)
              for _ in range(2))
    qd = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dt)
    p_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    n_t = p_t + 1
    qdt = qd.transpose(1, 2).contiguous()
    kl, vl = (x[:, :pos + 1].transpose(1, 2).contiguous() for x in (ck, cv))
    err = max(err, b9_err("decode [8, 1, 32, 64] at pos 512",
                          ops.attention(qd, ck, cv, causal=True, q_offset=p_t, kv_len=n_t),
                          plain_attention(qd, ck, cv, causal=True, q_offset=p_t, kv_len=n_t)))
    ms, form = timed_form(torch, fa, lambda: ops.attention(qd, ck, cv, causal=True,
                                                           q_offset=p_t, kv_len=n_t))
    dec = dict(ms=ms, form=form,
               plain_ms=time_launches(torch, lambda: plain_attention(
                   qd, ck, cv, causal=True, q_offset=p_t, kv_len=n_t)),
               library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                   qdt, kl, vl, enable_gqa=True)))
    dec["device_ms"] = device_ms(torch, lambda: ops.attention(
        qd, ck, cv, causal=True, q_offset=p_t, kv_len=n_t), "flash_attention")
    dec["library_device_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qdt, kl, vl, enable_gqa=True))
    dec["bound_ms"], dec["bound_by"] = b9_bound(B, 1, H, Hkv, hd, pos + 1, 2, bw, peak)
    out["decode"] = dec
    log(f"[serve] B9 vs plain version at the timed shapes, bfloat16: max abs err {err:.3e}")
    for tag, r in out.items():
        log(f"[serve] B9 {tag} bf16 ({r['form']} form): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x SDPA), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); device time alone (profiler): kernel "
            f"{r['device_ms']:.4f} ms, SDPA {r['library_device_ms']:.4f} ms")
    return out, err


def serve_flow(torch, ops, fa, cfg, dev):
    """The serve_decode entry point at full width: 512-token prompts, 64
    greedy steps, one hot swap at step 32. B9 must launch once per layer in
    the prefill and in every decode step, and nowhere else."""
    from repro_torch.launch.serve_decode import serve_decode
    L = cfg.num_layers
    ops.zero_launch_counts()
    r = serve_decode(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, tokens=SERVE_TOKENS,
                     max_len=SERVE_MAX_LEN, device=dev, seed=0, swap_at=SERVE_SWAP_AT,
                     log=lambda m: log(f"[serve] {m}"))
    counts = ops.launch_counts()
    forms = dict(fa.FORM_LAUNCHES)
    want = L * (1 + SERVE_TOKENS)
    if r["prefill_launches"] != L or set(r["step_launches"]) != {L} or counts[B9] != want:
        raise RuntimeError(f"B9 launches: prefill {r['prefill_launches']}, per step "
                           f"{sorted(set(r['step_launches']))}, total {counts[B9]}; want "
                           f"{L}, {L}, {want}")
    others = {k: n for k, n in counts.items() if k != B9 and n}
    if others:
        raise RuntimeError(f"the serve path launched other kernels: {others}")
    if r["swaps"] != 2 or not r["final_logits_finite"] or \
            r["cache_pos"] != SERVE_PROMPT + SERVE_TOKENS or \
            tuple(r["stream"].shape) != (SERVE_BATCH, SERVE_TOKENS):
        raise RuntimeError(f"serve_decode: swaps {r['swaps']}, finite "
                           f"{r['final_logits_finite']}, pos {r['cache_pos']}, stream "
                           f"{tuple(r['stream'].shape)}")
    step = statistics.median(r["step_ms"])
    log(f"[serve] {cfg.name} bf16, batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, max_len "
        f"{SERVE_MAX_LEN}: prefill {r['prefill_ms']:.3f} ms, median decode step {step:.3f} ms "
        f"({SERVE_BATCH / step * 1e3:.1f} tokens/s), swap pause "
        f"{r['swap_pause_s'] * 1e3:.3f} ms, B9 launches {counts[B9]} = {L} x (1 + "
        f"{SERVE_TOKENS}), by form {forms}")
    return counts[B9], forms, dict(prefill_ms=r["prefill_ms"], step_ms=step,
                                   swap_ms=r["swap_pause_s"] * 1e3)


def serve_batcher(torch, ops, fa, cfg, dev):
    """A ContinuousBatcher over a TrafficGen stream until it drains (at most
    384 boundaries): invariants hold, every admitted request completes with
    its budget, B9 launches once per layer per boundary."""
    from repro_torch.models import transformer as tr
    from repro_torch.serve import ContinuousBatcher, LiveServer, SnapshotBus, TrafficGen
    from repro_torch.serving.engine import make_serve_program
    prog = make_serve_program(cfg, batch=SERVE_BATCH, max_len=SERVE_MAX_LEN, device=dev)
    bus = SnapshotBus()
    with torch.no_grad():
        bus.publish_params(tr.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)[0])
    server = LiveServer(prog, bus)
    server.maybe_swap()
    reqs = TrafficGen(TRAFFIC_SEED, vocab=cfg.vocab_size, **TRAFFIC).requests()
    bat = ContinuousBatcher(server, reqs)
    ops.zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = 0
    while t < TRAFFIC_BOUNDARIES and (bat.pending or bat.in_flight):
        bat.step(t)
        t += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()[B9]
    forms = dict(fa.FORM_LAUNCHES)
    bat.check_invariants()
    lat = bat.latency_summary()
    by_rid = {r.rid: r for r in reqs}
    if lat["completed"] != lat["admitted"] or bat.pending or any(
            len(rec["tokens"]) != by_rid[rec["rid"]].max_new for rec in bat.completed):
        raise RuntimeError(f"batcher did not complete every admitted request: {lat}")
    if launches != cfg.num_layers * t:
        raise RuntimeError(f"B9 launches {launches} != {cfg.num_layers} x {t} boundaries")
    tps = lat["generated_tokens"] / wall
    log(f"[serve] continuous batching: {t} boundaries in {wall:.3f} s "
        f"({wall / t * 1e3:.3f} ms a boundary), {lat['completed']} of {len(reqs)} requests "
        f"completed, {lat['generated_tokens']} tokens, {tps:.1f} tokens/s; latency in "
        f"boundaries: ttft p50 {lat['ttft_p50_boundaries']} p99 {lat['ttft_p99_boundaries']}, "
        f"total p50 {lat['latency_p50_boundaries']} p99 {lat['latency_p99_boundaries']}; "
        f"B9 launches {launches}, by form {forms}")
    return launches, forms, dict(tokens_per_s=tps, boundary_ms=wall / t * 1e3, **lat)


def serve_parity(torch, ops, cfg, dev):
    """f32 at full width: the same prefill and 8 decode steps through B9 and
    through the plain version (patched into the op), on the same weights
    and tokens."""
    from unittest import mock
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import make_serve_program
    params = tr.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)[0]
    prog = make_serve_program(cfg, batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                              param_dtype=torch.float32, cache_dtype=torch.float32,
                              with_prefill=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                           device=dev, dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, PARITY_STEPS), generator=g,
                          device=dev, dtype=torch.int32)

    def run():
        logits, cache = prog.prefill_fn(params, prompt)
        out = [logits]
        for t in range(PARITY_STEPS):
            logits, cache = prog.decode_fn(params, cache, steps[:, t:t + 1])
            out.append(logits)
        return torch.stack(out).float()

    from repro_torch.kernels import flash_attention as fa
    n = ops.launch_counts()[B9]
    before = dict(fa.FORM_LAUNCHES)
    got = run()
    forms = {f: fa.FORM_LAUNCHES[f] - before[f] for f in before}
    with mock.patch.object(ops, "attention", plain_attention):
        want = run()
    torch.cuda.synchronize()
    if ops.launch_counts()[B9] - n != cfg.num_layers * (1 + PARITY_STEPS):
        raise RuntimeError("the f32 kernel run did not launch B9 once per layer and step")
    gap = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not (torch.isfinite(got).all() and gap <= PARITY_TOL):
        raise RuntimeError(f"f32 logits through B9 vs plain: relative gap {gap} > {PARITY_TOL}")
    log(f"[serve] f32 prefill + {PARITY_STEPS} decode steps, B9 vs plain version: logits max "
        f"|diff| / max |logit| = {gap:.3e} (tolerance {PARITY_TOL}), greedy tokens agree "
        f"{agree:.4f}; B9 forms {forms}")
    return gap


def run_serve_phase(torch, ops, fa, dev, bw, peak):
    """Phase 6. Returns (B9 launches on the serve path, numbers for the
    kernels line). B9's work could run on the tensor cores, so its bound
    counts operations at the bf16 dense peak ``peak``."""
    from repro_torch.configs import get_config
    err, check_forms = check_b9(torch, ops, fa, dev)
    times, err_full = time_b9(torch, ops, fa, dev, bw, peak)
    err["bfloat16"] = max(err["bfloat16"], err_full)
    torch.cuda.empty_cache()
    cfg = get_config(SERVE_ARCH)
    n_flow, flow_forms, flow = serve_flow(torch, ops, fa, cfg, dev)
    torch.cuda.empty_cache()
    n_bat, bat_forms, bat = serve_batcher(torch, ops, fa, cfg, dev)
    torch.cuda.empty_cache()
    gap = serve_parity(torch, ops, cfg, dev)
    torch.cuda.empty_cache()
    pre, dec = times["prefill"], times["decode"]
    entry = dict(max_abs_err=err["float32"], max_abs_err_bf16=err["bfloat16"], **pre,
                 shape=[SERVE_BATCH, SERVE_PROMPT, 32, 64],
                 decode_shape=[SERVE_BATCH, 1, 32, 64], decode_cache=[SERVE_BATCH, SERVE_MAX_LEN, 4, 64],
                 decode_ms=dec["ms"], decode_form=dec["form"], decode_plain_ms=dec["plain_ms"],
                 decode_library_ms=dec["library_ms"], decode_device_ms=dec["device_ms"],
                 decode_library_device_ms=dec["library_device_ms"],
                 decode_bound_ms=dec["bound_ms"],
                 decode_bound_by=dec["bound_by"], library="scaled_dot_product_attention",
                 launches_by_form={f: flow_forms[f] + bat_forms[f] for f in flow_forms},
                 check_launches_by_form=check_forms,
                 serve=dict(flow, **{k: bat[k] for k in ("tokens_per_s", "boundary_ms",
                                                         "ttft_p50_boundaries",
                                                         "latency_p99_boundaries")},
                            f32_logit_gap=gap))
    return n_flow + n_bat, entry


# ---------------------------------------------------------------------------
# phase 7: the paper's CIFAR CNN, its table runner, and checkpoints
# ---------------------------------------------------------------------------

CNN_W, CNN_BATCH, CNN_P = 4, 32, 0.125
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")


def make_cnn_trainer(torch, W, dev):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(prm, x, y):
        return simple.xent_loss(simple.cnn_logits(prm, x), y)

    return GossipTrainer(
        engine="sim",
        protocol=ProtocolConfig(method="elastic_gossip", moving_rate=0.5,
                                comm_probability=CNN_P, topology="uniform"),
        optimizer=OptimizerConfig(name="nag", learning_rate=0.01, momentum=0.9),
        loss_fn=loss_fn, num_workers=W, device=dev,
        init_fn=lambda gen: simple.init_cnn(gen)[0])


def run_cnn_path(torch, train, dev):
    """The CNN at full width (init_cnn width 32, 307,306 parameters) on the
    CIFAR stand-in, W=4, batch 32 a worker, 50 steps. Counts set to 0 just
    before, read just after: B1 once a step, nothing else. Returns
    ({kernel: launches}, median step ms)."""
    from repro_torch.kernels import ops
    trainer = make_cnn_trainer(torch, CNN_W, dev)
    state = trainer.init_state(0)
    n = sum(s.size for s in state.spec.slots)
    if n != 307306:
        raise AssertionError(f"[paper] CNN has {n} parameters, expected 307,306")
    batches = staged_batches(torch, train, CNN_W, CNN_BATCH, STEPS, dev)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    losses, active, step_s = [], [], []
    for xb, yb in batches:
        t0 = time.perf_counter()
        state, m = trainer.step(state, (xb, yb))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        active.append(m["comm_active"])
    launches = ops.launch_counts()
    losses = [float(x) for x in losses]
    gates = sum(int(a) for a in active)
    units = int(state.proto.comm_units)
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"[paper] CNN: non-finite loss {losses}")
    head, tail = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    if not tail < head:
        raise AssertionError(f"[paper] CNN: loss not falling: first 10 {head}, last 10 {tail}")
    want = {k: (STEPS if k == B1 else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"[paper] CNN: launches {launches}, expected {want}")
    if units != gates:
        raise AssertionError(f"[paper] CNN: comm_units {units} != gates drawn {gates}")
    step_ms = statistics.median(step_s) * 1e3
    log(f"[paper] CNN W={CNN_W} batch={CNN_BATCH}/worker, {n} parameters, {STEPS} steps: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (first-10 mean {head:.4f}, last-10 mean "
        f"{tail:.4f}), median step {step_ms:.3f} ms (synchronised), launches {launches}, "
        f"comm_units {units} = gates {gates}")
    return launches, step_ms


def outside(torch, a, b, rtol=1e-4, atol=1e-6):
    """Fraction of the elements of ``a`` outside rtol / atol of ``b``."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((~torch.isclose(a, b, rtol=rtol, atol=atol)).double().mean())


def rel_l2(torch, a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# the card's CNN gradient against the CPU's f64 one at the main path's
# batch: the share of elements outside rtol 1e-4 / atol 1e-6, and each
# parameter leaf's relative L2
CNN_OUTSIDE, CNN_LEAF_L2 = 0.1, 1e-2


def cnn_against_f64(torch, card, cpu, batches, tf32_grads):
    """The main path's batch (32 a worker), 5 steps of the card's engine;
    at each, its gradient against the CPU's f64 gradient at the card's
    parameters. At most CNN_OUTSIDE of the elements outside rtol 1e-4 /
    atol 1e-6, a share the same gradient under TF32 must exceed; and every
    leaf within CNN_LEAF_L2 relative L2, so a wrong gradient in any leaf,
    however small, fails. A step where a ReLU input lies within f32
    rounding of 0 moves a few per cent of the elements, the most in the
    smallest leaf (the stem's 864): there the relative L2 of a sound f32
    gradient reaches ~1e-3 (the CPU's own too) and TF32's stays below it,
    so the leaf bound cannot tell TF32 and the share does. The CPU's own
    f32 gradient is printed beside the card's at the first step."""
    from repro_torch.checkpoint import io
    s_card = card.init_state(1)
    s64 = cpu.init_state(1, params={k: v[0].double().cpu() for k, v in s_card.params.items()})
    if s64.theta["float64"].shape != s_card.theta["float32"].shape:
        raise AssertionError("[paper] the f64 plane's layout differs from the card's")
    slots = io.flat_spec_manifest(s_card.spec)["slots"]

    def leaves(g, g64):
        return {s["path"]: rel_l2(torch, g[:, s["offset"]:s["offset"] + s["size"]],
                                  g64[:, s["offset"]:s["offset"] + s["size"]]) for s in slots}

    def show(g, g64):
        per = leaves(g, g64)
        return (f"{outside(torch, g, g64):.2e} of elements outside, rel L2 "
                f"{rel_l2(torch, g, g64):.3e}, per leaf {{"
                + ", ".join(f"{k}: {v:.2e}" for k, v in per.items()) + "}")

    worst, worst_leaf = 0.0, 0.0
    for i, (xb, yb) in enumerate(batches):
        s64.theta["float64"].copy_(s_card.theta["float32"].double().cpu())
        g64 = cpu.sim._grads(s64, xb.cpu().double(), yb.cpu())[1]["float64"]
        g = card.sim._grads(s_card, xb, yb)[1]["float32"]
        out, per = outside(torch, g, g64), leaves(g, g64)
        log(f"[paper] CNN gradient at batch {CNN_BATCH} against the CPU's f64, step {i}: card "
            f"{show(g, g64)}")
        if i == 0:
            s32 = cpu.init_state(1, params={k: v[0].cpu() for k, v in s_card.params.items()})
            gt = tf32_grads(s_card, xb, yb)
            tf32 = outside(torch, gt, g64)
            log(f"[paper] the same at step 0, CPU f32: "
                f"{show(cpu.sim._grads(s32, xb.cpu(), yb.cpu())[1]['float32'], g64)}; "
                f"card TF32 backward: {show(gt, g64)}")
            if tf32 <= CNN_OUTSIDE:
                raise AssertionError(f"[paper] the TF32 gradient passes the check: {tf32!r} of "
                                     f"its elements outside (<= {CNN_OUTSIDE})")
        bad = {k: v for k, v in per.items() if not v <= CNN_LEAF_L2}
        if out > CNN_OUTSIDE or bad:
            raise AssertionError(f"[paper] CNN gradient against f64 step {i}: {out!r} of the "
                                 f"elements outside (<= {CNN_OUTSIDE}); leaves over "
                                 f"{CNN_LEAF_L2} relative L2: {bad}")
        worst, worst_leaf = max(worst, out), max(worst_leaf, max(per.values()))
        s_card, _ = card.step(s_card, (xb, yb))
    return worst, worst_leaf, tf32


def cnn_card_vs_cpu(torch, train, dev, steps=5, batch=8):
    """The card's CNN gradients, with TF32 ALLOWED in the process for this
    check (the engine turns it off around its step). First against the
    CPU's f64 gradient at the main path's batch (cnn_against_f64). Then 5
    steps (batch 8) on the card and on the CPU, each from the card's
    parameters and velocity, on the same injected draws, per element at
    rtol 1e-4 / atol 1e-6: at least 90% of the gradient's elements and
    99.9% of theta's after the step; the same first gradient computed under
    TF32 (without the engine's context) must leave more than 10% outside,
    or the check could not tell. Not every element: at full width a ReLU
    input within rounding of 0 takes the kink on one side in one f32
    computation and on the other in the other, and moves ~1% of the
    gradient's elements by up to ~4e-4; each leaf's relative L2 against
    f64 holds those."""
    from torch.func import grad_and_value, vmap
    from repro_torch.core import topology
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        card, cpu = make_cnn_trainer(torch, CNN_W, dev), make_cnn_trainer(torch, CNN_W, "cpu")

        def tf32_grads(state, xb, yb):
            row = state.spec.with_lead(())
            return vmap(grad_and_value(lambda b, x, y: card.sim.loss_fn(
                row.views(b), x, y)))(state.theta, xb, yb)[0]["float32"].cpu()

        t0 = time.perf_counter()
        f64_out, f64_leaf, f64_tf32 = cnn_against_f64(
            torch, card, cpu, staged_batches(torch, train, CNN_W, CNN_BATCH, steps, dev),
            tf32_grads)
        s_card = card.init_state(1)
        params = {k: v[0].cpu() for k, v in s_card.params.items()}
        s_cpu = cpu.init_state(1, params=params)

        def off(a, b):
            return (f"{outside(torch, a, b):.2e} of elements outside rtol 1e-4 / atol 1e-6, "
                    f"rel L2 {rel_l2(torch, a, b):.3e}, "
                    f"max abs {float((a.double().cpu() - b.double().cpu()).abs().max()):.3e}")

        gen = torch.Generator().manual_seed(11)
        worst_g = worst_t = 0.0
        for i, (xb, yb) in enumerate(staged_batches(torch, train, CNN_W, batch, steps, dev)):
            draws = (topology.participation(gen, CNN_W, 0.5),
                     topology.sample_uniform_peers(gen, CNN_W))
            s_cpu.theta["float32"].copy_(s_card.theta["float32"].cpu())
            s_cpu.opt.mu["float32"].copy_(s_card.opt.mu["float32"].cpu())
            _, g_card = card.sim._grads(s_card, xb, yb)
            _, g_cpu = cpu.sim._grads(s_cpu, xb.cpu(), yb.cpu())
            og = outside(torch, g_card["float32"], g_cpu["float32"])
            line = f"step {i}: gradients {off(g_card['float32'], g_cpu['float32'])}"
            if i == 0:
                tf32_out = outside(torch, tf32_grads(s_card, xb, yb), g_cpu["float32"])
                line += f"; the same gradient under TF32: {tf32_out:.2e} outside"
                if tf32_out <= 0.1:
                    raise AssertionError(f"[paper] the TF32 gradient passes the check: "
                                         f"{tf32_out!r} of its elements outside (<= 0.1)")
            s_card, _ = card.step(s_card, (xb, yb), draws=(draws[0].to(dev), draws[1].to(dev)))
            s_cpu, _ = cpu.step(s_cpu, (xb.cpu(), yb.cpu()), draws=draws)
            ot = outside(torch, s_card.theta["float32"], s_cpu.theta["float32"])
            log(f"[paper] CNN card vs CPU {line}; theta "
                f"{off(s_card.theta['float32'], s_cpu.theta['float32'])}")
            if og > 0.1 or ot > 1e-3:
                raise AssertionError(f"[paper] CNN card vs CPU step {i}: {og!r} of the gradient's "
                                     f"elements (<= 0.1) and {ot!r} of theta's (<= 1e-3) outside "
                                     "rtol 1e-4 / atol 1e-6")
            worst_g, worst_t = max(worst_g, og), max(worst_t, ot)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    log(f"[paper] CNN card vs CPU with TF32 allowed in the process: at batch {CNN_BATCH} "
        f"against f64, at most {f64_out:.2e} of the elements outside (<= {CNN_OUTSIDE:g}; "
        f"TF32 {f64_tf32:.2e}), each leaf's relative L2 at most {f64_leaf:.3e} "
        f"(<= {CNN_LEAF_L2:g}); {steps} steps at batch "
        f"{batch} against the CPU's f32: at most {worst_g:.2e} of the gradient's elements "
        f"(<= 0.1) and {worst_t:.2e} of theta's (<= 1e-3) outside rtol 1e-4 / atol 1e-6, "
        f"the first gradient under TF32 {tf32_out:.2e} outside; "
        f"{time.perf_counter() - t0:.1f} s")


def profile_cnn(torch, dev):
    """Where the CNN step's time goes (repro_torch.launch.profile_sim)."""
    from repro_torch.launch import profile_sim
    r = profile_sim.profile(W=CNN_W, batch=CNN_BATCH, steps=10, device=dev, model="cnn")
    conv = r["phase_ms_per_step"].get("convolutions (cuDNN)", 0.0)
    summed = sum(r["phase_ms_per_step"].values())
    # kernels overlap in time, so their summed durations exceed the busy
    # time (the union of their intervals); the share is of the sum
    log(f"[paper] CNN profile (profile_sim --model cnn --workers {CNN_W} --batch {CNN_BATCH} "
        f"--steps 10): median step {r['step_ms_median']:.3f} ms under the profiler, "
        f"{r['kernel_launches_per_step']:.1f} kernels/step, device busy "
        f"{r['device_busy_ms_per_step']:.3f} ms/step (share {r['device_busy_share']!r}), "
        f"kernel durations summed {summed:.3f} ms/step, of which convolutions {conv:.3f} "
        f"({conv / summed:.3f}); phases {r['phase_ms_per_step']}")
    log("[paper] CNN top kernels: " + "; ".join(
        f"{k['ms_per_step']:.4f} ms x{k['calls_per_step']:.1f} {k['name'][:70]}"
        for k in r["top_kernels"][:8]))
    return r


def mlp_resume(torch, train, dev, codec=None, W=8, batch=16, steps=10):
    """The main path at full width: 10 steps, save_checkpoint, load into a
    trainer state built from init_state(1), 10 more steps on both. Every
    entry bit-equal after the load and after the steps (theta, velocity,
    residual, counters, the generator's state: the gate and peer draws).
    Returns ({kernel: launches of the resumed steps}, summary)."""
    from repro_torch.checkpoint import io
    from repro_torch.kernels import ops
    os.makedirs(CKPT_DIR, exist_ok=True)
    path = os.path.join(CKPT_DIR, f"mlp_{codec or 'raw'}.npz")
    batches = staged_batches(torch, train, W, batch, 2 * steps, dev)
    tr = make_trainer(torch, W, dev, codec=codec)
    st = tr.init_state(0)
    for xb, yb in batches[:steps]:
        st, _ = tr.step(st, (xb, yb))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save_checkpoint(path, st, meta={"step": steps})
    save_ms = (time.perf_counter() - t0) * 1e3
    mb = os.path.getsize(path) / 1e6
    saved = io.entries(st.state_dict())
    for xb, yb in batches[steps:]:
        st, _ = tr.step(st, (xb, yb))
    tr2 = make_trainer(torch, W, dev, codec=codec)
    like = tr2.init_state(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st2, _ = tr2.load_checkpoint(path, like)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    loaded = io.entries(st2.state_dict())
    ops.zero_launch_counts()
    for xb, yb in batches[steps:]:
        st2, _ = tr2.step(st2, (xb, yb))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    a, b = io.entries(st.state_dict()), io.entries(st2.state_dict())
    tag = f"MLP W={W} codec={codec}"
    for name, x, y in (("after the load", saved, loaded), (f"after {steps} more steps", a, b)):
        if set(x) != set(y):
            raise AssertionError(f"[ckpt] {tag}: entries {sorted(x)} != {sorted(y)}")
        bad = sorted(k for k in x if x[k].tobytes() != y[k].tobytes())
        if bad:
            raise AssertionError(f"[ckpt] {tag}: {bad} differ {name}")
    want = {k: (steps if k == B1 or k in CODEC_KERNELS.get(codec, ()) else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"[ckpt] {tag}: resumed launches {launches}, expected {want}")
    os.remove(path)
    log(f"[ckpt] {tag}: save {save_ms:.1f} ms, load {load_ms:.1f} ms, file {mb:.1f} MB "
        f"({len(saved)} entries: {sorted(saved)}); every entry bit-equal after the load and "
        f"after {steps} more steps on both; resumed launches {launches}")
    return launches, dict(save_ms=save_ms, load_ms=load_ms, file_mb=mb)


def run_paper_phase(torch, dev):
    """Phase 7. Returns ({kernel: launches}, summary)."""
    from repro_torch.data.synthetic import load_cifar_like, load_mnist
    from repro_torch.kernels import ops
    from repro_torch.launch import paper_tables
    cifar, _ = load_cifar_like(num_train=12800, num_test=10)
    launches, summary = run_cnn_path(torch, cifar, dev)
    summary = dict(cnn_step_ms=summary)
    cnn_card_vs_cpu(torch, cifar, dev)
    prof = profile_cnn(torch, dev)
    summary["cnn_profile"] = {k: prof[k] for k in ("step_ms_median", "kernel_launches_per_step",
                                                   "device_busy_ms_per_step",
                                                   "device_busy_share", "phase_ms_per_step")}
    mnist, _ = load_mnist(num_train=25600, num_test=10)
    for codec in (None, "topk"):
        got, summary[f"resume_{codec or 'raw'}"] = mlp_resume(torch, mnist, dev, codec)
        for k, n in got.items():
            launches[k] += n
    ops.zero_launch_counts()
    t0 = time.perf_counter()
    rows = paper_tables.main("4.3", steps=20, device=dev)
    got = ops.launch_counts()
    pairwise = sum(1 for r in rows if r.method != "allreduce")
    want = {k: (20 * pairwise if k == B1 else 0) for k in got}
    if got != want:
        raise AssertionError(f"[paper] table 4.3 launches {got}, expected {want}")
    for r in rows:
        if not all(x == x and abs(x) != float("inf") for x in (r.final_loss, r.rank0_acc,
                                                              r.aggregate_acc, r.comm_mb)):
            raise AssertionError(f"[paper] table 4.3 row {r.label}: non-finite {r}")
    for k, n in got.items():
        launches[k] += n
    log(f"[paper] table 4.3 at 20 steps a row: {len(rows)} rows in "
        f"{time.perf_counter() - t0:.1f} s, launches {got}")
    return launches, summary


# ---------------------------------------------------------------------------
# phase 8: the async engine and the fleet plane
# ---------------------------------------------------------------------------

ASYNC_LOGNORMAL = dict(time_model="lognormal", sigma=0.6, seed=3)


def register_two_groups():
    """A compute-time model whose every event window holds half the fleet:
    workers W/2.. start half a step late, so the two halves alternate.
    Registered through the public decorator, as user code would."""
    from repro_torch.hetero import available_time_models, get_time_model, register_time_model
    if "two_groups" in available_time_models():
        return

    @register_time_model("two_groups")
    class TwoGroups(get_time_model("constant")):
        def step_duration(self, worker, step):
            import numpy as np
            w = np.broadcast_arrays(np.asarray(worker), np.asarray(step))[0]
            dur = super().step_duration(worker, step)
            late = (w >= w.size // 2) & (np.asarray(step) == 0)
            return np.where(late, dur * 1.5, dur)


def window_launches(tag, got, want):
    """Every kernel's launches in a run must be ``want``'s (0 if absent)."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"[async] {tag}: launches {got}, expected {full}")


def run_windows(torch, trainer, state, batches, n=None, worker_steps=None):
    """Step ``trainer`` window by window (each synchronised) until ``n``
    windows or ``worker_steps`` worker-steps. Returns (state, records): per
    window its size, ms, loss, the gate and peers it drew (before the window
    mask) and its mask."""
    recs, done, i = [], 0, 0
    while (n is not None and i < n) or (worker_steps is not None and done < worker_steps):
        _, mask, _ = trainer.sim.next_window()
        xb, yb = batches[i % len(batches)]
        t0 = time.perf_counter()
        state, m = trainer.step(state, (xb, yb))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        gate, peers = (a.cpu().numpy() for a in trainer.sim.last_draws)
        recs.append(dict(size=int(m["window_size"]), ms=ms, loss=float(m["loss"]), gate=gate,
                         peers=peers, mask=mask, t=float(m["virtual_time"]), step=i,
                         steps_done=trainer.sim.steps_done.copy()))
        done += recs[-1]["size"]
        i += 1
    return state, recs


def median_ms(recs, size=None):
    sel = [r["ms"] for r in recs[1:] if size is None or r["size"] == size]
    return statistics.median(sel) if sel else float("nan")


def check_falling(tag, recs, k=50):
    losses = [r["loss"] for r in recs]
    if not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"[async] {tag}: non-finite loss")
    head, tail = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
    if not tail < head:
        raise AssertionError(f"[async] {tag}: loss not falling: first {k} {head}, last {k} {tail}")
    return head, tail


def async_constant_vs_sim(torch, train, dev):
    """(a) The constant fleet at W=8, batch 16, p 0.125, alpha 0.5: 50
    windows against 50 sim steps from the same seed, bit for bit (theta,
    velocity, counters, the generator); B1 once a window."""
    from repro_torch.common.config import HeteroConfig
    from repro_torch.kernels import ops
    batches = staged_batches(torch, train, 8, 16, STEPS, dev)
    sim = make_trainer(torch, 8, dev)
    s1 = sim.init_state(0)
    for xb, yb in batches:
        s1, _ = sim.step(s1, (xb, yb))
    asn = make_trainer(torch, 8, dev, engine="async", hetero=HeteroConfig())
    s2 = asn.init_state(0)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    s2, recs = run_windows(torch, asn, s2, batches, n=STEPS)
    launches = ops.launch_counts()
    window_launches("constant", launches, {B1: STEPS})
    pairs = [("theta", s1.theta["float32"], s2.theta["float32"]),
             ("velocity", s1.opt.mu["float32"], s2.opt.mu["float32"]),
             ("generator", s1.key.get_state(), s2.key.get_state())]
    pairs += [(f, getattr(s1.proto, f), getattr(s2.proto, f))
              for f in ("comm_rounds", "comm_units", "comm_bytes")]
    for name, a, b in pairs:
        if not bits_equal(torch, a, b):
            raise AssertionError(f"[async] constant fleet: {name} differs from the sim run")
    if asn.schedule_state()["hetero_clock"]["clocks"] != [float(STEPS)] * 8:
        raise AssertionError(f"[async] constant fleet clocks {asn.schedule_state()}")
    log(f"[async] (a) constant fleet W=8, {STEPS} windows: theta, velocity, comm_rounds/"
        f"units/bytes and the generator bit-equal to the sim run (comm_units "
        f"{int(s2.proto.comm_units)}); launches {launches}; median full window "
        f"{median_ms(recs):.3f} ms (synchronised)")
    return launches, dict(full_ms=median_ms(recs))


def async_stragglers(torch, train, dev, tag, W, batch, p, hetero, worker_steps=None, n=None):
    """(b), (c) and the half-window timing: windows under a straggler model.
    B1 once a window on the window's rows (checked: rows outside a window
    keep their bits, on the windows where some row is outside), comm_units
    equal to the host's count of in-window gates, the loss finite and (with
    ``worker_steps``) falling."""
    from repro_torch.kernels import ops
    trainer = make_trainer(torch, W, dev, engine="async", hetero=hetero, p=p)
    state = trainer.init_state(0)
    batches = staged_batches(torch, train, W, batch, 60, dev)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    # one partial window checked row by row (the check reads the plane back)
    _, mask, _ = trainer.sim.next_window()
    before = state.theta["float32"].clone()
    state, recs = run_windows(torch, trainer, state, batches, n=1)
    out = torch.from_numpy(~mask).to(dev)
    if not mask.all() and not bits_equal(torch, state.theta["float32"][out], before[out]):
        raise AssertionError(f"[async] {tag}: a row outside the window changed")
    del before
    state, more = run_windows(torch, trainer, state, batches, n=None if n is None else n - 1,
                              worker_steps=None if worker_steps is None
                              else worker_steps - recs[0]["size"])
    recs += more
    launches = ops.launch_counts()
    window_launches(tag, launches, {B1: len(recs)})
    units = int(state.proto.comm_units)
    host = int(sum((r["gate"] & r["mask"]).sum() for r in recs))
    if units != host:
        raise AssertionError(f"[async] {tag}: comm_units {units} != host count {host}")
    sizes = [r["size"] for r in recs]
    if worker_steps is not None:
        head, tail = check_falling(tag, recs)
    else:
        if not all(r["loss"] == r["loss"] and abs(r["loss"]) != float("inf") for r in recs):
            raise AssertionError(f"[async] {tag}: non-finite loss")
        head = tail = float("nan")
    log(f"[async] {tag}: {len(recs)} windows, {sum(sizes)} worker-steps, window sizes "
        f"{ {k: sizes.count(k) for k in sorted(set(sizes))} }, loss first-50 mean {head:.4f} -> "
        f"last-50 {tail:.4f}, comm_units {units} = host count, stale_events "
        f"{int(state.proto.stale_events)}, stale_time {float(state.proto.stale_time):.3f}, "
        f"virtual time {recs[-1]['t']:.3f}; launches {launches}; median window "
        f"{median_ms(recs):.3f} ms (singleton {median_ms(recs, 1):.3f}, half "
        f"{median_ms(recs, W // 2):.3f}, full {median_ms(recs, W):.3f}; synchronised)")
    return launches, dict(window_ms=median_ms(recs), singleton_ms=median_ms(recs, 1),
                          half_ms=median_ms(recs, W // 2), windows=len(recs))


def replay_queue(recs, fcfg, dm, fm):
    """Host recomputation of message mode from the recorded windows: the
    dispatch of every in-window initiation (drops and corrupt wires die
    there), delivery at arrival, timeouts with doubling backoff and
    retries. Returns the counters the engine must show."""
    import numpy as np
    pending, c = [], dict(applied=0, timeouts=0, retries=0, gaps=0, dropped=0, corrupt=0)
    for r in recs:
        t, mask, keep = r["t"], r["mask"], []
        for e in pending:
            if e["arrival"] <= t and (not fcfg.rendezvous or mask[e["k"]]):
                c["applied"] += 1
                c["gaps"] += e["gap"]
            elif fcfg.timeout > 0 and t > e["dispatch"] + fcfg.timeout * 2.0 ** e["attempt"]:
                c["timeouts"] += 1
                if e["attempt"] < fcfg.max_retries:
                    c["retries"] += 1
                    a = e["attempt"] + 1
                    d = float(dm.wire_delay(e["i"], e["step"], attempt=a))
                    keep.append(dict(e, attempt=a, dispatch=t, arrival=t + d))
            else:
                keep.append(e)
        pending = keep
        for i in np.nonzero(r["gate"] & mask)[0]:
            k = int(r["peers"][i])
            if k == i:
                continue
            if fm.injects_drop and bool(fm.drop_mask(int(i), r["step"])):
                c["dropped"] += 1
                continue
            if fm.injects_corrupt and bool(fm.corrupt_mask(int(i), r["step"])):
                c["corrupt"] += 1
                continue
            d = float(dm.wire_delay(int(i), r["step"], attempt=0))
            pending.append(dict(arrival=t + d, dispatch=t, attempt=0, i=int(i), k=k,
                                step=r["step"],
                                gap=int(abs(r["steps_done"][i] - r["steps_done"][k]))))
    return c


def async_message_mode(torch, train, dev, W=8, batch=16, windows=150):
    """(d) Message mode: lognormal compute times (sigma 0.6), lognormal wire
    delay (mean 0.5), timeout 1.0 with 2 retries, drops at rate 0.1,
    clipped_gossip, p 0.5. B8 once per applied exchange (both ends in one
    launch), B1 once a window; every counter equal to the host's replay."""
    from repro_torch.common.config import FaultConfig, HeteroConfig
    from repro_torch.kernels import ops
    fcfg = FaultConfig(fault_model="drop", fault_rate=0.1, delay_model="lognormal", delay=0.5,
                       delay_sigma=0.5, timeout=1.0, max_retries=2, seed=7)
    trainer = make_trainer(torch, W, dev, engine="async", method="clipped_gossip", p=0.5,
                           hetero=HeteroConfig(**ASYNC_LOGNORMAL), faults=fcfg)
    state = trainer.init_state(0)
    batches = staged_batches(torch, train, W, batch, 60, dev)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    state, recs = run_windows(torch, trainer, state, batches, n=windows)
    launches = ops.launch_counts()
    c = replay_queue(recs, fcfg, trainer.sim.delay_model, trainer.sim.fault_model)
    window_launches("message mode", launches, {B1: windows, B8: c["applied"]})
    got = {f: int(getattr(state.proto, f)) for f in ("comm_units", "exch_timeouts",
                                                    "exch_retries", "wire_dropped",
                                                    "stale_steps", "stale_events")}
    want = dict(comm_units=c["applied"], exch_timeouts=c["timeouts"],
                exch_retries=c["retries"], wire_dropped=c["dropped"], stale_steps=c["gaps"],
                stale_events=c["applied"])
    if got != want:
        raise AssertionError(f"[async] message mode: counters {got} != host replay {want}")
    if min(c["applied"], c["timeouts"], c["retries"], c["dropped"]) == 0:
        raise AssertionError(f"[async] message mode: nothing to check in {c}")
    per_event = trainer.sim._per_event
    want_bytes = torch.tensor(per_event / W * c["applied"], dtype=torch.float32)
    if not bits_equal(torch, state.proto.comm_bytes.cpu(), want_bytes):
        raise AssertionError(f"[async] message mode: comm_bytes {float(state.proto.comm_bytes)}")
    check_falling("message mode", recs)
    log(f"[async] (d) message mode W={W}, {windows} windows (clipped_gossip, drop 0.1, "
        f"lognormal delay 0.5, timeout 1.0, 2 retries): counters {got} = host replay, "
        f"comm_bytes {float(state.proto.comm_bytes)!r}; launches {launches}; median window "
        f"{median_ms(recs):.3f} ms (synchronised), {len(trainer.sim._pending)} wires pending")
    return launches, dict(message_ms=median_ms(recs))


def fleet_partitioned(torch, train, dev, W=8, batch=16, P=4):
    """(e) The sim engine at W=8 with partition=4: raw, q8, then
    clipped_gossip, 50 steps each at p 0.5. chunk_units and comm_units equal
    the host's count from the gates and ``partition_ids_np``; comm_bytes the
    plan's exact bytes (f64, to f32 rounding); B8 once per chunk per step in
    the clipped run; the raw plan's chunks sum to the full raw wire."""
    import numpy as np
    from repro_torch.common.config import FleetConfig
    from repro_torch.fleet.partition import partition_ids_np
    from repro_torch.kernels import ops
    fleet = FleetConfig(partition=P, seed=11)
    batches = staged_batches(torch, train, W, batch, STEPS, dev)
    launches_all, ms = {}, {}
    for tag, method, codec in (("raw", "elastic_gossip", None), ("q8", "elastic_gossip", "q8"),
                               ("clipped", "clipped_gossip", None)):
        trainer = make_trainer(torch, W, dev, codec=codec, method=method, p=0.5, fleet=fleet)
        state = trainer.init_state(0)
        torch.cuda.synchronize()
        ops.zero_launch_counts()
        cu, step_s = np.zeros(P, np.int64), []
        for i, (xb, yb) in enumerate(batches):
            t0 = time.perf_counter()
            state, m = trainer.step(state, (xb, yb))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            gate = trainer.sim.last_draws[0].cpu().numpy()
            pid = partition_ids_np(fleet.seed, i, W, P)
            cu += np.bincount(pid[gate], minlength=P)
        launches = ops.launch_counts()
        want = {B1: STEPS, **{k: STEPS for k in CODEC_KERNELS.get(codec, ())}}
        if method == "clipped_gossip":
            want[B8] = STEPS * P
        window_launches(f"partition {tag}", launches, want)
        plan = trainer.sim._fleet_plan(state.spec)
        if codec is None and sum(plan.wire_bytes) != WIRE[None]:
            raise AssertionError(f"partition plan bytes {plan.wire_bytes} != {WIRE[None]}")
        got_cu = state.proto.chunk_units.cpu().numpy()
        if not np.array_equal(got_cu, cu) or int(state.proto.comm_units) != int(cu.sum()):
            raise AssertionError(f"[fleet] {tag}: chunk_units {got_cu} != host {cu}")
        exact = float(np.dot(np.asarray(plan.wire_bytes, np.float64), cu)) / W
        if abs(float(state.proto.comm_bytes) - exact) > 1e-6 * exact:
            raise AssertionError(f"[fleet] {tag}: comm_bytes {float(state.proto.comm_bytes)} "
                                 f"!= plan's exact {exact}")
        ms[tag] = statistics.median(step_s[1:]) * 1e3
        for k, n in launches.items():
            launches_all[k] = launches_all.get(k, 0) + n
        log(f"[fleet] (e) sim W={W} partition={P} {tag}: chunk_units {got_cu.tolist()} = host "
            f"count, comm_bytes {float(state.proto.comm_bytes)!r} (plan's exact {exact!r}), "
            f"plan bytes per chunk {list(plan.wire_bytes)}; launches {launches}; median step "
            f"{ms[tag]:.3f} ms (synchronised)")
    return launches_all, ms


def fleet_host_plane(torch, train, dev, W=256, batch=16, windows=50, compare=20):
    """(f) The host plane at W=256 (theta and velocity pinned in host memory,
    5.97 GB): lognormal, partition=8, randomized_token_account, 50 windows;
    B1 once a window on the gathered, padded rows. The first 20 windows also
    run on the device plane from the same seed: theta within atol 2e-5,
    counters, tokens and the generator exact. Then 10 more windows timed
    phase by phase, and ``validate_fleet_memory`` for both planes at W=256
    and W=1024."""
    import numpy as np
    from repro_torch.common.config import FleetConfig, HeteroConfig
    from repro_torch.fleet import memory
    from repro_torch.kernels import ops
    fkw = dict(partition=8, flow_control="randomized_token_account", seed=13)
    replica = WIRE[None]
    for Wk in (256, 1024):
        for plane in ("device", "host"):
            try:
                need = memory.validate_fleet_memory(Wk, replica, plane, what="the MLP",
                                                    device=dev)
                log(f"[fleet] validate_fleet_memory W={Wk} plane={plane}: fits, "
                    f"~{need / 2 ** 30:.2f} GiB")
            except ValueError as e:
                log(f"[fleet] validate_fleet_memory W={Wk} plane={plane}: refuses: {e}")
    batches = staged_batches(torch, train, W, batch, 8, dev)
    het = HeteroConfig(**ASYNC_LOGNORMAL)
    t0 = time.perf_counter()
    host = make_trainer(torch, W, dev, engine="async", hetero=het,
                        fleet=FleetConfig(plane="host", **fkw))
    sh = host.init_state(0)
    init_s = time.perf_counter() - t0
    if not sh.theta["float32"].is_pinned():
        raise AssertionError("[fleet] host plane: theta is not pinned host memory")
    devp = make_trainer(torch, W, dev, engine="async", hetero=het, fleet=FleetConfig(**fkw))
    sd = devp.init_state(0)
    sd, _ = run_windows(torch, devp, sd, batches, n=compare)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    sh, recs = run_windows(torch, host, sh, batches, n=compare)
    diff = float((sh.theta["float32"] - sd.theta["float32"].cpu()).abs().max())
    if not diff <= 2e-5:
        raise AssertionError(f"[fleet] host plane vs device plane: theta max abs diff {diff}")
    for f in ("comm_units", "worker_steps", "stale_events", "clocks", "tokens", "chunk_units",
              "flow_skipped"):
        if not bits_equal(torch, getattr(sh.proto, f), getattr(sd.proto, f)):
            raise AssertionError(f"[fleet] host plane vs device plane: {f} differs")
    if not bits_equal(torch, sh.key.get_state(), sd.key.get_state()):
        raise AssertionError("[fleet] host plane vs device plane: generator differs")
    del sd, devp
    torch.cuda.empty_cache()
    sh, more = run_windows(torch, host, sh, batches, n=windows - compare)
    recs += more
    launches = ops.launch_counts()
    window_launches("host plane", launches, {B1: windows})
    if not all(r["loss"] == r["loss"] for r in recs):
        raise AssertionError("[fleet] host plane: non-finite loss")
    if int(sh.proto.chunk_units.sum()) != int(sh.proto.comm_units):
        raise AssertionError("[fleet] host plane: chunk_units do not sum to comm_units")
    hp = host.sim._hostplane
    hp.timed = True
    splits = []
    for i in range(10):
        sh, _ = host.step(sh, batches[i % len(batches)])
        splits.append(dict(hp.split_ms))
    hp.timed = False
    split = {k: statistics.median(s[k] for s in splits) for k in splits[0]}
    sizes = [r["size"] for r in recs]
    log(f"[fleet] (f) host plane W={W} ({2 * W * replica / 1e9:.2f} GB pinned, built in "
        f"{init_s:.1f} s), lognormal, partition 8, randomized_token_account: {windows} windows, "
        f"sizes { {k: sizes.count(k) for k in sorted(set(sizes))} }; first {compare} against the "
        f"device plane: theta max abs diff {diff!r}, counters, tokens and generator equal; "
        f"comm_units {int(sh.proto.comm_units)}, flow_skipped {int(sh.proto.flow_skipped)}; "
        f"launches {launches}; median window {median_ms(recs):.3f} ms (synchronised); timed "
        f"split (median of 10, ms): {json.dumps({k: round(v, 4) for k, v in split.items()})}")
    return launches, dict(host_window_ms=median_ms(recs), host_split_ms=split)


def run_async_phase(torch, dev):
    """Phase 8. Returns ({kernel: launches}, summary)."""
    from repro_torch.common.config import HeteroConfig
    from repro_torch.data.synthetic import load_mnist
    train, _ = load_mnist(num_train=25600, num_test=10)
    register_two_groups()
    launches, summary = {}, {}

    def add(got):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    got, summary["constant"] = async_constant_vs_sim(torch, train, dev)
    add(got)
    got, summary["lognormal"] = async_stragglers(
        torch, train, dev, "(b) lognormal sigma 0.6 W=8", 8, 16, 0.125,
        HeteroConfig(**ASYNC_LOGNORMAL), worker_steps=400)
    add(got)
    got, summary["slow_node"] = async_stragglers(
        torch, train, dev, "(c) slow_node x4 W=4 p 0.25", 4, 32, 0.25,
        HeteroConfig(time_model="slow_node", slow_worker=0, slow_factor=4.0), n=100)
    add(got)
    got, summary["half"] = async_stragglers(
        torch, train, dev, "half windows (two_groups) W=8", 8, 16, 0.125,
        HeteroConfig(time_model="two_groups"), n=50)
    add(got)
    got, summary["message"] = async_message_mode(torch, train, dev)
    add(got)
    got, summary["partition_ms"] = fleet_partitioned(torch, train, dev)
    add(got)
    got, summary["host_plane"] = fleet_host_plane(torch, train, dev)
    add(got)
    return launches, summary


# ---------------------------------------------------------------------------
# phase 9: the sharded plane and the telemetry plane
# ---------------------------------------------------------------------------

SHARD_S, SHARD_STEPS = 4, 50
# per-exchange, per-device wire at S = 4 on the full-width plane
# (repro_torch.shard.wire_per_device): raw 11,653,160 / 4; q8 1,423 blocks of
# 512 + 4 B; top-k 1,423 blocks x 26 pairs x 8 B
WIRE_S4 = {None: 2913290, "q8": 734268, "topk": 295984}
PADDED_S4 = {None: 2913792, "q8": 2914304, "topk": 2914304}


def shard_layout_of(torch, codec, S=SHARD_S):
    """(ShardLayout, spec) of the full-width MLP plane under S shards."""
    from repro_torch import comm, shard as shard_plane
    from repro_torch.common.config import ProtocolConfig, ShardConfig
    from repro_torch.common.flat import FlatSpec
    from repro_torch.models import simple
    gen = torch.Generator().manual_seed(0)
    params = simple.init_mlp(gen, **FULL)[0]
    spec = FlatSpec.build({k: v[None] for k, v in params.items()}, leading=1)
    cd = comm.active_codec(ProtocolConfig(codec=codec or "none"))
    return shard_plane.build_layout(spec, ShardConfig(n_shards=S), cd), spec, cd


def check_shard_kernels(torch, ck, ref, fu, rb, codec_seeds, dev, bw, peak):
    """B4-B7 on the [8 * 4, 728576] shard rows of the padded q8 / top-k
    plane, seeds codec_seeds(round, arange(32)), byte-equal to their plain
    versions; B1 on the padded [8, 2914304] plane, B2 on one padded dist
    row [1, 2914304] and B8 on the padded raw plane [8, 2913792], byte-equal
    too. Then B4-B7 timed on the shard rows beside their whole-row times of
    phase 2. Returns ({kernel: max abs err}, {kernel: timing})."""
    W, S, block, k = 8, SHARD_S, BLOCK, TOPK
    layout, _, _ = shard_layout_of(torch, "q8")
    n_pad = layout.totals["float32"]
    size = layout.shard_sizes["float32"]
    g = torch.Generator(device=dev).manual_seed(91)
    x = torch.randn(W, n_pad, generator=g, device=dev)
    x[:, N_FULL:] = 0.0                                     # the padding columns
    r = 0.1 * torch.randn(W, n_pad, generator=g, device=dev)
    rows, res = layout.shard_rows({"float32": x})["float32"], \
        layout.shard_rows({"float32": r})["float32"]
    if rows.data_ptr() != x.data_ptr() or tuple(rows.shape) != (W * S, size):
        raise AssertionError(f"shard rows are not a [{W * S}, {size}] view of the plane")
    seeds = codec_seeds(3, torch.arange(W * S, device=dev))
    got = codec_outputs(torch, ck, rows, res, seeds, block, k)
    want = codec_outputs(torch, ref, rows, res, seeds, block, k)
    err = {}
    for kname in got:
        for a, b in zip(got[kname], want[kname]):
            if not bits_equal(torch, a, b):
                raise AssertionError(f"[shard] {kname} on [{W * S}, {size}] shard rows differs "
                                     f"from its plain version")
        err[kname] = 0.0
    # B1 on the padded plane, B2 on a padded dist row, B8 on the padded raw plane
    t, p, v, gr, _ = b1_inputs(torch, W, n_pad, torch.float32, torch.float32, 92, dev)
    ones, eta = torch.ones(W, device=dev), torch.full((), 1e-3, device=dev)
    want_t, want_v = ref.fused_flat_elastic_nag_update(t, p, v, gr, ones, eta, 0.99)
    fu.fused_flat_elastic_nag_update(t, p, v, gr, ones, eta, 0.99)
    if not (bits_equal(torch, t, want_t) and bits_equal(torch, v, want_v)):
        raise AssertionError(f"[shard] B1 on the padded [{W}, {n_pad}] plane differs")
    t1, v1, g1 = t[:1].clone(), v[:1].clone(), gr[:1].clone()
    want_t, want_v = ref.fused_flat_nag_update(t1, v1, g1, eta, 0.99)
    fu.fused_flat_nag_update(t1, v1, g1, eta, 0.99)
    if not (bits_equal(torch, t1, want_t) and bits_equal(torch, v1, want_v)):
        raise AssertionError(f"[shard] B2 on a padded [1, {n_pad}] dist row differs")
    n_raw = PADDED_S4[None]
    t8 = t[:, :n_raw].contiguous()
    d = 3 * torch.randn(W, n_raw, generator=g, device=dev)
    scale = torch.rand(W, generator=g, device=dev)
    thr = torch.full((W,), float("inf"), device=dev)
    if not bits_equal(torch, rb.robust_flat_apply(t8, d, scale, thr),
                      ref.robust_flat_apply(t8, d, scale, thr)):
        raise AssertionError(f"[shard] B8 on the padded [{W}, {n_raw}] raw plane differs")
    del t, p, v, gr, t1, v1, g1, t8, d, want_t, want_v
    # B4-B7 timed (CUDA events) on the shard rows and, beside them, on the
    # same memory viewed as the whole [8, n_pad] rows. No device time here:
    # this late in the script torch.profiler has seen 6-20 of 20 launches
    # and durations below the bound; `profile_sim --shard` gives it.
    shapes = {"rows": (rows, res, seeds, size),
              "whole": (x, r, codec_seeds(3, torch.arange(W, device=dev)), n_pad)}
    times = {}
    for form, (xx, rr, ss, nn) in shapes.items():
        v8, sc = ck.q8_encode(xx, ss, block=block)
        vals, idx, _ = ck.topk_encode(xx, rr, k=k, block=block)
        calls = {"q8_encode": lambda: ck.q8_encode(xx, ss, block=block),
                 "q8_decode": lambda: ck.q8_decode(v8, sc, nn, block=block),
                 "topk_encode": lambda: ck.topk_encode(xx, rr, k=k, block=block),
                 "topk_decode": lambda: ck.topk_decode(vals, idx, nn, k=k, block=block)}
        for kname, fn in calls.items():
            times.setdefault(kname, {})[form] = dict(ms=time_launches(torch, fn))
        del v8, sc, vals, idx
    log(f"[shard] B4-B7 on the [{W * S}, {size}] shard rows (seeds w*S+s, padding columns "
        f"zero) byte-equal to their plain versions; B1 on the padded [{W}, {n_pad}] plane, B2 "
        f"on a padded [1, {n_pad}] dist row and B8 on the padded [{W}, {n_raw}] raw plane "
        f"byte-equal; CUDA-event ms, shard rows [{W * S}, {size}] | the same memory as "
        f"[{W}, {n_pad}]: "
        + ", ".join(f"{kn} {t['rows']['ms']:.4f} | {t['whole']['ms']:.4f}"
                    for kn, t in times.items()))
    del x, r, rows, res
    return err, times


def make_shard_trainer(torch, W, dev, codec=None, method="elastic_gossip", p=0.5, shard=None,
                       obs=None, engine="sim", hetero=None, fleet=None, faults=None):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(prm, x, y):
        return simple.xent_loss(simple.mlp_logits(prm, x), y)

    return GossipTrainer(
        engine=engine, hetero=hetero, fleet=fleet, faults=faults, shard=shard, obs=obs,
        protocol=ProtocolConfig(method=method, moving_rate=0.5, comm_probability=p,
                                topology="uniform", robust_clip=0.1),
        optimizer=OptimizerConfig(name="nag", learning_rate=1e-3, momentum=0.99),
        loss_fn=loss_fn, num_workers=W, device=dev, codec=codec,
        init_fn=lambda gen: simple.init_mlp(gen, **FULL)[0])


def run_steps(torch, trainer, state, batches, n):
    """n synchronised steps; returns (state, [ms], [gate drawn (numpy)])."""
    ms, gates = [], []
    for i in range(n):
        xb, yb = batches[i % len(batches)]
        t0 = time.perf_counter()
        state, _ = trainer.step(state, (xb, yb))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        gates.append(trainer.sim.last_draws[0].cpu().numpy())
    return state, ms, gates


def states_bit_equal(torch, a, b, fields=("comm_rounds", "comm_units", "comm_bytes")):
    pairs = [("theta", a.theta["float32"], b.theta["float32"]),
             ("velocity", a.opt.mu["float32"], b.opt.mu["float32"]),
             ("generator", a.key.get_state(), b.key.get_state())]
    pairs += [(f, getattr(a.proto, f), getattr(b.proto, f)) for f in fields
              if getattr(a.proto, f) is not None]
    return [name for name, x, y in pairs if not bits_equal(torch, x, y)]


def shard_sim_runs(torch, train, dev, W=8, batch=16):
    """(a) The sim engine at W=8, batch 16, p 0.5 on the sharded plane, S=4:
    raw, q8 and top-k for 50 steps, clipped_gossip raw for 20; ShardConfig()
    bit-equal to the plain run; comm_bytes = f32(wire per device / W) *
    f32(comm_units), comm_units = the gates drawn; B1 once a step on the
    padded plane, B4/B5 or B6/B7 once a step on the [32, 728576] shard rows,
    B8 once a step in the clipped run. Returns ({kernel: launches},
    {tag: median step ms})."""
    import numpy as np
    from repro_torch.common.config import ShardConfig
    from repro_torch.kernels import ops
    batches = staged_batches(torch, train, W, batch, SHARD_STEPS, dev)
    plain = make_shard_trainer(torch, W, dev)
    inert = make_shard_trainer(torch, W, dev, shard=ShardConfig())
    s0, s1 = plain.init_state(0), inert.init_state(0)
    s0, ms_plain, _ = run_steps(torch, plain, s0, batches, SHARD_STEPS)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    s1, ms_inert, _ = run_steps(torch, inert, s1, batches, SHARD_STEPS)
    launches = ops.launch_counts()
    window_launches("shard ShardConfig()", launches, {B1: SHARD_STEPS})
    bad = states_bit_equal(torch, s0, s1)
    if bad or inert.sim.shard_layout is not None:
        raise AssertionError(f"[shard] ShardConfig(): {bad} differ from the plain run")
    del s0, s1
    total, ms = dict(launches), {"plain": statistics.median(ms_plain[1:])}
    for tag, method, codec, steps in (("raw", "elastic_gossip", None, SHARD_STEPS),
                                      ("q8", "elastic_gossip", "q8", SHARD_STEPS),
                                      ("topk", "elastic_gossip", "topk", SHARD_STEPS),
                                      ("clipped", "clipped_gossip", None, 20)):
        tr = make_shard_trainer(torch, W, dev, codec=codec, method=method,
                                shard=ShardConfig(n_shards=SHARD_S))
        st = tr.init_state(0)
        torch.cuda.synchronize()
        ops.zero_launch_counts()
        st, step_ms, gates = run_steps(torch, tr, st, batches, steps)
        got = ops.launch_counts()
        want = {B1: steps, **{k: steps for k in CODEC_KERNELS.get(codec, ())}}
        if method == "clipped_gossip":
            want[B8] = steps
        window_launches(f"shard {tag}", got, want)
        layout = tr.sim.shard_layout
        if layout.totals["float32"] != PADDED_S4[codec] or \
                st.theta["float32"].shape[1] != PADDED_S4[codec]:
            raise AssertionError(f"[shard] {tag}: padded total {layout.totals}")
        wire = tr._backend.wire_bytes()
        if wire != WIRE_S4[codec]:
            raise AssertionError(f"[shard] {tag}: wire per device {wire}, expected "
                                 f"{WIRE_S4[codec]}")
        units, gates_n = int(st.proto.comm_units), int(np.sum(gates))
        if units != gates_n:
            raise AssertionError(f"[shard] {tag}: comm_units {units} != gates {gates_n}")
        want_bytes = (torch.tensor(tr.sim._wire_bytes(st.spec) / W, dtype=torch.float32)
                      * torch.tensor(float(units), dtype=torch.float32))
        if not bits_equal(torch, st.proto.comm_bytes.cpu(), want_bytes):
            raise AssertionError(f"[shard] {tag}: comm_bytes {float(st.proto.comm_bytes)!r} != "
                                 f"{float(want_bytes)!r}")
        if not bool(torch.isfinite(st.theta["float32"]).all()) or \
                not bool((st.theta["float32"][:, N_FULL:] == 0).all()):
            raise AssertionError(f"[shard] {tag}: non-finite theta or a written padding column")
        ms[tag] = statistics.median(step_ms[1:])
        for kname, n in got.items():
            total[kname] = total.get(kname, 0) + n
        log(f"[shard] (a) sim W={W} S={SHARD_S} {tag}, {steps} steps at p 0.5: padded total "
            f"{layout.totals['float32']} ({layout.shard_sizes['float32']} a shard), wire "
            f"{wire} B per exchange and device, comm_units {units} = gates, comm_bytes "
            f"{float(st.proto.comm_bytes)!r} = f32(wire/W) * f32(units); launches {got}; median "
            f"step {ms[tag]:.3f} ms (synchronised; plain run {ms['plain']:.3f} ms, "
            f"ShardConfig() bit-equal to it)")
        del st, tr
    return total, ms


def shard_partition(torch, train, dev, W=8, batch=16, P=4, steps=20):
    """(b) partition=4 with S=4, q8, 20 steps: chunk_units equal the host's
    count from the gates and partition_ids_np; comm_bytes the plan's chunk
    wires over S."""
    import numpy as np
    from repro_torch.common.config import FleetConfig, ShardConfig
    from repro_torch.fleet.partition import partition_ids_np
    from repro_torch.kernels import ops
    fleet = FleetConfig(partition=P, seed=11)
    tr = make_shard_trainer(torch, W, dev, codec="q8", fleet=fleet,
                            shard=ShardConfig(n_shards=SHARD_S))
    st = tr.init_state(0)
    batches = staged_batches(torch, train, W, batch, steps, dev)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    st, step_ms, gates = run_steps(torch, tr, st, batches, steps)
    got = ops.launch_counts()
    window_launches("shard partition", got, {B1: steps, "q8_encode": steps, "q8_decode": steps})
    cu = np.zeros(P, np.int64)
    for i, gate in enumerate(gates):
        cu += np.bincount(partition_ids_np(fleet.seed, i, W, P)[gate], minlength=P)
    have = st.proto.chunk_units.cpu().numpy()
    if not np.array_equal(have, cu):
        raise AssertionError(f"[shard] partition: chunk_units {have} != host {cu}")
    plan = tr.sim._fleet_plan(st.spec)
    exact = float(np.dot(np.asarray(plan.wire_bytes, np.float64), cu)) / W
    if abs(float(st.proto.comm_bytes) - exact) > 1e-6 * exact:
        raise AssertionError(f"[shard] partition: comm_bytes {float(st.proto.comm_bytes)} != "
                             f"{exact}")
    log(f"[shard] (b) sim W={W} partition={P} S={SHARD_S} q8, {steps} steps: chunk_units "
        f"{have.tolist()} = host count, chunk wires per device {list(plan.wire_bytes)}, "
        f"comm_bytes {float(st.proto.comm_bytes)!r} (plan's exact {exact!r}); launches {got}; "
        f"median step {statistics.median(step_ms[1:]):.3f} ms")
    return got


def shard_async(torch, train, dev, W=8, batch=16, windows=50):
    """(c) The async engine, lognormal sigma 0.6, W=8, S=4, q8: 50 windows,
    B1 once a window, B4/B5 once a window on the shard rows, comm_units
    equal to the host's count of in-window gates."""
    from repro_torch.common.config import HeteroConfig, ShardConfig
    from repro_torch.kernels import ops
    tr = make_shard_trainer(torch, W, dev, codec="q8", p=0.125, engine="async",
                            hetero=HeteroConfig(**ASYNC_LOGNORMAL),
                            shard=ShardConfig(n_shards=SHARD_S))
    st = tr.init_state(0)
    batches = staged_batches(torch, train, W, batch, 20, dev)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    st, recs = run_windows(torch, tr, st, batches, n=windows)
    got = ops.launch_counts()
    window_launches("shard async", got, {B1: windows, "q8_encode": windows,
                                         "q8_decode": windows})
    units = int(st.proto.comm_units)
    host = int(sum((r["gate"] & r["mask"]).sum() for r in recs))
    if units != host:
        raise AssertionError(f"[shard] async: comm_units {units} != host count {host}")
    sizes = [r["size"] for r in recs]
    log(f"[shard] (c) async lognormal W={W} S={SHARD_S} q8, {windows} windows, sizes "
        f"{ {k: sizes.count(k) for k in sorted(set(sizes))} }: comm_units {units} = host count, "
        f"comm_bytes {float(st.proto.comm_bytes)!r}; launches {got}; median window "
        f"{median_ms(recs):.3f} ms (synchronised)")
    return got, median_ms(recs)


SHARD_DIST_W, SHARD_DIST_S, SHARD_DIST_STEPS = 4, 2, 20


def shard_dist(torch, train, dev, trace_dir):
    """(d) and the dist half of (e): 4 processes on this card, fsdp = S = 2,
    p 0.125, batch 16, 20 steps: q8 on the sharded plane (B1 on the firing
    steps, B2 on the others, B4/B5 once per firing step on the rank's [2,
    shard_size] rows; sends = recvs = the firing steps; comm_bytes the
    host's float64 recomputation from the per-device wire), a plain and a
    recording run (rank 0 records the fleet's events; bit-equal to the plain
    run), and one peer round on a noisy stack: each rank's decoded peer wire
    byte-equal to the sim engine's decode of the partner's shard rows,
    seeded (round, worker * S + shard). Returns ({kernel: launches},
    summary)."""
    import numpy as np
    from repro_torch import comm, shard as shard_plane
    from repro_torch.common.config import MeshConfig, ProtocolConfig, ShardConfig
    from repro_torch.common.flat import FlatSpec
    from repro_torch.core.scheduler import GossipSchedule
    from repro_torch.data.partition import batches_for_step, partition_iid
    from repro_torch.launch import dist_run
    from repro_torch.models import simple
    W, S, steps = SHARD_DIST_W, SHARD_DIST_S, SHARD_DIST_STEPS
    mesh = MeshConfig(data=W, model=1, pods=1, workers_per_pod=W)
    gen = torch.Generator(device=dev).manual_seed(DIST_SEED)
    params = {k: v.cpu().numpy() for k, v in simple.init_mlp(gen, **FULL)[0].items()}
    shards = partition_iid(train, W, 0)
    xs, ys = zip(*(batches_for_step(shards, i, DIST_BATCH) for i in range(steps)))
    x, y = np.stack(xs).astype(np.float32), np.stack(ys)
    rng = np.random.RandomState(5)
    stack = {k: (v[None] + 0.01 * rng.randn(W, *v.shape)).astype(np.float32)
             for k, v in params.items()}
    active = np.ones(W, np.float32)
    base = dict(kind="train", protocol=DIST_EG, optimizer=DIST_OPT, steps=steps, seed=DIST_SEED,
                gather=True)
    runs = [dict(base, tag="shard q8", codec="q8", shard=S),
            dict(base, tag="plain", codec=None),
            dict(base, tag="recording", codec=None, obs=dict(trace=True, metrics=True)),
            dict(kind="peer", tag="peer", protocol=DIST_EG, codec="q8", shard=S,
                 params_stack=stack, active=active, rounds=[0, 1])]
    t0 = time.perf_counter()
    ranks = dist_run.run_fleet(mesh, dev, dict(params=params, x=x, y=y, runs=runs),
                               timeout_s=180, join_timeout_s=400)
    spawn_s = time.perf_counter() - t0
    run_of = lambda rk, tag: next(r for r in rk["runs"] if r["tag"] == tag)   # noqa: E731
    sched = GossipSchedule(ProtocolConfig(**DIST_EG), W, seed=DIST_SEED + 1,
                           mesh_cfg=MeshConfig(data=W * S, model=1, pods=1, workers_per_pod=W))
    polls = [sched.poll(i) for i in range(steps)]
    fires = [bool(f) for f, _, _ in polls]
    nfire = sum(fires)
    total, want_bytes = 0.0, []
    for f, act, _ in polls:
        if f:
            total += float(WIRE_SHARD2_Q8) * float(np.sum(act) / len(act))
        want_bytes.append(total)
    want = dict.fromkeys(KERNELS, 0)
    want.update({B1: nfire, B2: steps - nfire, "q8_encode": nfire, "q8_decode": nfire})
    launches = {}
    for rank, rk in enumerate(ranks):
        r = run_of(rk, "shard q8")
        got = {k: r["launches"][k] for k in KERNELS}
        if got != want or r["fired"] != fires:
            raise AssertionError(f"[shard] dist rank {rank}: launches {got} / fired "
                                 f"{r['fired']}, expected {want} / {fires}")
        if r["sends"] != nfire or r["recvs"] != nfire:
            raise AssertionError(f"[shard] dist rank {rank}: {r['sends']} sends / "
                                 f"{r['recvs']} recvs, expected {nfire}")
        if r["wire"] != WIRE_SHARD2_Q8 or r["comm_bytes"] != want_bytes:
            raise AssertionError(f"[shard] dist rank {rank}: wire {r['wire']}, comm_bytes "
                                 f"{r['comm_bytes'][-1]!r} != host {want_bytes[-1]!r}")
        a, b = run_of(rk, "plain"), run_of(rk, "recording")
        for k in ("loss", "fired", "comm_round", "comm_active", "comm_bytes"):
            if a[k] != b[k]:
                raise AssertionError(f"[obs] dist rank {rank}: recording changed {k}")
        if ("events" in b) != (rank == 0):
            raise AssertionError(f"[obs] dist: rank {rank} recorded: {'events' in b}")
        for tag in ("shard q8", "plain", "recording"):
            for k, n in run_of(rk, tag)["launches"].items():
                launches[k] = launches.get(k, 0) + n
    r0 = run_of(ranks[0], "shard q8")
    if not all(np.isfinite(r0["loss"])):
        raise AssertionError("[shard] dist: non-finite loss")
    a, b = run_of(ranks[0], "plain"), run_of(ranks[0], "recording")
    for k in ("theta", "velocity"):
        if a[k]["float32"].tobytes() != b[k]["float32"].tobytes():
            raise AssertionError(f"[obs] dist: the recording run's {k} differs")
    # the peer round: each rank's decoded wire against the sim engine's
    spec = FlatSpec.build({k: torch.as_tensor(v) for k, v in stack.items()}, leading=1)
    cd = comm.active_codec(ProtocolConfig(codec="q8"))
    layout = shard_plane.build_layout(spec, ShardConfig(n_shards=S), cd)
    bufs = shard_plane.pad_bufs({k: v.to(dev) for k, v in spec.flatten(
        {k: torch.as_tensor(v) for k, v in stack.items()}).items()}, layout)
    for i, rnd in enumerate((0, 1)):
        hat, _ = comm.roundtrip_bufs(cd, layout.shard_rows(bufs),
                                     comm.codec_seeds(rnd, torch.arange(W * S, device=dev)))
        hat = layout.unshard_rows(hat)["float32"].cpu().numpy()
        partners = sched.partners(rnd)
        for rank, rk in enumerate(ranks):
            peer = run_of(rk, "peer")["rounds"][i]["float32"]
            if peer.tobytes() != hat[partners[rank]:partners[rank] + 1].tobytes():
                raise AssertionError(f"[shard] dist rank {rank} round {rnd}: the decoded peer "
                                     f"wire differs from the sim engine's")
    rec = run_of(ranks[0], "recording")
    from repro_torch.obs import TraceRecorder, report, schema
    tr = TraceRecorder()
    tr.events = rec["events"]
    errs = schema.validate_trace(tr.perfetto(num_workers=W))
    ex = [e for e in rec["events"] if e["ev"] == "exchange"]
    if errs or len(ex) != sum(rec["comm_active"]) or \
            report.totals(rec["rows"])["comm_bytes"] != rec["comm_bytes"][-1]:
        raise AssertionError(f"[obs] dist: trace {errs[:3]}, {len(ex)} exchange events for "
                             f"{sum(rec['comm_active'])} initiations, totals "
                             f"{report.totals(rec['rows'])}")
    path = os.path.join(trace_dir, "dist_trace.json")
    with open(path, "w") as fh:
        json.dump(tr.perfetto(num_workers=W), fh)
    fire_ms = [ms for ms, f in zip(r0["step_ms"], fires) if f]
    quiet_ms = [ms for ms, f in zip(r0["step_ms"], fires) if not f]
    med = (lambda xs: statistics.median(xs) if xs else float("nan"))   # noqa: E731
    plain_fire = med([ms for ms, f in zip(a["step_ms"], fires) if f])
    log(f"[shard] (d) dist W={W} processes on one card, fsdp = S = {S}, q8, {steps} steps "
        f"(spawned and joined in {spawn_s:.1f} s): {nfire} firing steps = host schedule, "
        f"launches per rank {want}, sends = recvs = {nfire}, wire {WIRE_SHARD2_Q8} B per "
        f"device, comm_bytes {r0['comm_bytes'][-1]!r} = host recomputation; every rank's "
        f"decoded peer wire byte-equal to the sim engine's shard rows (2 rounds); rank 0 "
        f"median synchronised step: firing {med(fire_ms):.3f} ms, non-firing "
        f"{med(quiet_ms):.3f} ms (plain raw run firing {plain_fire:.3f} ms)")
    log(f"[obs] (e) dist W={W} recording: bit-equal to the plain run on every rank, rank 0 "
        f"alone records: {len(rec['events'])} events ({len(ex)} exchanges = initiations), "
        f"trace valid, report comm_bytes {report.totals(rec['rows'])['comm_bytes']!r} = host "
        f"account; trace at {path}")
    return launches, dict(fire_ms=med(fire_ms), quiet_ms=med(quiet_ms), plain_fire_ms=plain_fire)


# S = 2 of the 4-worker dist run: 2,914,304 / 2 = 1,457,152 columns = 2,846
# blocks of 512 + 4 B
WIRE_SHARD2_Q8 = 2846 * 516


def obs_runs(torch, train, dev, trace_dir, W=8, batch=16):
    """(e) Recording runs (ObsConfig with trace and metrics paths) on the sim
    engine (50 steps) and the async engine (lognormal, drop 0.2, token
    account; 50 windows), each against the same run without recording:
    theta, velocity, counters and the generator bit-equal; the trace valid;
    the report's totals equal to the accumulators. The sim step's recording
    overhead: median of the same 50 steps with and without, run in turns."""
    from repro_torch.common.config import FaultConfig, FleetConfig, HeteroConfig, ObsConfig
    from repro_torch.obs import report, schema
    batches = staged_batches(torch, train, W, batch, SHARD_STEPS, dev)
    out = {}
    for tag, kw in (("sim", {}),
                    ("async", dict(engine="async", p=0.5, hetero=HeteroConfig(**ASYNC_LOGNORMAL),
                                   method="clipped_gossip",
                                   faults=FaultConfig(fault_model="drop", fault_rate=0.2, seed=5),
                                   fleet=FleetConfig(flow_control="token_account",
                                                     token_capacity=2.0, token_rate=0.5)))):
        paths = {k: os.path.join(trace_dir, f"{tag}.{k}") for k in ("json", "jsonl")}
        plain = make_shard_trainer(torch, W, dev, **kw)
        rec = make_shard_trainer(torch, W, dev, obs=ObsConfig(trace_path=paths["json"],
                                                              metrics_path=paths["jsonl"]), **kw)
        trainers = (plain, rec)
        states = [tr.init_state(0) for tr in trainers]
        ms0, ms1 = [], []
        for i in range(SHARD_STEPS):             # in turns: plain, recording
            for j, (tr, st_ms) in enumerate(zip(trainers, (ms0, ms1))):
                t0 = time.perf_counter()
                states[j], _ = tr.step(states[j], batches[i])
                torch.cuda.synchronize()
                st_ms.append((time.perf_counter() - t0) * 1e3)
        s0, s1 = states
        fields = ("comm_rounds", "comm_units", "comm_bytes", "stale_time", "wire_dropped",
                  "flow_skipped", "tokens")
        bad = states_bit_equal(torch, s0, s1, fields)
        if bad:
            raise AssertionError(f"[obs] {tag}: the recording run's {bad} differ")
        written = rec.export_obs()
        with open(paths["json"]) as fh:
            doc = json.load(fh)
        errs = schema.validate_trace(doc)
        tot = report.totals(report.load_jsonl(paths["jsonl"]))
        want = {f: float(getattr(s1.proto, f)) for f in fields[:-1]
                if getattr(s1.proto, f) is not None}
        if errs or any(tot.get(f) != v for f, v in want.items()):
            raise AssertionError(f"[obs] {tag}: trace {errs[:3]}, totals {tot} != {want}")
        kinds = {}
        for e in doc["reproEvents"]:
            kinds[e["ev"]] = kinds.get(e["ev"], 0) + 1
        m0, m1 = statistics.median(ms0[1:]), statistics.median(ms1[1:])
        out[tag] = dict(plain_ms=m0, recording_ms=m1, overhead=m1 / m0 - 1.0)
        log(f"[obs] (e) {tag} W={W} recording, {SHARD_STEPS} "
            f"{'windows' if tag == 'async' else 'steps'}: bit-equal to the plain run "
            f"(theta, velocity, counters, generator), trace valid ({kinds}), report totals = "
            f"accumulators {want}; median step plain {m0:.3f} ms, recording {m1:.3f} ms "
            f"(overhead {m1 / m0 - 1.0:+.1%}, same steps in turns); wrote {sorted(written)}")
        del s0, s1, states, plain, rec, trainers
    return out


def shard_memory(torch, dev):
    """(f) validate_fleet_memory at S in {1, 4} for the device plane at W=8,
    1024 and 4096 against the card's free memory: the whole plane is held
    on the one card, the per-device figure printed beside it."""
    from repro_torch.fleet import memory
    free = torch.cuda.mem_get_info(dev)[0]
    lines = []
    for Wk in (8, 1024, 4096):
        for S in (1, SHARD_S):
            per = memory.plane_bytes(Wk, WIRE[None], "device", S)
            try:
                need = memory.validate_fleet_memory(Wk, WIRE[None], "device", what="the MLP",
                                                    device=dev, n_shards=S)
                verdict = f"fits, holds {need / 2 ** 30:.2f} GiB"
            except ValueError as e:
                verdict = f"refuses ({str(e).split('; ')[-1][:60]}...)"
            lines.append(f"W={Wk} S={S}: per device {per / 2 ** 30:.2f} GiB, {verdict}")
    log(f"[shard] (f) validate_fleet_memory, device plane, card free "
        f"{free / 2 ** 30:.2f} GiB: " + "; ".join(lines))


def run_shard_phase(torch, ck, ref, fu, rb, codec_seeds, dev, bw, peak):
    """Phase 9. Returns ({kernel: launches}, {kernel: max abs err},
    summary)."""
    from repro_torch.data.synthetic import load_mnist
    train, _ = load_mnist(num_train=25600, num_test=10)
    trace_dir = os.path.join(HERE, "build", "chip_smoke_obs")
    os.makedirs(trace_dir, exist_ok=True)
    err, times = check_shard_kernels(torch, ck, ref, fu, rb, codec_seeds, dev, bw, peak)
    launches = {}

    def add(got):
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    got, sim_ms = shard_sim_runs(torch, train, dev)
    add(got)
    add(shard_partition(torch, train, dev))
    got, async_ms = shard_async(torch, train, dev)
    add(got)
    got, dist_ms = shard_dist(torch, train, dev, trace_dir)
    add(got)
    obs = obs_runs(torch, train, dev, trace_dir)
    shard_memory(torch, dev)
    return launches, err, dict(shard_row_ms=times, sim_ms=sim_ms, async_ms=async_ms,
                               dist=dist_ms, obs=obs)


# kernel -> (id, source, TPU kernel it replaces)
KERNELS = {
    B1: ("B1", "src/repro_torch/kernels/csrc/fused_update.cu",
         "src/repro/kernels/fused_update.py:87"),
    B2: ("B2", "src/repro_torch/kernels/csrc/fused_update.cu",
         "src/repro/kernels/fused_update.py:100"),
    B3: ("B3", "src/repro_torch/kernels/csrc/fused_update.cu",
         "src/repro/kernels/fused_update.py:36"),
    "q8_encode": ("B4", "src/repro_torch/kernels/csrc/codec.cu", "src/repro/kernels/codec.py:44"),
    "q8_decode": ("B5", "src/repro_torch/kernels/csrc/codec.cu", "src/repro/kernels/codec.py:59"),
    "topk_encode": ("B6", "src/repro_torch/kernels/csrc/codec.cu",
                    "src/repro/kernels/codec.py:106"),
    "topk_decode": ("B7", "src/repro_torch/kernels/csrc/codec.cu",
                    "src/repro/kernels/codec.py:131"),
    B8: ("B8", "src/repro_torch/kernels/csrc/robust.cu", "src/repro/kernels/robust.py:30"),
    B9: ("B9", "src/repro_torch/kernels/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:28"),
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.comm import codec_seeds
    from repro_torch.data.synthetic import load_mnist
    from repro_torch.kernels import build
    from repro_torch.kernels import codec as ck
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    from repro_torch.kernels import robust as rb

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(smi)
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda}, device {kind}; "
        "TF32 off for matmul and cuDNN")
    bw, peak, peak_bf16 = card_rates(kind)
    t0 = time.perf_counter()
    sources = ("fused_update", "codec", "robust", "flash_attention")
    with ThreadPoolExecutor(len(sources)) as ex:      # one nvcc per source, together
        list(ex.map(build.build, sources))
    for name in sources:
        build.load(name)
    log(f"[build] fused_update.cu (B1-B3), codec.cu (B4-B7), robust.cu (B8) and "
        f"flash_attention.cu (B9) in parallel: "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {build.BUILD_SECONDS.get(n, 0.0):.2f} s" for n in sources) + ")")
    phase_s = {"1 build": time.perf_counter() - t0}
    t_phase = time.perf_counter()

    err = {B1: max(check_b1(torch, fu, ref, dev), check_b1_rows(torch, fu, ref, dev)),
           B2: check_b2(torch, fu, ref, dev), B3: check_b3(torch, fu, ref, dev)}
    err.update(check_codec(torch, ck, ref, codec_seeds, dev))
    err[B8] = max(check_b8(torch, rb, ref, dev), check_b8_strided(torch, rb, ref, dev))
    ms8, plain8, bound8, by8 = time_b1(torch, fu, ref, dev, 8, bw, peak)
    ms4, plain4, bound4, _ = time_b1(torch, fu, ref, dev, 4, bw, peak)
    rows = time_b1_rows(torch, fu, ref, dev, bw, peak)
    times = {B1: dict(ms=ms8, plain_ms=plain8, library_ms=None, bound_ms=bound8, bound_by=by8,
                      ms_w4=ms4, plain_ms_w4=plain4, bound_ms_w4=bound4,
                      rows_of_8={k: dict(ms=a, device_ms=d, plain_ms=b, bound_ms=c)
                                 for k, (a, d, b, c) in rows.items()})}
    t23 = {W: time_b2_b3(torch, fu, ref, dev, W, bw, peak) for W in (8, 4)}
    for kname in (B2, B3):
        times[kname] = dict(t23[8][kname], ms_w4=t23[4][kname]["ms"],
                            plain_ms_w4=t23[4][kname]["plain_ms"],
                            bound_ms_w4=t23[4][kname]["bound_ms"])
    times.update(time_codec(torch, ck, ref, codec_seeds, dev, bw, peak))
    times[B8] = time_b8(torch, rb, ref, dev, bw, peak)
    times[B8]["chunks"] = {P: dict(strided_ms=a, strided_device_ms=b, copy_ms=c,
                                   copy_device_ms=d, bound_ms=e)
                           for P, (a, b, c, d, e) in time_b8_strided(torch, rb, dev, bw,
                                                                     peak).items()}
    wire_ms = time_wire(torch, dev)
    phase_s["2 kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    train, test = load_mnist(num_train=25600, num_test=4000)
    launches = dict.fromkeys(KERNELS, 0)
    step_ms = {}
    for W, batch, codec in ((8, 16, None), (4, 32, None), (8, 16, "q8"), (8, 16, "topk")):
        got, step_ms[(W, codec)] = run_main_path(torch, train, test, W, batch, dev, codec)
        for kname, n in got.items():
            launches[kname] += n
    log("[main] median synchronised step at W=8, batch 16: "
        + ", ".join(f"{c or 'uncompressed'} {step_ms[(8, c)]:.3f} ms"
                    for c in (None, "q8", "topk")))
    fused_vs_unfused(torch, train, dev)
    fused_vs_unfused(torch, train, dev, codec="q8")
    phase_s["3 main"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    register_drop_byzantine()
    fault_ms = {}
    for tag, method, fkw, codec in FAULT_RUNS:
        got, fault_ms[tag] = run_fault_path(torch, train, dev, tag, method, fkw, codec)
        for kname, n in got.items():
            launches[kname] += n
    log("[faults] median synchronised step at W=8, batch 16, p 0.5: "
        + ", ".join(f"{t} {ms:.3f} ms" for t, ms in fault_ms.items())
        + f"; checksummed raw wire round trip {wire_ms['roundtrip_ms']:.4f} ms")
    zero_fault_anchor(torch, train, dev)
    phase_s["4 faults"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    dist_launches, dist_ms = run_dist_phase(torch, train, dev)
    for kname, n in dist_launches.items():
        launches[kname] += n
    e, q = dist_ms["elastic"], dist_ms["elastic q8"]
    log(f"[dist] rank 0's median synchronised step at W={DIST_W}, batch {DIST_BATCH}: elastic "
        f"firing {e['fire_ms']:.3f} ms / non-firing {e['quiet_ms']:.3f} ms, q8 firing "
        f"{q['fire_ms']:.3f} / non-firing {q['quiet_ms']:.3f} ms, allreduce "
        f"{dist_ms['allreduce']['quiet_ms']:.3f} ms")
    phase_s["5 dist"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    n_serve, times[B9] = run_serve_phase(torch, ops, fa, dev, bw, peak_bf16)
    launches[B9] += n_serve
    err[B9] = times[B9].pop("max_abs_err")
    phase_s["6 serve"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    paper_launches, paper = run_paper_phase(torch, dev)
    for kname, n in paper_launches.items():
        launches[kname] += n
    log(f"[paper] summary: {json.dumps(paper)}")
    phase_s["7 paper"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    async_launches, async_summary = run_async_phase(torch, dev)
    for kname, n in async_launches.items():
        launches[kname] += n
    log(f"[async] summary: {json.dumps(async_summary)}")
    phase_s["8 async"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    shard_launches, shard_err, shard_summary = run_shard_phase(torch, ck, ref, fu, rb,
                                                               codec_seeds, dev, bw, peak)
    for kname, n in shard_launches.items():
        launches[kname] += n
    for kname, e in shard_err.items():
        err[kname] = max(err[kname], e)
    for kname, t in shard_summary["shard_row_ms"].items():
        times[kname]["shard_rows_of_32"] = t
    log(f"[shard] launches in phase 9: {shard_launches}; summary ({smi}): "
        f"{json.dumps(shard_summary)}")
    phase_s["9 shard+obs"] = time.perf_counter() - t_phase
    log("[phases] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; total {sum(phase_s.values()):.1f}")

    kernels = []
    for kname, (kid, source, replaces) in KERNELS.items():
        kernels.append({"name": kname, "id": kid, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": err[kname], "shape": [8, N_FULL], **times[kname],
                        "card": smi})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
