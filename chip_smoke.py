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
             in a decode and a prefill suffix; each of B9's four forms
             (wgmma, mma, split, simt) must have run. B9, its plain version
             and SDPA timed at the prefill ([8, 512, 32, 64] causal, the
             wgmma form) and decode ([8, 1, 32, 64] over the cache at pos
             512, the split form) shapes in bf16, with CUDA events back to
             back and, for B9 and SDPA, their device time alone under
             torch.profiler; then the wgmma form at every model's bf16
             prefill shape (WGMMA_TIMED: TinyLlama, MusicGen, Llama-3.2-V
             self and cross, Zamba2, Gemma2-9B, Granite-20B's prefill and
             decode), each held to its plain version first, its device time
             beside roofline.b9_cost's bound and SDPA's (the backend named).
             Then TinyLlama-1.1B at full width (22 layers,
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
             card's free memory.
10. lm     — training TinyLlama-1.1B through the reference's CLI
             (``repro_torch.launch.train.run``): validate_fleet_memory on
             abstract_lm's bytes admits W=2 and refuses W=4 at full width
             before anything is allocated; the longest sequence of
             {256, 128, 64} whose planes and estimated activations fit is
             taken; 10 sim steps at full width (22 layers, d 2048, f32,
             random weights from seed 0, each layer rematerialised: the
             config's default remat=True), W=2, global batch 8, p 0.5, NAG
             lr 1e-2: the loss finite and falling, B1 launched 10 times and
             B9 never (training attention is the differentiable online
             softmax), comm_units equal to the gates and comm_bytes its f32
             derivation, the step times and max_memory_allocated; one more
             step with B1's inputs copied to the host, the step's theta and
             velocity byte-equal to the plain version in 16 column chunks,
             and B1 timed at [2, 1100048384] beside its bound; the trained
             consensus served in f32 (a prefill and 4 decode steps: B9 22
             times in the simt form and 88 in the split form); the
             full-width LM gradient at 2 layers in f32 against f64 on the
             card (at most 10% of the elements outside rtol 1e-4 / atol
             1e-6, each leaf within 1e-2 rel L2); then through the CLI at
             --reduced: dist with 4 processes (B1 / B2 per rank, sends and
             receives, comm_bytes against the host's replay of the
             schedule), async lognormal (B1 once a window) and q8 on sim.
11. serve-live — training TinyLlama-1.1B while serving it, through the
             reference's train-while-serve CLI (``repro_torch.launch.serve``,
             ``build`` then ``run``): W=4 refused by its memory plan before
             anything is allocated; at full width (f32, random weights from
             seed 0), sim W=2, seq 32 x 2 a worker, p 0.25, alpha 0.5, NAG
             lr 0.01, publish every 5 steps, 4 slots, max_len 256, a poisson
             stream (rate 0.3, 24 requests), 120 decode boundaries of one
             training step each: B1 once a step and B9 never in one, B9 22
             times a boundary in the split form (prompts stream through
             decode), bus_seq = steps // 5, swaps >= 1 and none refused,
             staleness <= 5 steps, the largest swap pause below the mean
             decode boundary (both synchronised), the batcher's invariants;
             then one decode step on the last served snapshot through B9
             and through the plain version on copies of the live cache
             (logits within 1e-3 of the largest, greedy tokens equal), peak
             memory, the boundary interval, tokens/s and the seconds.
12. mla    — DeepSeek-V2-Lite-16B served at its published widths and full
             depth (27 layers, d 2048, 16 heads, MLA 512 + 64, 64 experts
             top-6 + 2 shared at 1408, vocab 102400, bf16, random weights
             from seed 0): B9 at MLA's shapes (576-wide keys, 512-wide
             latent values, as the keys' prefix view and as a tensor of
             their own; decode at 0, 511, 1023 and with a kv_start, prefill
             8 x 512, 77 rows and a q_offset suffix, each in its form: bf16
             over the prefix view in the mma form's MLA kernel, else simt)
             against its plain version in f32 and bf16, NaN below kv_start
             invisible, its time beside the bound, the plain version and
             SDPA (the prefill also device alone); serve_decode at 8 slots,
             prompt 512, max_len 1024, 64 greedy steps, bf16 weights and no
             mid-stream swap by its memory plan (B9 27 times in the prefill,
             mma, and 27 a step, split), with the prefill and step times,
             tokens/s and peak memory; a ContinuousBatcher drain of 16
             requests (every one completed, the invariants); and at 2 layers
             (1 dense + 1 MoE, full widths: depth is cut, widths are not)
             the f32 gate (a prefill and 8 decode steps through B9 and the
             plain version, logits within 1e-3 of the largest, greedy
             tokens equal) and one hot swap.
13. moe    — training DeepSeek-V2-Lite-16B (MLA + MoE) at its published
             widths, depth cut to 2 layers (1 dense + 1 MoE: 1,085,287,424
             f32 parameters), through ``launch.train.run`` with phase 10's
             arguments (W=2, global batch 8, seq 256, 10 steps): the step's
             memory plan beside max_memory_allocated, B1 10 times and B9
             never, the loss finite and falling, comm_units = gates, the
             dispatch's capacity (C = 120) with tokens dropped, B1 on one
             more step's own inputs byte for byte in 16 column chunks and
             timed; the card's f32 gradient against the CPU's f64 one at the
             card's parameters (1 x 64 tokens; the f64 run takes the card's
             top-k sets and the tokens whose f64 sets differ are counted);
             then train-while-serve through ``launch.serve`` at the same
             depth with phase 11's arguments for 48 boundaries (B1 once a
             step, B9 2 a boundary in the split form, the bus, staleness,
             swap pauses, the batcher's invariants, the last snapshot's
             decode and a [4, 256] f32 prefill (simt, hd 576) through B9
             within 1e-3 of the plain version, greedy tokens equal); then the
             reduced DeepSeek and Grok-1 through the CLI on dist (2 gloo
             processes on the card), async lognormal and q8 on sim.
14. ssm    — serving xLSTM-125M (12 layers, 10 mLSTM + 2 sLSTM) and
             Zamba2-2.7B (54 Mamba2 layers, 8 shared attention sites of 32
             heads of 80) at their published widths and full depth in bf16,
             random weights from seed 0: B9 at head dim 80 against its plain
             version in f32 and bf16 (decode, split; prefill, wgmma in bf16
             and simt in f32; NaN and inf below kv_start invisible), its time
             beside the bound, the plain version and SDPA (the prefill also
             device alone); per model
             serve_decode at 8 slots, prompt 512, max_len 1024, 64 greedy
             steps and a hot swap (B9 once per shared site in the prefill
             and in every step: 8 for Zamba2, none for xLSTM), a 16-request
             batcher drain, and the f32 gate through B9 and the plain
             version (xLSTM at its 12 layers, Zamba2 cut to 13 layers: two
             shared sites).
15. ssm-train — training SSM and hybrid models through ``launch.train.run``
             with phase 10's arguments but W: xLSTM-125M whole (12 layers,
             d 768, f32) at the paper's W=4, global batch 16, and Zamba2-2.7B
             at its widths cut to 18 of 54 layers (3 Mamba2 segments of 6,
             2 shared sites) at W=2, global batch 8; the sequence phase
             10's way (the longest of 256, 128, 64 whose step plan fits:
             256 for both with remat), 10 sim steps each: B1 10 times and
             B9 never, the loss finite and falling, comm_units = gates,
             max_memory_allocated within 0.9-1.2 of the step's memory plan
             (launch.train.step_bytes, by cfg.remat), the step
             times and tokens/s, B1 on one more step's own inputs byte for
             byte over the whole [W, N] plane and timed; the card's f32
             gradient against the CPU's f64 one at the widths (xLSTM at 2
             layers and at 6 with its first sLSTM, Zamba2 at 7 with its
             first shared site; 1 x 64 tokens); then train-while-serve
             through ``launch.serve`` at the same depth with phase 11's
             arguments for 48 boundaries (B9 never for xLSTM, twice a
             boundary for Zamba2's two sites).
16. cross   — Llama-3.2-Vision-11B (40 layers + 8 cross blocks over 1601
             image tokens) and MusicGen-large (48 layers, each with a
             cross-attention to 64 conditioning tokens, 4 codebooks) at
             full width and depth in bf16, random weights from seed 0 with
             every cross gate at 0.5 (zero at init) and a random cond: B9 at
             their self- and cross-attention shapes (prefill 8 x 512,
             non-causal over 1601 keys with a partial last tile and over
             64; decode at position 512 and over the cond) against its
             plain version in f32 and bf16, timed beside the bound, the
             plain version and SDPA; serve_decode (8 slots, prompt 512,
             64 greedy steps, per codebook for MusicGen; B9 48 times a step
             for vision, 96 for MusicGen, wgmma in the prefill, split in
             decode); the f32 gate through B9 and the plain version (vision
             at 4 layers with its first cross block, MusicGen at 2); then
             MusicGen trained at its widths cut to 15 of 48 layers
             (1,040,281,615 f32 parameters, TinyLlama's plane) as phase
             15's runs; vision's training plan at its widths logged (4
             layers + 1 cross block: step_memory refuses it) and the
             reduced vision model trained on sim.
17. accum+tp — (a) TinyLlama-1.1B whole in f32 on the dist engine at
             W = 2 ranks, with remat=False (a rematerialised step keeps too
             little for A = 2 to lower the peak): the largest per-worker
             batch whose step plan
             fits (seq 256), 3 steps at grad_accum 1 and then 2 in the
             same ranks, step 1's loss and theta at A = 2 within rtol 1e-4
             / atol 1e-5 of A = 1 and each rank's peak at A = 2 below A =
             1's, B1 / B2 once a step; (b) the reduced TinyLlama in the
             reference's model = 2 test's configuration (data=4, model=2,
             4 ranks), 24 elastic steps bit-equal to model = 1; (c) B9 at
             the ranks' local shapes of TinyLlama at M = 2 and 4 against
             its plain version and timed beside SDPA, then tensor-parallel
             serving of TinyLlama-1.1B whole in bf16 (8 x 512 prompts, 64
             greedy steps; 16 at M = 4) at M = 1 (this process), 2 and 4 ranks on the
             card: prefill and decode-step ms, the collectives' host ms a
             step, each rank's peak, the logit gap to M = 1 and the share of
             greedy tokens equal; B9 exactly M x layers x (1 + steps)
             times and the collectives of every step exact; the gate in
             f32 at 4 layers (every step's logits within 1e-5 of the
             largest of M = 1, every greedy token equal); (d) reduced
             Gemma2 in f32 at M = 4 (kv heads kept whole, softcaps, local
             windows) against M = 1 within the same gate.
18. tp-kinds — tensor-parallel serving of the other kinds: B9 at each
             rank's heads at M = 2, at the shapes of the bf16 runs below
             (MLA 8 heads of 576 over 512-wide values, Zamba2 16 of 80,
             vision 16 over 4 kv heads, self-attention and over 1601 image
             tokens; prefill and decode) against its plain version in f32
             and bf16 and timed beside SDPA; then, over 2
             ranks (one spawned group), DeepSeek-V2-Lite-16B whole in bf16
             (8 x 512 prompts, 16 greedy steps), Zamba2-2.7B, xLSTM-125M and
             Llama-3.2-Vision-11B whole in bf16 (8 x 256, 8 steps), each
             rank drawing only its slice of the weights; xLSTM-125M also
             over 4 ranks. f32 gates at full width and cut depth (DeepSeek
             2 layers, Zamba2 7 with a shared site, xLSTM 6 with an sLSTM,
             MusicGen 2, vision 4 with a cross block; 8 x 128, 8 steps)
             against the one-device program: every step within 1e-5 of the
             largest logit or no farther from the f64 program than 2x M =
             1's f32 distance, every greedy token equal, DeepSeek's routing
             ids equal on every rank and to M = 1's; each gate again in f64
             (the group reducing in f64, attention in f64) within 1e-10 of
             the one-device f64 program's largest logit. Every run: B9
             exactly M x attentions x (1 + steps), the collectives of the
             prefill and of every step equal to the program's count, each
             rank's peak and the card's most used memory.
19. plan    — the planning tools against the card: chip_spec's figures
             beside the card's properties, the HBM copy rate (a 2 GiB
             device-to-device copy_) and the bf16 matmul rate at 8192^3
             (medians of 20), each at most 1.05 of its spec figure; then
             programs counted on the meta device (analysis.opcount) and run
             on the card at the same shapes: the MLP sim step at W = 8 (B1),
             TinyLlama-1.1B bf16 prefill 8 x 512 (B9 wgmma) and a decode step
             from position 512 (B9 split), DeepSeek-V2-Lite-16B bf16
             prefill at 2 layers (B9 mma), each one's roofline share (the
             counted bound over the measured median) at most 1.05 and, for
             the LM programs, max_memory_allocated within 0.75-1.33 of the
             plan's argument + temp bytes (launch.specs); then the dry-run
             sweep's serving cells on the one-pod mesh (launch.dryrun, on
             meta), fits, bottleneck and count seconds per cell.
20. remat   — rematerialisation in LM training (``cfg.remat``,
             ``common/remat.py``; every training phase above runs with it,
             the config's default, but 17 (a)): (a) TinyLlama-1.1B at full
             width in f32, phase 10's shape (W = 2, global batch 8, seq
             256, p 0.5, NAG lr 1e-2, seed 0), 3 sim steps with remat=True
             and 3 with remat=False (``dataclasses.replace`` and
             ``lm_loss_fn``) on the same draws: per-step losses equal (bit
             for bit, or within 1e-6 relative with the gap printed), both
             max_memory_allocated (the remat one lower) and both median
             step times, B1 6 times and B9 never; (b) at train_4k's 4,096
             tokens (else the longest of 2,048 / 1,024 whose remat plan
             fits): step_memory refuses remat=False with nothing
             allocated, remat=True is admitted and runs 3 sim steps, the
             loss finite, B1 3 times, B9 never, comm_units equal to the
             gates, max_memory_allocated within 0.9-1.2 of the plan, the
             step time and tokens/s.
             Every phase's seconds are printed.

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
B1, B2, B3 = "fused_flat_elastic_nag_update", "fused_flat_nag_update", "fused_elastic_nag_update"
BLOCK, TOPK = 512, 26               # the codecs' defaults: codec_block, round(0.05 * 512)
# exact wire bytes per event on the full-width plane (the reference's
# wire_param_bytes / SimTrainer._wire_bytes)
WIRE = {None: 11653160, "q8": 2936556, "topk": 1183728}
CODEC_KERNELS = {"q8": ("q8_encode", "q8_decode"), "topk": ("topk_encode", "topk_decode")}
B8 = "robust_flat_apply"
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



def log(msg):
    print(msg, flush=True)


def card_rates(name):
    """(memory bytes/s, f32 FLOP/s, bf16 dense FLOP/s) of the card named
    ``name``: ``repro_torch.common.hardware.chip_spec``'s figures."""
    from repro_torch.common.hardware import chip_spec
    spec = chip_spec(name)
    return spec.hbm_bandwidth, spec.peak_f32_flops, spec.peak_bf16_flops


def bound(cost, rate, bw):
    """(least ms, "bytes" or "operations") of a kernel's ``(flops, bytes)``
    cost (``repro_torch.analysis.roofline``) at these rates."""
    from repro_torch.analysis import roofline
    return roofline.bound_ms(*cost, rate, bw)


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


def b1_cost(W, n, t_size=4, v_size=4):
    """B1's (flops, least bytes): ``repro_torch.analysis.roofline.b1_cost``."""
    from repro_torch.analysis import roofline
    return roofline.b1_cost(W, n, t_size, v_size)


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
    cost = b1_cost(W, N_FULL)
    nbytes = cost[1]
    bound_ms, by = bound(cost, peak, bw)
    log(f"[kernels] B1 [{W}, {N_FULL}] f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved)")
    del t, p, v, g
    return ms, plain_ms, bound_ms, by


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
        bound_ms = bound(b1_cost(k, N_FULL), peak, bw)[0]
        out[k] = (ms, dev_ms, plain_ms, bound_ms)
        log(f"[kernels] B1 row list, {k} of 8 rows of [8, {N_FULL}] f32: kernel {ms:.4f} ms "
            f"(device alone {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} "
            f"ms ({tb_s(b1_cost(k, N_FULL)[1], dev_ms)} TB/s achieved on the device)")
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
    from repro_torch.analysis import roofline
    t, p, v, g, _ = b1_inputs(torch, W, N_FULL, torch.float32, torch.float32, 60 + W, dev)
    eta = torch.full((), 1e-3, device=dev)
    out = {}
    calls = {
        B2: (lambda: fu.fused_flat_nag_update(t, v, g, eta, 0.99),
             lambda: ref.fused_flat_nag_update(t, v, g, eta, 0.99),
             roofline.b2_cost(W, N_FULL)),
        B3: (lambda: fu.fused_elastic_nag_update(t, p, v, g, 0.5, eta=1e-3, mu=0.99),
             lambda: ref.fused_elastic_nag_update(t, p, v, g, 0.5, eta=1e-3, mu=0.99),
             roofline.b3_cost(W * N_FULL)),
    }
    for kname, (kern, plain, cost) in calls.items():
        ms = time_launches(torch, kern)
        plain_ms = time_launches(torch, plain)
        nbytes = cost[1]
        bound_ms, by = bound(cost, peak, bw)
        out[kname] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                          bound_by=by)
        log(f"[kernels] {KERNELS[kname][0]} [{W}, {N_FULL}] f32: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB "
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
    from repro_torch.analysis import roofline
    W, n, block, k = 8, N_FULL, BLOCK, TOPK
    nb = -(-n // block)
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
    # (operations at the f32 rate, least bytes: each input read once, each
    # output written once)
    costs = {"q8_encode": roofline.q8_encode_cost(W, n, block),
             "q8_decode": roofline.q8_decode_cost(W, n, block),
             "topk_encode": roofline.topk_encode_cost(W, n, block, k),
             "topk_decode": roofline.topk_decode_cost(W, n, block, k)}
    nbytes = {name: c[1] for name, c in costs.items()}
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
        bound_ms, by = bound(costs[kname], peak, bw)
        out[kname] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library=lib_name,
                          library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                          bound_by=by)
        share = "not measured" if dev_ms is None else f"{bound_ms / dev_ms:.0%}"
        ratio = ("not measured" if dev_ms is None or lib_dev_ms is None
                 else f"{dev_ms / lib_dev_ms:.2f}x")
        log(f"[kernels] {kname} [{W}, {n}] block {block} k {k}: kernel {ms:.4f} ms (device "
            f"alone {fmt_ms(dev_ms)} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes[kname] / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; "
            f"{tb_s(nbytes[kname], dev_ms)} TB/s achieved on the device, "
            f"{share} of the bound)"
            + (f", {lib_name} {lib_ms:.4f} ms (device {fmt_ms(lib_dev_ms)} ms; kernel "
               f"{ratio} on the device)" if lib is not None else ""))
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
    from repro_torch.analysis import roofline
    _, t, d, sc, thr = b8_cases(torch, dev)[1]
    W, n = t.shape
    ms = time_launches(torch, lambda: rb.robust_flat_apply(t, d, sc, thr))
    plain_ms = time_launches(torch, lambda: ref.robust_flat_apply(t, d, sc, thr))
    cost = roofline.b8_cost(W, n)
    nbytes = cost[1]
    bound_ms, by = bound(cost, peak, bw)
    log(f"[kernels] B8 [{W}, {n}] f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at {bw / 1e12:.2f} TB/s; "
        f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved); no single PyTorch call computes it")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=by)


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
        from repro_torch.analysis import roofline
        cost = roofline.b8_cost(8, N_FULL, chunks=P)
        nbytes = cost[1]
        bound_ms = bound(cost, peak, bw)[0]
        res[P] = (ms, dev_ms, copy_ms, copy_dev_ms, bound_ms)
        log(f"[kernels] B8 over [8, {N_FULL}] f32 in {P} column chunks: strided in place "
            f"{ms:.4f} ms (device alone {fmt_ms(dev_ms)}), contiguous copy + B8 + copy back "
            f"{copy_ms:.4f} ms (device {fmt_ms(copy_dev_ms)}), bound {bound_ms:.4f} ms "
            f"({tb_s(nbytes, dev_ms)} TB/s achieved strided on the device)")
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
CROSS_GATE = 0.5                     # the cross-attention gates, zero at init, opened


def plain_attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
                    kv_len=None, kv_start=None):
    """B9's plain version behind the op's signature (patched into
    ``kernels.ops.attention`` for the plain runs of this phase only)."""
    from repro_torch.kernels import ref
    return ref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap,
                         q_offset=q_offset, kv_len=kv_len, kv_start=kv_start)


def b9_cases(torch, dev, dt):
    """(tag, q, k, v, kwargs) at the shapes of the checks: causal prefill
    over G and hd and at query counts off the 128-row item (77, 200, 513),
    MQA at G = 48 and hd 128, MLA's 576-wide keys over their 512-wide
    prefix (the mma form in bf16), a q_offset suffix, decode over a
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
    kk = rnd(1, 64, 1, 576)
    cases.append(("MLA 576 over its 512-wide prefix", rnd(1, 64, 16, 576), kk, kk[..., :512],
                  dict(causal=True)))
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
    at pos 700 (split form) and a 100-query suffix at q_offset 600 (the wgmma
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


def b9_bound(B, Sq, H, Hkv, hd, visible, size, bw, peak, causal=True):
    """(bound ms, by) of B9 with values as wide as the keys
    (``repro_torch.analysis.roofline.b9_cost``): q, the visible K/V rows and
    out moved once against 4 hd flops per (query row, visible key) at the
    bf16 tensor-core peak (a causal prefill's query i sees i + 1 keys; a
    non-causal one all)."""
    from repro_torch.analysis import roofline
    return bound(roofline.b9_cost(B, Sq, H, Hkv, hd, visible, size=size, causal=causal),
                 peak, bw)


def device_ms(torch, fn, match="", n=20, sessions=3):
    """Device ms per call of fn: the summed durations of its kernels whose
    name holds ``match``, under torch.profiler (no host time). CUPTI at
    times drops a session's kernel records, all or some of them, so a
    session counts only where it shows at least one matching kernel per
    call; after ``sessions`` that did not, the time is not measured (None)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if len(us) >= n:
            return sum(us) / n / 1e3
        seen.append(len(us))
    log(f"[profiler] kernels named {match!r}: {seen} records in {sessions} sessions of "
        f"{n} calls each; device time not measured")
    return None


def fmt_ms(ms):
    """A measured time as '0.1234', or 'not measured' where it is None."""
    return "not measured" if ms is None else f"{ms:.4f}"


def tb_s(nbytes, ms):
    """Bytes over a device time in TB/s, or 'not measured'."""
    return "not measured" if ms is None else f"{nbytes / (ms * 1e-3) / 1e12:.3f}"


def timed_form(torch, fa, fn):
    """(median ms of fn, the one B9 form its launches went through)."""
    before = dict(fa.FORM_LAUNCHES)
    ms = time_launches(torch, fn)
    ran = [f for f in before if fa.FORM_LAUNCHES[f] != before[f]]
    if len(ran) != 1:
        raise RuntimeError(f"B9 timing ran forms {ran}")
    return ms, ran[0]


def device_alone(torch, fa, r, fn, match, n=20, sessions=3):
    """B9's device time alone per call of fn under torch.profiler, into
    ``r``: per session, the kernel events whose name holds ``match`` beside
    the launches B9's counter made in it (``device_seen``, one pair a
    session). ``device_ms`` is the mean of the first session whose two are
    equal (CUPTI at times drops records), else None: not seen."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    r["device_seen"], r["device_ms"] = [], None
    for _ in range(sessions):
        n0 = fa.LAUNCHES
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        r["device_seen"].append([len(us), fa.LAUNCHES - n0])
        if len(us) == fa.LAUNCHES - n0:
            r["device_ms"] = sum(us) / len(us) / 1e3
            return


def seen_text(r):
    """device_alone's reading as text: the time, or 'not seen', beside the
    events and launches it rests on."""
    ms = "not seen" if r["device_ms"] is None else f"{r['device_ms']:.4f} ms"
    return (f"device alone (profiler) {ms}: kernel events for launches by session "
            + ", ".join(f"{e} / {n}" for e, n in r["device_seen"]))


def time_b9(torch, ops, fa, dev, bw, peak):
    """B9, its plain version and SDPA at the serve path's two shapes, bf16:
    prefill q [8, 512, 32, 64] causal (the wgmma form), and decode
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
            f"{fmt_ms(r['device_ms'])} ms, SDPA {fmt_ms(r['library_device_ms'])} ms")
    return out, err


# the wgmma form's timed shapes, bf16: (tag, B, Sq, H, Skv, Hkv, hd, causal,
# kwargs, decode position or None): every served model's prefill that takes
# it (Llama-3.2-V's cross prefill also at a tensor-parallel rank's M = 2
# heads), Gemma2-9B's with its softcap and window, and Granite-20B's MQA (G =
# 48), whose decode (48 rows a kv head) takes the wgmma form too
WGMMA_TIMED = (
    ("TinyLlama prefill", 8, 512, 32, 512, 4, 64, True, {}, None),
    ("MusicGen self prefill (MHA)", 8, 512, 32, 512, 32, 64, True, {}, None),
    ("Llama-3.2-V self prefill", 8, 512, 32, 512, 8, 128, True, {}, None),
    ("Llama-3.2-V cross prefill", 8, 512, 32, 1601, 8, 128, False, {}, None),
    ("Llama-3.2-V cross prefill at M = 2", 8, 256, 16, 1601, 4, 128, False, {}, None),
    ("Zamba2 shared attention prefill", 8, 512, 32, 512, 32, 80, True, {}, None),
    ("Gemma2-9B prefill", 8, 512, 16, 512, 8, 256, True, dict(window=4096, softcap=50.0), None),
    ("Granite-20B prefill", 8, 512, 48, 512, 1, 128, True, {}, None),
    ("Granite-20B decode", 8, 1, 48, 1024, 1, 128, True, {}, 512),
)


def sdpa_backend(torch, fn, sessions=3):
    """(the SDPA backend, the name of its longest kernel) of one call of fn,
    read off torch.profiler's records; (None, None) where no session of
    ``sessions`` kept one (CUPTI at times drops them)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            names = " ".join(e.name for e in ev).lower()
            main = max(ev, key=lambda e: e.time_range.end - e.time_range.start).name
            return ("cuDNN" if "cudnn" in names else "flash" if "flash" in names else
                    "memory-efficient" if ("fmha" in names or "efficient" in names) else
                    "math"), main
    return None, None


def time_b9_wgmma(torch, ops, fa, dev, bw, peak):
    """The wgmma form at every shape of WGMMA_TIMED: held to its plain
    version first (phase 6's tolerances), then its time by CUDA events and
    device alone (device_alone), its bound (roofline.b9_cost: the bytes
    over the memory rate, the operations over the bf16 dense peak ``peak``),
    and SDPA's on the same inputs (BHSD copies, ``enable_gqa``; no softcap
    (Gemma2's 4096-key window spans the whole 512-key prompt); the decode
    over the live rows), with the backend that ran; SDPA's device time is
    its longest kernel's. The factor is device over device where both were
    seen, else events over events. Returns a list of records and the max
    abs err."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(35)
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=dev))
    out, err = [], 0.0
    for tag, B, Sq, H, Skv, Hkv, hd, causal, extra, pos in WGMMA_TIMED:
        q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kw = dict(causal=causal, **extra)
        live = Skv
        if pos is not None:
            kw.update(q_offset=i32(pos), kv_len=i32(pos + 1))
            live = pos + 1
        err = max(err, b9_err(tag, ops.attention(q, k, v, **kw), plain_attention(q, k, v, **kw)))
        fn = (lambda: ops.attention(q, k, v, **kw))
        ms, form = timed_form(torch, fa, fn)
        if form != "wgmma":
            raise RuntimeError(f"B9 {tag}: timed through the {form} form, not wgmma")
        r = dict(tag=tag, q=[B, Sq, H, hd], kv=[B, Skv, Hkv, hd], causal=causal, ms=ms,
                 form=form, **{k_: v_ for k_, v_ in extra.items()})
        device_alone(torch, fa, r, fn, "wgmma")
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[:, :live].transpose(1, 2).contiguous() for x in (k, v))
        sfn = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal and pos is None, enable_gqa=True))
        r["library_ms"] = time_launches(torch, sfn)
        r["library_backend"], main = sdpa_backend(torch, sfn)
        r["library_device_ms"] = device_ms(torch, sfn, main) if main else None
        r["bound_ms"], r["bound_by"] = b9_bound(B, Sq, H, Hkv, hd, live, 2, bw, peak,
                                                causal=causal)
        dev_ms, lib_dev = r["device_ms"], r["library_device_ms"]
        r["factor"] = (dev_ms / lib_dev if dev_ms is not None and lib_dev is not None
                       else ms / r["library_ms"])
        basis = "device" if dev_ms is not None and lib_dev is not None else "events"
        log(f"[serve] B9 wgmma {tag}: q {r['q']} over {r['kv']}"
            + (f" at pos {pos}" if pos is not None else "")
            + (" causal" if causal else " non-causal")
            + (f", softcap {extra['softcap']:g}, window {extra['window']}" if extra else "")
            + f": kernel {ms:.4f} ms, {seen_text(r)}; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); SDPA ({r['library_backend']} backend"
            + (", no softcap" if extra.get("softcap") else "")
            + f") {r['library_ms']:.4f} ms, device {fmt_ms(lib_dev)} ms; "
            f"{r['factor']:.2f}x SDPA ({basis})")
        out.append(r)
        del q, k, v, qt, kt, vt
    log(f"[serve] B9 wgmma form vs plain version at the timed shapes, bfloat16: max abs err "
        f"{err:.3e}")
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
    wgmma_times, err_wg = time_b9_wgmma(torch, ops, fa, dev, bw, peak)
    err["bfloat16"] = max(err["bfloat16"], err_full, err_wg)
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
                 check_launches_by_form=check_forms, wgmma_shapes=wgmma_times,
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
        f"({f'{conv / summed:.3f}' if summed else 'not measured'}); "
        f"phases {r['phase_ms_per_step']}")
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


# ---------------------------------------------------------------------------
# phase 10: training TinyLlama-1.1B through the reference's CLI
# ---------------------------------------------------------------------------

LM_ARCH, LM_W, LM_BATCH, LM_STEPS, LM_LR, LM_P = "tinyllama_1_1b", 2, 8, 10, 1e-2, 0.5
LM_SEQS = (256, 128, 64)             # the longest that fits the card is taken
LM_PARAMS = 1_100_048_384            # f32 elements of one TinyLlama-1.1B replica
LM_GRAD_LAYERS = 2                   # the f64 gradient check's depth cut
LM_GRAD_OUT, LM_GRAD_REL = 0.10, 1e-2   # share outside rtol 1e-4 / atol 1e-6; per-leaf rel L2
LM_SERVE_STEPS = 4
LM_REDUCED_STEPS = 10


def lm_run_kw(**kw):
    """launch.train.run's arguments for phase 10 (the CLI's defaults, as
    ``--arch tinyllama_1_1b --engine sim --workers 2 --p 0.5``)."""
    base = dict(reduced=False, steps=LM_STEPS, method="elastic_gossip", p=LM_P, tau=0,
                alpha=0.5, workers=LM_W, global_batch=LM_BATCH, seq=64, lr=LM_LR,
                engine="sim", log_every=1, device="cuda")
    base.update(kw)
    return base


def lm_memory(torch, cfg, dev):
    """validate_fleet_memory on abstract_lm's bytes: W=2 admitted, W=4
    refused, nothing allocated by either. Then the longest sequence whose
    planes and activations fit the card. Returns (seq, summary)."""
    from repro_torch.fleet import memory
    from repro_torch.launch.train import replica_bytes, step_bytes
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated(dev)
    rb = replica_bytes(cfg)
    if rb != 4 * LM_PARAMS:
        raise AssertionError(f"abstract_lm: {rb} B a replica, expected {4 * LM_PARAMS}")
    free = torch.cuda.mem_get_info(dev)[0]
    need2 = memory.validate_fleet_memory(LM_W, rb, "device", what=f"arch {LM_ARCH!r}",
                                         device=dev)
    try:
        memory.validate_fleet_memory(4, rb, "device", what=f"arch {LM_ARCH!r}", device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None:
        raise AssertionError("validate_fleet_memory admitted W=4 at full width")
    if torch.cuda.memory_allocated(dev) != alloc0:
        raise AssertionError("the memory check allocated on the card")
    gib = 2 ** 30
    log(f"[lm] validate_fleet_memory, {cfg.name} f32 ({rb / 1e9:.3f} GB a replica from "
        f"abstract_lm, nothing allocated): card free {free / gib:.2f} GiB; W={LM_W} admitted, "
        f"needs {need2 / gib:.2f} GiB; W=4 refused: {refused.split('; ')[0]}")
    seq = train_seq(torch, cfg, LM_W, LM_BATCH, dev, "lm")
    return seq, dict(replica_bytes=rb, free=free, need_w2=need2, seq=seq,
                     step_plan=step_bytes(cfg, LM_W, LM_BATCH * seq, seq))


def lm_full_width(torch, ops, fa, cfg, seq, dev):
    """10 sim steps of TinyLlama-1.1B at full width through
    launch.train.run. Every count is set to 0 just before the run and read
    just after. Returns (launches, trainer, state, summary)."""
    from repro_torch.launch import train as cli
    rec = {"gates": [], "step_s": [], "trainer": None}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = [time.perf_counter()]

    def on_step(i, trainer, state, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["step_s"].append(now - t[0])
        rec["gates"].append(trainer.sim.last_draws[0].cpu())
        rec["trainer"] = trainer
        t[0] = time.perf_counter()

    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    state, hist = cli.run(LM_ARCH, **lm_run_kw(seq=seq, on_step=on_step))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    trainer = rec["trainer"]
    want = dict.fromkeys(KERNELS, 0)
    want[B1] = LM_STEPS
    got = {k: launches[k] for k in KERNELS}
    if got != want or dict(fa.FORM_LAUNCHES) != forms0:
        raise AssertionError(f"[lm] launches {got} (B9 forms {dict(fa.FORM_LAUNCHES)}), "
                             f"expected {want} and no B9 form")
    losses = [r["loss"] for r in hist]
    if len(losses) != LM_STEPS or not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"[lm] losses {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"[lm] loss not falling: {losses}")
    gates = int(sum(int(g.sum()) for g in rec["gates"]))
    units = int(state.proto.comm_units)
    wire = trainer.sim._wire_bytes(state.spec)
    if wire != 4 * LM_PARAMS:          # the raw wire carries no lane padding
        raise AssertionError(f"[lm] wire {wire} B per event")
    want_bytes = (torch.tensor(wire / LM_W, dtype=torch.float32)
                  * torch.tensor(float(units), dtype=torch.float32))
    if units != gates or not bits_equal(torch, state.proto.comm_bytes.cpu(), want_bytes):
        raise AssertionError(f"[lm] comm_units {units} / gates {gates}, comm_bytes "
                             f"{float(state.proto.comm_bytes)!r} != {float(want_bytes)!r}")
    step_ms = [s * 1e3 for s in rec["step_s"]]
    med = statistics.median(step_ms[1:])
    tokens = LM_BATCH * seq
    log(f"[lm] {cfg.name} full width (22 layers, d 2048, f32), sim W={LM_W}, global batch "
        f"{LM_BATCH}, seq {seq}, NAG lr {LM_LR}, p {LM_P}: loss " + " ".join(
            f"{x:.4f}" for x in losses) + f"; step ms (synchronised, first with warm-up) "
        + " ".join(f"{x:.1f}" for x in step_ms) + f"; median after the first {med:.3f} ms "
        f"({tokens / med * 1e3:.0f} tokens/s); max_memory_allocated {peak / 2 ** 30:.2f} GiB; "
        f"launches {got}; comm_units {units} = gates {gates}, comm_bytes "
        f"{float(state.proto.comm_bytes)!r} = f32(wire/W) * f32(units), wire {wire} B/event")
    return got, trainer, state, dict(losses=losses, step_ms=step_ms, step_ms_median=med,
                                     max_memory_allocated=peak, tokens_per_step=tokens)


def lm_b1(torch, fu, ref, ops, trainer, state, cfg, seq, dev, bw, peak, tag="lm", W=LM_W,
          batch=LM_BATCH):
    """B1 on one more step's own inputs: theta, peer, v and g copied to the
    host as B1 is called (the activations are freed by then), the step's
    theta and v afterwards held byte for byte against the plain version,
    column chunk by column chunk on the card. Then B1 timed at [W, N] with
    CUDA events beside its bound, in place on the state's planes (the state
    is not used after). Returns (max abs err, timing)."""
    from unittest import mock
    from repro_torch.launch.train import engine_batch, lm_batches
    captured = {}
    real = ops.fused_flat_elastic_nag_update

    def capture(theta, peer, v, g, coef, eta, mu, rows=None):
        captured.update(theta=theta.cpu(), peer=peer.cpu(), v=v.cpu(), g=g.cpu(),
                        coef=coef.clone(), eta=eta, mu=mu)
        return real(theta, peer, v, g, coef, eta, mu, rows=rows)

    b = next(lm_batches(cfg, W, batch // W, seq, seed=1, device=dev))
    with mock.patch.object(ops, "fused_flat_elastic_nag_update", capture):
        state, _ = trainer.step(state, engine_batch(b))
    torch.cuda.synchronize()
    theta, v = state.theta["float32"], state.opt.mu["float32"]
    W, N = theta.shape
    eta = captured["eta"]
    chunks = 16
    err = 0.0
    for c in range(chunks):
        lo, hi = c * N // chunks, (c + 1) * N // chunks
        col = {k: captured[k][:, lo:hi].to(dev) for k in ("theta", "peer", "v", "g")}
        t_new, v_new = ref.fused_flat_elastic_nag_update(
            col["theta"], col["peer"], col["v"], col["g"], captured["coef"], eta,
            captured["mu"])
        if not (bits_equal(torch, theta[:, lo:hi].contiguous(), t_new)
                and bits_equal(torch, v[:, lo:hi].contiguous(), v_new)):
            raise AssertionError(f"[{tag}] B1 at [{W}, {N}] differs from its plain version in "
                                 f"columns {lo}:{hi}")
        err = max(err, float((theta[:, lo:hi] - t_new).abs().max()))
        del col, t_new, v_new
    del captured
    peer = torch.randn_like(theta)
    g = torch.randn_like(theta)
    ones = torch.ones(W, device=dev)
    eta_t = torch.full((), 1e-3, device=dev)
    ms = time_launches(torch, lambda: fu.fused_flat_elastic_nag_update(
        theta, peer, v, g, ones, eta_t, 0.9), reps=20, warmup=3)
    del peer, g
    nbytes = b1_cost(W, N)[1]
    bound_ms = bound(b1_cost(W, N), peak, bw)[0]
    log(f"[{tag}] B1 on one step's own inputs at [{W}, {N}] f32 (2^31 < {W * N} elements): "
        f"byte-equal to the plain version ({chunks} column chunks); kernel {ms:.4f} ms "
        f"(CUDA events, median of 20), bound {bound_ms:.4f} ms ({nbytes / 1e9:.2f} GB at "
        f"{bw / 1e12:.2f} TB/s), {bound_ms / ms:.1%} of the bound")
    return err, dict(ms=ms, bound_ms=bound_ms, shape=[W, N])


def lm_grad_vs_f64(torch, cfg, seq, dev):
    """At full width cut to LM_GRAD_LAYERS layers: the card's f32 loss and
    flat gradient (the engine's path: vmap(grad_and_value) over the views)
    against the same function in f64 on the card."""
    import dataclasses
    from torch.func import grad_and_value, vmap
    from repro_torch.common.flat import FlatSpec
    from repro_torch.common.precision import full_f32
    from repro_torch.launch.train import lm_batches
    from repro_torch.models import transformer as tr
    from repro_torch.common.pytree import tree_map
    c2 = dataclasses.replace(cfg, num_layers=LM_GRAD_LAYERS)
    params = tr.init_lm(torch.Generator(device=dev).manual_seed(3), c2)[0]
    b = next(lm_batches(c2, 1, LM_BATCH // LM_W, seq, seed=2, device=dev))

    def grads(params):
        # the views cast to their spec's dtypes: an f64 run needs an f64 spec
        spec = FlatSpec.build(params)
        row = spec.with_lead(())

        def one(bb, x, y):
            return tr.lm_loss(row.views(bb), c2, x, y)[0]
        with full_f32():
            g, l = vmap(grad_and_value(one))({k: v[None] for k, v in
                                              spec.flatten(params).items()},
                                             b["tokens"], b["labels"])
        (_, g), = g.items()
        return spec, g[0], float(l[0])

    spec, a, l32 = grads(params)
    _, w, l64 = grads(tree_map(lambda t: t.double(), params))
    del params
    if a.dtype != torch.float32 or w.dtype != torch.float64:
        raise AssertionError(f"[lm] gradient dtypes {a.dtype} / {w.dtype}")
    out = float((~torch.isclose(a.double(), w, rtol=1e-4, atol=1e-6)).double().mean())
    leaves = {}
    for path, s in zip(_leaf_names(spec), spec.slots):
        x, y = a[s.offset:s.offset + s.size].double(), w[s.offset:s.offset + s.size]
        leaves[path] = float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))
    worst = max(leaves, key=leaves.get)
    log(f"[lm] gradient at full width, {LM_GRAD_LAYERS} layers ({a.numel()} elements), "
        f"{LM_BATCH // LM_W} x {seq} tokens: f32 loss {l32:.7f} vs f64 {l64:.7f}; "
        f"{out:.4%} of the elements outside rtol 1e-4 / atol 1e-6 of f64 (limit "
        f"{LM_GRAD_OUT:.0%}); worst leaf rel L2 {leaves[worst]:.3e} ({worst}, limit "
        f"{LM_GRAD_REL})")
    if not (out <= LM_GRAD_OUT and leaves[worst] <= LM_GRAD_REL
            and abs(l32 - l64) <= 1e-4 * abs(l64)):
        raise AssertionError("[lm] the f32 gradient is not the f64 one within the limits")
    return dict(outside=out, worst_leaf_rel_l2=leaves[worst], loss_f32=l32, loss_f64=l64)


def _leaf_names(spec):
    """The spec's leaf paths ("segments/seg0_attn/attn/wq"), in slot order."""
    from repro_torch.common.pytree import tree_unflatten
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            out.append((t, path))

    walk(tree_unflatten(spec.treedef, list(range(len(spec.slots)))), "")
    return [p for _, p in sorted(out)]


def lm_serve(torch, ops, fa, ref, cfg, trainer, state, seq, dev):
    """The trained consensus (f32) through serving.engine: a prefill and
    LM_SERVE_STEPS decode steps; B9 once per layer in each (the simt form
    in the f32 prefill, split in decode). The same prefill and decode steps
    through B9's plain version (patched into the op), on the same consensus
    and tokens, give the logits the kernel run is held to (PARITY_TOL of
    the largest |logit|). Then B9 itself against its plain version at the
    prefill and decode shapes this run gave it (these launches are not
    counted). Returns (B9 launches, max abs err)."""
    from unittest import mock
    from repro_torch.serving.engine import make_serve_program
    params = trainer.consensus_params(state)
    B = LM_BATCH // LM_W
    prog = make_serve_program(cfg, batch=B, max_len=seq + LM_SERVE_STEPS,
                              param_dtype=torch.float32, cache_dtype=torch.float32,
                              with_prefill=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (B, seq), generator=g, device=dev,
                           dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, (B, LM_SERVE_STEPS), generator=g, device=dev,
                          dtype=torch.int32)

    def run():
        logits, cache = prog.prefill_fn(params, prompt)
        out = [logits]
        for t in range(LM_SERVE_STEPS):
            logits, cache = prog.decode_fn(params, cache, steps[:, t:t + 1])
            out.append(logits)
        return torch.stack(out).float()

    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    got = run()
    torch.cuda.synchronize()
    n = ops.launch_counts()[B9]
    forms = {f: fa.FORM_LAUNCHES[f] - forms0[f] for f in forms0}
    L = cfg.num_layers
    if n != L * (1 + LM_SERVE_STEPS) or forms.get("simt") != L or \
            forms.get("split") != L * LM_SERVE_STEPS:
        raise AssertionError(f"[lm] serving the consensus: B9 {n} by form {forms}")
    with mock.patch.object(ops, "attention", plain_attention):
        want = run()
    torch.cuda.synchronize()
    del params, prog
    gap = float((got - want).abs().max() / want.abs().max())
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not (bool(torch.isfinite(got).all()) and gap <= PARITY_TOL):
        raise AssertionError(f"[lm] the trained consensus through B9 vs plain: logits "
                             f"relative gap {gap} > {PARITY_TOL}")
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    r = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(*shape, generator=r, device=dev)

    q, k, v = rnd(B, seq, H, hd), rnd(B, seq, Hkv, hd), rnd(B, seq, Hkv, hd)
    err = b9_err(f"prefill [{B}, {seq}, {H}, {hd}]", ops.attention(q, k, v, causal=True),
                 plain_attention(q, k, v, causal=True))
    last = seq + LM_SERVE_STEPS - 1
    qd, ck, cv = rnd(B, 1, H, hd), rnd(B, last + 1, Hkv, hd), rnd(B, last + 1, Hkv, hd)
    pos = torch.tensor(last, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=pos, kv_len=pos + 1)
    err = max(err, b9_err(f"decode [{B}, 1, {H}, {hd}] over {last + 1} rows",
                          ops.attention(qd, ck, cv, **kw), plain_attention(qd, ck, cv, **kw)))
    log(f"[lm] the trained consensus served (f32, batch {B}, prompt {seq}): B9 launches {n} = "
        f"{L} prefill (simt) + {L * LM_SERVE_STEPS} decode (split), by form {forms}; logits "
        f"vs the plain version on the same consensus and tokens: max |diff| / max |logit| = "
        f"{gap:.3e} (tolerance {PARITY_TOL}), greedy tokens agree {agree:.4f}; B9 at this "
        f"run's prefill and decode shapes vs plain: max abs err {err!r} (tolerance "
        f"{B9_TOL['float32']})")
    return n, err


def lm_reduced_kernels(torch, fu, ck, ref, codec_seeds, N, block, dev, tag="lm"):
    """B1 and B2 at [1, N] (a dist rank's plane at --reduced) and B4 / B5 at
    [4, N] (the q8 run's plane) against their plain versions, byte for byte.
    Returns {kernel: max abs err}."""
    f32 = torch.float32
    eta, mu = torch.full((), 3e-3, device=dev), torch.full((), 0.9, device=dev)
    t, p, v, g, coef = b1_inputs(torch, 1, N, f32, f32, 60, dev)
    want = (ref.fused_flat_elastic_nag_update(t, p, v, g, coef, eta, mu),
            ref.fused_flat_nag_update(t, v, g, eta, mu))
    kt, kv = t.clone(), v.clone()
    fu.fused_flat_elastic_nag_update(kt, p, kv, g, coef, eta, mu)
    got = [(kt, kv)]
    kt, kv = t.clone(), v.clone()
    fu.fused_flat_nag_update(kt, kv, g, eta, mu)
    got.append((kt, kv))
    torch.cuda.synchronize()
    err = {}
    for kname, a, b in ((B1, got[0], want[0]), (B2, got[1], want[1])):
        err[kname] = max(float((u - w).abs().max()) for u, w in zip(a, b))
        if not all(bits_equal(torch, u, w) for u, w in zip(a, b)):
            raise AssertionError(f"[{tag}] {kname} at [1, {N}] differs from its plain version: "
                                 f"max abs err {err[kname]!r}")
    del t, p, v, g, kt, kv, got, want
    gen = torch.Generator(device=dev).manual_seed(61)
    x = torch.randn(4, N, generator=gen, device=dev)
    seeds = codec_seeds(3, torch.arange(4, device=dev))
    enc = (ck.q8_encode(x, seeds, block=block), ref.q8_encode(x, seeds, block=block))
    dec = (ck.q8_decode(*enc[1], N, block=block), ref.q8_decode(*enc[1], N, block=block))
    torch.cuda.synchronize()
    for kname, a, b in (("q8_encode", enc[0], enc[1]), ("q8_decode", (dec[0],), (dec[1],))):
        err[kname] = max(float((u.double() - w.double()).abs().max()) for u, w in zip(a, b))
        if not all(bits_equal(torch, u, w) for u, w in zip(a, b)):
            raise AssertionError(f"[{tag}] {kname} at [4, {N}] block {block} differs from its "
                                 f"plain version: max abs err {err[kname]!r}")
    log(f"[{tag}] B1 and B2 at [1, {N}] and B4 / B5 at [4, {N}] block {block} (the reduced "
        f"runs' planes) vs plain versions: byte-equal; max abs err {err}")
    return err


def lm_reduced_runs(torch, ops, fu, ck, ref, codec_seeds, dev, arch=LM_ARCH, W=4, tag="lm"):
    """The other engines through the CLI at --reduced: dist with W (4)
    processes (launches, sends and receives, comm_bytes against the host's
    replay of the schedule), async lognormal, and q8 on sim; then their
    kernels at those planes against the plain versions
    (:func:`lm_reduced_kernels`). Returns ({kernel: launches},
    {kernel: max abs err})."""
    from repro_torch.common.config import MeshConfig, ProtocolConfig
    from repro_torch.core.scheduler import GossipSchedule
    from repro_torch.launch import train as cli
    total = dict.fromkeys(KERNELS, 0)
    steps = LM_REDUCED_STEPS
    kw = lm_run_kw(reduced=True, steps=steps, workers=W, lr=3e-3)
    # p 0.125 on dist, so that both programs run (B1 firing, B2 otherwise)
    ranks, hist = cli.run(arch, **dict(kw, engine="dist", p=0.125))
    sched = GossipSchedule(ProtocolConfig(method="elastic_gossip", moving_rate=0.5,
                                          comm_probability=0.125), W, seed=1,
                           mesh_cfg=MeshConfig(data=W, model=1, pods=1, workers_per_pod=W))
    polls = [sched.poll(i) for i in range(steps)]
    nfire = sum(bool(f) for f, _, _ in polls)
    for r in ranks:
        want = dict.fromkeys(KERNELS, 0)
        want[B1], want[B2] = nfire, steps - nfire
        got = {k: r["launches"][k] for k in KERNELS}
        cb = 0.0
        for f, active, _ in polls:
            if f:
                cb += float(r["wire"]) * float(sum(active) / len(active))
        if got != want or r["sends"] != nfire or r["recvs"] != nfire or r["comm_bytes"] != cb:
            raise AssertionError(f"[{tag}] dist rank {r['rank']}: launches {got} (want {want}), "
                                 f"sends {r['sends']} recvs {r['recvs']} (want {nfire}), "
                                 f"comm_bytes {r['comm_bytes']!r} (want {cb!r})")
        for k in KERNELS:
            total[k] += got[k]
    log(f"[{tag}] dist --reduced, {W} processes on one card, {steps} steps: {nfire} firing "
        f"steps = host schedule; on every rank B1 {nfire}, B2 {steps - nfire}, sends = recvs "
        f"= {nfire}, comm_bytes = host recomputation; loss {hist[0]['loss']:.4f} -> "
        f"{hist[-1]['loss']:.4f}")
    for run_tag, extra, want_k in (
            ("async lognormal", dict(engine="async", time_model="lognormal", sigma=0.6),
             {B1: steps}),
            ("sim q8", dict(codec="q8"), {B1: steps, "q8_encode": steps, "q8_decode": steps})):
        ops.zero_launch_counts()
        state, hist = cli.run(arch, **dict(kw, **extra))
        torch.cuda.synchronize()
        got = {k: ops.launch_counts()[k] for k in KERNELS}
        want = dict.fromkeys(KERNELS, 0)
        want.update(want_k)
        losses = [r["loss"] for r in hist]
        if got != want or not all(x == x and abs(x) != float("inf") for x in losses):
            raise AssertionError(f"[{tag}] {run_tag}: launches {got} (want {want}), losses {losses}")
        for k in KERNELS:
            total[k] += got[k]
        extra_log = (f", virtual time {hist[-1]['virtual_time']}" if "virtual_time" in hist[-1]
                     else "")
        log(f"[{tag}] {run_tag} --reduced W={W}, {steps} steps: launches {got}; loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f}{extra_log}")
    N = state.theta["float32"].shape[1]
    del state
    err = lm_reduced_kernels(torch, fu, ck, ref, codec_seeds, N, ProtocolConfig().codec_block,
                             dev, tag)
    return total, err


def run_lm_phase(torch, ops, fu, ck, ref, fa, codec_seeds, dev, bw, peak):
    """Phase 10. Returns ({kernel: launches}, {kernel: max abs err},
    {kernel: timing}, summary)."""
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    seq, mem = lm_memory(torch, cfg, dev)
    launches, trainer, state, run_summary = lm_full_width(torch, ops, fa, cfg, seq, dev)
    # serve the trained state first: B1's timing below overwrites its planes
    n9, err9 = lm_serve(torch, ops, fa, ref, cfg, trainer, state, seq, dev)
    err, b1 = lm_b1(torch, fu, ref, ops, trainer, state, cfg, seq, dev, bw, peak)
    del trainer, state
    torch.cuda.empty_cache()
    grad = lm_grad_vs_f64(torch, cfg, seq, dev)
    torch.cuda.empty_cache()
    reduced, errs = lm_reduced_runs(torch, ops, fu, ck, ref, codec_seeds, dev)
    for k, n in reduced.items():
        launches[k] += n
    launches[B9] += n9
    errs[B1] = max(errs[B1], err)
    errs[B9] = err9
    return launches, errs, {B1: b1}, dict(memory=mem, run=run_summary, grad=grad)


# ---------------------------------------------------------------------------
# phase 11: training TinyLlama-1.1B while serving it (launch/serve.py)
# ---------------------------------------------------------------------------

# launch.serve.run's arguments: the reference CLI's defaults at full width,
# W = 2 (W = 4's planes alone need 4 x 4 x 4.10 GiB, and
# validate_fleet_memory refuses it)
TS_W, TS_EVERY, TS_BOUNDARIES = 2, 5, 40
TS_KW = dict(reduced=False, engine="sim", workers=TS_W, method="elastic_gossip", p=0.25,
             alpha=0.5, lr=0.01, seq=32, per_worker_batch=2, slots=4, max_len=256, rate=0.3,
             num_requests=24, publish_every=TS_EVERY, train_per_boundary=1,
             traffic_mode="poisson", seed=0, device="cuda")


def attn_shape(cfg):
    """(H, Hkv, hd, dv) of B9's inputs for ``cfg``: GQA's heads, or MLA's
    absorbed form (H heads of r + rope over one key head, values its first
    r columns)."""
    if cfg.mla is not None:
        r = cfg.mla.kv_lora_rank
        return cfg.num_heads, 1, r + cfg.mla.qk_rope_head_dim, r
    hd = cfg.resolved_head_dim
    return cfg.num_heads, cfg.num_kv_heads, hd, hd


def ts_decode_parity(torch, ops, ts, dev, tag="serve-live"):
    """One decode step on the last served snapshot over copies of the live
    cache and slots, through B9 and through its plain version (patched into
    the op): the f32 logits within PARITY_TOL of the largest logit, every
    greedy token equal. Then B9 alone against its plain version at that
    decode shape with the slots' kv_start. Returns (gap, max abs err)."""
    from unittest import mock
    b, server = ts.batcher, ts.server
    tokens = torch.as_tensor(b.next_tok, device=dev)[:, None]
    kv_start = torch.as_tensor(b.kv_start, device=dev)

    def decode():
        cache = {"segments": {s: {k: a.clone() for k, a in seg.items()}
                              for s, seg in b.cache["segments"].items()},
                 "pos": b.cache["pos"].clone()}
        if "shared_sites" in b.cache:
            cache["shared_sites"] = {k: a.clone() for k, a in b.cache["shared_sites"].items()}
        return server.decode(cache, tokens, None, kv_start)[0].float()

    got = decode()
    with mock.patch.object(ops, "attention", plain_attention):
        want = decode()
    torch.cuda.synchronize()
    gap = float((got - want).abs().max() / want.abs().max())
    equal = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if not (bool(torch.isfinite(got).all()) and gap <= PARITY_TOL and equal):
        raise AssertionError(f"[{tag}] the served snapshot's decode through B9 vs plain: "
                             f"gap {gap} (tolerance {PARITY_TOL}), greedy tokens equal {equal}")
    cfg = ts.cfg
    (H, Hkv, hd, dv), B, pos = attn_shape(cfg), b.B, b.pos
    r = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(B, 1, H, hd, generator=r, device=dev)
    k = torch.randn(B, b.max_len, Hkv, hd, generator=r, device=dev)
    v = k[..., :dv] if cfg.mla is not None else torch.randn(B, b.max_len, Hkv, dv,
                                                            generator=r, device=dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    kw = dict(causal=True, q_offset=p, kv_len=p + 1, kv_start=kv_start)
    err = b9_err(f"decode [{B}, 1, {H}, {hd}] over [{B}, {b.max_len}, {Hkv}, {hd}] at pos {pos}",
                 ops.attention(q, k, v, **kw), plain_attention(q, k, v, **kw))
    return gap, err


def run_train_serve_phase(torch, ops, fa, dev, smi):
    """Phase 11: launch.serve at full width, W = 2, through the entry points
    (``build`` then ``run``, which is what ``launch.serve.run`` does). Every
    count is set to 0 just before the loop and read just after. Returns
    ({kernel: launches}, {kernel: max abs err}, summary)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as cli
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    alloc0 = torch.cuda.memory_allocated(dev)
    try:
        cli.plan_memory(cfg, workers=4, tokens=4 * 2 * 32, seq=32, slots=4, max_len=256,
                        device=dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or torch.cuda.memory_allocated(dev) != alloc0:
        raise AssertionError("[serve-live] plan_memory admitted W=4 at full width or allocated")
    log(f"[serve-live] W=4 refused before anything is allocated: {refused.split('; ')[0]}")
    return train_serve(torch, ops, fa, dev, smi, LM_ARCH, TS_KW, TS_BOUNDARIES, TS_EVERY,
                       "serve-live", "22 layers, d 2048, vocab 32000, f32", t_phase)


def train_serve(torch, ops, fa, dev, smi, arch, kw, boundaries, every, tag, desc, t_phase,
                after=None):
    """launch.serve's ``build`` then ``run`` of ``arch`` with ``kw``, for
    ``boundaries`` decode boundaries publishing every ``every`` steps. Every
    count is set to 0 just before the loop and read just after: B1 once a
    training step and no B9 in one, B9 once per attention layer a decode
    boundary (split); the bus, staleness, swap pauses and the batcher's
    invariants; the last served snapshot's decode through B9 against the
    plain version; then ``after(ts)``, whose result the summary keeps under
    "after". Returns ({kernel: launches}, {kernel: max abs err}, summary)."""
    import gc
    from unittest import mock
    from repro_torch.api import GossipTrainer
    from repro_torch.launch import serve as cli
    ts = cli.build(arch, **kw)
    built_s = time.perf_counter() - t_phase
    steps = []
    real = GossipTrainer.step

    def timed_step(self, state, batch, draws=None):
        torch.cuda.synchronize()
        n0, f0 = ops.launch_counts(), dict(fa.FORM_LAUNCHES)
        t = time.perf_counter()
        out = real(self, state, batch, draws=draws)
        torch.cuda.synchronize()
        n1 = ops.launch_counts()
        steps.append(dict(s=time.perf_counter() - t, b1=n1[B1] - n0[B1], b9=n1[B9] - n0[B9],
                          forms=sum(fa.FORM_LAUNCHES[f] - f0[f] for f in f0)))
        return out

    torch.cuda.synchronize()
    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    t_loop = time.perf_counter()
    with mock.patch.object(GossipTrainer, "step", timed_step):
        summary = ts.run(boundaries)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t_loop
    launches = {k: ops.launch_counts()[k] for k in KERNELS}
    forms = {f: fa.FORM_LAUNCHES[f] - forms0[f] for f in forms0}
    peak = torch.cuda.max_memory_allocated(dev)
    cfg = ts.cfg
    L, nb, nsteps = attn_passes(cfg), summary["boundaries"], ts.trainer._host_steps
    want = dict.fromkeys(KERNELS, 0)
    want[B1], want[B9] = nsteps, L * nb
    # (a) B1 once a training step and no B9 in one; (b) B9 once per attention
    # layer a decode boundary, all split (prompts stream through decode: no prefill launch)
    if (launches != want or nsteps != nb or len(steps) != nsteps
            or any(s["b1"] != 1 or s["b9"] != 0 or s["forms"] != 0 for s in steps)
            or forms != {**dict.fromkeys(forms0, 0), "split": L * nb}):
        raise AssertionError(f"[{tag}] launches {launches} (want {want}), B9 forms {forms}, "
                             f"{nsteps} steps / {nb} boundaries, per step "
                             f"{[(s['b1'], s['b9']) for s in steps]}")
    if nb != boundaries and ts.batcher.pos < ts.batcher.max_len:
        raise AssertionError(f"[{tag}] {nb} boundaries of {boundaries}")
    # (c) the bus and the swaps; (d) staleness; (e) the swap pause against
    # the decode boundary, both synchronised
    st = summary
    if not (st["bus_seq"] == nsteps // every and st["swaps"] >= 1
            and st["rejected_swaps"] == 0):
        raise AssertionError(f"[{tag}] bus_seq {st['bus_seq']} (want {nsteps // every}), "
                             f"swaps {st['swaps']}, rejected {st['rejected_swaps']}")
    if not 0 <= st["staleness_max_steps"] <= every:
        raise AssertionError(f"[{tag}] staleness {st['staleness_max_steps']} > {every}")
    if not st["swap_pause_max_s"] < st["boundary_interval_mean_s"]:
        raise AssertionError(f"[{tag}] max swap pause {st['swap_pause_max_s']} s is not "
                             f"below the mean decode boundary {st['boundary_interval_mean_s']} s")
    # (f) the batcher's invariants (ts.run checked them) and its completions
    if not (st["completed"] > 0 and st["admitted"] == st["completed"] + st["in_flight"]):
        raise AssertionError(f"[{tag}] batcher {st}")
    # (g) the last served snapshot through B9 and through the plain version
    gap, err = ts_decode_parity(torch, ops, ts, dev, tag)
    step_ms = sorted(s["s"] * 1e3 for s in steps)
    decode_s = sum(ts.loop.boundary_times)
    toks = st["generated_tokens"]
    extra = None if after is None else after(ts)
    del ts
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(summary, max_memory_allocated=peak, built_s=built_s, loop_s=loop_s,
               train_step_ms_median=statistics.median(step_ms), train_step_ms_max=step_ms[-1],
               tokens_per_decode_s=toks / decode_s, tokens_per_loop_s=toks / loop_s,
               logits_gap=gap, b9_err=err, after=extra,
               phase_s=time.perf_counter() - t_phase)
    log(f"[{tag}] {cfg.name} full width ({desc}), sim W={kw['workers']}, "
        f"seq {kw['seq']} x {kw['per_worker_batch']} a worker, publish every {every}, "
        f"{kw['slots']} slots, max_len {kw['max_len']}, poisson rate {kw['rate']}, "
        f"{kw['num_requests']} requests, seed {kw['seed']}: {nb} boundaries, {nsteps} training "
        f"steps in {loop_s:.2f} s "
        f"(built in {built_s:.2f} s); launches {launches} (B1 once a step, B9 never in a step; "
        f"B9 {L * nb} = {L} x {nb} boundaries, by form {forms})")
    log(f"[{tag}] bus_seq {st['bus_seq']} = {nsteps} // {every}, swaps {st['swaps']}, "
        f"rejected {st['rejected_swaps']}; staleness mean {st['staleness_mean_steps']:.3f} max "
        f"{st['staleness_max_steps']} steps (<= {every}); swap pause mean "
        f"{st['swap_pause_mean_s'] * 1e3:.4f} ms max {st['swap_pause_max_s'] * 1e3:.4f} ms < "
        f"decode boundary mean {st['boundary_interval_mean_s'] * 1e3:.3f} ms (p50 "
        f"{st['boundary_interval_p50_s'] * 1e3:.3f} ms), both synchronised; training step "
        f"median {out['train_step_ms_median']:.3f} ms (synchronised)")
    log(f"[{tag}] batcher: {st['completed']} completed, {st['admitted']} admitted, "
        f"{st['in_flight']} in flight, {st['pending']} pending, invariants held; "
        f"{toks} tokens generated: {out['tokens_per_decode_s']:.1f} tokens/s of decode time, "
        f"{out['tokens_per_loop_s']:.1f} tokens/s of loop time; ttft p50 "
        f"{st['ttft_p50_boundaries']} / latency p50 {st['latency_p50_boundaries']} boundaries")
    log(f"[{tag}] the last served snapshot (seq {st['bus_seq']}), one decode step through B9 "
        f"vs plain on copies of the live cache: max |diff| / max |logit| = {gap:.3e} (tolerance "
        f"{PARITY_TOL}), greedy tokens equal; B9 at that decode shape vs plain: max abs err "
        f"{err!r}; max_memory_allocated {peak / 2 ** 30:.2f} GiB; phase {out['phase_s']:.1f} s "
        f"({smi})")
    return launches, {B9: err}, out


# ---------------------------------------------------------------------------
# phase 12: DeepSeek-V2-Lite-16B served at full width: MoE and MLA, B9 at
# MLA's 576-wide keys and 512-wide latent values
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek_v2_lite_16b"
MLA_HD, MLA_DV, MLA_H = 576, 512, 16       # kv_lora_rank + qk_rope_head_dim, kv_lora_rank
MLA_TRAFFIC = dict(rate=0.5, num_requests=16, prompt_len=(8, 64), max_new=(16, 64))
MLA_GATE_LAYERS = 2                        # the f32 gate's depth cut: 1 dense + 1 MoE layer
MLA_SWAP_TOKENS = 16


def b9_mla_cases(torch, dev, dt):
    """(tag, q, k, v, kwargs, form) at MLA's shapes, with the form each must
    take: decode q [8, 1, 16, 576] over the keys [8, 1024, 1, 576] at
    positions 0, 511 and 1023 and with a kv_start, the values the view
    k[..., :512] (the model's; the split form reads them from its key
    tiles) and once a tensor of their own (split); prefill q
    [8, 512, 16, 576] causal over the keys' prefix, 77 rows (off the
    32-key tile and the 4-position row block) and a 60-query suffix at
    q_offset 200 (in bf16 the mma form's MLA kernel, in f32 simt); with
    values of their own, keys and values of 576, and a 576 / 256 pair
    (simt in both)."""
    g = torch.Generator(device=dev).manual_seed(51)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    tc = "mma" if dt == torch.bfloat16 else "simt"
    B, H, hd, dv = SERVE_BATCH, MLA_H, MLA_HD, MLA_DV
    kk, qd = rnd(B, SERVE_MAX_LEN, 1, hd), rnd(B, 1, H, hd)
    cases = [(f"decode pos {p}", qd, kk, kk[..., :dv],
              dict(causal=True, q_offset=i32(p), kv_len=i32(p + 1)), "split")
             for p in (0, 511, 1023)]
    start = i32([0, 100, 512, 700, 3, 699, 250, 1])
    cases.append(("decode kv_start", qd, kk, kk[..., :dv],
                  dict(causal=True, q_offset=i32(700), kv_len=i32(701), kv_start=start), "split"))
    cases.append(("decode own values", qd, kk, rnd(B, SERVE_MAX_LEN, 1, dv),
                  dict(causal=True, q_offset=i32(600), kv_len=i32(601)), "split"))
    kp, qp = rnd(B, SERVE_PROMPT, 1, hd), rnd(B, SERVE_PROMPT, H, hd)
    cases.append(("prefill 8 x 512", qp, kp, kp[..., :dv], dict(causal=True), tc))
    cases.append(("prefill 77 rows", qp[:2, :77], kp[:2, :77], kp[:2, :77, :, :dv],
                  dict(causal=True), tc))
    cases.append(("prefill 60 at q_offset 200", qp[:, :60], kp[:, :260], kp[:, :260, :, :dv],
                  dict(causal=True, q_offset=i32(200)), tc))
    cases.append(("prefill own values", qp, kp, rnd(B, SERVE_PROMPT, 1, dv), dict(causal=True),
                  "simt"))
    k576 = rnd(2, 100, 1, hd)
    cases.append(("hd = dv = 576", rnd(2, 100, 4, hd), k576, k576, dict(causal=True), "simt"))
    cases.append(("hd = dv = 576 own values", rnd(2, 100, 4, hd), k576, rnd(2, 100, 1, hd),
                  dict(causal=True), "simt"))
    cases.append(("hd 576 dv 256 own values", rnd(2, 100, 4, hd), k576, rnd(2, 100, 1, 256),
                  dict(causal=True), "simt"))
    return cases


def b9_garbage_prefill(torch, ops, dev, dt, H, Hkv, hd, dv, tag, seed):
    """An 80-query suffix at q_offset 200 over 300 keys (280 live) whose
    first kv_start[b] = (150, 3) rows hold NaN (the keys) and inf (values
    of their own; MLA's are the keys' prefix) must give the bits of zeroed
    rows. Returns the form it ran."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(2, 80, H, hd, generator=g, device=dev).to(dt)
    k = torch.randn(2, 300, Hkv, hd, generator=g, device=dev).to(dt)
    v = None if dv < hd else torch.randn(k.shape, generator=g, device=dev).to(dt)
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=dev))
    kw = dict(causal=True, q_offset=i32(200), kv_len=i32(280), kv_start=i32([150, 3]))
    below = torch.arange(300, device=dev)[None, :, None, None] < kw["kv_start"].reshape(2, 1, 1, 1)
    kz, kg = k.masked_fill(below, 0), k.masked_fill(below, float("nan"))
    vz, vg = ((kz[..., :dv], kg[..., :dv]) if v is None else
              (v.masked_fill(below, 0), v.masked_fill(below, float("inf"))))
    before = dict(fa.FORM_LAUNCHES)
    zeroed = ops.attention(q, kz, vz, **kw)
    garbage = ops.attention(q, kg, vg, **kw)
    torch.cuda.synchronize()
    ran = [f for f in before if fa.FORM_LAUNCHES[f] != before[f]]
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    if len(ran) != 1 or not torch.equal(zeroed.view(bits), garbage.view(bits)):
        raise RuntimeError(f"B9 {tag} {dt}: garbage below kv_start changed the output "
                           f"(forms {ran})")
    return ran[0]


def check_b9_mla(torch, ops, fa, dev):
    """B9 at MLA's shapes against its plain version, f32 and bf16, to the
    tolerances of phase 6, each case through the form b9_mla_cases names
    (split and mma in bf16, split and simt in f32), and NaN below kv_start
    invisible in the prefill's form. Returns the max abs err by dtype."""
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        before = dict(fa.FORM_LAUNCHES)
        worst[name] = 0.0
        cases = b9_mla_cases(torch, dev, dt)
        for tag, q, k, v, kw, form in cases:
            n, f0 = fa.LAUNCHES, fa.FORM_LAUNCHES[form]
            got = ops.attention(q, k, v, **kw)
            want = plain_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if fa.LAUNCHES != n + 1 or fa.FORM_LAUNCHES[form] != f0 + 1 \
                    or got.shape != want.shape:
                raise RuntimeError(f"B9 MLA {tag} {name}: forms {dict(fa.FORM_LAUNCHES)} (want "
                                   f"{form}), or shape {tuple(got.shape)}")
            worst[name] = max(worst[name], b9_err(f"MLA {tag}", got, want))
        garbage = b9_garbage_prefill(torch, ops, dev, dt, MLA_H, 1, MLA_HD, MLA_DV, "MLA", 55)
        ran = {f: fa.FORM_LAUNCHES[f] - before[f] for f in before}
        tc = "mma" if dt == torch.bfloat16 else "simt"
        if garbage != tc or not (ran["split"] and ran[tc]) or (tc == "simt" and ran["mma"]):
            raise RuntimeError(f"B9 MLA checks, {name}: forms {ran}, garbage case {garbage}")
        log(f"[mla] B9 vs plain version at MLA's shapes, {name}: {len(cases)} cases, max abs "
            f"err {worst[name]:.3e} (tolerance {B9_TOL[name]}"
            + (", and 2^-6 max |plain| per case" if dt == torch.bfloat16 else "")
            + f"); garbage below kv_start = zeroed, bit for bit ({garbage} prefill suffix); "
            f"forms {ran}")
    return worst


def b9_mla_bound(B, Sq, visible, v_own, bw, peak):
    """(bound ms, by) of B9 at MLA's shapes (``roofline.b9_cost``): q, the
    visible key rows (and value rows when the values are a tensor of their
    own; as the keys' prefix they are read with them) and out moved once,
    against 2 (hd + dv) flops per (query row, visible key) at the bf16
    tensor-core peak."""
    from repro_torch.analysis import roofline
    return bound(roofline.b9_cost(B, Sq, MLA_H, 1, MLA_HD, visible, dv=MLA_DV, v_own=v_own),
                 peak, bw)


def time_b9_mla(torch, ops, fa, dev, bw, peak):
    """B9, its plain version and SDPA (``Ev != E``, GQA) at the serve path's
    MLA shapes in bf16, by CUDA events: the prefill [8, 512, 16, 576] over
    [8, 512, 1, 576] keys and their 512-wide prefix as values, causal (the
    mma form's MLA kernel; also its device time alone, device_alone), and
    the decode [8, 1, 16, 576] over the [8, 1024, 1, 576] keys at position
    512 (the split form; SDPA gets the live rows)."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(52)
    dt, B, S = torch.bfloat16, SERVE_BATCH, SERVE_PROMPT
    q = torch.randn(B, S, MLA_H, MLA_HD, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, 1, MLA_HD, generator=g, device=dev).to(dt)
    v = k[..., :MLA_DV]
    qt, kt, vt = q.transpose(1, 2).contiguous(), k.transpose(1, 2), v.transpose(1, 2)
    out = {}
    ms, form = timed_form(torch, fa, lambda: ops.attention(q, k, v, causal=True))
    pre = dict(ms=ms, form=form, shape=[B, S, MLA_H, MLA_HD], values=[B, S, 1, MLA_DV],
               plain_ms=time_launches(torch, lambda: plain_attention(q, k, v, causal=True),
                                      reps=20, warmup=3),
               library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True), reps=20, warmup=3))
    pre["bound_ms"], pre["bound_by"] = b9_mla_bound(B, S, S, False, bw, peak)
    device_alone(torch, fa, pre, lambda: ops.attention(q, k, v, causal=True),
                 "flash_attention_mla_kernel")
    out["prefill"] = pre
    pos = SERVE_PROMPT
    kk = torch.randn(B, SERVE_MAX_LEN, 1, MLA_HD, generator=g, device=dev).to(dt)
    qd = torch.randn(B, 1, MLA_H, MLA_HD, generator=g, device=dev).to(dt)
    p_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    n_t = p_t + 1
    qdt = qd.transpose(1, 2).contiguous()
    kl = kk[:, :pos + 1].transpose(1, 2).contiguous()
    vl = kl[..., :MLA_DV]

    def dec():
        return ops.attention(qd, kk, kk[..., :MLA_DV], causal=True, q_offset=p_t, kv_len=n_t)

    ms, form = timed_form(torch, fa, dec)
    d = dict(ms=ms, form=form, shape=[B, 1, MLA_H, MLA_HD], cache=[B, SERVE_MAX_LEN, 1, MLA_HD],
             pos=pos,
             plain_ms=time_launches(torch, lambda: plain_attention(
                 qd, kk, kk[..., :MLA_DV], causal=True, q_offset=p_t, kv_len=n_t)),
             library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                 qdt, kl, vl, enable_gqa=True)))
    d["bound_ms"], d["bound_by"] = b9_mla_bound(B, 1, pos + 1, False, bw, peak)
    out["decode"] = d
    for tag, r in out.items():
        log(f"[mla] B9 {tag} bf16 at MLA's shapes ({r['form']} form): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x SDPA), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it reached), CUDA events"
            + (f"; {seen_text(r)}" if "device_seen" in r else ""))
    return out


def attn_passes(cfg):
    """B9 launches per prefill or decode step of ``cfg``: one per attention
    (every layer of a dense or MoE model, a hybrid's shared sites, none in an
    SSM; MusicGen's layers two each, self and cross; a vision model's cross
    blocks one each)."""
    from repro_torch.models import transformer as tr
    plan = tr.make_plan(cfg)
    per = {"attn": 1, "attn_cross": 2}
    return (sum(s.count * per.get(s.kind, 0) for s in plan.segments) + plan.num_shared_sites
            + plan.num_cross)


def mla_serve_flow(torch, ops, fa, cfg, dev, tag="mla", desc=None, cross_gate=0.0):
    """The serve_decode entry point at full width and depth in bf16: 512-token
    prompts, 64 greedy steps (the audio and vision models with their cross
    gates at ``cross_gate`` and a random cond). For DeepSeek its memory plan
    publishes bf16 weights and turns the mid-stream swap off (a second
    replica does not fit beside the first). B9 must launch once per
    attention (27 for DeepSeek) in the prefill (the mma form, MLA's kernel,
    for DeepSeek; the wgmma form for every other model) and as many times a
    step (split), and nowhere else."""
    from repro_torch.launch.serve_decode import serve_decode
    L = attn_passes(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    r = serve_decode(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, tokens=SERVE_TOKENS,
                     max_len=SERVE_MAX_LEN, device=dev, seed=0, cross_gate=cross_gate,
                     log=lambda m: log(f"[{tag}] {m}"))
    counts = ops.launch_counts()
    forms = {f: fa.FORM_LAUNCHES[f] - forms0[f] for f in forms0}
    peak = torch.cuda.max_memory_allocated(dev)
    counts = {k: counts[k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want[B9] = L * (1 + SERVE_TOKENS)
    want_forms = {**dict.fromkeys(forms0, 0), "mma" if cfg.mla else "wgmma": L,
                  "split": L * SERVE_TOKENS}
    if (r["prefill_launches"] != L or set(r["step_launches"]) != {L} or counts != want
            or forms != want_forms):
        raise RuntimeError(f"[{tag}] launches: prefill {r['prefill_launches']}, per step "
                           f"{sorted(set(r['step_launches']))}, {counts}, by form {forms}; "
                           f"want {L}, {L}, {want}")
    plan = r["plan"]
    swaps = 2 if plan["swap"] else 1
    if (r["swaps"] != swaps or not r["final_logits_finite"]
            or r["cache_pos"] != SERVE_PROMPT + SERVE_TOKENS
            or (r["stream"].shape[0], r["stream"].shape[-1]) != (SERVE_BATCH, SERVE_TOKENS)
            or (cfg.name.startswith("deepseek") and (plan["init_dtype"] != torch.bfloat16
                                                     or plan["swap"]))):
        raise RuntimeError(f"[{tag}] serve_decode: plan {plan['init_dtype']} swap "
                           f"{plan['swap']}, swaps {r['swaps']}, finite "
                           f"{r['final_logits_finite']}, pos {r['cache_pos']}, stream "
                           f"{tuple(r['stream'].shape)}")
    step = statistics.median(r["step_ms"])
    desc = desc or ("27 layers, d 2048, MLA 512 + 64, 64 experts top-6 + 2 shared at 1408, "
                    "vocab 102400")
    log(f"[{tag}] {cfg.name} full width and depth ({desc}), bf16, random weights from seed 0, "
        f"batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, max_len {SERVE_MAX_LEN}: prefill "
        f"{r['prefill_ms']:.3f} ms ({SERVE_BATCH * SERVE_PROMPT / r['prefill_ms'] * 1e3:.1f} "
        f"prompt tokens/s), median decode step {step:.3f} ms ({SERVE_BATCH / step * 1e3:.1f} "
        f"tokens/s), max_memory_allocated {peak / 2 ** 30:.2f} GiB; B9 launches {counts[B9]} = "
        f"{L} x (1 + {SERVE_TOKENS}), by form {forms}")
    return counts[B9], dict(prefill_ms=r["prefill_ms"], step_ms=step,
                            tokens_per_s=SERVE_BATCH / step * 1e3,
                            max_memory_allocated=peak, swap_pause_ms=r["swap_pause_s"] * 1e3,
                            plan={k: v for k, v in plan.items() if k != "init_dtype"},
                            init_dtype=str(plan["init_dtype"]).split(".")[-1], forms=forms)


def mla_batcher(torch, ops, fa, cfg, dev, tag="mla"):
    """A ContinuousBatcher over a 16-request TrafficGen stream (prompts 8-64,
    budgets 16-64) at full width and depth in bf16 until it drains: every
    admitted request completes with its budget, the batcher's invariants
    hold, B9 launches once per attention layer a boundary (27 for
    DeepSeek)."""
    from repro_torch.models import transformer as tr
    from repro_torch.serve import ContinuousBatcher, LiveServer, SnapshotBus, TrafficGen
    from repro_torch.serving.engine import make_serve_program
    prog = make_serve_program(cfg, batch=SERVE_BATCH, max_len=SERVE_MAX_LEN, device=dev)
    bus = SnapshotBus()
    with torch.no_grad():
        bus.publish_params(tr.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                                      torch.bfloat16)[0])
    server = LiveServer(prog, bus)
    server.maybe_swap()
    reqs = TrafficGen(TRAFFIC_SEED, vocab=cfg.vocab_size, **MLA_TRAFFIC).requests()
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
    bat.check_invariants()
    lat = bat.latency_summary()
    by_rid = {r.rid: r for r in reqs}
    if lat["completed"] != len(reqs) or bat.pending or any(
            len(rec["tokens"]) != by_rid[rec["rid"]].max_new for rec in bat.completed):
        raise RuntimeError(f"[{tag}] batcher did not complete every request: {lat}")
    L = attn_passes(cfg)
    if launches != L * t:
        raise RuntimeError(f"[{tag}] B9 launches {launches} != {L} x {t} boundaries")
    tps = lat["generated_tokens"] / wall
    log(f"[{tag}] continuous batching: {t} boundaries in {wall:.3f} s ({wall / t * 1e3:.3f} ms a "
        f"boundary), {lat['completed']} of {len(reqs)} requests completed, invariants held, "
        f"{lat['generated_tokens']} tokens, {tps:.1f} tokens/s; ttft p50 "
        f"{lat['ttft_p50_boundaries']} / latency p99 {lat['latency_p99_boundaries']} "
        f"boundaries; B9 launches {launches} = {L} x {t}")
    return launches, dict(tokens_per_s=tps, boundary_ms=wall / t * 1e3, boundaries=t,
                          completed=lat["completed"])


def mla_gate(torch, ops, cfg, dev, tag="mla", what="2 layers (1 dense + 1 MoE)"):
    """f32 at full widths and cut depth (DeepSeek: 2 layers, 1 dense + 1
    MoE): a prefill and 8 decode steps through B9 and through its plain
    version (patched into the op), on the same weights and tokens (the
    audio and vision models with their cross gates at CROSS_GATE and a
    random cond): logits within PARITY_TOL of the largest, greedy tokens
    equal."""
    from unittest import mock
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve_decode import open_cross_gates
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import make_serve_program
    params = tr.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)[0]
    open_cross_gates(params, CROSS_GATE)
    prog = make_serve_program(cfg, batch=SERVE_BATCH, max_len=SERVE_MAX_LEN,
                              param_dtype=torch.float32, cache_dtype=torch.float32,
                              with_prefill=True, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, prog.token_shapes(SERVE_PROMPT).shape,
                           generator=g, device=dev, dtype=torch.int32)
    steps = torch.randint(0, cfg.vocab_size, prog.token_shapes(PARITY_STEPS).shape,
                          generator=g, device=dev, dtype=torch.int32)
    cond = (None if prog.cond_shapes() is None else
            torch.randn(prog.cond_shapes().shape, generator=g, device=dev))

    def run():
        logits, cache = prog.prefill_fn(params, prompt, cond)
        out = [logits]
        for t in range(PARITY_STEPS):
            logits, cache = prog.decode_fn(params, cache, steps[..., t:t + 1], cond)
            out.append(logits)
        return torch.stack(out).float()

    n = ops.launch_counts()[B9]
    before = dict(fa.FORM_LAUNCHES)
    got = run()
    forms = {f: fa.FORM_LAUNCHES[f] - before[f] for f in before}
    with mock.patch.object(ops, "attention", plain_attention):
        want = run()
    torch.cuda.synchronize()
    launched = ops.launch_counts()[B9] - n
    if launched != attn_passes(cfg) * (1 + PARITY_STEPS):
        raise RuntimeError(f"[{tag}] the f32 gate launched B9 {launched} times")
    gap = float((got - want).abs().max() / want.abs().max())
    equal = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if not (torch.isfinite(got).all() and gap <= PARITY_TOL and equal):
        raise RuntimeError(f"[{tag}] f32 logits through B9 vs plain: relative gap {gap} "
                           f"(tolerance {PARITY_TOL}), greedy tokens equal {equal}")
    log(f"[{tag}] f32 gate at full widths, {what}: prefill + "
        f"{PARITY_STEPS} decode steps, B9 vs plain version: logits max |diff| / max |logit| = "
        f"{gap:.3e} (tolerance {PARITY_TOL}), greedy tokens equal; B9 forms {forms}")
    return launched, gap


def mla_swap(torch, ops, cfg, dev):
    """serve_decode at full widths and 2 layers with its mid-stream hot swap
    (the plan publishes f32 and admits the swap at this depth)."""
    from repro_torch.launch.serve_decode import serve_decode
    n = ops.launch_counts()[B9]
    r = serve_decode(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, tokens=MLA_SWAP_TOKENS,
                     max_len=SERVE_MAX_LEN, device=dev, seed=0,
                     log=lambda m: log(f"[mla] {m}"))
    launched = ops.launch_counts()[B9] - n
    if (r["swaps"] != 2 or not r["plan"]["swap"] or not r["final_logits_finite"]
            or launched != cfg.num_layers * (1 + MLA_SWAP_TOKENS)):
        raise RuntimeError(f"[mla] reduced-depth swap: swaps {r['swaps']}, plan swap "
                           f"{r['plan']['swap']}, finite {r['final_logits_finite']}, B9 "
                           f"{launched}")
    log(f"[mla] hot swap at {cfg.num_layers} layers, full widths: swap pause "
        f"{r['swap_pause_s'] * 1e3:.3f} ms (published in "
        f"{str(r['plan']['init_dtype']).split('.')[-1]})")
    return launched, r["swap_pause_s"] * 1e3


def run_mla_phase(torch, ops, fa, dev, bw, peak, smi):
    """Phase 12. Returns (B9 launches, B9's max abs err, the numbers for
    the kernels line)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    err = check_b9_mla(torch, ops, fa, dev)
    times = time_b9_mla(torch, ops, fa, dev, bw, peak)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(MLA_ARCH)
    n_flow, flow = mla_serve_flow(torch, ops, fa, cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    n_bat, bat = mla_batcher(torch, ops, fa, cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, num_layers=MLA_GATE_LAYERS)
    n_gate, gap = mla_gate(torch, ops, cut, dev)
    gc.collect()
    torch.cuda.empty_cache()
    n_swap, swap_ms = mla_swap(torch, ops, cut, dev)
    gc.collect()
    torch.cuda.empty_cache()
    summary = dict(serve=flow, batcher=bat, f32_gate_gap=gap, swap_ms_at_2_layers=swap_ms,
                   b9=times, card=smi)
    log(f"[mla] summary: {json.dumps(summary, default=str)}")
    return n_flow + n_bat + n_gate + n_swap, max(err.values()), dict(
        max_abs_err_f32=err["float32"], max_abs_err_bf16=err["bfloat16"],
        launches_serve_decode=n_flow, launches_batcher=n_bat, **times)


# ---------------------------------------------------------------------------
# phase 13: training DeepSeek-V2-Lite-16B (MLA + MoE) at its published widths
# through the reference's CLI, and training it while serving it
# ---------------------------------------------------------------------------

MOE_LAYERS = 2                       # the depth cut: the dense first layer + one MoE layer
MOE_SEQ = 256
MOE_CAPACITY = 120                   # 4 x 256 tokens a worker x top-6 / 64 experts x 1.25
F64_TOKENS = 64                      # the f64 gradient checks' one sequence (CPU time)
PEAK_PLAN = (0.9, 1.2)               # max_memory_allocated / the step's memory plan
MOE_TS_BOUNDARIES = 32
MOE_TS_KW = dict(TS_KW, layers=MOE_LAYERS)
MOE_REDUCED_W = 2                    # the reduced dist runs' processes


def train_seq(torch, cfg, W, gb, dev, tag):
    """Phase 10's sequence: the longest of LM_SEQS whose step plan
    (``launch.train.step_bytes``, by ``cfg.remat``) fits in 0.9 of the
    card's free memory."""
    from repro_torch.launch.train import step_bytes
    free = torch.cuda.mem_get_info(dev)[0]
    fits = {s: step_bytes(cfg, W, gb * s, s) for s in LM_SEQS}
    seq = next((s for s in LM_SEQS if fits[s] <= 0.9 * free), None)
    if seq is None:
        raise AssertionError(f"[{tag}] no sequence in {LM_SEQS} fits: {fits}, free {free}")
    log(f"[{tag}] {cfg.name}: step plan by sequence " + ", ".join(
        f"{s}: {fits[s] / 2 ** 30:.2f} GiB" for s in LM_SEQS) + f" of {free / 2 ** 30:.2f} GiB "
        f"free; taken: seq {seq} (cut: "
        + ("none" if seq == LM_SEQS[0] else f"{LM_SEQS[0]} does not fit") + ")")
    return seq


def lm_train_run(torch, ops, fu, ref, fa, dev, bw, peak, arch, layers, W, gb, tag, desc,
                 inspect=None):
    """10 sim steps of ``arch`` through launch.train.run (depth cut to
    ``layers``, widths uncut; W workers, global batch ``gb``, the sequence
    of :func:`train_seq`, NAG lr 1e-2, p 0.5). Every count is set to 0 just
    before the run and read
    just after: B1 once a step, B9 never. The loss finite and falling,
    comm_units = gates and comm_bytes its f32 derivation, max_memory_allocated
    within 0.9-1.2 of the step's memory plan (made before anything is
    allocated); ``inspect(trainer, state, cfg, seq)``, whose result the
    summary keeps; then B1 on one more step's own inputs, byte for byte over
    the whole [W, N] plane in column chunks, and timed. Returns
    (launches, B1's max abs err, B1's timing, summary)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as cli
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rb = cli.replica_bytes(cfg)
    seq = train_seq(torch, cfg, W, gb, dev, tag)
    tokens = gb * seq
    free = torch.cuda.mem_get_info(dev)[0]
    plan = cli.step_memory(cfg, W, tokens, seq, dev)
    act = cli.activation_bytes(cfg, tokens, seq)
    gib = 2 ** 30
    rec = {"gates": [], "step_s": [], "trainer": None}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = [time.perf_counter()]

    def on_step(i, trainer, state, m):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec["step_s"].append(now - t[0])
        rec["gates"].append(trainer.sim.last_draws[0].cpu())
        rec["trainer"] = trainer
        t[0] = time.perf_counter()

    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    state, hist = cli.run(arch, **lm_run_kw(seq=seq, layers=layers, workers=W,
                                            global_batch=gb, steps=LM_STEPS,
                                            on_step=on_step))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak_mem = torch.cuda.max_memory_allocated(dev)
    trainer = rec["trainer"]
    want = dict.fromkeys(KERNELS, 0)
    want[B1] = LM_STEPS
    got = {k: launches[k] for k in KERNELS}
    if got != want or dict(fa.FORM_LAUNCHES) != forms0:
        raise AssertionError(f"[{tag}] launches {got} (B9 forms {dict(fa.FORM_LAUNCHES)}), "
                             f"expected {want} and no B9 form")
    losses = [r["loss"] for r in hist]
    if len(losses) != LM_STEPS or not all(x == x and abs(x) != float("inf") for x in losses):
        raise AssertionError(f"[{tag}] losses {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"[{tag}] loss not falling: {losses}")
    gates = int(sum(int(g.sum()) for g in rec["gates"]))
    units = int(state.proto.comm_units)
    wire = trainer.sim._wire_bytes(state.spec)
    want_bytes = (torch.tensor(wire / W, dtype=torch.float32)
                  * torch.tensor(float(units), dtype=torch.float32))
    if wire != rb or units != gates or not bits_equal(torch, state.proto.comm_bytes.cpu(),
                                                      want_bytes):
        raise AssertionError(f"[{tag}] wire {wire} (replica {rb}), comm_units {units} / gates "
                             f"{gates}, comm_bytes {float(state.proto.comm_bytes)!r}")
    ratio = peak_mem / plan
    if not PEAK_PLAN[0] <= ratio <= PEAK_PLAN[1]:
        raise AssertionError(f"[{tag}] max_memory_allocated {peak_mem} is {ratio:.3f} of the "
                             f"plan {plan}, outside {PEAK_PLAN}")
    step_ms = [x * 1e3 for x in rec["step_s"]]
    med = statistics.median(step_ms[1:])
    log(f"[{tag}] {cfg.name} ({desc}; {rb // 4} f32 parameters), sim W={W}, global batch {gb}, "
        f"seq {seq}, NAG lr {LM_LR}, p {LM_P}: loss " + " ".join(f"{x:.4f}" for x in losses)
        + "; step ms (synchronised, first with warm-up) " + " ".join(f"{x:.1f}" for x in step_ms)
        + f"; median after the first {med:.3f} ms ({tokens / med * 1e3:.0f} tokens/s); "
        f"launches {got}; comm_units {units} = gates {gates}")
    log(f"[{tag}] memory: step plan ([{W}, N] planes of {W * rb / gib:.2f} GiB, activations "
        f"estimate {act / gib:.2f} GiB, remat={cfg.remat}) {plan / gib:.2f} GiB of "
        f"{free / gib:.2f} GiB free; max_memory_allocated {peak_mem / gib:.2f} GiB ({ratio:.3f} of "
        f"the plan, limits {PEAK_PLAN})")
    extra = None if inspect is None else inspect(trainer, state, cfg, seq)
    err, b1 = lm_b1(torch, fu, ref, ops, trainer, state, cfg, seq, dev, bw, peak, tag=tag,
                    W=W, batch=gb)
    del trainer, state
    return got, err, b1, dict(params=rb // 4, layers=cfg.num_layers, workers=W, seq=seq,
                              inspected=extra, losses=losses,
                              step_ms=step_ms, step_ms_median=med,
                              tokens_per_s=tokens / med * 1e3, max_memory_allocated=peak_mem,
                              plan_bytes=plan, peak_over_plan=ratio,
                              activations_estimate=act, tokens_per_step=tokens)


def grad_vs_f64(torch, arch, layers, dev, tag, patches=(None, None)):
    """At the published widths cut to ``layers`` layers: the card's f32 loss
    and flat gradient against the CPU's f64 ones at the card's parameters,
    on one sequence of 64 tokens from lm_batches, plain autograd through the
    views (the engines' loss on one row); the two gradients are compared
    leaf by leaf on the card. Limits: phase 10's (share of
    elements outside rtol 1e-4 / atol 1e-6, worst leaf rel L2, the loss to
    1e-4); leaves without gradient in f64 (a hybrid's shared block that no
    site of the cut reaches, an expert no token reaches) must get exactly 0
    in f32. ``patches``: a context manager factory for the f32 and the f64
    side (or None), e.g. to read the card's MoE routing and impose it on
    the f64 run."""
    import contextlib
    import dataclasses
    from repro_torch.common.flat import FlatSpec
    from repro_torch.common.precision import full_f32
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch.train import engine_batch, lm_batches
    from repro_torch.models import transformer as tr
    from repro_torch.train.losses import lm_loss_fn
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    params = tr.init_lm(torch.Generator(device=dev).manual_seed(3), cfg)[0]
    x, y = engine_batch(next(lm_batches(cfg, 1, 1, F64_TOKENS, seed=2, device=dev)))
    x, y = tree_map(lambda t: t[0], x), y[0]
    loss_fn = lm_loss_fn(cfg)

    def grad(params, dev_, patch):
        spec = FlatSpec.build(params)
        (name, flat), = spec.flatten(params).items()
        buf = flat.to(dev_).requires_grad_(True)
        with full_f32(), (patch or contextlib.nullcontext)():
            loss = loss_fn(spec.with_lead(()).views({name: buf}),
                           tree_map(lambda t: t.to(dev_), x), y.to(dev_))
            loss.backward()
        return spec, buf.grad.detach(), float(loss.detach())

    spec, a, l32 = grad(params, dev, patches[0])
    p64 = tree_map(lambda t: t.detach().cpu().double(), params)
    del params
    torch.cuda.empty_cache()
    _, w, l64 = grad(p64, "cpu", patches[1])
    del p64
    if a.dtype != torch.float32 or w.dtype != torch.float64 or w.device.type != "cpu":
        raise AssertionError(f"[{tag}] gradients {a.dtype} / {w.dtype} on {w.device}")
    w = w.to(dev)
    leaves, silent, counts = {}, 0, {}
    for path, s in zip(_leaf_names(spec), spec.slots):
        u, v = a[s.offset:s.offset + s.size].double(), w[s.offset:s.offset + s.size]
        counts[path] = int((~torch.isclose(u, v, rtol=1e-4, atol=1e-6)).sum())
        nv = torch.linalg.vector_norm(v)
        if float(nv) == 0.0:
            if bool(u.any()):
                raise AssertionError(f"[{tag}] {path}: f64 gradient 0, f32 not")
            silent += 1
            continue
        leaves[path] = float(torch.linalg.vector_norm(u - v) / nv)
    n = a.numel()
    out = sum(counts.values()) / n
    del a, w
    torch.cuda.empty_cache()
    worst = max(leaves, key=leaves.get)
    most = sorted(counts, key=counts.get, reverse=True)[:3]
    secs = time.perf_counter() - t0
    log(f"[{tag}] gradient at the published widths, {layers} layers ({n} elements), "
        f"1 x {F64_TOKENS} tokens: f32 (card) loss {l32:.7f} vs f64 (CPU) {l64:.7f}; "
        f"{out:.4%} of the elements outside rtol 1e-4 / atol 1e-6 of f64 (limit "
        f"{LM_GRAD_OUT:.0%}; most in " + ", ".join(f"{p} {counts[p]}" for p in most)
        + f"); worst leaf rel L2 {leaves[worst]:.3e} ({worst}, limit "
        f"{LM_GRAD_REL}); {silent} leaves without gradient in both; {secs:.1f} s")
    if not (out <= LM_GRAD_OUT and leaves[worst] <= LM_GRAD_REL
            and abs(l32 - l64) <= 1e-4 * abs(l64)):
        raise AssertionError(f"[{tag}] the f32 gradient is not the f64 one within the limits")
    return dict(layers=layers, outside=out, worst_leaf_rel_l2=leaves[worst], loss_f32=l32,
                loss_f64=l64, silent_leaves=silent, seconds=secs)


def moe_train(torch, ops, fu, ref, fa, dev, bw, peak):
    """10 sim steps of DeepSeek-V2-Lite-16B at its published widths, cut to
    2 layers, through :func:`lm_train_run` with phase 10's arguments (W = 2,
    global batch 8, seq 256); then the MoE layer's capacity and dropped
    tokens on the run's first batch at the trained parameters of worker 0.
    Returns (launches, B1's max abs err, B1's timing, summary)."""
    from unittest import mock
    from repro_torch.launch import train as cli
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr

    def dispatch(trainer, state, cfg, seq):
        # the MoE layer's dispatch on the run's first batch of worker 0, at
        # worker 0's trained parameters (outside the engines' vmap, where it
        # can be read)
        seen = []
        real = moe._build_buffer

        def spy(xt, ids, weights, E, k, C, *rest):
            out = real(xt, ids, weights, E, k, C, *rest)
            seen.append((xt.shape[0], C, int((~out[4]).sum())))
            return out

        b0 = next(cli.lm_batches(cfg, LM_W, LM_BATCH // LM_W, seq, 0, device=dev))
        row0 = state.spec.with_lead(()).unflatten({k: v[0] for k, v in state.theta.items()})
        with torch.no_grad(), mock.patch.object(moe, "_build_buffer", spy):
            tr.forward(row0, cfg, b0["tokens"][0])
        del row0
        if len(seen) != 1 or seen[0][1] != MOE_CAPACITY or not seen[0][2] > 0:
            raise AssertionError(f"[moe] dispatch (tokens, C, dropped) {seen}, want C "
                                 f"{MOE_CAPACITY} with tokens dropped")
        log(f"[moe] dispatch on worker 0's first batch at its trained parameters: {seen[0][0]} "
            f"tokens, capacity C = {seen[0][1]} (= int({seen[0][0]} x 6 / 64 x 1.25)), "
            f"{seen[0][2]} of {seen[0][0] * 6} routed slots dropped")
        return dict(capacity=seen[0][1], dropped_slots=seen[0][2])

    return lm_train_run(torch, ops, fu, ref, fa, dev, bw, peak, MLA_ARCH, MOE_LAYERS, LM_W,
                        LM_BATCH, "moe", "published widths: d 2048, 16 heads, MLA 512 + 64, "
                        "64 experts top-6 + 2 shared at 1408, vocab 102400; depth cut to "
                        f"{MOE_LAYERS} layers, 1 dense + 1 MoE", inspect=dispatch)


def moe_grad_vs_f64(torch, dev):
    """:func:`grad_vs_f64` of DeepSeek at its widths, 2 layers. The card's
    routing is read (its top-k sets) and imposed on the CPU's f64 run, which
    takes its own f64 probabilities at those ids, so the check holds the
    arithmetic; the tokens whose f64 top-k set differs are counted."""
    from unittest import mock
    from repro_torch.models import moe
    real = moe._route
    card_ids, differ = [], []

    def spy(logits, top_k):
        out = real(logits, top_k)
        card_ids.append(out[2].detach().cpu())
        return out

    def forced(logits, top_k):
        probs, _, ids = real(logits, top_k)
        want = card_ids[len(differ)].to(ids.device)
        differ.append(int((ids.sort(-1).values != want.sort(-1).values).any(-1).sum()))
        w = torch.gather(probs, -1, want)
        return probs, w / torch.sum(w, dim=-1, keepdim=True), want

    out = grad_vs_f64(torch, MLA_ARCH, MOE_LAYERS, dev, "moe",
                      patches=(lambda: mock.patch.object(moe, "_route", spy),
                               lambda: mock.patch.object(moe, "_route", forced)))
    log(f"[moe] top-k expert sets differing between f32 and f64: {differ} of {F64_TOKENS} "
        f"tokens (the f64 run takes the card's)")
    return dict(out, topk_sets_differing=differ)


def moe_prefill_parity(torch, ops, fa, ts, dev):
    """The last served snapshot's prefill of a [4, 256] prompt in f32 through
    B9 (the simt form at MLA's shapes, once per layer) and through its plain
    version: logits
    within PARITY_TOL of the largest, greedy tokens equal."""
    from unittest import mock
    from repro_torch.serving.engine import make_serve_program
    cfg, params = ts.cfg, ts.server.params
    prog = make_serve_program(cfg, batch=4, max_len=MOE_SEQ, param_dtype=torch.float32,
                              cache_dtype=torch.float32, with_prefill=True, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (4, MOE_SEQ), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(9))
    n, forms0 = ops.launch_counts()[B9], dict(fa.FORM_LAUNCHES)
    got = prog.prefill_fn(params, prompt)[0].float()
    torch.cuda.synchronize()
    launched = ops.launch_counts()[B9] - n
    forms = {f: fa.FORM_LAUNCHES[f] - forms0[f] for f in forms0}
    with mock.patch.object(ops, "attention", plain_attention):
        want = prog.prefill_fn(params, prompt)[0].float()
    gap = float((got - want).abs().max() / want.abs().max())
    equal = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    if launched != cfg.num_layers or forms["simt"] != cfg.num_layers or not (
            gap <= PARITY_TOL and equal and bool(torch.isfinite(got).all())):
        raise AssertionError(f"[moe-serve] prefill through B9: {launched} launches by form "
                             f"{forms}, gap {gap}, greedy tokens equal {equal}")
    log(f"[moe-serve] the last served snapshot's prefill [4, {MOE_SEQ}] (f32): B9 {launched} "
        f"launches by form {forms}; logits vs the plain version: max |diff| / max |logit| = "
        f"{gap:.3e} (tolerance {PARITY_TOL}), greedy tokens equal")
    return launched, gap


def run_moe_phase(torch, ops, fu, ck, ref, fa, codec_seeds, dev, bw, peak, smi):
    """Phase 13. Returns ({kernel: launches}, {kernel: max abs err}, B1's
    timing, summary)."""
    import gc
    launches, err1, b1, run = moe_train(torch, ops, fu, ref, fa, dev, bw, peak)
    gc.collect()
    torch.cuda.empty_cache()
    grad = moe_grad_vs_f64(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_ts = time.perf_counter()
    ts_launches, ts_err, ts_summary = train_serve(
        torch, ops, fa, dev, smi, MLA_ARCH, MOE_TS_KW, MOE_TS_BOUNDARIES, TS_EVERY, "moe-serve",
        f"published widths, {MOE_LAYERS} layers, f32", t_ts,
        after=lambda ts: moe_prefill_parity(torch, ops, fa, ts, dev))
    gc.collect()
    torch.cuda.empty_cache()
    for k, n in ts_launches.items():
        launches[k] += n
    launches[B9] += ts_summary["after"][0]
    errs = {B1: err1, B9: ts_err[B9]}
    for arch in (MLA_ARCH, "grok_1_314b"):
        reduced, e = lm_reduced_runs(torch, ops, fu, ck, ref, codec_seeds, dev, arch=arch,
                                     W=MOE_REDUCED_W, tag="moe")
        for k, n in reduced.items():
            launches[k] += n
        for k, x in e.items():
            errs[k] = max(errs.get(k, 0.0), x)
    return launches, errs, b1, dict(run=run, grad=grad, train_serve=ts_summary)


# ---------------------------------------------------------------------------
# phase 14: serving SSM and hybrid models (xLSTM-125M, Zamba2-2.7B) at full
# width and depth; B9 at Zamba2's head dim 80
# ---------------------------------------------------------------------------

SSM_ARCHS = ("xlstm_125m", "zamba2_2_7b")
SSM_DESC = {"xlstm_125m": "12 layers: 10 mLSTM + 2 sLSTM, d 768, 4 heads, vocab 50304",
            "zamba2_2_7b": "54 Mamba2 layers, d 2560, state 64, 8 shared attention sites over "
                           "2 shared blocks, 32 heads of 80, vocab 32000"}
# the f32 gates' depth: xLSTM whole (its sLSTM layers are 5 and 11); Zamba2
# 13 layers, its first two shared sites (a site follows every 6 Mamba2 layers)
SSM_GATE_LAYERS = {"xlstm_125m": 12, "zamba2_2_7b": 13}
ZAMBA_H, ZAMBA_HD = 32, 80


def b9_hd80_cases(torch, dev, dt):
    """(tag, q, k, v, kwargs) at Zamba2's shared attention (32 heads of 80
    over 32 kv heads): decode over the [8, 1024] cache at positions 0, 511,
    1023 and with a kv_start (split form), prefill 8 x 512, 77 rows (off
    the 64-key tile and the 128-row block) and a 60-query suffix at
    q_offset 200 (the wgmma form in bf16, simt in f32)."""
    g = torch.Generator(device=dev).manual_seed(53)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    B, H, hd = SERVE_BATCH, ZAMBA_H, ZAMBA_HD
    ck, cv, qd = rnd(B, SERVE_MAX_LEN, H, hd), rnd(B, SERVE_MAX_LEN, H, hd), rnd(B, 1, H, hd)
    cases = [(f"decode pos {p}", qd, ck, cv, dict(causal=True, q_offset=i32(p),
                                                  kv_len=i32(p + 1))) for p in (0, 511, 1023)]
    cases.append(("decode kv_start", qd, ck, cv,
                  dict(causal=True, q_offset=i32(700), kv_len=i32(701),
                       kv_start=i32([0, 100, 512, 700, 3, 699, 250, 1]))))
    kp, vp, qp = (rnd(B, SERVE_PROMPT, H, hd) for _ in range(3))
    cases.append(("prefill 8 x 512", qp, kp, vp, dict(causal=True)))
    cases.append(("prefill 77 rows", qp[:2, :77], kp[:2, :77], vp[:2, :77], dict(causal=True)))
    cases.append(("prefill 60 at q_offset 200", qp[:, :60], kp[:, :260], vp[:, :260],
                  dict(causal=True, q_offset=i32(200))))
    return cases


def check_b9_hd80(torch, ops, fa, dev):
    """B9 at head dim 80 against its plain version, f32 and bf16, to phase
    6's tolerances: decode in the split form, prefill in the wgmma form in
    bf16 and the simt form in f32, and nothing else; NaN and inf below
    kv_start invisible in the prefill's form. Returns the max abs err by
    dtype."""
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        before = dict(fa.FORM_LAUNCHES)
        worst[name] = 0.0
        cases = b9_hd80_cases(torch, dev, dt)
        for tag, q, k, v, kw in cases:
            n = fa.LAUNCHES
            got = ops.attention(q, k, v, **kw)
            want = plain_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if fa.LAUNCHES != n + 1 or got.shape != want.shape:
                raise RuntimeError(f"B9 hd 80 {tag}: no launch, or shape {tuple(got.shape)}")
            worst[name] = max(worst[name], b9_err(f"hd 80 {tag}", got, want))
        tc = "wgmma" if dt == torch.bfloat16 else "simt"
        garbage = b9_garbage_prefill(torch, ops, dev, dt, ZAMBA_H, ZAMBA_H, ZAMBA_HD, ZAMBA_HD,
                                     "hd 80", 56)
        ran = {f: fa.FORM_LAUNCHES[f] - before[f] for f in before}
        n_dec = sum(1 for c in cases if c[1].shape[1] == 1)
        want_ran = {**dict.fromkeys(before, 0), "split": n_dec}
        want_ran[tc] = len(cases) - n_dec + 2
        if ran != want_ran or garbage != tc:
            raise RuntimeError(f"B9 hd 80 checks, {name}: forms {ran} (want {want_ran}), "
                               f"garbage case {garbage}")
        log(f"[ssm] B9 vs plain version at Zamba2's head dim 80, {name}: {len(cases)} cases, max "
            f"abs err {worst[name]:.3e} (tolerance {B9_TOL[name]}"
            + (", and 2^-6 max |plain| per case" if dt == torch.bfloat16 else "")
            + f"); garbage below kv_start = zeroed, bit for bit ({garbage} prefill suffix); "
            f"forms {ran}")
    return worst


def time_b9_hd80(torch, ops, fa, dev, bw, peak):
    """B9, its plain version and SDPA at Zamba2's shared attention in bf16,
    by CUDA events: the prefill [8, 512, 32, 80] causal (the wgmma form; also
    its device time alone, device_alone) and the decode [8, 1, 32, 80] over
    the [8, 1024, 32, 80] cache at position 512 (split form; SDPA gets the
    live rows)."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(54)
    dt, B, S, H, hd = torch.bfloat16, SERVE_BATCH, SERVE_PROMPT, ZAMBA_H, ZAMBA_HD
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev).to(dt) for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    out = {}
    ms, form = timed_form(torch, fa, lambda: ops.attention(q, k, v, causal=True))
    pre = dict(ms=ms, form=form, shape=[B, S, H, hd],
               plain_ms=time_launches(torch, lambda: plain_attention(q, k, v, causal=True),
                                      reps=20, warmup=3),
               library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True), reps=20, warmup=3))
    pre["bound_ms"], pre["bound_by"] = b9_bound(B, S, H, H, hd, S, 2, bw, peak)
    device_alone(torch, fa, pre, lambda: ops.attention(q, k, v, causal=True),
                 "flash_attention_wgmma_kernel")
    out["prefill"] = pre
    pos = SERVE_PROMPT
    ck, cv = (torch.randn(B, SERVE_MAX_LEN, H, hd, generator=g, device=dev).to(dt)
              for _ in range(2))
    qd = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dt)
    p_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    n_t = p_t + 1
    qdt = qd.transpose(1, 2).contiguous()
    kl, vl = (a[:, :pos + 1].transpose(1, 2).contiguous() for a in (ck, cv))
    ms, form = timed_form(torch, fa, lambda: ops.attention(qd, ck, cv, causal=True,
                                                           q_offset=p_t, kv_len=n_t))
    d = dict(ms=ms, form=form, shape=[B, 1, H, hd], cache=[B, SERVE_MAX_LEN, H, hd], pos=pos,
             plain_ms=time_launches(torch, lambda: plain_attention(
                 qd, ck, cv, causal=True, q_offset=p_t, kv_len=n_t)),
             library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                 qdt, kl, vl)))
    d["bound_ms"], d["bound_by"] = b9_bound(B, 1, H, H, hd, pos + 1, 2, bw, peak)
    out["decode"] = d
    for tag, r in out.items():
        log(f"[ssm] B9 {tag} bf16 at head dim 80 ({r['form']} form): kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x SDPA), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it reached), CUDA events"
            + (f"; {seen_text(r)}" if "device_seen" in r else ""))
    return out


def run_ssm_phase(torch, ops, fa, dev, bw, peak, smi):
    """Phase 14. Returns (B9 launches, B9's max abs err, the numbers for the
    kernels line, summary)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    err = check_b9_hd80(torch, ops, fa, dev)
    times = time_b9_hd80(torch, ops, fa, dev, bw, peak)
    launches, summary = 0, {}
    for arch in SSM_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        n_flow, flow = mla_serve_flow(torch, ops, fa, cfg, dev, tag="ssm", desc=SSM_DESC[arch])
        if arch == "xlstm_125m":
            log("[ssm] xLSTM-125M launches no kernel: its mLSTM and sLSTM blocks are recurrent "
                "(the chunked GLA core and the sLSTM loop in torch ops; the reference has no "
                "Pallas kernel for them either)")
        gc.collect()
        torch.cuda.empty_cache()
        n_bat, bat = mla_batcher(torch, ops, fa, cfg, dev, tag="ssm")
        gc.collect()
        torch.cuda.empty_cache()
        L = SSM_GATE_LAYERS[arch]
        cut = dataclasses.replace(cfg, num_layers=L)
        n_gate, gap = mla_gate(torch, ops, cut, dev, tag="ssm",
                               what=f"{cfg.name} at {L} of {cfg.num_layers} layers "
                                    f"({attn_passes(cut)} attention sites)")
        launches += n_flow + n_bat + n_gate
        summary[arch] = dict(serve=flow, batcher=bat, f32_gate_gap=gap,
                             f32_gate_layers=L)
    gc.collect()
    torch.cuda.empty_cache()
    summary["b9_hd80"] = times
    log(f"[ssm] summary ({smi}): {json.dumps(summary, default=str)}")
    return launches, max(err.values()), dict(max_abs_err_f32=err["float32"],
                                             max_abs_err_bf16=err["bfloat16"], **times), summary


# ---------------------------------------------------------------------------
# phase 15: training SSM and hybrid models (xLSTM-125M whole, Zamba2-2.7B at
# its widths cut to 18 layers) through the reference's CLI, and training
# them while serving them
# ---------------------------------------------------------------------------

# arch -> (depth cut (0: none), W, global batch): xLSTM at the paper's W = 4,
# Zamba2 with phase 10's arguments; the sequence is phase 10's: the longest
# of LM_SEQS whose step plan fits
SSM_TRAIN = {"xlstm_125m": (0, 4, 16), "zamba2_2_7b": (18, LM_W, LM_BATCH)}
# the f64 gradient check's depth: xLSTM's first 2 layers (mLSTM) and its
# first 6 (5 mLSTM and its first sLSTM), Zamba2's first 7 (6 Mamba2 layers
# and the first shared site)
F64_LAYERS = {"xlstm_125m": (2, 6), "zamba2_2_7b": (7,)}
TS_CUT_BOUNDARIES = 32


def run_ssm_train_phase(torch, ops, fu, ref, fa, dev, bw, peak, smi):
    """Phase 15. Returns ({kernel: launches}, {kernel: max abs err}, {arch:
    B1's timing}, summary)."""
    import gc
    launches, errs, b1, summary = dict.fromkeys(KERNELS, 0), {B1: 0.0, B9: 0.0}, {}, {}
    for arch, (layers, W, gb) in SSM_TRAIN.items():
        gc.collect()
        torch.cuda.empty_cache()
        desc = SSM_DESC[arch] if not layers else (f"published widths, depth cut to {layers} of "
                                                  f"54 layers: 3 segments of 6, 2 shared sites")
        got, err, b1[arch], run = lm_train_run(torch, ops, fu, ref, fa, dev, bw, peak, arch,
                                               layers, W, gb, "ssm-train", desc)
        errs[B1] = max(errs[B1], err)
        for k, n in got.items():
            launches[k] += n
        gc.collect()
        torch.cuda.empty_cache()
        grad = [grad_vs_f64(torch, arch, n, dev, "ssm-train") for n in F64_LAYERS[arch]]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t_ts = time.perf_counter()
        ts_launches, ts_err, ts_summary = train_serve(
            torch, ops, fa, dev, smi, arch, dict(TS_KW, layers=layers), TS_CUT_BOUNDARIES,
            TS_EVERY, "ssm-serve-live", f"{layers or 'all'} layers, f32", t_ts)
        for k, n in ts_launches.items():
            launches[k] += n
        errs[B9] = max(errs[B9], ts_err[B9])
        summary[arch] = dict(run=run, grad=grad, train_serve=ts_summary)
    return launches, errs, b1, summary


# ---------------------------------------------------------------------------
# phase 16: cross-attention: Llama-3.2-Vision-11B and MusicGen-large served at
# full width and depth, B9 at their self- and cross-attention shapes, and
# MusicGen trained at its widths
# ---------------------------------------------------------------------------

CROSS_ARCHS = ("llama_3_2_vision_11b", "musicgen_large")
CROSS_DESC = {"llama_3_2_vision_11b": "40 layers + 8 gated cross-attention blocks over 1601 "
                                      "image tokens of 4096, d 4096, 32 / 8 heads of 128, "
                                      "vocab 128256",
              "musicgen_large": "48 layers, each self- and cross-attention to 64 conditioning "
                                "tokens, d 2048, 32 heads of 64, 4 codebooks of 2048"}
# the f32 gates' depth: vision 4 layers and its first cross block, MusicGen 2
CROSS_GATE_LAYERS = {"llama_3_2_vision_11b": 4, "musicgen_large": 2}
# (tag, B, Sq, H, Skv, Hkv, hd, causal): B9's shapes in the two models' bf16
# serving at 8 x 512 prompts; decode at position 512 of the [8, 1024] cache
CROSS_B9 = (("vision self prefill", 8, 512, 32, 512, 8, 128, True),
            ("vision cross prefill", 8, 512, 32, 1601, 8, 128, False),
            ("vision self decode", 8, 1, 32, 1024, 8, 128, True),
            ("vision cross decode", 8, 1, 32, 1601, 8, 128, False),
            ("musicgen self prefill", 8, 512, 32, 512, 32, 64, True),
            ("musicgen cross prefill", 8, 512, 32, 64, 32, 64, False),
            ("musicgen self decode", 8, 1, 32, 1024, 32, 64, True),
            ("musicgen cross decode", 8, 1, 32, 64, 32, 64, False))
# 15 of 48 layers: 1,040,281,615 f32 parameters (a layer's self- and
# cross-attention and FFN: 67.1 M), TinyLlama's plane; at 20 the replica
# (5.13 GiB) is refused by validate_fleet_memory at W = 2
MUSICGEN_TRAIN_LAYERS = 15
VISION_TRAIN_LAYERS = 4              # the smallest cut with a cross block: not run, planned


def b9_cross_case(torch, dev, dt, case, seed):
    """(q, k, v, kwargs, visible keys) of a CROSS_B9 case in ``dt``."""
    tag, B, Sq, H, Skv, Hkv, hd, causal = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dt)
    k, v = (torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).to(dt) for _ in range(2))
    kw, visible = dict(causal=causal), Skv
    if Sq == 1 and causal:
        p = torch.tensor(SERVE_PROMPT, dtype=torch.int32, device=dev)
        kw.update(q_offset=p, kv_len=p + 1)
        visible = SERVE_PROMPT + 1
    return q, k, v, kw, visible


CROSS_WHAT = ("non-causal over 1601 image tokens, a partial last key tile, and over 64 "
              "conditioning tokens; causal self-attention beside")


def check_b9_cross(torch, ops, fa, dev, cases=CROSS_B9, tag="cross", what=CROSS_WHAT):
    """B9 at every shape of ``cases`` (CROSS_B9's form) against its plain
    version, f32 and bf16, to phase 6's tolerances: prefill in the wgmma form
    (bf16) or simt (f32), decode in the split form, each launch counted.
    Returns the max abs err by dtype."""
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        worst[name] = 0.0
        before = dict(fa.FORM_LAUNCHES)
        for i, case in enumerate(cases):
            q, k, v, kw, _ = b9_cross_case(torch, dev, dt, case, 70 + i)
            want_form = ("split" if q.shape[1] == 1 else
                         "wgmma" if dt == torch.bfloat16 else "simt")
            n, f0 = fa.LAUNCHES, fa.FORM_LAUNCHES[want_form]
            got = ops.attention(q, k, v, **kw)
            want = plain_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if fa.LAUNCHES != n + 1 or fa.FORM_LAUNCHES[want_form] != f0 + 1:
                raise RuntimeError(f"B9 {case[0]} {name}: launches {fa.LAUNCHES - n}, forms "
                                   f"{dict(fa.FORM_LAUNCHES)} (want {want_form})")
            worst[name] = max(worst[name], b9_err(case[0], got, want))
            del q, k, v, got, want
        ran = {f: fa.FORM_LAUNCHES[f] - before[f] for f in before}
        log(f"[{tag}] B9 vs plain version at the {tag} shapes, {name}: "
            f"{len(cases)} cases ({what}), max abs err "
            f"{worst[name]:.3e} (tolerance {B9_TOL[name]}"
            + (", and 2^-6 max |plain| per case" if dt == torch.bfloat16 else "")
            + f"); forms {ran}")
    return worst


def time_b9_cross(torch, ops, fa, dev, bw, peak, cases=CROSS_B9, tag="cross"):
    """B9, its plain version and SDPA at every shape of ``cases`` in bf16, by
    CUDA events (SDPA gets the live cache rows in a causal decode)."""
    import torch.nn.functional as F
    out = {}
    for i, case in enumerate(cases):
        _, B, Sq, H, Skv, Hkv, hd, causal = case
        q, k, v, kw, visible = b9_cross_case(torch, dev, torch.bfloat16, case, 80 + i)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (a[:, :visible].transpose(1, 2).contiguous() for a in (k, v))
        sdpa_causal = causal and Sq > 1
        ms, form = timed_form(torch, fa, lambda: ops.attention(q, k, v, **kw))
        r = dict(ms=ms, form=form, shape=[B, Sq, H, hd], keys=[B, Skv, Hkv, hd],
                 causal=causal,
                 plain_ms=time_launches(torch, lambda: plain_attention(q, k, v, **kw),
                                        reps=20, warmup=3),
                 library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=sdpa_causal, enable_gqa=True), reps=20, warmup=3))
        r["bound_ms"], r["bound_by"] = b9_bound(B, Sq, H, Hkv, hd, visible, 2, bw, peak,
                                                causal=causal)
        out[case[0]] = r
        log(f"[{tag}] B9 {case[0]} bf16 q {r['shape']} over {r['keys']} ({r['form']} form): kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms "
            f"({r['ms'] / r['library_ms']:.2f}x SDPA), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%} of it reached), CUDA events")
        del q, k, v, qt, kt, vt
    return out


def vision_train_plan(torch, dev):
    """Vision at its widths is not trained on the card: the smallest cut with
    a cross block (4 layers + 1) still holds the 128256-row embedding and
    head, and four [2, N] f32 planes of it nearly fill the card before any
    activation. Logs the replica and the step's plan (the CLI's own
    step_memory, which refuses what does not fit); runs nothing."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as cli
    cfg = dataclasses.replace(get_config("llama_3_2_vision_11b"),
                              num_layers=VISION_TRAIN_LAYERS)
    rb = cli.replica_bytes(cfg)
    seq = LM_SEQS[0]
    tokens = LM_BATCH * seq
    act = cli.activation_bytes(cfg, tokens, seq)
    free = torch.cuda.mem_get_info(dev)[0]
    gib = 2 ** 30
    try:
        need = cli.step_memory(cfg, LM_W, tokens, seq, dev)
        verdict = (f"step_memory admits {need / gib:.2f} GiB ({need / free:.1%} of the free "
                   "memory); not run")
    except ValueError as e:
        verdict = f"refused by step_memory: {str(e).split(';')[0]}"
    log(f"[cross] {cfg.name} at its widths cut to {VISION_TRAIN_LAYERS} layers + 1 cross block: "
        f"{rb // 4} f32 parameters ({rb / gib:.2f} GiB a replica); at W={LM_W} the 4 planes "
        f"need {4 * LM_W * rb / gib:.2f} GiB and the activations of {tokens} tokens "
        f"{act / gib:.2f} GiB (estimate, remat={cfg.remat}) of {free / gib:.2f} GiB "
        f"free: {verdict}")
    return dict(params=rb // 4, planes_bytes=4 * LM_W * rb, activations_estimate=act,
                free=free, verdict=verdict)


def vision_reduced_train(torch, ops, fa, dev):
    """The reduced vision model trained on the card through launch.train.run
    (sim, W = 2, 10 steps, its zero cond): B1 once a step, B9 never, the
    loss finite and falling."""
    from repro_torch.launch import train as cli
    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    _, hist = cli.run("llama_3_2_vision_11b", **lm_run_kw(reduced=True, steps=LM_REDUCED_STEPS,
                                                         lr=3e-3))
    torch.cuda.synchronize()
    got = {k: ops.launch_counts()[k] for k in KERNELS}
    want = dict.fromkeys(KERNELS, 0)
    want[B1] = LM_REDUCED_STEPS
    losses = [r["loss"] for r in hist]
    if got != want or dict(fa.FORM_LAUNCHES) != forms0 or not all(
            x == x and abs(x) != float("inf") for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"[cross] reduced vision: launches {got}, losses {losses}")
    log(f"[cross] llama-vision-reduced trained on sim W={LM_W}, {LM_REDUCED_STEPS} steps: "
        f"launches {got}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return got


def run_cross_phase(torch, ops, fu, ref, fa, dev, bw, peak, peak_bf16, smi):
    """Phase 16. Returns ({kernel: launches}, {kernel: max abs err}, the B9
    numbers for the kernels line, B1's timing on MusicGen's plane,
    summary)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    err = check_b9_cross(torch, ops, fa, dev)
    times = time_b9_cross(torch, ops, fa, dev, bw, peak_bf16)
    launches = dict.fromkeys(KERNELS, 0)
    summary = {}
    for arch in CROSS_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        n_flow, flow = mla_serve_flow(torch, ops, fa, cfg, dev, tag="cross",
                                      desc=CROSS_DESC[arch],
                                      cross_gate=CROSS_GATE)
        gc.collect()
        torch.cuda.empty_cache()
        L = CROSS_GATE_LAYERS[arch]
        cut = dataclasses.replace(cfg, num_layers=L)
        n_gate, gap = mla_gate(torch, ops, cut, dev, tag="cross",
                               what=f"{cfg.name} at {L} of {cfg.num_layers} layers "
                                    f"({attn_passes(cut)} attentions a step), gates "
                                    f"{CROSS_GATE}, random cond")
        launches[B9] += n_flow + n_gate
        summary[arch] = dict(serve=flow, f32_gate_gap=gap, f32_gate_layers=L)
    gc.collect()
    torch.cuda.empty_cache()
    got, err1, b1, run = lm_train_run(
        torch, ops, fu, ref, fa, dev, bw, peak, "musicgen_large", MUSICGEN_TRAIN_LAYERS, LM_W,
        LM_BATCH, "cross-train", f"published widths, depth cut to {MUSICGEN_TRAIN_LAYERS} of 48 "
        "layers, 4 codebooks, its zero cond")
    for k, n in got.items():
        launches[k] += n
    summary["musicgen_train"] = run
    gc.collect()
    torch.cuda.empty_cache()
    summary["vision_train_plan"] = vision_train_plan(torch, dev)
    for k, n in vision_reduced_train(torch, ops, fa, dev).items():
        launches[k] += n
    summary["b9"] = times
    log(f"[cross] summary ({smi}): {json.dumps(summary, default=str)}")
    return launches, {B1: err1, B9: max(err.values())}, dict(
        max_abs_err_f32=err["float32"], max_abs_err_bf16=err["bfloat16"], **times), b1, summary


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


# ---------------------------------------------------------------------------
# phase 17: grad_accum and model > 1 on the dist engine (TinyLlama-1.1B at
# full width, the reduced model in the reference's model = 2 test), and
# tensor-parallel serving of TinyLlama-1.1B over 2 and 4 ranks on the card
# ---------------------------------------------------------------------------

GA_W, GA_SEQ, GA_PWS, GA_STEPS = 2, 256, (8, 4, 2), 3   # the largest fitting pw is taken
GA_LR, GA_P = 1e-2, 0.25          # p 0.25: fewer 4.4 GB exchanges through gloo
MP_STEPS = 24                        # the reference's protocols test: W 4, pw 2, seq 32
TP_MODELS = (2, 4)
TP_BATCH, TP_PROMPT, TP_TOKENS, TP_MAX_LEN = 8, 512, 32, 1024
TP_TOKENS_M4 = 8                     # M = 4's bf16 run: its steps are the script's slowest
TP_GATE = dict(layers=4, prompt=128, tokens=16, max_len=256)   # the f32 gate, TinyLlama widths
TP_GATE_REL = 1e-5                   # largest |logit diff| / largest |logit|, every step
TP_B9 = tuple(case for M in TP_MODELS for case in (
    (f"M={M} prefill", TP_BATCH, TP_PROMPT, 32 // M, TP_PROMPT, 4 // M, 64, True),
    (f"M={M} decode", TP_BATCH, 1, 32 // M, TP_MAX_LEN, 4 // M, 64, True)))


def _lm_opt_proto(lr, p):
    return (dict(name="nag", learning_rate=lr, momentum=0.9),
            dict(method="elastic_gossip", comm_probability=p, moving_rate=0.5))


def _fired_launches(rec, steps, tag):
    """B1 once a firing step, B2 once a quiet one, nothing else of the
    update: the rank's counts against its replay of the schedule."""
    fired = sum(rec["fired"])
    got = {B1: rec["launches"][B1], B2: rec["launches"][B2]}
    if got != {B1: fired, B2: steps - fired}:
        raise AssertionError(f"[{tag}] launches {got}, want B1 {fired} / B2 {steps - fired}")
    return got


def grad_accum_full(torch, dev):
    """(a) TinyLlama-1.1B whole, f32, on the dist engine at W = 2 ranks:
    the largest per-worker batch whose step plan fits at A = 1, then A = 2
    at that batch, GA_STEPS steps each in one group. Step 1's loss and theta
    at A = 2 within rtol 1e-4 / atol 1e-5 of A = 1, each rank's peak at A = 2
    below its peak at A = 1, B1 / B2 once a step. With remat=False: A = 2
    trades the activations for an f32 accumulator plane, and a
    rematerialised step keeps too little for that trade to lower the peak.
    Returns (launches, summary)."""
    import dataclasses
    from repro_torch.common.config import MeshConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import dist_run
    from repro_torch.launch.train import activation_bytes, step_bytes
    cfg = dataclasses.replace(get_config(LM_ARCH), remat=False)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    plans = {pw: step_bytes(cfg, GA_W, GA_W * pw * GA_SEQ, GA_SEQ) for pw in GA_PWS}
    pw = next((p for p in GA_PWS if plans[p] <= 0.9 * free), None)
    if pw is None:
        raise AssertionError(f"[accum] no per-worker batch of {GA_PWS} fits: {plans}")
    act = {A: activation_bytes(cfg, GA_W * pw * GA_SEQ // A, GA_SEQ) for A in (1, 2)}
    gib = 2 ** 30
    log(f"[accum] {cfg.name} f32 (remat=False) dist W={GA_W}, seq {GA_SEQ}: step plan by "
        "per-worker batch "
        + ", ".join(f"{p}: {plans[p] / gib:.2f} GiB" for p in GA_PWS) + f" of "
        f"{free / gib:.2f} GiB free; taken {pw}; activations (estimate, both ranks) A=1 "
        f"{act[1] / gib:.2f} GiB, A=2 {act[2] / gib:.2f} GiB")
    opt, proto = _lm_opt_proto(GA_LR, GA_P)
    base = dict(protocol=proto, optimizer=opt, steps=GA_STEPS, pw=pw, seq=GA_SEQ)
    job = dict(cfg=cfg, seed=0, runs=[dict(base, tag="A1", grad_accum=1, keep="step1"),
                                      dict(base, tag="A2", grad_accum=2,
                                           against=("A1", "step1"))])
    t0 = time.perf_counter()
    ranks = dist_run.spawn_workers(dist_run.lm_rank, MeshConfig(data=GA_W, model=1, pods=1,
                                                                workers_per_pod=GA_W),
                                   dev, args=(job,), join_timeout_s=900)
    secs = time.perf_counter() - t0
    launches = dict.fromkeys(KERNELS, 0)
    for r, res in enumerate(ranks):
        a1, a2 = res["A1"], res["A2"]
        for tag in ("A1", "A2"):
            for k, n in _fired_launches(res[tag], GA_STEPS, f"accum {tag}").items():
                launches[k] += n
        held = a2["against"]
        l1, l2 = a1["loss"][0], a2["loss"][0]
        log(f"[accum] rank {r}: step 1 loss A=1 {l1:.7f} A=2 {l2:.7f}; theta after step 1 at "
            f"A=2 vs A=1: {held['outside']} of {LM_PARAMS} elements outside rtol 1e-4 / atol "
            f"1e-5, max |diff| {held['max_abs']:.3e}; peak A=1 {a1['peak_bytes'] / gib:.3f} "
            f"GiB, A=2 {a2['peak_bytes'] / gib:.3f} GiB (plan of both ranks "
            f"{plans[pw] / gib:.2f} GiB); losses A=1 {[round(x, 5) for x in a1['loss']]} A=2 "
            f"{[round(x, 5) for x in a2['loss']]}; {a1['seconds']:.1f} / {a2['seconds']:.1f} s")
        if held["outside"] or abs(l1 - l2) > 1e-4 * abs(l1):
            raise AssertionError(f"[accum] rank {r}: A=2 is not A=1 within rtol 1e-4 / atol 1e-5")
        if not a2["peak_bytes"] < a1["peak_bytes"]:
            raise AssertionError(f"[accum] rank {r}: peak at A=2 {a2['peak_bytes']} is not "
                                 f"below A=1's {a1['peak_bytes']}")
    log(f"[accum] launches {dict((k, v) for k, v in launches.items() if v)}; {secs:.1f} s")
    return launches, dict(pw=pw, plans=plans, seconds=secs,
                          ranks=[{t: dict(loss=res[t]["loss"], peak_bytes=res[t]["peak_bytes"],
                                          seconds=res[t]["seconds"],
                                          against=res[t].get("against"))
                                  for t in ("A1", "A2")} for res in ranks])


def model2_dist(torch, dev):
    """(b) The reduced TinyLlama in the reference's model = 2 test's
    configuration (data=4, model=2, 4 workers, pw 2, seq 32, lr 3e-3,
    elastic p 0.5) for MP_STEPS steps, bit-equal to model = 1 on every rank.
    Returns (launches, summary)."""
    from repro_torch.common.config import MeshConfig
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dist_run
    opt, proto = _lm_opt_proto(3e-3, 0.5)
    base = dict(protocol=proto, optimizer=opt, steps=MP_STEPS, pw=2, seq=32)
    job = dict(cfg=get_reduced(LM_ARCH), seed=0, runs=[
        dict(base, tag="model1", mesh=dict(data=4, model=1, pods=1, workers_per_pod=4),
             keep="final"),
        dict(base, tag="model2", mesh=dict(data=4, model=2, pods=1, workers_per_pod=4),
             against=("model1", "final"))])
    t0 = time.perf_counter()
    ranks = dist_run.spawn_workers(dist_run.lm_rank, MeshConfig(data=4, model=1, pods=1,
                                                                workers_per_pod=4),
                                   dev, args=(job,), join_timeout_s=600)
    launches = dict.fromkeys(KERNELS, 0)
    for r, res in enumerate(ranks):
        for tag in ("model1", "model2"):
            for k, n in _fired_launches(res[tag], MP_STEPS, f"model2 {tag}").items():
                launches[k] += n
        same = res["model2"]["against"]["bit_equal"] and res["model2"]["loss"] == \
            res["model1"]["loss"] and res["model2"]["fired"] == res["model1"]["fired"]
        if not same:
            raise AssertionError(f"[model2] rank {r}: model=2 is not bit-equal to model=1")
    l = ranks[0]["model2"]["loss"]
    if not l[-1] < l[0]:
        raise AssertionError(f"[model2] the loss did not fall: {l[0]} -> {l[-1]}")
    log(f"[model2] reduced {LM_ARCH} dist W=4, MeshConfig(data=4, model=2): {MP_STEPS} elastic "
        f"steps bit-equal to model=1 on all 4 ranks (theta, loss, fired); loss {l[0]:.4f} -> "
        f"{l[-1]:.4f}; launches {dict((k, v) for k, v in launches.items() if v)}; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, dict(loss=l, seconds=time.perf_counter() - t0)


def _tp_runs(torch, M):
    """The tensor-parallel runs of (c) and (d) at M ranks (M = 1: the one-device
    program): TinyLlama-1.1B whole in bf16, the f32 gate at TP_GATE's depth,
    and at M in (1, 4) reduced Gemma2 in f32."""
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    cfg = get_config(LM_ARCH)
    runs = [dict(tag="bf16", cfg=cfg, dtype=torch.bfloat16, batch=TP_BATCH,
                 prompt_len=TP_PROMPT, tokens=TP_TOKENS if M < 4 else TP_TOKENS_M4,
                 max_len=TP_MAX_LEN, seed=0),
            dict(tag="gate", cfg=dataclasses.replace(cfg, num_layers=TP_GATE["layers"]),
                 dtype=torch.float32, batch=TP_BATCH, prompt_len=TP_GATE["prompt"],
                 tokens=TP_GATE["tokens"], max_len=TP_GATE["max_len"], seed=0, logits=True)]
    if M in (1, 4):
        runs.append(dict(tag="gemma2", cfg=get_reduced("gemma2_9b"), dtype=torch.float32,
                         batch=4, prompt_len=8, tokens=8, max_len=32, seed=0, logits=True))
    return runs


def _logit_gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def tp_serving(torch, ops, fa, dev, bw, peak_bf16):
    """(c) + (d): B9 at the ranks' local shapes against its plain version
    and timed beside SDPA; then each run of _tp_runs at M = 1 (in this
    process), 2 and 4 (a spawned ModelGroup each), with B9 at exactly
    M x layers x (1 + steps) launches, the collectives of every decode step
    exact, the f32 runs' logits within TP_GATE_REL of M = 1 at every step
    and every greedy token equal. Returns (launches, errs, b9 timings,
    summary)."""
    from repro_torch.common.config import MeshConfig
    from repro_torch.launch import serve_decode as sd
    from repro_torch.launch.mesh import spawn_model_group
    worst = check_b9_cross(torch, ops, fa, dev, cases=TP_B9, tag="tp",
                           what="each rank's heads and kv heads of TinyLlama-1.1B at M = 2 "
                                "and 4: prefill 8 x 512, decode over the 1024-row cache")
    times = time_b9_cross(torch, ops, fa, dev, bw, peak_bf16, cases=TP_B9, tag="tp")
    torch.cuda.empty_cache()
    launches = dict.fromkeys(KERNELS, 0)
    t0 = time.perf_counter()
    res = {1: [sd.tp_rank(sd.OneRank(dev), dict(runs=_tp_runs(torch, 1)))]}
    secs = {1: time.perf_counter() - t0}
    for M in TP_MODELS:
        t0 = time.perf_counter()
        res[M] = spawn_model_group(sd.tp_rank, MeshConfig(data=1, model=M, pods=1,
                                                          workers_per_pod=1),
                                   dev, args=(dict(runs=_tp_runs(torch, M)),),
                                   join_timeout_s=900)
        secs[M] = time.perf_counter() - t0
    gib = 2 ** 30
    summary = {}
    for M, ranks in res.items():
        for tag, rec0 in ranks[0].items():
            run = next(r for r in _tp_runs(torch, M) if r["tag"] == tag)
            L, steps = run["cfg"].num_layers, run["tokens"]
            b9 = sum(r[tag]["launches"][B9] for r in ranks)
            if b9 != M * L * (1 + steps):
                raise AssertionError(f"[tp] M={M} {tag}: B9 launches {b9}, want "
                                     f"{M} x {L} x (1 + {steps})")
            launches[B9] += b9        # each run's counts: set to 0 before it, read after
            want = rec0["expected_per_step"]
            for r in ranks:
                bad = [c for c in r[tag]["step_collectives"]
                       if {k: c[k] for k in want} != want]
                if bad:
                    raise AssertionError(f"[tp] M={M} {tag}: collectives {bad[0]}, want {want}")
            base = res[1][0][tag]
            gap = _logit_gap(rec0["prefill_logits"], base["prefill_logits"])
            n = rec0["stream"].shape[-1]          # M = 4's bf16 run takes fewer steps
            same = float((rec0["stream"] == base["stream"][..., :n]).double().mean())
            line = (f"[tp] {run['cfg'].name} {tag} ({str(run['dtype']).split('.')[-1]}, "
                    f"{L} layers, {run['batch']} x {run['prompt_len']} prompts, {steps} steps) "
                    f"M={M}: prefill {rec0['prefill_ms']:.3f} ms, decode step median "
                    f"{statistics.median(rec0['step_ms']):.3f} ms, collectives "
                    f"{ {k: v for k, v in want.items()} } a step, host "
                    f"{statistics.median(c['host_s'] for c in rec0['step_collectives']) * 1e3:.3f}"
                    f" ms a step; B9 {b9} = {M} x {L} x (1 + {steps}); peak per rank "
                    + ", ".join(f"{r[tag]['peak_bytes'] / gib:.3f}" for r in ranks)
                    + f" GiB; prefill logits gap to M=1 {gap:.3e} of the largest, greedy tokens "
                    f"equal {same:.4f}")
            if rec0["logits"] is not None and M > 1:
                gaps = [_logit_gap(a, b) for a, b in zip(rec0["logits"], base["logits"])]
                line += f"; gate: every step's gap <= {max(gaps):.3e} (limit {TP_GATE_REL})"
                if max(gaps) > TP_GATE_REL or same != 1.0:
                    raise AssertionError(f"[tp] M={M} {tag}: logits gap {max(gaps)} or greedy "
                                         f"tokens equal {same}")
            log(line)
            summary[f"M={M} {tag}"] = dict(
                prefill_ms=rec0["prefill_ms"], step_ms=statistics.median(rec0["step_ms"]),
                collective_ms=statistics.median(c["host_s"] for c in
                                                rec0["step_collectives"]) * 1e3,
                peak_gib=[r[tag]["peak_bytes"] / gib for r in ranks], b9=b9,
                prefill_gap=gap, greedy_equal=same)
    log(f"[tp] seconds by M: {secs}")
    return launches, worst, times, summary


def run_tp_phase(torch, ops, fa, dev, bw, peak_bf16, smi):
    """Phase 17. Returns ({kernel: launches}, {kernel: max abs err}, B9's
    timings at the local shapes, summary)."""
    launches = dict.fromkeys(KERNELS, 0)
    ga_launches, ga = grad_accum_full(torch, dev)
    mp_launches, mp = model2_dist(torch, dev)
    tp_launches, worst, times, tp = tp_serving(torch, ops, fa, dev, bw, peak_bf16)
    for got in (ga_launches, mp_launches, tp_launches):
        for k, n in got.items():
            launches[k] += n
    errs = {B9: max(worst.values())}
    log(f"[tp] launches in phase 17: {dict((k, v) for k, v in launches.items() if v)}; "
        f"summary ({smi}): {json.dumps(dict(accum=ga, model2=mp, tp=tp), default=str)}")
    return launches, errs, times, dict(accum=ga, model2=mp, tp=tp)


# ---------------------------------------------------------------------------
# phase 18: tensor-parallel serving of the MoE, MLA, SSM / hybrid and
# cross-attention models (DeepSeek-V2-Lite-16B whole in bf16 over 2 ranks)
# ---------------------------------------------------------------------------

# the bf16 runs at M = 2 (xLSTM also at 4): published widths, depth cut for
# the script's time (DeepSeek 9 of 27 layers: the dense one and 8 MoE;
# Zamba2 18 of 54: 3 segments and their shared sites; vision 10 of 40 with
# its cross blocks among them; xLSTM whole)
TPK_BF16 = dict(deepseek_v2_lite_16b=dict(prompt=512, tokens=8, layers=9),
                zamba2_2_7b=dict(prompt=256, tokens=8, layers=18),
                xlstm_125m=dict(prompt=256, tokens=8),
                llama_3_2_vision_11b=dict(prompt=256, tokens=8, layers=10))
# B9 on each rank at M = 2 in TPK_BF16's runs: (tag, B, Sq, H, Skv, Hkv, hd,
# dv, causal, a decode query's position). A prefill attends over its
# prompt, a decode over the SERVE_MAX_LEN-row cache from the first step's
# position (the prompt's length), the cross-attention over 1601 image
# tokens; MLA's keys are [c_kv ; k_rope] (576) over 512-wide values, 8 of
# 16 heads; Zamba2's shared blocks 16 of 32 heads of 80; vision 16 of 32
# heads over 4 of 8 kv heads, hd 128 (xLSTM has no attention)
_P = {arch: kw["prompt"] for arch, kw in TPK_BF16.items()}
TPK_B9 = tuple(case for tag, arch, H, Hkv, hd, dv in (
    ("MLA", "deepseek_v2_lite_16b", 8, 1, 576, 512), ("Zamba2", "zamba2_2_7b", 16, 16, 80, 80),
    ("vision self", "llama_3_2_vision_11b", 16, 4, 128, 128))
    for case in ((f"{tag} prefill", SERVE_BATCH, _P[arch], H, _P[arch], Hkv, hd, dv, True, 0),
                 (f"{tag} decode", SERVE_BATCH, 1, H, SERVE_MAX_LEN, Hkv, hd, dv, True,
                  _P[arch]))) + tuple(
    (f"vision cross {what}", SERVE_BATCH, sq, 16, 1601, 4, 128, 128, False, 0)
    for what, sq in (("prefill", _P["llama_3_2_vision_11b"]), ("decode", 1)))
# the f32 gates: full widths, depth cut (Zamba2's 7 layers hold one shared
# site; xLSTM's 6 its first sLSTM layer; vision's 4 its first cross block)
TPK_GATE_LAYERS = dict(deepseek_v2_lite_16b=2, zamba2_2_7b=7, xlstm_125m=6,
                       musicgen_large=2, llama_3_2_vision_11b=4)
TPK_GATE = dict(batch=8, prompt=128, tokens=8, max_len=256)
# The split itself is held in f64 (each gate's run in f64 at M ranks, the
# group reducing in f64, attention through f64_attention) against the
# one-device f64 program, within TPK_F64_GATE of the largest logit: f64
# rounding moves them ~1e-15 apart (reduced models on the CPU), so a fault
# of the split shows far below the f32 noise. In f32, where rounding alone
# moves M = 1's logits from the f64 program's by more than TP_GATE_REL
# (Zamba2, xLSTM, vision at these depths), M ranks may sit at most this
# factor farther from it: two independent f32 roundings of one computation
# differ by up to ~2x either one's distance from f64
TP_F64_FACTOR = 2.0
TPK_F64_GATE = 1e-10


def b9_local_case(torch, dev, dt, case, seed):
    """(q, k, v, kwargs, visible keys) of a TPK_B9 case in ``dt``; MLA's
    values are the keys' 512-wide prefix, as the model passes them."""
    tag, B, Sq, H, Skv, Hkv, hd, dv, causal, pos = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).to(dt)
    v = k[..., :dv] if dv < hd else torch.randn(B, Skv, Hkv, dv, generator=g,
                                                 device=dev).to(dt)
    kw, visible = dict(causal=causal), Skv
    if Sq == 1 and causal:
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        kw.update(q_offset=p, kv_len=p + 1)
        visible = pos + 1
    return q, k, v, kw, visible


def b9_local_bound(case, visible, bw, peak):
    """(bound ms, by) in bf16 (``roofline.b9_cost``): q, the visible key rows
    (and value rows unless they are the keys' prefix) and out moved once,
    against 2 (hd + dv) flops per (query row, visible key) at the bf16
    tensor-core peak."""
    from repro_torch.analysis import roofline
    _, B, Sq, H, Skv, Hkv, hd, dv, causal, _ = case
    return bound(roofline.b9_cost(B, Sq, H, Hkv, hd, visible, dv=dv, causal=causal), peak, bw)


def tp_kinds_b9(torch, ops, fa, dev, bw, peak_bf16):
    """B9 at each rank's shapes of TPK_B9 against its plain version (f32
    and bf16, phase 6's tolerances; split form in decode, wgmma for every
    bf16 prefill but MLA's (mma: its own kernel, over the keys' prefix),
    simt for the f32 ones), then timed in bf16 beside its plain version and
    SDPA, and the MLA and Zamba2 prefills also device alone.
    Returns (max abs err by dtype, timings)."""
    import torch.nn.functional as F
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        worst[name] = 0.0
        for i, case in enumerate(TPK_B9):
            q, k, v, kw, _ = b9_local_case(torch, dev, dt, case, 90 + i)
            form = ("split" if q.shape[1] == 1 else "simt" if dt == torch.float32 else
                    "mma" if v.shape[-1] < q.shape[-1] else "wgmma")
            n, f0 = fa.LAUNCHES, fa.FORM_LAUNCHES[form]
            got = ops.attention(q, k, v, **kw)
            want = plain_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if fa.LAUNCHES != n + 1 or fa.FORM_LAUNCHES[form] != f0 + 1:
                raise RuntimeError(f"[tp-kinds] B9 {case[0]} {name}: launches "
                                   f"{fa.LAUNCHES - n}, forms {dict(fa.FORM_LAUNCHES)} "
                                   f"(want {form})")
            worst[name] = max(worst[name], b9_err(case[0], got, want))
            del q, k, v, got, want
        log(f"[tp-kinds] B9 vs plain version at each rank's shapes at M = 2 in the bf16 runs "
            f"(MLA 8 heads of 576 / 512, Zamba2 16 of 80, vision 16 over 4 kv heads of 128, "
            f"self and over 1601 image tokens; prefill at {sorted(set(_P.values()))}-token "
            f"prompts, decode at the first step's position of the {SERVE_MAX_LEN}-row cache), "
            f"{name}: {len(TPK_B9)} cases, max abs err {worst[name]:.3e} (tolerance "
            f"{B9_TOL[name]}" + (", and 2^-6 max |plain| per case" if dt == torch.bfloat16
                                 else "") + ")")
    times = {}
    for i, case in enumerate(TPK_B9):
        q, k, v, kw, visible = b9_local_case(torch, dev, torch.bfloat16, case, 110 + i)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (a[:, :visible].transpose(1, 2) for a in (k, v))
        sdpa_causal = case[8] and case[2] > 1
        ms, form = timed_form(torch, fa, lambda: ops.attention(q, k, v, **kw))
        r = dict(ms=ms, form=form, shape=list(q.shape), keys=list(k.shape),
                 values=list(v.shape), causal=case[8],
                 plain_ms=time_launches(torch, lambda: plain_attention(q, k, v, **kw),
                                        reps=20, warmup=3),
                 library_ms=time_launches(torch, lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=sdpa_causal, enable_gqa=True), reps=20, warmup=3))
        r["bound_ms"], r["bound_by"] = b9_local_bound(case, visible, bw, peak_bf16)
        if case[0] in ("MLA prefill", "Zamba2 prefill"):
            device_alone(torch, fa, r, lambda: ops.attention(q, k, v, **kw),
                         "flash_attention_mla_kernel" if case[6] == MLA_HD
                         else "flash_attention_wgmma_kernel")
        times[case[0]] = r
        log(f"[tp-kinds] B9 {case[0]} bf16 q {r['shape']} over {r['keys']} values "
            f"{r['values']} ({form} form): kernel {ms:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"SDPA {r['library_ms']:.4f} ms ({ms / r['library_ms']:.2f}x SDPA), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['bound_ms'] / ms:.1%} of it reached), "
            "CUDA events" + (f"; {seen_text(r)}" if "device_seen" in r else ""))
        del q, k, v, qt, kt, vt
    return worst, times


def _tpk_runs(torch, M):
    """The runs of phase 18 at M ranks (M = 1: the one-device program, the
    f32 gates only): at M = 2 TPK_BF16's models whole in bf16 and every f32
    gate; at M = 4 xLSTM-125M whole and its gate."""
    import dataclasses
    from repro_torch.configs import get_config
    runs = []
    if M > 1:
        for arch, kw in TPK_BF16.items():
            if M == 2 or arch == "xlstm_125m":
                cfg = get_config(arch)
                cfg = dataclasses.replace(cfg, num_layers=kw.get("layers", cfg.num_layers))
                runs.append(dict(tag=f"{arch} bf16", cfg=cfg, dtype=torch.bfloat16,
                                 batch=SERVE_BATCH, prompt_len=kw["prompt"],
                                 tokens=kw["tokens"], max_len=SERVE_MAX_LEN, seed=0,
                                 cross_gate=CROSS_GATE))
    for arch, L in TPK_GATE_LAYERS.items():
        if M != 4 or arch == "xlstm_125m":
            cfg = dataclasses.replace(get_config(arch), num_layers=L)
            runs.append(dict(tag=f"{arch} gate", cfg=cfg, dtype=torch.float32,
                             batch=TPK_GATE["batch"], prompt_len=TPK_GATE["prompt"],
                             tokens=TPK_GATE["tokens"], max_len=TPK_GATE["max_len"], seed=0,
                             cross_gate=CROSS_GATE, logits=True, routes=cfg.moe is not None))
    return runs


def f64_attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0, kv_len=None,
                  kv_start=None):
    """The model's own online-softmax attention (f64 stays f64) behind the
    op's signature, for the f64 runs: B9 takes f32 and bf16, and its plain
    version computes in f32, whose rounding would move with the rank's
    head count (the card's matmuls pick their algorithm by shape)."""
    from repro_torch.models.attention import online_softmax_attention
    return online_softmax_attention(q, k, v, causal=causal, window=window,
                                    logit_softcap=softcap, q_offset=q_offset, kv_len=kv_len,
                                    kv_start=kv_start, chunk=min(1024, k.shape[1]))


def _tpk_f64(torch, runs):
    """The f32 gate runs of ``runs`` in f64, tagged ``<arch> f64``."""
    return [dict(r, tag=r["tag"].replace(" gate", " f64"), dtype=torch.float64)
            for r in runs if r.get("logits")]


def tpk_rank(group, job):
    """A rank of phase 18 (module level, so ``spawn`` can import it):
    ``job["runs"]`` through ``serve_decode.tp_rank``, then ``job["f64"]``
    with attention through :func:`f64_attention`."""
    from unittest import mock
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_decode as sd
    out = sd.tp_rank(group, dict(runs=job["runs"]))
    with mock.patch.object(ops, "attention", f64_attention):
        out.update(sd.tp_rank(group, dict(runs=job["f64"])))
    return out


def tp_kinds_check(torch, M, ranks, base, truth, gib):
    """Holds every run of one group: B9 exactly M x attentions x (1 +
    steps) (none in f64), every decode step's and the prefill's collectives
    equal to the program's count, the MoE routing ids equal on every rank
    and to M = 1's, every greedy token equal to M = 1's, each f64 run's
    logits at every step within TPK_F64_GATE of the largest of the
    one-device f64 program's (``truth``: the same weights and inputs), and each f32
    gate's within TP_GATE_REL of M = 1's or no farther from the f64
    program's than TP_F64_FACTOR times M = 1's own f32 distance from it.
    Every run is logged before a failed gate raises. Returns ({run tag:
    summary}, B9 launches)."""
    out, b9_total, failed = {}, 0, []
    runs = _tpk_runs(torch, M)
    for run in runs + _tpk_f64(torch, runs):
        tag, cfg = run["tag"], run["cfg"]
        f64 = run["dtype"] == torch.float64
        recs = [r[tag] for r in ranks]
        rec0, steps = recs[0], run["tokens"]
        b9 = sum(r["launches"][B9] for r in recs)
        want_b9 = 0 if f64 else M * attn_passes(cfg) * (1 + steps)
        if b9 != want_b9:
            raise AssertionError(f"[tp-kinds] M={M} {tag}: B9 launches {b9}, want {want_b9}")
        b9_total += b9
        want = rec0["expected_per_step"]
        for r in recs:
            bad = [c for c in r["step_collectives"] if {k: c[k] for k in want} != want]
            pre = {k: r["prefill_collectives"][k] for k in want}
            if bad or pre != want:
                raise AssertionError(f"[tp-kinds] M={M} {tag}: collectives "
                                     f"{bad[0] if bad else pre}, want {want} a step and a "
                                     "prefill")
        if run.get("routes"):
            for r in recs[1:]:
                if len(r["routes"]) != len(rec0["routes"]) or not all(
                        (a == b).all() for a, b in zip(r["routes"], rec0["routes"])):
                    raise AssertionError(f"[tp-kinds] M={M} {tag}: routing ids differ by rank")
        kinds = "; ".join(f"{k} {c['all_reduce']} + {c['all_gather']}"
                          for k, c in rec0["expected_by_kind"].items()
                          if c["all_reduce"] or c["all_gather"])
        line = (f"[tp-kinds] {cfg.name} {tag.split()[-1]} ({str(run['dtype']).split('.')[-1]}, "
                f"{cfg.num_layers} layers, {run['batch']} x {run['prompt_len']} prompts, {steps} "
                f"steps) M={M}: prefill {rec0['prefill_ms']:.3f} ms, decode step median "
                f"{statistics.median(rec0['step_ms']):.3f} ms; collectives a step and a prefill "
                f"{want} (by kind, all-reduces + all-gathers: {kinds}), host "
                f"{statistics.median(c['host_s'] for c in rec0['step_collectives']) * 1e3:.3f} ms "
                f"a step, {rec0['prefill_collectives']['host_s'] * 1e3:.1f} ms in the prefill; "
                f"B9 {b9} = {M} x {0 if f64 else attn_passes(cfg)} x (1 + {steps}); placed "
                + ", ".join(f"{r['placed_bytes'] / gib:.3f}" for r in recs) + " GiB, peak "
                + ", ".join(f"{(r['peak_bytes'] or 0) / gib:.3f}" for r in recs)
                + f" GiB a rank, card used up to "
                f"{max(r['card_bytes'] or 0 for r in recs) / gib:.3f} GiB (every process)")
        summ = dict(prefill_ms=rec0["prefill_ms"], step_ms=statistics.median(rec0["step_ms"]),
                    collective_ms=statistics.median(c["host_s"] for c in
                                                    rec0["step_collectives"]) * 1e3,
                    collectives=want, by_kind=rec0["expected_by_kind"],
                    placed_gib=[r["placed_bytes"] / gib for r in recs],
                    peak_gib=[(r["peak_bytes"] or 0) / gib for r in recs],
                    card_gib=max(r["card_bytes"] or 0 for r in recs) / gib, b9=b9)
        if run.get("routes"):
            line += f"; routing ids equal on all {M} ranks ({len(rec0['routes'])} MoE calls)"
        if run.get("logits"):
            one = truth[tag] if f64 else base[tag]
            gap = max(_logit_gap(a, b) for a, b in zip(rec0["logits"], one["logits"]))
            same = bool(torch.equal(rec0["stream"], one["stream"]))
            routes = not run.get("routes") or (len(rec0["routes"]) == len(one["routes"]) and all(
                (a == b).all() for a, b in zip(rec0["routes"], one["routes"])))
            if f64:
                close = gap <= TPK_F64_GATE
                line += (f"; split gate (f64): every step's gap to M=1's f64 "
                         f"<= {gap:.3e} of the largest logit (limit {TPK_F64_GATE})")
            else:
                ref = truth[tag.replace(" gate", " f64")]
                f32_err = max(_logit_gap(a, b.float()) for a, b in zip(one["logits"],
                                                                         ref["logits"]))
                tp_err = max(_logit_gap(a, b.float()) for a, b in zip(rec0["logits"],
                                                                        ref["logits"]))
                close = gap <= TP_GATE_REL or tp_err <= TP_F64_FACTOR * f32_err
                line += (f"; f32 gate: every step's gap to M=1 <= {gap:.3e} of the largest logit "
                         f"(limit {TP_GATE_REL}), against the f64 program M={M} {tp_err:.3e} and "
                         f"M=1 {f32_err:.3e} (limit {TP_F64_FACTOR} x M=1's)")
                summ.update(f32_err=f32_err, f64_gap=tp_err)
            line += f", greedy tokens equal {same}"
            if run.get("routes"):
                line += f", routing ids equal to M=1 {routes}"
            if not (close and same and routes):
                failed.append(f"{tag}: logits gap {gap}, greedy tokens equal {same}, routing "
                              f"ids equal to M=1 {routes}")
            summ.update(gate_gap=gap, greedy_equal=same)
        log(line)
        out[f"M={M} {tag}"] = summ
    if failed:
        raise AssertionError(f"[tp-kinds] M={M}: " + "; ".join(failed))
    return out, b9_total


def run_tp_kinds_phase(torch, ops, fa, dev, bw, peak_bf16, smi):
    """Phase 18. Returns ({kernel: launches}, {kernel: max abs err}, B9's
    timings at the local shapes, summary)."""
    import gc
    from unittest import mock
    from repro_torch.common.config import MeshConfig
    from repro_torch.launch import serve_decode as sd
    from repro_torch.launch.mesh import spawn_model_group
    worst, times = tp_kinds_b9(torch, ops, fa, dev, bw, peak_bf16)
    gc.collect()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    launches = dict.fromkeys(KERNELS, 0)
    secs, summary = {}, {}
    t0 = time.perf_counter()
    base = sd.tp_rank(sd.OneRank(dev), dict(runs=_tpk_runs(torch, 1)))
    secs[1] = time.perf_counter() - t0
    for tag, rec in base.items():
        launches[B9] += rec["launches"][B9]
    gc.collect()
    torch.cuda.empty_cache()
    # the gates' one-device f64 program
    with mock.patch.object(ops, "attention", f64_attention):
        truth = sd.tp_rank(sd.OneRank(dev), dict(runs=_tpk_f64(torch, _tpk_runs(torch, 1))))
    secs["1 f64"] = time.perf_counter() - t0 - secs[1]
    gc.collect()
    torch.cuda.empty_cache()
    for M in (2, 4):
        t0 = time.perf_counter()
        runs = _tpk_runs(torch, M)
        ranks = spawn_model_group(tpk_rank, MeshConfig(data=1, model=M, pods=1,
                                                       workers_per_pod=1),
                                  dev, args=(dict(runs=runs, f64=_tpk_f64(torch, runs)),),
                                  join_timeout_s=900)
        secs[M] = time.perf_counter() - t0
        got, b9 = tp_kinds_check(torch, M, ranks, base, truth, gib)
        summary.update(got)
        launches[B9] += b9
    log(f"[tp-kinds] seconds by M: { {M: round(v, 1) for M, v in secs.items()} }; "
        f"summary ({smi}): {json.dumps(dict(runs=summary, b9=times), default=str)}")
    return launches, {B9: max(worst.values())}, dict(
        max_abs_err_f32=worst["float32"], max_abs_err_bf16=worst["bfloat16"], **times), summary


# ---------------------------------------------------------------------------
# phase 19: the planning tools (common.hardware, analysis, launch.specs,
# launch.dryrun) against the card
# ---------------------------------------------------------------------------

PLAN_COPY_BYTES = 2 * 2 ** 30        # the HBM copy's source (>= 2 GiB)
PLAN_MATMUL = 8192                   # the bf16 matmul's M = N = K
PLAN_RATE_LIMIT = 1.05               # a measured rate above spec x this fails
PLAN_SHARE_LIMIT = 1.05              # a counted roofline share above this fails
PLAN_PEAK_LIMITS = (0.75, 1.33)      # max_memory_allocated over the plan's bytes
PLAN_STEPS = 8                       # timed runs of each counted program
# the sweep's cells run in this phase (the serving programs on one mesh:
# each counts in about a second on the CPU); the training cells and
# xLSTM-125M's prefill (its sLSTM loops over 32,768 steps) are left to the
# CPU sweep (PERF.md §6)
PLAN_SWEEP_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
PLAN_SWEEP_SKIP = {("xlstm_125m", "prefill_32k")}


def spec_vs_card(torch, dev, spec, smi):
    """The spec's figures beside the card's properties; the HBM copy rate
    (a device-to-device copy_ of PLAN_COPY_BYTES, read and written) and
    the bf16 dense matmul rate at 8192^3, each the median of 20 by CUDA
    events. Raises if either exceeds its spec figure by PLAN_RATE_LIMIT."""
    props = torch.cuda.get_device_properties(0)
    log(f"[plan] {smi}: chip_spec {spec.name!r}: bf16 dense {spec.peak_bf16_flops / 1e12:.0f} "
        f"TFLOP/s, f32 {spec.peak_f32_flops / 1e12:.0f} TFLOP/s, HBM "
        f"{spec.hbm_bandwidth / 1e12:.2f} TB/s and {spec.hbm_capacity / 2 ** 30:.1f} GiB, NVLink "
        f"{spec.nvlink_bandwidth / 1e9:.0f} GB/s a direction over {spec.nvlink_links} links, "
        f"inter-node {spec.internode_bandwidth / 1e9:.0f} GB/s, shared memory "
        f"{spec.smem_bytes_per_sm // 1024} KiB an SM; the card: {props.name}, total memory "
        f"{props.total_memory / 2 ** 30:.2f} GiB, {props.multi_processor_count} SMs")
    src = torch.empty(PLAN_COPY_BYTES, dtype=torch.uint8, device=dev).fill_(1)
    dst = torch.empty_like(src)
    copy_ms = time_launches(torch, lambda: dst.copy_(src), reps=20, warmup=3)
    del src, dst
    g = torch.Generator(device=dev).manual_seed(190)
    a, b = (torch.randn(PLAN_MATMUL, PLAN_MATMUL, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    mm_ms = time_launches(torch, lambda: torch.matmul(a, b), reps=20, warmup=3)
    del a, b
    torch.cuda.empty_cache()
    bw = 2 * PLAN_COPY_BYTES / (copy_ms * 1e-3)
    rate = 2 * PLAN_MATMUL ** 3 / (mm_ms * 1e-3)
    out = dict(copy_ms=copy_ms, hbm_bytes_s=bw, hbm_share=bw / spec.hbm_bandwidth,
               matmul_ms=mm_ms, bf16_flops_s=rate, bf16_share=rate / spec.peak_bf16_flops,
               total_memory=props.total_memory, sms=props.multi_processor_count)
    log(f"[plan] {smi}: HBM copy of {PLAN_COPY_BYTES / 2 ** 30:.0f} GiB {copy_ms:.4f} ms "
        f"(median of 20) = {bw / 1e12:.3f} TB/s read + written, {out['hbm_share']:.3f} of "
        f"the spec's {spec.hbm_bandwidth / 1e12:.2f}; bf16 matmul {PLAN_MATMUL}^3 "
        f"{mm_ms:.4f} ms = {rate / 1e12:.1f} TFLOP/s, {out['bf16_share']:.3f} of the spec's "
        f"{spec.peak_bf16_flops / 1e12:.0f} (limit {PLAN_RATE_LIMIT} each)")
    if out["hbm_share"] > PLAN_RATE_LIMIT or out["bf16_share"] > PLAN_RATE_LIMIT:
        raise AssertionError(f"the card beats chip_spec({props.name!r}): HBM "
                             f"{out['hbm_share']:.3f}, bf16 {out['bf16_share']:.3f} of the spec")
    return out


def roofline_terms(costs, spec, dtype):
    """(compute, memory, collective) seconds of a counted program."""
    return (costs.flops / spec.peak_flops(dtype), costs.bytes_accessed / spec.hbm_bandwidth,
            costs.collective_bytes / spec.nvlink_bandwidth)


def plan_report(tag, costs, spec, dtype, ms, smi, plan_bytes=None, peak=None):
    """Log a counted program's terms beside its measured median ms; raise if
    the bound over the time exceeds PLAN_SHARE_LIMIT, or the peak over the
    plan leaves PLAN_PEAK_LIMITS. Returns the reading."""
    terms = roofline_terms(costs, spec, dtype)
    names = ("compute", "memory", "collective")
    lower = max(terms)
    share = lower / (ms * 1e-3)
    rec = dict(flops=costs.flops, bytes=costs.bytes_accessed,
               collective_bytes=costs.collective_bytes,
               t_compute_s=terms[0], t_memory_s=terms[1], t_collective_s=terms[2],
               bottleneck=names[terms.index(lower)], bound_ms=lower * 1e3, ms=ms, share=share,
               kernels={k: n for k, n in costs.ops.items() if k in KERNELS})
    line = (f"[plan] {smi}: {tag}: counted {costs.flops:.4e} FLOPs, {costs.bytes_accessed:.4e} "
            f"bytes, kernels {rec['kernels']}; bound {lower * 1e3:.4f} ms "
            f"({rec['bottleneck']}; compute {terms[0] * 1e3:.4f}, memory {terms[1] * 1e3:.4f} "
            f"ms) against {ms:.4f} ms measured (median of {PLAN_STEPS}): roofline share "
            f"{share:.4f} (limit {PLAN_SHARE_LIMIT})")
    if plan_bytes is not None:
        rec.update(plan_bytes=plan_bytes, peak_bytes=peak, peak_over_plan=peak / plan_bytes)
        line += (f"; max_memory_allocated {peak / 2 ** 30:.3f} GiB against the plan's "
                 f"argument + temp {plan_bytes / 2 ** 30:.3f} GiB: {peak / plan_bytes:.3f} "
                 f"(limits {PLAN_PEAK_LIMITS})")
    log(line)
    if share > PLAN_SHARE_LIMIT:
        raise AssertionError(f"{tag}: the counted bound is {share:.3f} of the measured time")
    if plan_bytes is not None and not PLAN_PEAK_LIMITS[0] <= peak / plan_bytes <= \
            PLAN_PEAK_LIMITS[1]:
        raise AssertionError(f"{tag}: peak over plan {peak / plan_bytes:.3f} outside "
                             f"{PLAN_PEAK_LIMITS}")
    return rec


def timed_median_ms(torch, fn, n=PLAN_STEPS, warmup=2):
    """Median ms of n synchronised calls (CUDA events around each)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def plan_mlp_step(torch, ops, dev, spec, smi):
    """The main path's sim step at W = 8, batch 16, counted on meta and run
    on the card. Returns ({kernel: launches}, the reading)."""
    from repro_torch.analysis import opcount
    W, batch = 8, 16
    trainer = make_trainer(torch, W, dev)
    state = trainer.init_state(0)
    g = torch.Generator(device=dev).manual_seed(191)
    x = torch.randn(W, batch, 784, generator=g, device=dev)
    y = torch.randint(0, 10, (W, batch), generator=g, device=dev, dtype=torch.int32)
    meta = torch.device("meta")
    draws = (torch.empty(W, dtype=torch.bool, device=meta),
             torch.empty(W, dtype=torch.int64, device=meta))
    _, costs = opcount.count(trainer.sim._step, opcount.to_meta(state), opcount.to_meta(x),
                             opcount.to_meta(y), draws=draws)
    ops.zero_launch_counts()
    holder = [state]

    def step():
        holder[0], _ = trainer.sim._step(holder[0], x, y)

    ms = timed_median_ms(torch, step)
    launches = ops.launch_counts()
    if launches[B1] != PLAN_STEPS + 2 or costs.ops.get(B1) != 1:
        raise AssertionError(f"[plan] MLP step: B1 launched {launches[B1]} times in "
                             f"{PLAN_STEPS + 2} steps, counted {costs.ops.get(B1)} a step")
    rec = plan_report(f"MLP sim step W={W} batch {batch}/worker f32", costs, spec,
                      torch.float32, ms, smi)
    return launches, rec


def plan_lm(torch, ops, fa, dev, spec, smi, arch, layers=None):
    """Prefill (8 x 512) and, for TinyLlama, a decode step from position 512
    of an [8, 1024] cache, bf16: counted on meta (specs.serve_program, its
    memory plan) and run on the card on init_lm weights. Returns ({kernel:
    launches}, readings)."""
    import gc
    from repro_torch.analysis import opcount
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.serving.engine import make_serve_program
    import dataclasses
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    B, S, max_len = SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN
    kinds = ("prefill", "decode") if arch == SERVE_ARCH else ("prefill",)
    counted = {}
    for kind in kinds:
        prog = specs.serve_program(cfg, kind, batch=B, seq=S, max_len=max_len)
        _, costs = opcount.count(prog.fn, *prog.args)
        counted[kind] = (prog, costs)
    gc.collect()
    torch.cuda.empty_cache()
    sp = make_serve_program(cfg, batch=B, max_len=max_len, with_prefill=True, device=dev)
    base = torch.cuda.memory_allocated()
    params = sp.init_params(torch.Generator(device=dev).manual_seed(192))
    g = torch.Generator(device=dev).manual_seed(193)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev,
                           dtype=torch.int32)
    torch.cuda.synchronize()
    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    torch.cuda.reset_peak_memory_stats()
    ms = timed_median_ms(torch, lambda: sp.prefill_fn(params, tokens), warmup=1)
    peak = torch.cuda.max_memory_allocated() - base
    name = cfg.name + (f" ({layers} layers)" if layers else "")
    prog, costs = counted["prefill"]
    out = {"prefill": plan_report(
        f"{name} bf16 prefill {B} x {S}", costs, spec, torch.bfloat16, ms, smi,
        prog.argument_bytes + prog.temp_bytes, peak)}
    launches = ops.launch_counts()
    forms = {f: fa.FORM_LAUNCHES[f] - forms0[f] for f in forms0}
    want = (PLAN_STEPS + 1) * cfg.num_layers
    # a bf16 prefill takes the tensor cores: TinyLlama's head dim 64 the
    # wgmma form, DeepSeek's MLA (576-wide keys over their 512-wide prefix)
    # the mma form
    tc = "mma" if cfg.mla else "wgmma"
    if (launches[B9] != want or costs.ops.get(B9) != cfg.num_layers
            or forms != {**dict.fromkeys(forms0, 0), tc: want}):
        raise AssertionError(f"[plan] {name} prefill: B9 launched {launches[B9]} by form "
                             f"{forms} (want {want}, all {tc}), counted {costs.ops.get(B9)} "
                             f"a prefill")
    if "decode" in counted:
        logits, cache = sp.prefill_fn(params, tokens)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        del logits
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        n0 = fa.LAUNCHES
        holder = [cache]

        def step():
            lg, holder[0] = sp.decode_fn(params, holder[0], tok)

        ms = timed_median_ms(torch, step)
        peak = torch.cuda.max_memory_allocated() - base
        prog, costs = counted["decode"]
        out["decode"] = plan_report(
            f"{name} bf16 decode step at positions {S}-{S + PLAN_STEPS + 1} of {max_len}",
            costs, spec, torch.bfloat16, ms, smi, prog.argument_bytes + prog.temp_bytes, peak)
        if fa.LAUNCHES - n0 != (PLAN_STEPS + 2) * cfg.num_layers:
            raise AssertionError(f"[plan] {name} decode: B9 launched {fa.LAUNCHES - n0}")
        launches = ops.launch_counts()
        forms = {f: fa.FORM_LAUNCHES[f] - forms0[f] for f in forms0}
        del holder, cache
    log(f"[plan] {name}: launches {dict((k, v) for k, v in launches.items() if v)}, "
        f"B9 by form {forms}")
    del params, tokens, sp
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def plan_sweep(smi):
    """The dry-run's serving cells on the one-pod mesh, in this process (no
    card: the meta device). Returns the records' headline numbers."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import dryrun
    out_root = os.path.join(HERE, "build", "chip_smoke_dryrun")
    t0 = time.perf_counter()
    rows, skipped = [], []
    for arch in ARCH_IDS:
        for shape in PLAN_SWEEP_SHAPES:
            if (arch, shape) in PLAN_SWEEP_SKIP:
                skipped.append(f"{arch} x {shape}")
                continue
            for rec in dryrun.run_cell(arch, shape, multi_pod=False, force=True,
                                       out_root=out_root):
                if rec["status"] != "ok":
                    raise AssertionError(f"[plan] dry run {arch} x {shape}: {rec['error']}")
                rows.append(rec)
    secs = time.perf_counter() - t0
    for r in rows:
        mem = r["memory_analysis"]
        log(f"[plan] dry run {r['arch']} x {r['shape']} ({r['program']}): fits {r['fits']} "
            f"(argument {mem['argument_size_in_bytes'] / 2 ** 30:.3f} + temp "
            f"{mem['temp_size_in_bytes'] / 2 ** 30:.3f} GiB), bottleneck {r['bottleneck']} "
            f"(compute {r['t_compute_s'] * 1e3:.4f}, memory {r['t_memory_s'] * 1e3:.4f}, "
            f"collective {r['t_collective_s'] * 1e3:.4f} ms), count {r['count_seconds']:.2f} s")
    log(f"[plan] {smi}: dry run of {len(rows)} serving cells on pod16x16 in {secs:.1f} s; "
        f"left to the CPU sweep: every train_4k cell, {', '.join(skipped)}")
    return dict(cells=len(rows), seconds=secs, skipped=skipped)


def run_plan_phase(torch, ops, fa, dev, smi, kind):
    """Phase 19. Returns ({kernel: launches}, summary)."""
    from repro_torch.common.hardware import chip_spec
    spec = chip_spec(kind)
    launches = dict.fromkeys(KERNELS, 0)
    summary = {"spec": spec_vs_card(torch, dev, spec, smi)}
    got, summary["mlp"] = plan_mlp_step(torch, ops, dev, spec, smi)
    for k, n in got.items():
        launches[k] += n
    for arch, layers in ((SERVE_ARCH, None), (MLA_ARCH, MLA_GATE_LAYERS)):
        got, summary[arch] = plan_lm(torch, ops, fa, dev, spec, smi, arch, layers)
        for k, n in got.items():
            launches[k] += n
    summary["sweep"] = plan_sweep(smi)
    log(f"[plan] launches in phase 19: {dict((k, v) for k, v in launches.items() if v)}; "
        f"summary ({smi}): {json.dumps(summary, default=str)}")
    return launches, summary


# ---------------------------------------------------------------------------
# phase 20: rematerialisation in LM training (cfg.remat, common/remat.py)
# ---------------------------------------------------------------------------

RM_STEPS = 3
RM_SEQS = (4096, 2048, 1024)         # train_4k's sequence, else the longest that fits
RM_LOSS_REL = 1e-6                   # the losses' gap where they are not bit-equal


def remat_run(torch, ops, fa, cfg, seq, dev, draws=None):
    """RM_STEPS sim steps of ``cfg`` (TinyLlama-1.1B at full width, f32)
    through GossipTrainer over ``lm_loss_fn(cfg)`` at W = LM_W, global batch
    LM_BATCH, ``seq``, NAG lr LM_LR, p LM_P, seed 0, on ``draws`` (each
    step's gate and peers) when given. Every count is set to 0 just before
    the steps and read just after. Returns the losses, step ms
    (synchronised), max_memory_allocated, the launches, whether any B9 form
    ran, the draws, the gates fired and comm_units."""
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.launch.train import engine_batch, lm_batches
    from repro_torch.models import transformer as tr
    from repro_torch.train.losses import lm_loss_fn
    trainer = GossipTrainer(
        engine="sim", protocol=ProtocolConfig(method="elastic_gossip", moving_rate=0.5,
                                              comm_probability=LM_P),
        optimizer=OptimizerConfig(name="nag", learning_rate=LM_LR, momentum=0.9),
        loss_fn=lm_loss_fn(cfg), num_workers=LM_W,
        init_fn=lambda gen: tr.init_lm(gen, cfg)[0], seed=0, device=dev)
    state = trainer.init_state(0)
    batches = lm_batches(cfg, LM_W, LM_BATCH // LM_W, seq, 0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.zero_launch_counts()
    forms0 = dict(fa.FORM_LAUNCHES)
    out = dict(losses=[], step_ms=[], draws=[])
    for i in range(RM_STEPS):
        b = engine_batch(next(batches))
        t0 = time.perf_counter()
        state, m = trainer.step(state, b, draws=None if draws is None else draws[i])
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(float(m["loss"]))
        out["draws"].append(trainer.sim.last_draws)
    out["launches"] = {k: n for k, n in ops.launch_counts().items() if k in KERNELS}
    out["b9_forms"] = dict(fa.FORM_LAUNCHES) != forms0
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["gates"] = int(sum(int(g.sum()) for g, _ in out["draws"]))
    out["units"] = int(state.proto.comm_units)
    del trainer, state
    torch.cuda.empty_cache()
    return out


def remat_check(tag, run):
    """B1 once a step, B9 never (no form), finite losses and comm_units equal
    to the gates fired."""
    want = dict.fromkeys(KERNELS, 0)
    want[B1] = RM_STEPS
    if run["launches"] != want or run["b9_forms"]:
        raise AssertionError(f"[remat] {tag}: launches {run['launches']} (a B9 form ran: "
                             f"{run['b9_forms']}), expected {want}")
    if not all(x == x and abs(x) != float("inf") for x in run["losses"]):
        raise AssertionError(f"[remat] {tag}: losses {run['losses']}")
    if run["units"] != run["gates"]:
        raise AssertionError(f"[remat] {tag}: comm_units {run['units']} != gates "
                             f"{run['gates']}")


def run_remat_phase(torch, ops, fa, dev, smi):
    """Phase 20. (a) TinyLlama-1.1B at LM_SEQS[0] with remat=True, then
    remat=False on the same draws: per-step losses equal (bit for bit, or
    within RM_LOSS_REL with the gap printed), the remat peak lower, both
    step times; (b) at the longest of RM_SEQS whose remat plan fits 0.9 of
    the free memory: step_memory refuses remat=False with nothing
    allocated, remat=True runs within PEAK_PLAN of its plan. Returns
    ({kernel: launches}, summary)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as cli
    gib = 2 ** 30
    on = get_config(LM_ARCH)
    if not on.remat:
        raise AssertionError("the config's default is remat=False")
    off = dataclasses.replace(on, remat=False)
    launches = dict.fromkeys(KERNELS, 0)
    seq = LM_SEQS[0]
    a = {"on": remat_run(torch, ops, fa, on, seq, dev)}
    a["off"] = remat_run(torch, ops, fa, off, seq, dev, draws=a["on"]["draws"])
    for tag, run in a.items():
        remat_check(f"(a) remat {tag}", run)
        for k, n in run["launches"].items():
            launches[k] += n
    l_on, l_off = a["on"]["losses"], a["off"]["losses"]
    gap = max(abs(x - y) / abs(y) for x, y in zip(l_on, l_off))
    if l_on != l_off and gap > RM_LOSS_REL:
        raise AssertionError(f"[remat] (a) losses remat {l_on} vs not {l_off}: gap {gap}")
    if not a["on"]["peak"] < a["off"]["peak"]:
        raise AssertionError(f"[remat] (a) peak with remat {a['on']['peak']} not below "
                             f"{a['off']['peak']}")
    med = {t: statistics.median(r["step_ms"][1:]) for t, r in a.items()}
    log(f"[remat] (a) {on.name} full width f32, sim W={LM_W}, global batch {LM_BATCH}, seq "
        f"{seq}, NAG lr {LM_LR}, p {LM_P}, seed 0, the same draws: losses remat "
        f"{[f'{x:.7f}' for x in l_on]}, not {[f'{x:.7f}' for x in l_off]} ("
        + ("bit-equal" if l_on == l_off else f"largest relative gap {gap:.3e}")
        + f"); max_memory_allocated remat {a['on']['peak'] / gib:.3f} GiB, not "
        f"{a['off']['peak'] / gib:.3f} GiB ({a['on']['peak'] / a['off']['peak']:.3f}); step ms "
        f"(synchronised) remat {[round(x, 1) for x in a['on']['step_ms']]}, not "
        f"{[round(x, 1) for x in a['off']['step_ms']]}: median after the first "
        f"{med['on']:.1f} / {med['off']:.1f} ms ({med['on'] / med['off']:.3f}x); launches "
        f"{dict((k, v) for k, v in launches.items() if v)} = B1 once a step, B9 none; "
        f"comm_units = gates {a['on']['gates']} / {a['off']['gates']} ({smi})")
    # (b) train_4k's sequence
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    plans = {s: cli.step_bytes(on, LM_W, LM_BATCH * s, s) for s in RM_SEQS}
    seq = next((s for s in RM_SEQS if plans[s] <= 0.9 * free), None)
    if seq is None:
        raise AssertionError(f"[remat] (b) no sequence of {RM_SEQS} fits: {plans}, free {free}")
    tokens = LM_BATCH * seq
    alloc0 = torch.cuda.memory_allocated(dev)
    try:
        cli.step_memory(off, LM_W, tokens, seq, dev)
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or torch.cuda.memory_allocated(dev) != alloc0:
        raise AssertionError(f"[remat] (b) step_memory admitted remat=False at seq {seq}, or "
                             "allocated while it planned")
    plan = cli.step_memory(on, LM_W, tokens, seq, dev)
    act = cli.activation_bytes(on, tokens, seq)
    b = remat_run(torch, ops, fa, on, seq, dev)
    remat_check(f"(b) seq {seq}", b)
    for k, n in b["launches"].items():
        launches[k] += n
    ratio = b["peak"] / plan
    if not PEAK_PLAN[0] <= ratio <= PEAK_PLAN[1]:
        raise AssertionError(f"[remat] (b) max_memory_allocated {b['peak']} is {ratio:.3f} of "
                             f"the plan {plan}, outside {PEAK_PLAN}")
    med_b = statistics.median(b["step_ms"][1:])
    log(f"[remat] (b) {on.name} at seq {seq} (plans by sequence "
        + ", ".join(f"{s}: {plans[s] / gib:.2f} GiB" for s in RM_SEQS)
        + f" of {free / gib:.2f} GiB free; taken {seq}"
        + ("" if seq == RM_SEQS[0] else f", {RM_SEQS[0]} does not fit") + "), sim "
        f"W={LM_W}, global batch {LM_BATCH}: remat=False refused before anything was "
        f"allocated ({refused.split(';')[0]}); remat=True admitted: plan {plan / gib:.2f} GiB "
        f"(activations estimate {act / gib:.2f} GiB), max_memory_allocated "
        f"{b['peak'] / gib:.3f} GiB ({ratio:.3f} of the plan, limits {PEAK_PLAN}); losses "
        f"{[round(x, 5) for x in b['losses']]}; step ms (synchronised) "
        f"{[round(x, 1) for x in b['step_ms']]}, median after the first {med_b:.1f} ms "
        f"({tokens / med_b * 1e3:.0f} tokens/s); launches {b['launches'][B1]} B1, B9 none; "
        f"comm_units {b['units']} = gates {b['gates']} ({smi})")
    return launches, dict(
        seq256=dict(losses_remat=l_on, losses_plain=l_off, loss_gap=gap,
                    peak_remat=a["on"]["peak"], peak_plain=a["off"]["peak"],
                    step_ms_remat=a["on"]["step_ms"], step_ms_plain=a["off"]["step_ms"]),
        long=dict(seq=seq, plan=plan, peak=b["peak"], ratio=ratio, losses=b["losses"],
                  step_ms=b["step_ms"], tokens_per_s=tokens / med_b * 1e3,
                  refused=refused))


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
    t_phase = time.perf_counter()

    lm_launches, lm_err, lm_times, lm_summary = run_lm_phase(torch, ops, fu, ck, ref, fa,
                                                             codec_seeds, dev, bw, peak)
    for kname, n in lm_launches.items():
        launches[kname] += n
    for kname, e in lm_err.items():
        err[kname] = max(err[kname], e)
    times[B1]["tinyllama_plane"] = lm_times[B1]
    log(f"[lm] launches in phase 10: {lm_launches}; summary ({smi}): "
        f"{json.dumps(lm_summary)}")
    phase_s["10 lm"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    ts_launches, ts_err, ts_summary = run_train_serve_phase(torch, ops, fa, dev, smi)
    for kname, n in ts_launches.items():
        launches[kname] += n
    for kname, e in ts_err.items():
        err[kname] = max(err[kname], e)
    log(f"[serve-live] launches in phase 11: {ts_launches}; summary ({smi}): "
        f"{json.dumps(ts_summary)}")
    phase_s["11 serve-live"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    n_mla, mla_err, times[B9]["mla"] = run_mla_phase(torch, ops, fa, dev, bw, peak_bf16, smi)
    launches[B9] += n_mla
    err[B9] = max(err[B9], mla_err)
    phase_s["12 mla"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    moe_launches, moe_err, times[B1]["deepseek_2_layer_plane"], moe_summary = run_moe_phase(
        torch, ops, fu, ck, ref, fa, codec_seeds, dev, bw, peak, smi)
    for kname, n in moe_launches.items():
        launches[kname] += n
    for kname, e in moe_err.items():
        err[kname] = max(err[kname], e)
    log(f"[moe] launches in phase 13: {moe_launches}; summary ({smi}): "
        f"{json.dumps(moe_summary, default=str)}")
    phase_s["13 moe"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    n_ssm, ssm_err, times[B9]["zamba2_hd80"], _ = run_ssm_phase(torch, ops, fa, dev, bw,
                                                                  peak_bf16, smi)
    launches[B9] += n_ssm
    err[B9] = max(err[B9], ssm_err)
    phase_s["14 ssm"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    st_launches, st_err, st_b1, st_summary = run_ssm_train_phase(torch, ops, fu, ref, fa, dev,
                                                                 bw, peak, smi)
    for kname, n in st_launches.items():
        launches[kname] += n
    for kname, e in st_err.items():
        err[kname] = max(err[kname], e)
    times[B1]["xlstm_plane"] = st_b1["xlstm_125m"]
    times[B1]["zamba2_18_layer_plane"] = st_b1["zamba2_2_7b"]
    log(f"[ssm-train] launches in phase 15: {st_launches}; summary ({smi}): "
        f"{json.dumps(st_summary, default=str)}")
    phase_s["15 ssm-train"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    cr_launches, cr_err, times[B9]["cross"], times[B1]["musicgen_15_layer_plane"], _ = \
        run_cross_phase(torch, ops, fu, ref, fa, dev, bw, peak, peak_bf16, smi)
    for kname, n in cr_launches.items():
        launches[kname] += n
    for kname, e in cr_err.items():
        err[kname] = max(err[kname], e)
    log(f"[cross] launches in phase 16: {cr_launches}")
    phase_s["16 cross"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    tp_launches, tp_err, times[B9]["tensor_parallel"], _ = run_tp_phase(
        torch, ops, fa, dev, bw, peak_bf16, smi)
    for kname, n in tp_launches.items():
        launches[kname] += n
    for kname, e in tp_err.items():
        err[kname] = max(err[kname], e)
    phase_s["17 accum+tp"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    tk_launches, tk_err, times[B9]["tensor_parallel_kinds"], _ = run_tp_kinds_phase(
        torch, ops, fa, dev, bw, peak_bf16, smi)
    for kname, n in tk_launches.items():
        launches[kname] += n
    for kname, e in tk_err.items():
        err[kname] = max(err[kname], e)
    log(f"[tp-kinds] launches in phase 18: {dict((k, v) for k, v in tk_launches.items() if v)}")
    phase_s["18 tp-kinds"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    pl_launches, _ = run_plan_phase(torch, ops, fa, dev, smi, kind)
    for kname, n in pl_launches.items():
        launches[kname] += n
    phase_s["19 plan"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    rm_launches, rm_summary = run_remat_phase(torch, ops, fa, dev, smi)
    for kname, n in rm_launches.items():
        launches[kname] += n
    log(f"[remat] launches in phase 20: {dict((k, v) for k, v in rm_launches.items() if v)}; "
        f"summary ({smi}): {json.dumps(rm_summary)}")
    phase_s["20 remat"] = time.perf_counter() - t_phase
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
