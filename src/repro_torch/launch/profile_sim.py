"""Where one sim step's time goes on the card: the main path
(GossipTrainer(engine="sim", method="elastic_gossip"), NAG, the §4.1 MLP at
full width) under ``torch.profiler``, or the same run with another
protocol, a codec or a fault plane, or the paper's CIFAR CNN at full width
(``--model cnn``: width 32, the CIFAR stand-in, lr 0.01 / momentum 0.9;
use ``--workers 4 --batch 32``, the paper's effective batch 128). With
``--engine async`` a "step" is one event window of the async engine
(``--time-model``, ``--sigma``), optionally over the fleet plane
(``--partition``, ``--flow-control``, ``--plane host``): kernels per
window and the device-busy share of the windows. ``--shard N`` pads the
plane to N column shards (the codec then encodes ``[W * N, shard_size]``
rows); ``--trace run.json`` / ``--metrics run.jsonl`` record the run through
the telemetry plane (``repro_torch.obs``) and write both files at the end,
so the profile shows what recording costs a step. ``--model lm --arch
tinyllama_1_1b`` profiles the transformer LM's sim step at full size (f32,
the reference CLI's ``lm_loss`` over ``launch.train.lm_batches`` at
``--seq``, ``--batch`` per worker; ``--layers N`` cuts the depth to N
layers, widths uncut, e.g. ``--arch deepseek_v2_lite_16b --layers 2``);
its kernels are further split into the attention (the ops run inside the
differentiable online softmax and their backward nodes, matched by
autograd sequence number), an MoE layer's expert ``bmm``s and its dispatch
(route, sort + scatter, gather + combine; matched the same way), the
recurrent models' chunked GLA core and sLSTM loop (``--arch xlstm_125m``,
``--arch zamba2_2_7b --layers 18``), the LM head and its cross-entropy
(the ``lm head + loss`` span), the flat views' backward, the layers'
recompute in the backward (``cfg.remat``, the ``remat recompute`` span of
``common/remat.py``) and the rest; the audio and vision models train on
their zero ``cond`` stub. For the LM only, as many unprofiled steps are
first timed by CUDA events. The kernel list leaves out the device-side
copies of the spans' ranges (user annotations, not kernels). Every model
also prints the device time a step of each span of the profiled steps
(:mod:`repro_torch.obs.spans`: ``step``, ``forward``, ``backward``,
``update``, ``gossip mix``, ``fused update``, the model's own).

    python -m repro_torch.launch.profile_sim [--model mlp|cnn|lm]
                                             [--arch tinyllama_1_1b] [--seq 256]
                                             [--layers N]
                                             [--workers 8] [--batch 16] [--steps 10]
                                             [--codec none|q8|topk]
                                             [--method clipped_gossip] [--p 0.5]
                                             [--fault-model drop_byzantine]
                                             [--fault-rate 0.2] [--fault-frac 0.125]
                                             [--engine sim|async]
                                             [--time-model lognormal] [--sigma 0.6]
                                             [--partition 8]
                                             [--flow-control randomized_token_account]
                                             [--plane device|host]
                                             [--shard 4]
                                             [--trace run.json] [--metrics run.jsonl]

``--method``, ``--p`` and the ``--fault-*`` flags mirror the reference's
``launch.train``; a FaultConfig is built only when ``--fault-model`` is not
"none". ``drop_byzantine`` is the reference's benchmarks/faults.py
composite (drop and Byzantine noise at once), registered here on demand.

Prints the synchronised step time (under the profiler; for the LM also by
CUDA events over as many unprofiled steps first), the device-busy share of the profiled
window (the union of kernel intervals over the span from the first kernel's
start to the last one's end), and the kernels by total device time, then one
JSON line with the same numbers. Kernel names are grouped into the step's
phases: the model's gradients (vmapped matmuls or the CNN's convolutions,
softmax and reductions), the mixing matmul, kernel B1, the codec kernels
B4-B7 (with ``--codec``), kernel B8 (with a robust ``--method``), the
copies between host and device (the host plane's) and the rest.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from collections import defaultdict

import torch

from repro_torch.obs import spans

FULL = dict(in_dim=784, hidden=1024, depth=3, num_classes=10)


def _ensure_drop_byzantine() -> None:
    from repro_torch.faults import available_fault_models, register_fault_model
    from repro_torch.faults.models import ByzantineNoise, DropFault
    if "drop_byzantine" not in available_fault_models():
        @register_fault_model("drop_byzantine")
        class DropByzantine(ByzantineNoise, DropFault):
            """fault_rate of wires dropped + the first round(fault_frac*W)
            workers publishing noise rows."""


def _trainer(W: int, device, codec: str = "none", method: str = "elastic_gossip",
             p: float = 0.125, faults=None, model: str = "mlp", engine: str = "sim",
             hetero=None, fleet=None, shard=None, obs=None, lm_cfg=None):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple

    if model == "lm":
        from repro_torch.models import transformer as tr
        from repro_torch.train.losses import lm_loss_fn
        return GossipTrainer(
            engine=engine,
            protocol=ProtocolConfig(method=method, moving_rate=0.5, comm_probability=p),
            optimizer=OptimizerConfig(learning_rate=1e-3, momentum=0.9),
            loss_fn=lm_loss_fn(lm_cfg), num_workers=W, device=device, codec=codec,
            hetero=hetero, faults=faults, fleet=fleet, shard=shard, obs=obs,
            init_fn=lambda gen: tr.init_lm(gen, lm_cfg)[0])
    if model == "cnn":
        apply, opt = simple.cnn_logits, OptimizerConfig(learning_rate=0.01, momentum=0.9)
        init = lambda gen: simple.init_cnn(gen)[0]                       # noqa: E731
    else:
        apply, opt = simple.mlp_logits, OptimizerConfig(learning_rate=1e-3, momentum=0.99)
        init = lambda gen: simple.init_mlp(gen, **FULL)[0]               # noqa: E731

    def loss_fn(prm, x, y):
        return simple.xent_loss(apply(prm, x), y)

    return GossipTrainer(
        engine=engine,
        protocol=ProtocolConfig(method=method, moving_rate=0.5, comm_probability=p,
                                topology="uniform"),
        optimizer=opt, loss_fn=loss_fn, num_workers=W, device=device, codec=codec,
        hetero=hetero, faults=faults, fleet=fleet, shard=shard, obs=obs, init_fn=init)


def _busy_us(intervals):
    """Length of the union of [start, end) intervals (µs)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile(W: int = 8, batch: int = 16, steps: int = 10, device="cuda",
            codec: str = "none", method: str = "elastic_gossip", p: float = 0.125,
            fault_model: str = "none", fault_rate: float = 0.0,
            fault_frac: float = 0.0, model: str = "mlp", engine: str = "sim",
            time_model: str = "lognormal", sigma: float = 0.6, partition: int = 1,
            flow_control: str = "none", plane: str = "device", shard: int = 1,
            trace: str = "", metrics: str = "", arch: str = "tinyllama_1_1b",
            seq: int = 256, layers: int = 0) -> dict:
    from repro_torch.common.config import (FaultConfig, FleetConfig, HeteroConfig, ObsConfig,
                                           ShardConfig)
    from repro_torch.data.partition import batches_for_step, partition_iid
    from repro_torch.data.synthetic import load_cifar_like, load_mnist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    faults = None
    if fault_model != "none":
        if fault_model == "drop_byzantine":
            _ensure_drop_byzantine()
        faults = FaultConfig(fault_model=fault_model, fault_rate=fault_rate,
                             fault_frac=fault_frac)
    hetero = HeteroConfig(time_model=time_model, sigma=sigma) if engine == "async" else None
    fleet = FleetConfig(partition=partition, flow_control=flow_control, plane=plane)
    obs = ObsConfig(trace_path=trace, metrics_path=metrics)
    lm_cfg = None
    if model == "lm":
        from repro_torch.configs import get_config
        lm_cfg = get_config(arch)
        if layers:
            lm_cfg = dataclasses.replace(lm_cfg, num_layers=layers)
    trainer = _trainer(W, device, codec, method, p, faults, model, engine, hetero,
                       fleet if fleet.enabled() else None,
                       ShardConfig(n_shards=shard) if shard != 1 else None,
                       obs if obs.enabled() else None, lm_cfg)
    dev = trainer.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    warm = 2 if model == "lm" else 5
    if model == "lm":
        from repro_torch.launch.train import engine_batch, lm_batches
        stream = lm_batches(lm_cfg, W, batch, seq, 0, device=dev)
        batches = [engine_batch(b) for b in
                   (next(stream) for _ in range(2 * steps + warm))]
    else:
        train, _ = (load_cifar_like(num_train=12800, num_test=10) if model == "cnn"
                    else load_mnist(num_train=25600, num_test=10))
        shards = partition_iid(train, W, 0)
        batches = [tuple(torch.as_tensor(a, device=dev)
                         for a in batches_for_step(shards, i, batch))
                   for i in range(steps + warm)]
    state = trainer.init_state(0)
    for xb, yb in batches[:warm]:              # warm-up: vmap, cuBLAS, the kernel build
        state, _ = trainer.step(state, (xb, yb))
    sync()
    event_ms = []
    timed = steps if model == "lm" else 0
    if dev.type == "cuda" and timed:
        # unprofiled steps, each timed by CUDA events around it
        torch.cuda.reset_peak_memory_stats(dev)
        for xb, yb in batches[warm:warm + steps]:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, _ = trainer.step(state, (xb, yb))
            ev[1].record()
            ev[1].synchronize()
            event_ms.append(ev[0].elapsed_time(ev[1]))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    step_s = []
    span0 = spans.TABLE.next_id()
    with torch.profiler.profile(activities=acts) as prof:
        for xb, yb in batches[warm + timed:]:
            t0 = time.perf_counter()
            state, _ = trainer.step(state, (xb, yb))
            sync()
            step_s.append(time.perf_counter() - t0)
    written = trainer.export_obs()
    span_ms = defaultdict(float)        # the spans' device time, forward and backward parts
    for r in spans.TABLE.read(since=span0):
        if r.device_ms is not None:
            span_ms[r.name] += r.device_ms
    events = prof.events()
    # the spans' ranges show on the device as user annotations: not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_name[e.name][0] += d
        by_name[e.name][1] += 1
    phases = defaultdict(float)
    if model == "lm":
        for name, us in _lm_split(events).items():
            phases[name] += us
    else:
        for name, (us, _) in by_name.items():
            phases[_phase(name)] += us
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
            if kernels else 0.0)
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "model": model, "engine": engine,
        "time_model": time_model if engine == "async" else None,
        "sigma": sigma if engine == "async" else None, "partition": partition,
        "flow_control": flow_control, "plane": plane, "shard": shard,
        "wire_bytes": trainer._backend.wire_bytes(), "obs_written": written,
        "workers": W, "batch_per_worker": batch, "steps": steps, "codec": codec,
        "method": method, "p": p, "fault_model": fault_model, "fault_rate": fault_rate,
        "fault_frac": fault_frac,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "step_ms_median": statistics.median(step_s) * 1e3,
        "step_ms_events_median": statistics.median(event_ms) if event_ms else None,
        "kernel_launches_per_step": len(kernels) / steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_busy_share": (busy / span) if span else None,
        "phase_ms_per_step": {k: v / steps / 1e3 for k, v in sorted(phases.items())},
        "span_ms_per_step": {k: v / steps for k, v in sorted(span_ms.items())},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / steps / 1e3,
                         "calls_per_step": c / steps} for n, (us, c) in top],
        "arch": lm_cfg.name if lm_cfg is not None else None,
        "seq": seq if model == "lm" else None,
        "layers": lm_cfg.num_layers if lm_cfg is not None else None,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }


# record_function ranges of the LM step -> the part their kernels (and
# their backward nodes' kernels) are counted under
RECOMPUTE = "remat recompute"
RANGES = {RECOMPUTE: "remat recompute (the layers' forward again)",
          "online_softmax_attention": "attention (fwd + bwd)",
          "moe expert matmuls": "MoE expert bmms (fwd + bwd)",
          "moe route": "MoE dispatch: route (fwd + bwd)",
          "moe sort + scatter": "MoE dispatch: sort + scatter (fwd + bwd)",
          "moe gather + combine": "MoE dispatch: gather + combine (fwd + bwd)",
          "gla_chunked": "chunked GLA: Mamba2 / mLSTM core (fwd + bwd)",
          "slstm loop": "sLSTM loop (fwd + bwd)",
          "lm head + loss": "LM head + chunked cross-entropy (fwd + bwd)"}


def _lm_split(events) -> dict:
    """The LM step's device time (us) by part: B1; each of :data:`RANGES`
    (kernels launched by ops inside the range, and by backward nodes whose
    forward op ran there, matched by autograd sequence number); the flat
    views' backward (the ``_Views`` backward node); the remaining matmuls
    and the remaining elementwise / reduction kernels. A kernel goes by
    the op that launched it (the op's ``kernels``); those launched outside
    any op (the hand-written kernels, through ctypes) go by name. The
    layers' recompute (``cfg.remat``, ``common/remat.py``) is its own part
    whatever range it holds (the attention's forward in it too); the
    backward of what it recomputed goes to the part of its own range, and
    the key chunks' recompute inside the attention's backward to the
    attention."""
    CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    def by_name(n):
        n = n.lower()
        if "fused_flat_elastic_nag" in n:
            return "B1 fused update"
        if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n or "matmul" in n:
            return "matmuls (model + mixing)"
        if "memcpy" in n:
            return "host <-> device copies"
        return "elementwise / reductions / copies"

    def innermost_range(chain):
        return next((a.name for a in chain if a.name in RANGES and a.name != RECOMPUTE), None)

    ops = [e for e in events if e.device_type == CPU]
    seq_range = {}
    for e in ops:
        if e.sequence_nr >= 0:
            r = innermost_range(ancestors(e.cpu_parent))
            if r is not None:
                seq_range[e.sequence_nr] = r
    out = defaultdict(float)
    unlinked = defaultdict(float)
    for k in events:
        if k.device_type == CUDA and not k.is_user_annotation:
            unlinked[k.name] += k.time_range.end - k.time_range.start
    # a kernel listed under more than one op is counted once: no name is
    # given more time than its kernels took on the device
    left = dict(unlinked)
    for e in ops:
        if not e.kernels:
            continue
        chain = list(ancestors(e))
        names = [a.name for a in chain]
        r = RECOMPUTE if RECOMPUTE in names else innermost_range(chain)
        if r is None:
            r = next((seq_range[a.sequence_nr] for a in chain
                      if "evaluate_function" in a.name and a.sequence_nr in seq_range), None)
        for k in e.kernels:
            if k.name in RANGES:
                continue
            us = min(k.duration, max(left.get(k.name, 0.0), 0.0))
            left[k.name] = left.get(k.name, 0.0) - us
            unlinked[k.name] -= us
            if any("_Views" in a and "Backward" in a for a in names):
                part = "views backward"
            elif r is not None:
                part = RANGES[r]
            else:
                part = by_name(k.name)
            out[part] += us
    for name, us in unlinked.items():
        if us > 0:
            out[by_name(name)] += us
    return out


def _phase(kernel_name: str) -> str:
    n = kernel_name.lower()
    if "memcpy" in n:
        return "host <-> device copies"
    if "fused_flat_elastic_nag" in n:
        return "B1 fused update"
    if "robust_flat_apply" in n:
        return "B8 robust apply"
    if any(k in n for k in ("q8_encode", "q8_decode", "topk_encode", "topk_decode")):
        return "B4-B7 codec"
    if any(k in n for k in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                            "cudnn")):
        return "convolutions (cuDNN)"
    if "gemm" in n or "gemv" in n or "sm90" in n or "cutlass" in n or "matmul" in n:
        return "matmuls (model grads + mixing)"
    if "softmax" in n or "reduce" in n or "sum" in n or "max" in n:
        return "reductions / softmax"
    if "elementwise" in n or "vectorized" in n or "copy" in n or "fill" in n:
        return "elementwise / copies / fills"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="mlp", choices=("mlp", "cnn", "lm"))
    ap.add_argument("--arch", default="tinyllama_1_1b", help="--model lm: the architecture")
    ap.add_argument("--seq", type=int, default=256, help="--model lm: sequence length")
    ap.add_argument("--layers", type=int, default=0,
                    help="--model lm: cut the depth to this many layers (widths uncut)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--codec", default="none", help="wire codec: none, q8 or topk")
    ap.add_argument("--method", default="elastic_gossip",
                    help="registered protocol, e.g. clipped_gossip or trimmed_gossip")
    ap.add_argument("--p", type=float, default=0.125, help="comm probability per worker")
    ap.add_argument("--fault-model", default="none",
                    help="none, drop, corrupt, byzantine_scale, byzantine_noise or "
                         "drop_byzantine")
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--fault-frac", type=float, default=0.0)
    ap.add_argument("--engine", default="sim", choices=("sim", "async"),
                    help="async: a step is one event window")
    ap.add_argument("--time-model", default="lognormal",
                    help="async: constant, lognormal, slow_node or fail_rejoin")
    ap.add_argument("--sigma", type=float, default=0.6, help="async lognormal: log-space std")
    ap.add_argument("--partition", type=int, default=1, help="fleet: chunks per exchange")
    ap.add_argument("--flow-control", default="none",
                    help="fleet: none, token_account or randomized_token_account")
    ap.add_argument("--plane", default="device", choices=("device", "host"),
                    help="async: host keeps theta and velocity in pinned host memory")
    ap.add_argument("--shard", type=int, default=1,
                    help="sharded plane: column shards per replica (repro_torch.shard)")
    ap.add_argument("--trace", default="", help="record and write a Perfetto trace here")
    ap.add_argument("--metrics", default="", help="record and write metrics JSONL here")
    a = ap.parse_args(argv)
    r = profile(a.workers, a.batch, a.steps, a.device, a.codec, a.method, a.p,
                a.fault_model, a.fault_rate, a.fault_frac, a.model, a.engine, a.time_model,
                a.sigma, a.partition, a.flow_control, a.plane, a.shard, a.trace, a.metrics,
                a.arch, a.seq, a.layers)
    unit = "window" if a.engine == "async" else "step"
    events = ("" if r["step_ms_events_median"] is None else
              f" (by CUDA events, unprofiled: {r['step_ms_events_median']} ms)")
    print(f"{r['model']} {r['engine']} W={r['workers']} batch={r['batch_per_worker']} "
          f"codec={r['codec']} method={r['method']} p={r['p']} faults={r['fault_model']} "
          f"partition={r['partition']} flow={r['flow_control']} plane={r['plane']} "
          f"shard={r['shard']} (wire {r['wire_bytes']:.0f} B/event): median {unit} "
          f"{r['step_ms_median']:.3f} ms{events}, {r['kernel_launches_per_step']:.1f} kernels/step, "
          f"device busy {r['device_busy_ms_per_step']:.3f} ms/step, busy share "
          f"{r['device_busy_share']}")
    for k, v in r["phase_ms_per_step"].items():
        print(f"  {k:34s} {v:.4f} ms/step")
    for k, v in r["span_ms_per_step"].items():
        print(f"  span {k:29s} {v:.4f} device ms/step")
    for k in r["top_kernels"]:
        print(f"  {k['ms_per_step']:.4f} ms/step x{k['calls_per_step']:.1f}  {k['name']}")
    for kind, path in r["obs_written"].items():
        print(f"wrote {kind} {path}")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
