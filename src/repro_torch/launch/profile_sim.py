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
so the profile shows what recording costs a step.

    python -m repro_torch.launch.profile_sim [--model mlp|cnn]
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

Prints the synchronised step time, the device-busy share of the profiled
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
import json
import statistics
import time
from collections import defaultdict

import torch

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
             hetero=None, fleet=None, shard=None, obs=None):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple

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
            trace: str = "", metrics: str = "") -> dict:
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
    trainer = _trainer(W, device, codec, method, p, faults, model, engine, hetero,
                       fleet if fleet.enabled() else None,
                       ShardConfig(n_shards=shard) if shard != 1 else None,
                       obs if obs.enabled() else None)
    dev = trainer.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    train, _ = (load_cifar_like(num_train=12800, num_test=10) if model == "cnn"
                else load_mnist(num_train=25600, num_test=10))
    shards = partition_iid(train, W, 0)
    batches = [tuple(torch.as_tensor(a, device=dev)
                     for a in batches_for_step(shards, i, batch))
               for i in range(steps + 5)]
    state = trainer.init_state(0)
    for xb, yb in batches[:5]:                 # warm-up: vmap, cuBLAS, the kernel build
        state, _ = trainer.step(state, (xb, yb))
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    step_s = []
    with torch.profiler.profile(activities=acts) as prof:
        for xb, yb in batches[5:]:
            t0 = time.perf_counter()
            state, _ = trainer.step(state, (xb, yb))
            sync()
            step_s.append(time.perf_counter() - t0)
    written = trainer.export_obs()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_name[e.name][0] += d
        by_name[e.name][1] += 1
    phases = defaultdict(float)
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
        "kernel_launches_per_step": len(kernels) / steps,
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_busy_share": (busy / span) if span else None,
        "phase_ms_per_step": {k: v / steps / 1e3 for k, v in sorted(phases.items())},
        "top_kernels": [{"name": n[:120], "ms_per_step": us / steps / 1e3,
                         "calls_per_step": c / steps} for n, (us, c) in top],
    }


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
    ap.add_argument("--model", default="mlp", choices=("mlp", "cnn"))
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
                a.sigma, a.partition, a.flow_control, a.plane, a.shard, a.trace, a.metrics)
    unit = "window" if a.engine == "async" else "step"
    print(f"{r['model']} {r['engine']} W={r['workers']} batch={r['batch_per_worker']} "
          f"codec={r['codec']} method={r['method']} p={r['p']} faults={r['fault_model']} "
          f"partition={r['partition']} flow={r['flow_control']} plane={r['plane']} "
          f"shard={r['shard']} (wire {r['wire_bytes']:.0f} B/event): median {unit} "
          f"{r['step_ms_median']:.3f} ms, {r['kernel_launches_per_step']:.1f} kernels/step, "
          f"device busy {r['device_busy_ms_per_step']:.3f} ms/step, busy share "
          f"{r['device_busy_share']}")
    for k, v in r["phase_ms_per_step"].items():
        print(f"  {k:34s} {v:.4f} ms/step")
    for k in r["top_kernels"]:
        print(f"  {k['ms_per_step']:.4f} ms/step x{k['calls_per_step']:.1f}  {k['name']}")
    for kind, path in r["obs_written"].items():
        print(f"wrote {kind} {path}")
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
