#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. build   — the card's name and power limit, then kernel B1
             (``kernels/csrc/fused_update.cu``) built with nvcc for sm_90a
             into ``build/repro_torch/``;
2. kernels — B1 held against its plain PyTorch version on the card at the
             main path's shapes ([8, 2913408], [4, 2913408] f32), a ragged
             N=1000 and bf16 / bf16+f32-velocity storage, scalar and [W] coef,
             and peer is theta; then B1 and the plain version timed with CUDA
             events (median of 60 launches) beside the bandwidth bound;
3. main    — GossipTrainer(engine="sim", method="elastic_gossip") with NAG on
             the §4.1 MLP at full width (784 -> 3x1024 -> 10, random weights
             from a seed) over the synthetic MNIST stand-in: W=8 at batch 16
             per worker, then W=4 at batch 32, 50 steps each, p=0.125,
             alpha=0.5, uniform peers. The loss must be finite and falling,
             B1 must launch exactly once per step (one f32 bucket) and
             comm_units must equal the gates drawn. Then 10 steps of the fused
             path against the unfused (plain) path on the same draws.

The line before the last is a JSON object listing the kernels with their
launches on the main path, error, times and bounds; the last line is
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
cuDNN, so the model and the mixing matmul run in full f32.
"""
import json
import os
import statistics
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

# (memory bytes/s, f32 non-tensor FLOP/s) by card name, from NVIDIA's data sheets
CARDS = [("H200", 4.8e12, 67e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100 PCIe", 2.0e12, 51e12), ("H100", 3.35e12, 67e12)]


def log(msg):
    print(msg, flush=True)


def card_rates(name):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops
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


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_trainer(torch, W, dev, fused=True):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(prm, x, y):
        return simple.xent_loss(simple.mlp_logits(prm, x), y)

    return GossipTrainer(
        engine="sim",
        protocol=ProtocolConfig(method="elastic_gossip", moving_rate=0.5,
                                comm_probability=0.125, topology="uniform"),
        optimizer=OptimizerConfig(name="nag", learning_rate=1e-3, momentum=0.99),
        loss_fn=loss_fn, num_workers=W, fused_update=fused, device=dev,
        init_fn=lambda gen: simple.init_mlp(gen, **FULL)[0])


def staged_batches(torch, train, W, batch, steps, dev):
    from repro_torch.data.partition import batches_for_step, partition_iid
    shards = partition_iid(train, W, 0)
    out = []
    for i in range(steps):
        x, y = batches_for_step(shards, i, batch)
        out.append((torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)))
    return out


def run_main_path(torch, train, test, W, batch, dev, fu=None):
    """One main-path run. ``fu`` (the kernel module) is given on the card:
    its launch count is zeroed just before the run and read just after."""
    from repro_torch.models import simple
    trainer = make_trainer(torch, W, dev)
    state = trainer.init_state(0)
    batches = staged_batches(torch, train, W, batch, STEPS, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    if fu is not None:
        fu.LAUNCHES = 0
    losses, active, step_s = [], [], []
    for xb, yb in batches:
        t0 = time.perf_counter()
        state, m = trainer.step(state, (xb, yb))
        sync()
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        active.append(m["comm_active"])
    launches = fu.LAUNCHES if fu is not None else None
    losses = [float(x) for x in losses]
    gates = sum(int(a) for a in active)
    units = int(state.proto.comm_units)
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise AssertionError(f"W={W}: non-finite loss {losses}")
    head, tail = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    if not tail < head:
        raise AssertionError(f"W={W}: loss not falling: first 10 {head}, last 10 {tail}")
    if fu is not None and launches != STEPS:
        raise AssertionError(f"W={W}: B1 launched {launches} times in {STEPS} steps")
    if units != gates:
        raise AssertionError(f"W={W}: comm_units {units} != gates drawn {gates}")
    with torch.no_grad():
        xt = torch.as_tensor(test.x, device=dev)
        yt = torch.as_tensor(test.y, device=dev)
        agg = float(simple.accuracy(simple.mlp_logits(trainer.consensus_params(state), xt), yt))
        rank0 = float(simple.accuracy(simple.mlp_logits(trainer.rank0_params(state), xt), yt))
    log(f"[main] W={W} batch={batch}/worker: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first-10 mean {head:.4f}, last-10 mean {tail:.4f}), median step "
        f"{statistics.median(step_s) * 1e3:.3f} ms (synchronised), B1 launches "
        f"{launches}, comm_units {units} = gates {gates}, comm_bytes "
        f"{float(state.proto.comm_bytes)!r}, aggregate acc {agg:.4f}, rank-0 acc {rank0:.4f}")
    return launches


def fused_vs_unfused(torch, train, dev, W=8, batch=16, steps=10):
    """The fused path (B1) and the unfused (plain) path on the same draws."""
    from repro_torch.core import topology
    tr_f = make_trainer(torch, W, dev, fused=True)
    tr_u = make_trainer(torch, W, dev, fused=False)
    s_f, s_u = tr_f.init_state(1), tr_u.init_state(1)
    gen = torch.Generator(device=dev).manual_seed(7)
    for xb, yb in staged_batches(torch, train, W, batch, steps, dev):
        draws = (topology.participation(gen, W, 0.5), topology.sample_uniform_peers(gen, W))
        s_f, _ = tr_f.step(s_f, (xb, yb), draws=draws)
        s_u, _ = tr_u.step(s_u, (xb, yb), draws=draws)
    # the two paths round the comm displacement differently: rtol 1e-4, atol 1e-5
    for name, a, b in (("theta", s_f.theta, s_u.theta), ("velocity", s_f.opt.mu, s_u.opt.mu)):
        torch.testing.assert_close(a["float32"], b["float32"], rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"fused vs unfused {name}: {m}")
    err = float((s_f.theta["float32"] - s_u.theta["float32"]).abs().max())
    log(f"[main] fused vs unfused, {steps} steps at W={W}, same draws: theta max abs "
        f"diff {err!r} (rtol 1e-4, atol 1e-5)")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.data.synthetic import load_mnist
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_update as fu
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(smi)
    log(f"[build] torch {torch.__version__} cuda {torch.version.cuda}, device {kind}; "
        "TF32 off for matmul and cuDNN")
    bw, peak = card_rates(kind)
    t0 = time.perf_counter()
    build.load("fused_update")
    log(f"[build] B1 fused_update.cu: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.BUILD_SECONDS.get('fused_update', 0.0):.2f} s)")

    max_err = check_b1(torch, fu, ref, dev)
    ms8, plain8, bound8, by8 = time_b1(torch, fu, ref, dev, 8, bw, peak)
    ms4, plain4, bound4, _ = time_b1(torch, fu, ref, dev, 4, bw, peak)

    train, test = load_mnist(num_train=25600, num_test=4000)
    launches = 0
    for W, batch in ((8, 16), (4, 32)):
        launches += run_main_path(torch, train, test, W, batch, dev, fu=fu)
    fused_vs_unfused(torch, train, dev)

    kernels = [{
        "name": "fused_flat_elastic_nag_update",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/fused_update.py:87",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms8, "plain_ms": plain8, "bound_ms": bound8, "bound_by": by8,
        "library_ms": None,
        "shape": [8, N_FULL],
        "ms_w4": ms4, "plain_ms_w4": plain4, "bound_ms_w4": bound4,
        "card": smi,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
