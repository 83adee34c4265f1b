"""One run of one cell of the port's benchmark.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix, each a data file found by its name: ``configs/<config>.json``
(the sizes as run, the reference family, how the program builds it) and
``traffic/<traffic>.json`` (workers, batch, sequence, gossip and optimizer
settings). Limits of the check are ``limits/<cell>.json``; a per-layer metric
is read by ``metrics/<metric>.py``.

The run (Elastic Gossip LM training through ``GossipTrainer(engine="sim")``):

1. set-up: the weights from the seed on the device (``bench/weights.py``),
   the trainer and its state from them, the token batches and the gate and
   peer draws from the seed; then the checked steps (3) through the
   window's own call and feed, which also build and warm every kernel, with
   the program's readings taken between them (the losses, the velocity
   after step 1, each leaf's change after the last);
2. the window: steps dispatched back to back, no synchronise a step, for
   ``--seconds``; then one synchronise. Or, with ``--trace 1``, a few steps
   under ``torch.profiler``;
3. the program's state freed, the plain reference follows the checked steps
   from the same weights (made again from the seed), batches and draws, and
   the readings are compared (``bench/check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import check, trace as trace_mod, weights
from bench.frozen.tokens import make_lm_tokens
from bench.reference import train as ref_train

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the run may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2.0 ** 30


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    reference: object                # the family's module in bench/reference


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


def find_cell(spec: dict, name: str, bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration, traffic mix,
    limits and reference, each found by name under ``bench_dir``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has {sorted(cells)}")
    w = cells[name]
    config = _json(bench_dir / "configs" / f"{w['config']}.json")
    limits_file = bench_dir / "limits" / f"{name}.json"
    limits = ({k: v["limit"] for k, v in _json(limits_file).items() if "limit" in v}
              if limits_file.is_file() else {})
    return Cell(name, config, _json(bench_dir / "traffic" / f"{w['traffic']}.json"), limits,
                importlib.import_module(f"bench.reference.{config['reference']}"))


def metric_reader(name: str, bench_dir: Path = BENCH):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell's result line carries: its end-to-end metrics, or
    with ``trace`` its per-layer ones (a metric with ``workloads`` only in
    those cells, one without in every cell that reports what it moves)."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def port_config(config: dict):
    """The program's ModelConfig of a configuration file's ``port`` entry:
    the arch (its reduced preset where ``reduced``), fields replaced, and each
    ``matches`` field held equal to the file's number (a dotted key reads a
    nested group of the file, such as ``as_run``)."""
    from repro_torch.configs import get_config, get_reduced
    port = config["port"]
    cfg = (get_reduced if port.get("reduced") else get_config)(port["arch"])
    cfg = dataclasses.replace(cfg, **port.get("replace", {}))
    bad = []
    for key, attr in port["matches"].items():
        got = cfg
        for part in attr.split("."):
            got = getattr(got, part)
        want = config
        for part in key.split("."):
            want = want[part]
        if got != want:
            bad.append(f"{key}={want!r} but the program's {attr}={got!r}")
    if bad:
        raise ValueError(f"configuration {config['name']!r} is not what the program runs: "
                         + "; ".join(bad))
    return cfg


def check_tree(table, program_tree) -> None:
    """The reference's parameter table holds the program's leaves, by path
    and shape (``bench/test_bench_harness.py`` holds every configuration to
    it on the CPU; a run does not, since the program's abstract tree is
    drawn on the host, ~10 s at these widths)."""
    want = {"/".join(p): tuple(s) for p, s, _ in table}
    got = {k: tuple(v.shape) for k, v in ref_train.flat_leaves(program_tree).items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"the reference's parameters differ from the program's: {diff[:6]}")


class Feed:
    """The inputs of a run, from its seed: ``pool`` batches of token rows
    (``bench/frozen/tokens.py``) for W workers, and a gate and peer draw a
    step (Bernoulli(p) per worker, a uniform random matching). The second
    checked step always fires one worker, so that every seed checks the
    elastic exchange."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        W, B, S = traffic["workers"], traffic["batch_per_worker"], traffic["seq"]
        pool, n = traffic["batches"], traffic["draws"]
        rows = make_lm_tokens(pool * W * B * (S + 1), vocab, seed).reshape(pool, W, B, S + 1)
        self.tokens = torch.from_numpy(rows[..., :-1].copy()).to(device)
        self.labels = torch.from_numpy(rows[..., 1:].copy()).to(device)
        rng = np.random.default_rng(seed)
        gates = rng.random((n, W)) < traffic["p"]
        gates[1, rng.integers(W)] = True
        peers = np.empty((n, W), dtype=np.int64)
        for i in range(n):
            perm = rng.permutation(W)
            for a, b in zip(perm[0::2], perm[1::2]):
                peers[i, a], peers[i, b] = b, a
            if W % 2:
                peers[i, perm[-1]] = perm[-1]
        self.gates = torch.from_numpy(gates).to(device)
        self.peers = torch.from_numpy(peers).to(device)
        self.tokens_per_step = W * B * S

    def batch(self, i: int):
        j = i % self.tokens.shape[0]
        return self.tokens[j], self.labels[j]

    def draws(self, i: int):
        j = i % self.gates.shape[0]
        return self.gates[j], self.peers[j]


def _leaf_norms(tree: dict, W: int, scale: float = 1.0, minus: Optional[dict] = None):
    """[w]{leaf: norm} of a [W, ...] tree (less ``minus``'s leaf, one replica)."""
    leaves = ref_train.flat_leaves(tree)
    sub = ref_train.flat_leaves(minus) if minus is not None else {}
    norms = {}
    for k, t in leaves.items():
        norms[k] = torch.stack([torch.linalg.vector_norm(t[w] - sub[k] if k in sub else t[w])
                                for w in range(W)]) * scale
    host = {k: v.tolist() for k, v in norms.items()}
    return [{k: host[k][w] for k in leaves} for w in range(W)]


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: Dict[str, object]
    check: Dict[str, dict]
    breakdown: Optional[dict] = None
    lines: List[str] = dataclasses.field(default_factory=list)

    def line(self) -> str:
        out = {"correct": self.correct, "attempted": self.attempted, "failed": self.failed,
               "metrics": self.metrics, "device": self.device}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        out["check"] = self.check
        return json.dumps(out)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             spec: Optional[dict] = None, bench_dir: Path = BENCH,
             t0: Optional[float] = None) -> Result:
    """Run cell ``name`` once; see the module's docstring."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = [("start", time.perf_counter())]
    spec = load_spec() if spec is None else spec
    cell = find_cell(spec, name, bench_dir)
    c, tr, model = cell.config, cell.traffic, cell.reference
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    from repro_torch.api.trainer import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.train.losses import lm_loss_fn

    marks.append(("imports", time.perf_counter()))
    if cuda:
        torch.zeros((), device=dev)
        sync()
        free0, total = torch.cuda.mem_get_info(dev)
        marks.append(("cuda init", time.perf_counter()))
    pcfg = port_config(c)
    table = model.param_table(c)
    marks.append(("config", time.perf_counter()))
    W, B, S = tr["workers"], tr["batch_per_worker"], tr["seq"]
    lr, mom = tr["lr"], tr["momentum"]
    trainer = GossipTrainer(
        engine="sim", protocol=ProtocolConfig(method="elastic_gossip",
                                              comm_probability=tr["p"],
                                              moving_rate=tr["alpha"]),
        optimizer=OptimizerConfig(name="nag", learning_rate=lr, momentum=mom),
        loss_fn=lm_loss_fn(pcfg), num_workers=W, device=device)
    marks.append(("trainer", time.perf_counter()))
    params = weights.make(table, seed, dev)
    sync()
    marks.append(("weights", time.perf_counter()))
    state = trainer.init_state(seed, params=params)
    del params
    sync()
    marks.append(("init_state", time.perf_counter()))
    feed = Feed(tr, c["vocab_size"], seed, dev)
    marks.append(("feed", time.perf_counter()))

    def step(i):
        nonlocal state
        state, m = trainer.step(state, feed.batch(i), draws=feed.draws(i))
        return m

    checked = tr["checked_steps"]
    prog = {"loss_mean": [], "loss_max": []}
    for i in range(checked):
        m = step(i)
        prog["loss_mean"].append(m["loss_mean"])
        prog["loss_max"].append(m["loss_max"])
        if i == 0:
            prog["grad1"] = _leaf_norms(state.velocity, W, scale=1.0 / lr)
        sync()
        marks.append((f"step {i + 1}", time.perf_counter()))
    theta0 = weights.make(table, seed, dev)
    prog["change"] = _leaf_norms(state.params, W, minus=theta0)
    del theta0
    prog["loss_mean"] = [float(x) for x in prog["loss_mean"]]
    prog["loss_max"] = [float(x) for x in prog["loss_max"]]
    # the allocator keeps the checked steps' blocks: the window's steps
    # reuse them and map no new memory
    gc.collect()
    sync()

    t_start = time.perf_counter()
    setup_s = t_start - t0
    marks.append(("readings", t_start))
    losses, breakdown, traced = [], None, None
    step_ms, wait_ms = [], None
    if not trace:
        n = 0
        marks_ev = [torch.cuda.Event(enable_timing=True)] if cuda else []
        if cuda:
            marks_ev[0].record()
        while time.perf_counter() - t_start < seconds:
            losses.append(step(checked + n)["loss_mean"])
            n += 1
            if cuda:
                marks_ev.append(torch.cuda.Event(enable_timing=True))
                marks_ev[-1].record()
        t_last = time.perf_counter()
        sync()
        window_s = time.perf_counter() - t_start
        wait_ms = (t_start + window_s - t_last) * 1e3
        step_ms = [a.elapsed_time(b) for a, b in zip(marks_ev, marks_ev[1:])]
    else:
        n = tr["trace_steps"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.profiler.profile(activities=acts) as prof:
            tw = time.perf_counter()
            if cuda:
                ev[0].record()
            for j in range(n):
                losses.append(step(checked + j)["loss_mean"])
            if cuda:
                ev[1].record()
            sync()
            window_s = time.perf_counter() - tw
        width = sum(b.shape[1] for b in state.theta.values())
        traced = trace_mod.read(
            prof.events(), steps=n, window_s=window_s,
            event_s=ev[0].elapsed_time(ev[1]) / 1e3 if cuda else None,
            flops_per_step=W * model.model_flops(c, B, S), workers=W, plane_width=width)
        del prof
        breakdown = {"device_ops": [[k, v] for k, v in trace_mod.device_ops(traced)],
                     "idle_gaps": [[k, v] for k, v in traced.gaps]}
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    marks.append(("window", time.perf_counter()))

    metrics: Dict[str, dict] = {}
    values = {"train_tokens_per_s": n * feed.tokens_per_step / window_s,
              "peak_mem_gib": peak / GIB, "setup_s": setup_s}
    for m in cell_metrics(spec, name, trace):
        v = values.get(m["name"]) if not trace else metric_reader(m["name"], bench_dir)(traced)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        device_info.update(busy_s=traced.busy_s, window_s=window_s)

    # the program's state goes before the reference runs
    del trainer, state, losses, traced
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    theta0 = weights.make(table, seed, dev)
    ref = ref_train.run(model, c, theta0,
                        [feed.batch(i) for i in range(checked)],
                        [feed.draws(i) for i in range(checked)],
                        lr=lr, momentum=mom, alpha=tr["alpha"])
    del theta0
    marks.append(("reference", time.perf_counter()))
    numbers = check.compare(prog, ref)
    ok = check.verdict(numbers, cell.limits)
    setup = " ".join(f"{k} {b - a:.3f}" for (_, a), (k, b) in zip(marks, marks[1:]))
    window = (f"window: {n} steps in {window_s:.3f} s, the last wait {wait_ms:.1f} ms, "
              f"device ms a step {[round(x, 1) for x in step_ms]}"
              if wait_ms is not None else f"window: {n} traced steps in {window_s:.3f} s")
    if cuda:
        ms = torch.cuda.memory_stats(dev)
        window += (f"; memory: free at start {free0 / GIB:.2f} of {total / GIB:.2f} GiB, "
                   f"reserved peak {ms.get('reserved_bytes.all.peak', 0) / GIB:.2f} GiB, "
                   f"allocation retries {ms.get('num_alloc_retries', 0)}")
    return Result(correct=ok, attempted=n, failed=failed, metrics=metrics, device=device_info,
                  check={k: {"value": numbers[k]["value"], "limit": v}
                         for k, v in cell.limits.items()},
                  breakdown=breakdown,
                  lines=[f"seconds: before the harness {marks[0][1] - t0:.3f} {setup}", window]
                  + check.lines(numbers, cell.limits))
