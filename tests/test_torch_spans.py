"""The port's span API (``repro_torch.obs.spans``) on the CPU: spans off add
no table entry, CUDA event or autograd node, and spans on leave losses and
gradients bit-equal; under a CPU ``torch.profiler`` every span of the sim
step and every model range shows once a step (the ``lm head + loss`` grad
marks once in the forward and once in the backward under
``vmap(grad_and_value)`` with W = 2), nested as the step runs, with its
counts; host stamps on the profiler's clock; the table's bound; CUDA events
recorded without a synchronise and resolved when the table is read; the
observer's "device spans" track.

The model is DeepSeek-V2-Lite's reduced preset (MLA, one MoE layer, remat
on), xLSTM's and Zamba2's for the recurrent ranges."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import GossipTrainer  # noqa: E402
from repro_torch.common.config import ObsConfig, OptimizerConfig, ProtocolConfig  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.obs import schema, spans  # noqa: E402
from repro_torch.train.losses import lm_loss_fn  # noqa: E402

W, B, S = 2, 2, 32
PHASES = ("step", "forward", "backward", "update", "gossip mix", "fused update")
MODEL_RANGES = ("moe route", "moe sort + scatter", "moe expert matmuls", "moe gather + combine",
                "online_softmax_attention", "remat recompute")
CPU = torch.profiler.ProfilerActivity.CPU


@pytest.fixture(autouse=True)
def _fresh_table(monkeypatch):
    monkeypatch.setattr(spans, "TABLE", spans.SpanTable())
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _trainer(cfg, obs=None):
    return GossipTrainer(engine="sim", protocol=ProtocolConfig(method="elastic_gossip",
                                                               comm_probability=0.5,
                                                               moving_rate=0.5),
                         optimizer=OptimizerConfig(name="nag", learning_rate=1e-2,
                                                   momentum=0.9),
                         loss_fn=lm_loss_fn(cfg), num_workers=W, device="cpu", obs=obs,
                         init_fn=lambda gen: tr.init_lm(gen, cfg)[0])


def _batches(cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, cfg.vocab_size, (n, W, B, S + 1), generator=g)
    return [(r[..., :-1].contiguous(), r[..., 1:].contiguous()) for r in rows]


def _draws(i):
    return torch.tensor([i % 2 == 0, True]), torch.tensor([1, 0])


def _run(trainer, batches, profile=False):
    state = trainer.init_state(0)
    losses = []
    ctx = torch.profiler.profile(activities=[CPU]) if profile else None
    if ctx is not None:
        ctx.__enter__()
    try:
        for i, b in enumerate(batches):
            state, m = trainer.step(state, b, draws=_draws(i))
            losses.append(m["loss_mean"])
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    return state, torch.stack(losses), ctx


def _mark_nodes(t) -> int:
    """The grad marks in the autograd graph that produced ``t``."""
    seen, todo, n = set(), [t.grad_fn], 0
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += "_Mark" in type(f).__name__
        todo.extend(g for g, _ in f.next_functions)
    return n


class _FakeEvent:
    """torch.cuda.Event on the CPU: counts its records and synchronises."""
    made, records, syncs = 0, [], 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1

    def record(self):
        self.at = len(_FakeEvent.records)
        _FakeEvent.records.append(self)

    def synchronize(self):
        _FakeEvent.syncs += 1

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_off_adds_nothing_and_on_is_bit_equal(monkeypatch):
    """With nothing recording, two steps add no table entry and no CUDA
    event, and the loss's graph holds no grad mark; under a profiler it
    holds two, and the same two steps give bit-equal losses, parameters
    and velocities."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    cfg = get_reduced("deepseek_v2_lite_16b")
    batches = _batches(cfg, 2)
    off_state, off_losses, _ = _run(_trainer(cfg), batches)
    assert len(spans.TABLE.spans) == 0 and spans.TABLE.next_id() == 0
    assert _FakeEvent.made == 0
    on_state, on_losses, _ = _run(_trainer(cfg), batches, profile=True)
    assert len(spans.TABLE.spans) > 0 and _FakeEvent.made == 0    # a CPU device: host only
    assert torch.equal(off_losses, on_losses)
    for k in off_state.theta:
        assert torch.equal(off_state.theta[k], on_state.theta[k]), k
        assert torch.equal(off_state.opt.mu[k], on_state.opt.mu[k]), k

    params = tr.init_lm(torch.Generator().manual_seed(0), cfg)[0]
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tokens, labels = batches[0][0][0], batches[0][1][0]
    loss_off, _ = tr.lm_loss(params, cfg, tokens, labels)
    with torch.profiler.profile(activities=[CPU]):
        loss_on, _ = tr.lm_loss(params, cfg, tokens, labels)
    assert _mark_nodes(loss_off) == 0 and _mark_nodes(loss_on) == 2
    assert torch.equal(loss_off, loss_on)
    leaves = [p for p in tree_leaves(params) if p.requires_grad]
    g_off = torch.autograd.grad(loss_off, leaves, allow_unused=True)
    g_on = torch.autograd.grad(loss_on, leaves, allow_unused=True)
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g_off, g_on))


def test_spans_under_the_profiler():
    """Three steps under a CPU profiler (W = 2, vmap(grad_and_value)): each
    step records each phase once and the head's span once forward and once
    backward (the grad marks), every model range at least once; the same
    names show as profiler ranges; parents and step indices follow the
    step; the head's counts; host stamps within 50 us of the profiler's
    range on its clock (after the session's first step, which pays the
    profiler's first range): the median span, and nine in ten of them,
    since a loaded CPU now and then preempts the process for milliseconds
    between a range's start and its stamp)."""
    cfg = get_reduced("deepseek_v2_lite_16b")
    trainer = _trainer(cfg)
    _, _, prof = _run(trainer, _batches(cfg, 3), profile=True)
    recs = spans.TABLE.read()
    assert sorted({r.step for r in recs}) == [0, 1, 2]
    by_id = {r.id: r for r in recs}
    for step in range(3):
        mine = [r for r in recs if r.step == step]
        names = [r.name for r in mine if not r.grad]
        for n in PHASES + ("lm head + loss",):
            assert names.count(n) == 1, (step, n, names)
        for n in MODEL_RANGES:
            assert n in names, (step, n)
        grads = [r for r in mine if r.grad]
        assert [r.name for r in grads] == ["lm head + loss"]
        parent = {r.name: by_id[r.parent].name if r.parent >= 0 else None
                  for r in mine if not r.grad and r.name in PHASES + ("lm head + loss",)}
        assert parent == {"step": None, "forward": "step", "backward": "step",
                          "update": "step", "gossip mix": "update", "fused update": "update",
                          "lm head + loss": "forward"}
        assert by_id[grads[0].parent].name == "backward"
        head = next(r for r in mine if r.name == "lm head + loss" and not r.grad)
        assert head.counts == {"tokens": W * B * S,
                               "flops": 6 * W * B * S * cfg.d_model * cfg.vocab_size}
        assert all(r.device_ms is None and r.events is None for r in mine)

    events = [e for e in prof.events() if e.name in PHASES + MODEL_RANGES + ("lm head + loss",)]
    for n in PHASES + ("lm head + loss",):
        assert sum(e.name == n for e in events) == 3, n
    for n in MODEL_RANGES:
        assert sum(e.name == n for e in events) >= 3, n
    t0 = prof.profiler.kineto_results.trace_start_ns()
    gaps = []                         # us: the span's host start and end less the range's
    for n in PHASES + MODEL_RANGES + ("lm head + loss",):
        mine = sorted((r for r in recs if r.name == n and not r.grad), key=lambda r: r.start_ns)
        theirs = sorted((e for e in events if e.name == n), key=lambda e: e.time_range.start)
        assert len(mine) == len(theirs), n
        gaps += [max(abs((r.start_ns - t0) / 1e3 - e.time_range.start),
                     abs((r.end_ns - t0) / 1e3 - e.time_range.end))
                 for r, e in zip(mine, theirs) if r.step > 0]
    gaps.sort()
    assert gaps[len(gaps) // 2] < 50 and gaps[int(0.9 * len(gaps)) - 1] < 50, gaps


@pytest.mark.parametrize("arch,ranges", [("xlstm_125m", ("gla_chunked", "slstm loop")),
                                         ("zamba2_2_7b", ("gla_chunked",))])
def test_recurrent_ranges(arch, ranges):
    """The recurrent models' ranges record and show under the profiler."""
    cfg = get_reduced(arch)
    _, _, prof = _run(_trainer(cfg), _batches(cfg, 1), profile=True)
    names = {r.name for r in spans.TABLE.read()}
    shown = {e.name for e in prof.events()}
    for n in ranges + PHASES + ("lm head + loss",):
        assert n in names and n in shown, n


def test_table_bound_counts_drops():
    spans.TABLE = spans.SpanTable(max_spans=2)
    for i in range(5):
        with spans.span("x", step=i, force=True) as rec:
            assert rec is not None and rec.id == i
    assert [r.step for r in spans.TABLE.read()] == [0, 1]
    assert spans.TABLE.dropped == 3 and spans.TABLE.next_id() == 5
    with spans.span("y") as rec:
        assert rec is None and not spans.recording()


def test_cuda_spans_record_events_and_never_synchronise(monkeypatch):
    """A span on a CUDA device records a start and an end event on the
    current stream, nested spans inherit the device and the step, nothing
    synchronises until the table is read, and the read resolves each
    span's device time from its events."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.records, _FakeEvent.syncs = [], 0
    with spans.span("outer", step=7, device="cuda", force=True, n=3) as outer:
        with spans.span("inner") as inner:
            pass
        with spans.span("host", device="cpu") as host:
            pass
    assert _FakeEvent.syncs == 0
    assert _FakeEvent.records == [outer.events[0], inner.events[0], inner.events[1],
                                  outer.events[1]]
    assert host.events is None and inner.step == 7 and inner.parent == outer.id
    recs = {r.name: r for r in spans.TABLE.read()}
    assert _FakeEvent.syncs == 2
    assert recs["outer"].device_ms == 3.0 and recs["inner"].device_ms == 1.0
    assert recs["host"].device_ms is None and recs["outer"].counts == {"n": 3}
    assert recs["outer"].start_ns <= recs["inner"].start_ns <= recs["inner"].end_ns \
        <= recs["outer"].end_ns


def test_observer_exports_the_span_track(tmp_path):
    """A tracing observer makes the sim step's spans record without a
    profiler, and its Perfetto document carries them as the "device
    spans" process track, valid under the schema."""
    cfg = get_reduced("deepseek_v2_lite_16b")
    path = str(tmp_path / "run.json")
    trainer = _trainer(cfg, obs=ObsConfig(trace_path=path))
    _run(trainer, _batches(cfg, 2))
    assert not spans.recording()
    assert trainer.export_obs()["trace"] == path
    with open(path) as f:
        doc = json.load(f)
    assert schema.validate_trace(doc) == []
    procs = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    pid = next(p for p, n in procs.items() if n == "device spans")
    mine = [e for e in doc["traceEvents"] if e.get("pid") == pid and e["ph"] == "X"]
    assert sorted(e["args"]["step"] for e in mine if e["name"] == "step") == [0, 1]
    assert {e["name"] for e in mine} >= set(PHASES) | {"lm head + loss"}
    assert all(e["args"]["device_ms"] is None and e["dur"] >= 0 for e in mine)
    computes = [e for e in doc["traceEvents"] if e.get("name") == "compute"]
    steps = sorted((e for e in mine if e["name"] == "step"), key=lambda e: e["ts"])
    for c, s in zip(sorted(computes, key=lambda e: e["ts"]), steps):
        assert c["ts"] <= s["ts"] + 50 and s["ts"] + s["dur"] <= c["ts"] + c["dur"] + 50
