"""The port's telemetry plane (slice 6) against the reference on the CPU,
case by case after tests/test_obs.py: the inert ObsConfig() and bit-exact
recording runs on the sim and async engines; per-engine step key sets equal
to the reference's; trace events equal to the reference's on the same
injected draws (sim, async with faults and flow control, partitions,
message mode); the exported trace valid under both packages' schema; the
report's totals equal to the engine's accumulators; sample_every, the ring
bound, the sink, the schema checks, the live server's sink and the report
CLI. The dist engine's recording is held in tests/test_torch_dist.py.

Inputs are made with numpy from a seed; the model is a small MLP."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_async_cases as cases  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro_torch.common import config as tcfg  # noqa: E402
from repro_torch.obs import MetricsSink, TraceRecorder, report, schema  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 8
TOL = dict(rtol=1e-4, atol=1e-5)
UNIFORM = dict(method="elastic_gossip", topology="uniform", comm_probability=0.5,
               moving_rate=0.5)
CONSTANT = dict(time_model="constant", mean_step_time=1.0)
LOGNORMAL = dict(time_model="lognormal", sigma=0.6, seed=1)
RECORDING = dict(trace=True, metrics=True)


def _run(trainer, steps=8):
    x, y = (torch.from_numpy(a) for a in cases.problem(W))
    state = trainer.init_state(0, params=cases.tparams())
    m = {}
    for _ in range(steps):
        state, m = trainer.step(state, (x, y))
    return state, m


def _jrun(trainer, steps=8):
    x, y = (jnp.asarray(a) for a in cases.problem(W))
    state = trainer.init_state(0, params=cases.jparams())
    m = {}
    for _ in range(steps):
        state, m = trainer.step(state, (x, y))
    return state, m


def _assert_states_equal(a, b):
    for k in a.theta:
        assert torch.equal(a.theta[k], b.theta[k]), k
        assert torch.equal(a.opt.mu[k], b.opt.mu[k]), k
    for f in ("comm_rounds", "comm_units", "comm_bytes", "stale_time", "tokens",
              "wire_dropped", "flow_skipped", "chunk_units"):
        x, y = getattr(a.proto, f), getattr(b.proto, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    assert torch.equal(a.key.get_state(), b.key.get_state())


def _het(engine):
    return CONSTANT if engine == "async" else None


# ---------------------------------------------------------------------------
# inert anchor, and recording changes nothing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sim", "async"])
def test_default_obsconfig_is_inert(engine):
    """ObsConfig() builds no observer and the run is bit-exact against
    obs=None."""
    _, plain = cases.trainers(engine, W, UNIFORM, hetero=_het(engine))
    _, anchored = cases.trainers(engine, W, UNIFORM, hetero=_het(engine), obs={})
    assert not tcfg.ObsConfig().enabled()
    assert anchored.observer is None and anchored.sim.obs is None
    assert anchored.export_obs() == {}
    _assert_states_equal(_run(plain)[0], _run(anchored)[0])


@pytest.mark.parametrize("engine,het", [("sim", None), ("async", CONSTANT),
                                        ("async", LOGNORMAL)])
def test_recording_run_is_bit_exact(engine, het):
    """Trace and metrics armed, the run reproduces the plain one bit for bit;
    every event validates in both packages' schema."""
    _, plain = cases.trainers(engine, W, UNIFORM, hetero=het)
    _, rec = cases.trainers(engine, W, UNIFORM, hetero=het, obs=RECORDING)
    s0, _ = _run(plain)
    s1, _ = _run(rec)
    _assert_states_equal(s0, s1)
    assert rec.observer is not None and rec.observer.tracing
    rec.observer.flush()
    evs = rec.observer.trace.events
    assert {"compute", "exchange"} <= {e["ev"] for e in evs}
    for e in evs:
        assert schema.validate_event(e) == [] and jschema.validate_event(e) == [], e


# ---------------------------------------------------------------------------
# the step key sets, against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,het,faults", [
    ("sim", None, None), ("async", CONSTANT, None),
    ("async", LOGNORMAL, dict(delay_model="constant", delay=1.5)),
])
def test_step_key_sets_equal_the_reference(engine, het, faults):
    """The facade's step metrics: CORE on sim, CORE + the window keys on
    async, + the pending-wire keys in message mode; the same sets as the
    reference's on the same config."""
    jtr, ttr = cases.trainers(engine, W, UNIFORM, hetero=het, faults=faults)
    _, mt = _run(ttr, 4)
    _, mj = _jrun(jtr, 4)
    assert set(mt) == set(mj)
    want = schema.CORE_STEP_KEYS
    if engine == "async":
        want = want | schema.ASYNC_STEP_KEYS
    if faults:
        want = want | schema.ASYNC_MESSAGE_KEYS
    assert set(mt) == want


def test_schema_constants_and_normalize_equal_the_reference():
    for name in ("CORE_STEP_KEYS", "ASYNC_STEP_KEYS", "ASYNC_MESSAGE_KEYS",
                 "SERVE_STEP_KEYS", "EVENT_TYPES"):
        assert getattr(schema, name) == getattr(jschema, name), name
    for m, step in (({"loss": 1.5, "my_extra": 7}, 3), ({"loss_mean": 2.0, "comm_active": 3}, 0)):
        got = schema.normalize_step_metrics(dict(m), step=step)
        assert got == jschema.normalize_step_metrics(dict(m), step=step)
        assert schema.CORE_STEP_KEYS <= set(got)
    got = schema.normalize_step_metrics({"loss": 1.5, "my_extra": 7}, step=3)
    assert got["my_extra"] == 7 and got["loss_mean"] == got["loss_max"] == 1.5
    assert got["fired"] is False and got["comm_active"] == 0


# ---------------------------------------------------------------------------
# trace events against the reference's, on the same draws
# ---------------------------------------------------------------------------

def _events(observer, wall):
    """The typed events in a canonical order (the port emits a step's
    compute span with its exchanges, one step later than the reference,
    which reads the step counter back at once); on a wall-clock track ``t``
    and ``dur`` are this run's, so they are dropped."""
    observer.flush()
    out = []
    for e in observer.trace.events:
        e = dict(e)
        if wall:
            e.pop("t")
            e.pop("dur", None)
        out.append(e)
    return sorted(out, key=lambda e: (e["step"], e["ev"], e["worker"], e.get("t", 0.0),
                                      e.get("peer", -2), e.get("attempt", -1)))


# case -> (engine, hetero, faults, fleet, event kinds that must appear)
EVENT_CASES = {
    "sim": ("sim", None, None, None, {"compute", "exchange"}),
    "sim partition flow": ("sim", None, None,
                           dict(partition=4, flow_control="token_account", token_capacity=1.5,
                                token_rate=0.3, seed=5), {"exchange", "chunk", "flow_skip"}),
    "sim corrupt": ("sim", None, dict(fault_model="corrupt", fault_rate=0.3, seed=3), None,
                    {"exchange", "corrupt"}),
    "async faults flow": ("async", LOGNORMAL, dict(fault_model="drop", fault_rate=0.3, seed=3),
                          dict(flow_control="token_account", token_capacity=1.5,
                               token_rate=0.3), {"exchange", "drop", "flow_skip"}),
    "async message": ("async", LOGNORMAL,
                      dict(fault_model="drop", fault_rate=0.1, delay_model="lognormal",
                           delay=1.0, delay_sigma=0.8, timeout=0.6, max_retries=1, seed=7),
                      None, {"dispatch", "apply", "timeout", "retry"}),
}


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_trace_events_equal_the_reference(case):
    """16 steps (async: windows) from the reference's state with its draws,
    both packages recording: the same typed events, with equal fields
    (virtual times included; the sim engine's wall-clock ``t`` / ``dur``
    aside)."""
    engine, het, faults, fleet, kinds = EVENT_CASES[case]
    method = "clipped_gossip" if faults else "elastic_gossip"
    proto = dict(UNIFORM, method=method, comm_probability=0.7)
    jtr, ttr = cases.trainers(engine, W, proto, hetero=het, faults=faults, fleet=fleet,
                              obs=RECORDING)
    cases.lockstep(jtr, ttr, W, 16, TOL)
    wall = engine == "sim"
    got, want = _events(ttr.observer, wall), _events(jtr.observer, wall)
    assert kinds | {"compute"} <= {e["ev"] for e in want}
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys(), (a, b)
        for k in a:
            if isinstance(b[k], float):
                assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-12), (a, b)
            else:
                assert a[k] == b[k], (a, b)


# ---------------------------------------------------------------------------
# export, report and the accumulators
# ---------------------------------------------------------------------------

def test_async_w8_faults_flow_trace_and_exact_totals(tmp_path):
    """W=8 async with drops and token-account flow control: the exported
    trace validates in both packages (worker tracks, exchange arrows,
    fault and skip markers); the report's totals equal the engine's
    accumulators exactly; the sink's counters likewise; the report CLI
    passes; the trajectory equals the non-recording run's."""
    trace_path, metrics_path = str(tmp_path / "run.json"), str(tmp_path / "run.jsonl")
    faults = dict(fault_model="drop", fault_rate=0.3, seed=3)
    fleet = dict(flow_control="token_account", token_capacity=3.0, token_rate=0.5)
    _, t = cases.trainers("async", W, UNIFORM, hetero=CONSTANT, faults=faults, fleet=fleet,
                          obs=dict(trace_path=trace_path, metrics_path=metrics_path))
    state, _ = _run(t, 20)
    _, plain = cases.trainers("async", W, UNIFORM, hetero=CONSTANT, faults=faults, fleet=fleet)
    _assert_states_equal(_run(plain, 20)[0], state)
    assert t.export_obs() == {"trace": trace_path, "metrics": metrics_path}
    with open(trace_path) as f:
        doc = json.load(f)
    assert schema.validate_trace(doc) == [] and jschema.validate_trace(doc) == []
    assert {"compute", "exchange", "drop", "flow_skip"} <= {e["ev"] for e in doc["reproEvents"]}
    tids = {e["tid"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    assert {w + 1 for w in range(W)} <= tids
    assert {"X", "i", "s", "f"} <= {e["ph"] for e in doc["traceEvents"]}
    rows = report.load_jsonl(metrics_path)
    assert len(rows) == 20 and [r["step"] for r in rows] == list(range(20))
    tot = report.totals(rows)
    proto = state.proto
    for f in ("comm_bytes", "comm_units", "comm_rounds", "stale_time", "stale_steps",
              "stale_events", "wire_dropped", "flow_skipped"):
        assert tot[f] == float(getattr(proto, f)), f
        assert t.observer.sink.counters.get(f, 0.0) == float(getattr(proto, f)), f
    assert np.array_equal(np.asarray(tot["tokens"], np.float32), proto.tokens.numpy())
    fr = report.frontier(rows)
    assert [p["step"] for p in fr] == sorted(p["step"] for p in fr)
    assert fr[-1]["comm_bytes"] == float(proto.comm_bytes)
    assert report.main([metrics_path, "--trace", trace_path]) == 0
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs.report", metrics_path,
                        "--trace", trace_path], capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert r.returncode == 0 and "schema: VALID" in r.stdout, r.stdout + r.stderr


def test_harvest_runs_one_step_behind():
    """The metrics row and the exchange events of step n are read when step
    n + 1 is recorded (or at flush), not at step n."""
    _, t = cases.trainers("sim", W, UNIFORM, obs=RECORDING)
    x, y = (torch.from_numpy(a) for a in cases.problem(W))
    state = t.init_state(0, params=cases.tparams())
    for i in range(3):
        state, _ = t.step(state, (x, y))
        assert len(t.observer.sink.records) == i
        assert {e["step"] for e in t.observer.trace.events} <= set(range(i))
    t.observer.flush()
    assert [r["step"] for r in t.observer.sink.records] == [0, 1, 2]
    assert t.observer.sink.records[-1]["comm_bytes"] == float(state.proto.comm_bytes)


def test_sample_every_thins_rows_and_events():
    _, t = cases.trainers("sim", W, UNIFORM, obs=dict(RECORDING, sample_every=3))
    _run(t, 9)
    t.observer.flush()
    assert [r["step"] for r in t.observer.sink.records] == [0, 3, 6]
    assert {e["step"] for e in t.observer.trace.events} == {0, 3, 6}


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def test_metrics_sink_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "m.jsonl")
    sink = MetricsSink(path)
    sink.counter_add("c", 2.0)
    sink.counter_add("c", 3.0)
    sink.gauge_set("g", 7)
    sink.observe("h", 1.0)
    sink.observe("h", 3.0)
    sink.record({"step": 0, "loss": torch.tensor(1.25), "n": torch.tensor(4, dtype=torch.int32)})
    sink.record({"step": 1, "loss": 1.0})
    sink.close()
    rows = report.load_jsonl(path)
    assert [r["step"] for r in rows] == [0, 1]
    assert rows[0]["loss"] == 1.25 and rows[0]["n"] == 4
    assert sink.counters["c"] == 5.0
    s = sink.summary()
    assert s["g"] == 7 and s["h_count"] == 2 and s["h_max"] == 3.0
    sink.samples("h").clear()
    assert sink.summary()["h_count"] == 0


def test_trace_recorder_bounded_and_equal_to_the_reference():
    from repro.obs import TraceRecorder as JRecorder
    recs = (TraceRecorder(max_events=5), JRecorder(max_events=5))
    for rec in recs:
        for i in range(9):
            rec.emit("exchange", float(i), i, worker=0, peer=1)
        rec.emit("dispatch", 9.0, 9, worker=1, peer=0, arrival=9.5)
        assert len(rec.events) == 5 and rec.dropped == 5
    assert recs[0].perfetto(num_workers=2) == recs[1].perfetto(num_workers=2)
    assert schema.validate_trace(recs[0].perfetto(num_workers=2)) == []


def test_schema_validation_catches_errors():
    assert schema.validate_event({"ev": "nope", "t": 0.0, "step": 0})
    assert schema.validate_event({"ev": "exchange", "t": 0.0, "step": 0, "worker": 1})
    assert schema.validate_event(
        {"ev": "exchange", "t": 0.0, "step": 0, "worker": 1, "peer": 2}) == []
    bad = {"traceEvents": [{"ph": "X", "ts": 0, "tid": 9, "name": "x"}], "reproEvents": []}
    errs = schema.validate_trace(bad)
    assert errs == jschema.validate_trace(bad)
    assert any("without dur" in e for e in errs) and any("thread_name" in e for e in errs)


def test_serve_telemetry_rides_metrics_sink():
    """The live server keeps its read surfaces (swap_pauses, rejected_swaps,
    swap_stats) as live views over one MetricsSink, as the reference's; the
    train-while-serve loop's half waits for slice 7b."""
    from repro_torch.serve import LiveServer

    class _Bus:
        def latest(self):
            return None

    sink = MetricsSink()
    server = LiveServer(program=None, bus=_Bus(), metrics=sink)
    assert server.metrics is sink
    assert server.maybe_swap() is False
    sink.observe("swap_pause_s", 0.25)
    sink.counter_add("swaps", 1)
    sink.counter_add("rejected_swaps", 2)
    assert server.swap_pauses == [0.25]
    assert server.rejected_swaps == 2
    st = server.swap_stats()
    assert st["swaps"] == 1 and st["swap_pause_max_s"] == 0.25 and st["rejected_swaps"] == 2
