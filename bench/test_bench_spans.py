"""The five readers of the program's spans (``bench/metrics/{lm_head_ms,
lm_head_tflop_s,forward_ms,backward_ms,update_ms}.py``) on hand-filled span
tables: the value a step of the traced steps (the checked steps' records
left out), None without the span, without device time, after dropped
records or without the program's span module; and a tiny traced run on the
CPU, whose result line carries none of them."""
import json
import sys
import types

import pytest

from bench import _cases, harness
from repro_torch.obs import spans

READERS = ("lm_head_ms", "lm_head_tflop_s", "forward_ms", "backward_ms", "update_ms")
FLOPS = 6 * 16_384 * 2048 * 102_400


def _table(steps, device=True, names=("forward", "backward", "update", "lm head + loss")):
    """Spans of host steps ``steps``: each phase's device ms is the step
    index plus a fixed part, the head 10 ms forward and 20 ms backward."""
    table = spans.SpanTable()
    ms = {"forward": 300.0, "backward": 800.0, "update": 30.0}
    for s in steps:
        for name in names:
            parts = ([(False, 10.0), (True, 20.0)] if name == "lm head + loss"
                     else [(False, ms[name] + s)])
            for grad, t in parts:
                counts = {"tokens": 16_384, "flops": FLOPS} if name == "lm head + loss" else {}
                rec = table.open(name, s, None, counts, 0, grad=grad)
                table.close(rec)
                table.keep(rec)
                rec.device_ms = t if device else None
    return table


def _read(name, t):
    return harness.metric_reader(name)(t)


@pytest.fixture
def traced():
    return types.SimpleNamespace(steps=2)


def test_values_a_step_of_the_traced_steps(monkeypatch, traced):
    """Steps 0-2 are the checked steps (no profiler: in a run they record
    nothing, here they are planted and must be left out), 3-4 traced."""
    monkeypatch.setattr(spans, "TABLE", _table(range(5)))
    assert _read("forward_ms", traced) == pytest.approx(300.0 + 3.5)
    assert _read("backward_ms", traced) == pytest.approx(800.0 + 3.5)
    assert _read("update_ms", traced) == pytest.approx(30.0 + 3.5)
    assert _read("lm_head_ms", traced) == pytest.approx(30.0)
    assert _read("lm_head_tflop_s", traced) == pytest.approx(FLOPS / 30.0 / 1e9)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["no span", "no device time", "dropped", "no module"])
def test_none_where_nothing_is_read(monkeypatch, traced, name, case):
    if case == "no span":
        table = _table(range(5), names=())
    else:
        table = _table(range(5), device=case != "no device time")
    if case == "dropped":
        table.dropped = 1
    monkeypatch.setattr(spans, "TABLE", table)
    if case == "no module":
        monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
        monkeypatch.delattr(sys.modules["repro_torch.obs"], "spans")
    assert _read(name, traced) is None


def test_tiny_traced_run_on_the_cpu_reports_none(tmp_path):
    spec = _cases.make_bench(tmp_path)
    r = harness.run_cell("ds-tiny.tiny", 2 ** 33 + 1, 0.1, True, device="cpu", spec=spec,
                         bench_dir=tmp_path)
    line = json.loads(r.line())
    assert r.correct, r.lines
    assert not set(READERS) & set(line["metrics"])
    recs = spans.TABLE.read()
    assert {r.name for r in recs} >= {"step", "forward", "backward", "update", "lm head + loss"}


@pytest.mark.cuda
def test_tiny_traced_run_on_the_card_reports_all(tmp_path):
    """On the card the five metrics are read, and the three phases tile the
    step span: their device time a step within 5% of its."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = _cases.make_bench(tmp_path)
    since = spans.TABLE.next_id()
    r = harness.run_cell("ds-tiny.tiny", 2 ** 31 + 23, 0.5, True, device="cuda", spec=spec,
                         bench_dir=tmp_path)
    assert r.correct, r.lines
    assert set(READERS) <= set(r.metrics), r.metrics
    ms = {n: sum(x.device_ms for x in spans.TABLE.read(since) if x.name == n)
          for n in ("step", "forward", "backward", "update")}
    assert ms["forward"] + ms["backward"] + ms["update"] == pytest.approx(ms["step"], rel=0.05)
