"""The harness on the CPU at the tiny cells: the program against the plain
reference, the result line, and a configuration, traffic mix and metric
added as files and entries only."""
import importlib
import json

import pytest
import torch

from bench import _cases, check, harness


@pytest.fixture
def bench_dir(tmp_path):
    spec = _cases.make_bench(tmp_path)
    return tmp_path, spec


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 40 + 3])
def test_program_matches_reference(bench_dir, seed):
    tmp, spec = bench_dir
    r = harness.run_cell("ds-tiny.tiny", seed, 0.3, False, device="cpu", spec=spec,
                         bench_dir=tmp)
    assert r.correct, r.lines
    assert r.attempted >= 1 and r.failed == 0


def test_result_line_shape(bench_dir):
    tmp, spec = bench_dir
    r = harness.run_cell("ds-tiny.tiny", 7, 0.3, False, device="cpu", spec=spec, bench_dir=tmp)
    line = json.loads(r.line())
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(line["metrics"]) == {"train_tokens_per_s", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["check"]) == {"loss_gap", "grad1_gap", "change3_gap"}
    assert all(set(v) == {"value", "limit"} for v in line["check"].values())
    assert len(r.lines) == 6 and r.lines[0].startswith("seconds: ")
    assert r.lines[1].startswith("window: ")
    assert r.lines[2].startswith("not compared: loss1_gap ")
    assert all(x.startswith("check ") for x in r.lines[3:])

    t = json.loads(harness.run_cell("ds-tiny.tiny", 7, 0.3, True, device="cpu", spec=spec,
                                    bench_dir=tmp).line())
    assert list(t) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "check"]
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert set(t["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(bench_dir):
    tmp, spec = bench_dir
    cell = harness.find_cell(spec, "ds-tiny.tiny", tmp)
    a, b = (harness.Feed(cell.traffic, 512, 2 ** 33 + 5, "cpu") for _ in range(2))
    c = harness.Feed(cell.traffic, 512, 2 ** 33 + 6, "cpu")
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.gates, b.gates)
    assert not torch.equal(a.tokens, c.tokens)
    assert bool(a.gates[1].any())                # the second checked step fires
    assert all(sorted(p.tolist()) == [0, 1] for p in a.peers[:8])


def test_added_config_traffic_and_metric_run(bench_dir):
    """A new configuration, traffic mix and per-layer metric, each a new file
    and an entry, run without an edit to any existing file."""
    tmp, spec = bench_dir
    c = _cases.tiny_config("ds-tiny")
    c.update(name="ds-tiny-3l", num_hidden_layers=3)
    c["port"]["replace"] = dict(c["port"]["replace"], num_layers=3)
    (tmp / "configs" / "ds-tiny-3l.json").write_text(json.dumps(c))
    t = _cases.tiny_traffic()
    t.update(batch_per_worker=1, seq=64)
    (tmp / "traffic" / "long.json").write_text(json.dumps(t))
    (tmp / "metrics" / "traced_steps.py").write_text("def read(t):\n    return t.steps\n")
    (tmp / "limits" / "ds-tiny-3l.long.json").write_text(
        json.dumps({k: {"limit": v} for k, v in _cases.LIMITS.items()}))
    spec["configs"] = spec["configs"] + [dict(spec["configs"][0], name="ds-tiny-3l")]
    spec["workloads"].append({"name": "ds-tiny-3l.long", "config": "ds-tiny-3l",
                              "traffic": "long", "chips": 1, "why": "added"})
    spec["per_layer"].append({"name": "traced_steps", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "train_tokens_per_s", "workloads": ["ds-tiny-3l.long"]})
    r = harness.run_cell("ds-tiny-3l.long", 3, 0.2, True, device="cpu", spec=spec, bench_dir=tmp)
    assert r.correct, r.lines
    assert r.metrics["traced_steps"] == {"value": 2, "unit": "steps"}
    assert harness.find_cell(spec, "ds-tiny-3l.long", tmp).traffic["seq"] == 64
    assert "traced_steps" not in {m["name"] for m in harness.cell_metrics(spec, "ds-tiny.tiny",
                                                                          True)}


def test_unknown_names_are_refused(bench_dir):
    tmp, spec = bench_dir
    with pytest.raises(KeyError):
        harness.find_cell(spec, "nope", tmp)
    spec["workloads"].append({"name": "x.y", "config": "missing", "traffic": "tiny",
                              "chips": 1, "why": "x"})
    with pytest.raises(FileNotFoundError):
        harness.find_cell(spec, "x.y", tmp)


@pytest.mark.parametrize("key,value", [("kv_lora_rank", 128), ("rms_norm_eps", 1e-5),
                                       ("as_run.capacity_factor", 2.0)])
def test_config_must_be_what_the_program_runs(key, value):
    c = _cases.tiny_config("ds-tiny")
    harness.port_config(c)
    *group, last = key.split(".")
    (c[group[0]] if group else c)[last] = value
    with pytest.raises(ValueError, match=key):
        harness.port_config(c)


@pytest.mark.parametrize("name", ["dsv2-lite-2l", "ds-tiny"])
def test_reference_table_is_the_programs_tree(name):
    from repro_torch.models.transformer import abstract_lm
    c = (_cases.tiny_config(name) if name in _cases.TINY
         else json.loads((harness.BENCH / "configs" / f"{name}.json").read_text()))
    model = importlib.import_module(f"bench.reference.{c['reference']}")
    harness.check_tree(model.param_table(c), abstract_lm(harness.port_config(c))[0])
    bad = model.param_table(c)[1:]
    with pytest.raises(ValueError, match="differ"):
        harness.check_tree(bad, abstract_lm(harness.port_config(c))[0])


def test_real_cells_resolve():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.find_cell(spec, w["name"])
        assert cell.limits and set(cell.limits) <= set(check.NAMES)
        harness.port_config(cell.config)
        assert harness.cell_metrics(spec, w["name"], True)
