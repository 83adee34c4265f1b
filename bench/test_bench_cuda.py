"""On the card (marked ``cuda``; skips without one): the tiny cells run
through the harness on the device and read correct, and the control, the
reference in TF32 in the program's place, reads at least three times what
the program does (the cell-size readings are ``bench/control.py``'s, in
PERF.md)."""
import pytest
import torch

from bench import _cases, control, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_control_reads_above_the_program(card, tmp_path):
    cell = "ds-tiny.tiny"
    spec = _cases.make_bench(tmp_path)
    r = harness.run_cell(cell, 2 ** 31 + 19, 0.5, True, device="cuda", spec=spec,
                         bench_dir=tmp_path)
    assert r.correct, r.lines
    assert r.metrics["launches_per_step"]["value"] > 0
    ctl = control.readings(cell, 2 ** 31 + 19, faults=("tf32",), spec=spec,
                           bench_dir=tmp_path)["tf32"]
    assert ctl["grad1_gap"] >= 3 * r.check["grad1_gap"]["value"], (ctl, r.lines)
