"""The check catches a broken program: each fault a training cell can have
is planted under the timed path of a tiny run on the CPU, and ``correct``
comes out false."""
import pytest
import torch

from bench import _cases, control, harness


def _unchanged(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "fused_bufs_elastic_nag", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.train import losses
    real = losses.lm_loss_fn

    def half(cfg):
        fn = real(cfg)
        return lambda p, x, y=None: fn(p, x[: x.shape[0] // 2], y[: y.shape[0] // 2])
    monkeypatch.setattr(losses, "lm_loss_fn", half)


def _no_exchange(monkeypatch):
    from repro_torch.core import topology
    monkeypatch.setattr(topology, "elastic_gossip_mix",
                        lambda peers, active, alpha: torch.eye(peers.shape[0],
                                                               device=peers.device))


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "no_exchange": _no_exchange}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(tmp_path, monkeypatch, fault):
    spec = _cases.make_bench(tmp_path)
    FAULTS[fault](monkeypatch)
    r = harness.run_cell("ds-tiny.tiny", 2 ** 31 + 3, 0.1, False, device="cpu", spec=spec,
                         bench_dir=tmp_path)
    assert not r.correct, r.lines


@pytest.mark.parametrize("fault", ["half_batch", "no_exchange"])
def test_control_faults_fail_the_limits(tmp_path, fault):
    """``bench/control.py``'s fault readings, judged by the cell's limits,
    come out not correct (TF32 is a card's precision: on the chip only)."""
    spec = _cases.make_bench(tmp_path)
    got = control.readings("ds-tiny.tiny", 2 ** 31 + 5, device="cpu", faults=(fault,),
                           spec=spec, bench_dir=tmp_path)[fault]
    assert got["correct"] is False, got
