"""The benchmark's closed-form model FLOPs against
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
forward and backward at the tiny sizes. The reference multiplies every
query-key pair, so the count is taken with ``pairs = S * S``; the expert
capacity is raised so that no slot is dropped."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import _cases, weights
from bench.frozen import flops
from bench.reference import deepseek_v2, train


@pytest.mark.parametrize("batch,seq", [(2, 32), (1, 64), (3, 16)])
def test_closed_form_equals_counted(batch, seq):
    model = deepseek_v2
    c = _cases.tiny_config("ds-tiny")
    c["as_run"] = dict(c["as_run"], capacity_factor=float(c["n_routed_experts"]))
    p = train.flat_leaves(weights.make(model.param_table(c), 5, "cpu"))
    leaves = {k: v.requires_grad_(True) for k, v in p.items()}
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, c["vocab_size"], (batch, seq + 1), generator=g)
    with FlopCounterMode(display=False) as fc:
        loss = model.loss(train.nest(leaves), tok[:, :-1], tok[:, 1:], c)
        torch.autograd.grad(loss, list(leaves.values()))
    assert fc.get_total_flops() == model.model_flops(c, batch, seq, pairs=flops.full_pairs)


def test_causal_counts():
    assert flops.causal_pairs(4) == 10 and flops.full_pairs(4) == 16
    assert flops.attention_flops(1, 4, heads=2, d_qk=3, d_v=5) == 3 * 2 * 2 * 10 * 8


def test_cells_model_flops():
    """The real cells' counts, per worker step (the numbers PERF.md uses)."""
    from bench import harness
    spec = harness.load_spec()
    got = {}
    for w in spec["workloads"]:
        cell = harness.find_cell(spec, w["name"])
        t = cell.traffic
        got[w["name"]] = t["workers"] * cell.reference.model_flops(
            cell.config, t["batch_per_worker"], t["seq"])
    d1, d3 = (got[w["name"]] for w in spec["workloads"])
    assert 3.5e13 < d1 < 4.0e13 and d1 < d3 < 4.2e13
