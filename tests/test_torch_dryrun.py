"""The op counter (``analysis.opcount``), the kernels' ``meta`` branch and
the dry-run CLI (``launch.dryrun``) against the reference and by hand.

- FLOPs against the reference's HLO walk
  (``repro.analysis.hlo.analyze(jax.jit(f).lower(...).compile().as_text())``)
  on programs whose FLOPs are all products in both packages, within 1%:
  the §4.1 MNIST MLP's loss and gradient under ``vmap`` at W = 4 (the
  port's ``SimTrainer._grads`` against the reference's
  ``jax.vmap(jax.value_and_grad(one_loss))``), and a reduced TinyLlama's
  training forward with the attention taken out on both sides (each
  package's ``chunked_attention`` returns its queries);
- bytes by hand (exact): one ``addmm``, an elementwise chain, a chain of
  views (0 bytes);
- the kernels on ``meta``: one op per B1 / B2 / B9 call with the cost of
  ``analysis.roofline`` (exact), the forward's B9 once a layer; B3-B8
  raise ValueError naming themselves;
- the collectives of a reduced TinyLlama and a reduced DeepSeek
  tensor-parallel decode step at M = 2 on the counting group: the count by
  kind equal to the program's ``collectives_per_decode_step`` (what
  ``test_torch_tp_serve*.py`` holds the real group to) and the bytes each
  rank sends computed by hand (exact);
- the CLI: ``python -m repro_torch.launch.dryrun --arch tinyllama_1_1b
  --shape decode_32k`` in a subprocess with no CUDA device visible writes a
  ``status: "ok"`` record with ``chips: 256`` and the reference test's keys
  (``tests/test_launch_e2e.py``)."""
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import hlo as jhlo  # noqa: E402
from repro.common import flat as jflat  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.analysis import opcount, roofline as rf  # noqa: E402
from repro_torch.api.state import FlatState  # noqa: E402
from repro_torch.common.config import MeshConfig, OptimizerConfig, ProtocolConfig  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.gossip_sim import SimTrainer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _ref_flops(fn, *args) -> float:
    return jhlo.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


# ---------------------------------------------------------------------------
# FLOPs against the reference's HLO walk
# ---------------------------------------------------------------------------

def test_mlp_gradient_flops_equal_the_reference():
    """The main path's step 1 at W = 4 (within 1%), and by hand (exact). The
    reference's walk adds half the result bytes of every fusion as FLOPs
    (its "roofline noise": here ~2e8, mostly the flat plane's gradient
    fusions); at 1024 rows a worker that is 0.3% of the products."""
    W, B = 4, 1024

    def loss(p, x, y):
        return simple.xent_loss(simple.mlp_logits(p, x), y)

    trainer = SimTrainer(loss, W, ProtocolConfig(comm_probability=0.125),
                         OptimizerConfig(name="nag", learning_rate=0.01, momentum=0.9))
    params = simple.init_mlp(tr.meta_generator())[0]
    stack = tree_map(lambda t: t[None].expand((W,) + tuple(t.shape)), params)
    spec = FlatSpec.build(stack, leading=1)
    theta = {k: _meta(W, n, dtype=getattr(torch, k)) for k, n in spec.totals.items()}
    state = FlatState(spec=spec, theta=theta, opt=None)
    (losses, grads), costs = opcount.count(trainer._grads, state, _meta(W, B, 784),
                                           _meta(W, B, dtype=torch.int32))
    assert losses.shape == (W,) and grads["float32"].shape == theta["float32"].shape

    def jloss(p, x, y):
        return jsimple.xent_loss(jsimple.mlp_logits(p, x), y)

    jparams = jax.eval_shape(lambda k: jsimple.init_mlp(k)[0], jax.random.PRNGKey(0))
    jstack = jax.tree.map(lambda s: jax.ShapeDtypeStruct((W,) + s.shape, s.dtype), jparams)
    jspec = jflat.FlatSpec.build(jstack, leading=1)
    row = jspec.with_lead(())

    def one_loss(bufs, xi, yi):
        return jloss(row.views(bufs), xi, yi)

    jtheta = {k: jax.ShapeDtypeStruct((W, n), jnp.dtype(k)) for k, n in jspec.totals.items()}
    want = _ref_flops(jax.vmap(jax.value_and_grad(one_loss)), jtheta,
                      jax.ShapeDtypeStruct((W, B, 784), jnp.float32),
                      jax.ShapeDtypeStruct((W, B), jnp.int32))
    assert costs.flops == pytest.approx(want, rel=0.01)
    # forward and weight gradients of the four layers, input gradients of
    # the last three
    widths = [(784, 1024), (1024, 1024), (1024, 1024), (1024, 10)]
    assert costs.flops == 2 * W * B * (2 * sum(a * b for a, b in widths)
                                       + sum(a * b for a, b in widths[1:]))
    # every product the port ran is a batched matmul over the W workers
    assert set(k for k in costs.ops if k in ("mm", "bmm", "addmm", "baddbmm")) == {"bmm"}


def _no_attention(q, k, v, **kw):
    return q + (k.sum() + v.sum())


def test_lm_forward_flops_equal_the_reference_without_attention():
    """A reduced TinyLlama's training forward (2 layers, widened to d 1024,
    ffn 2816, 16 heads of 64 over 4 kv heads), B 2 x S 64, the attention
    (each package's ``chunked_attention``) replaced by its queries plus the
    sums of its keys and values on both sides, so XLA keeps the k and v
    projections: within 1% of the reference's walk, and exact by hand. The
    reference adds half the result bytes of every fusion as FLOPs, 1.3% of
    the products at the reduced config's d 256 and 0.3% at d 1024."""
    wide = dict(d_model=1024, d_ff=2816, num_heads=16, num_kv_heads=4, head_dim=64)
    cfg = dataclasses.replace(get_reduced("tinyllama_1_1b"), **wide)
    jcfg = dataclasses.replace(jget_reduced("tinyllama_1_1b"), **wide)
    B, S = 2, 64
    params = tr.abstract_lm(cfg)[0]
    with mock.patch.object(attn, "chunked_attention", _no_attention):
        (hidden, _), costs = opcount.count(tr.forward, params, cfg,
                                           _meta(B, S, dtype=torch.int32))
    assert hidden.shape == (B, S, cfg.d_model)
    jparams = jtr.abstract_lm(jcfg, jnp.float32)[0]
    with mock.patch.object(jattn, "chunked_attention", _no_attention):
        want = _ref_flops(lambda p, t: jtr.forward(p, jcfg, t), jparams,
                          jax.ShapeDtypeStruct((B, S), jnp.int32))
    assert costs.flops == pytest.approx(want, rel=0.01)
    d, hd, H, Hkv, f = 1024, 64, 16, 4, 2816
    per_layer = 2 * B * S * (d * (H + 2 * Hkv) * hd + H * hd * d + 3 * d * f)
    assert costs.flops == cfg.num_layers * per_layer


def test_lm_forward_counts_b9_once_a_layer():
    """Without a gradient the forward's attention is kernel B9: one op a
    layer with ``b9_cost`` at the layer's shapes (exact)."""
    cfg = get_reduced("tinyllama_1_1b")
    B, S = 2, 64
    params = tr.abstract_lm(cfg)[0]
    with torch.no_grad():
        _, costs = opcount.count(tr.forward, params, cfg, _meta(B, S, dtype=torch.int32))
    _, _, by_hand = _layer_b9(cfg, B, S)
    assert costs.ops["flash_attention"] == cfg.num_layers
    with torch.no_grad(), opcount.OpCounter() as c:
        q = _meta(B, S, cfg.num_heads, cfg.resolved_head_dim)
        k = _meta(B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
        ops.attention(q, k, k, causal=True)
    assert (c.costs.flops, c.costs.bytes_accessed) == by_hand


def _layer_b9(cfg, B, S):
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return H, Hkv, rf.b9_cost(B, S, H, Hkv, hd, S, size=4)


# ---------------------------------------------------------------------------
# bytes by hand
# ---------------------------------------------------------------------------

def test_bytes_by_hand():
    M, K, Nn = 16, 32, 8
    with opcount.OpCounter() as c:
        torch.addmm(_meta(Nn), _meta(M, K), _meta(K, Nn))
    assert c.costs.ops == {"addmm": 1}
    assert c.costs.flops == 2 * M * K * Nn
    assert c.costs.bytes_accessed == 4 * (Nn + M * K + K * Nn + M * Nn)

    x = _meta(4, 6)
    with opcount.OpCounter() as c:
        (x * 2 + 1).relu()
    assert c.costs.ops == {"mul": 1, "add": 1, "relu": 1}
    assert (c.costs.flops, c.costs.bytes_accessed) == (0, 3 * 2 * 4 * 6 * 4)

    with opcount.OpCounter() as c:
        x.view(6, 4).t().unsqueeze(0)[..., :3].expand(2, 4, 3)
        x.detach()
    assert (c.costs.ops, c.costs.bytes_accessed) == ({}, 0)


# ---------------------------------------------------------------------------
# the kernels' meta branch
# ---------------------------------------------------------------------------

def test_kernels_on_meta_record_one_op_with_their_cost():
    W, n = 4, 1000
    t, v, g, p = (_meta(W, n) for _ in range(4))
    vb = _meta(W, n, dtype=torch.bfloat16)
    coef = _meta(W)
    with opcount.OpCounter() as c:
        assert ops.fused_flat_elastic_nag_update(t, p, vb, g, coef, 1e-3, 0.9) == (t, vb)
    assert c.costs.ops == {"fused_flat_elastic_nag_update": 1}
    assert (c.costs.flops, c.costs.bytes_accessed) == rf.b1_cost(W, n, 4, 2)
    rows = torch.empty(2, dtype=torch.int32, device=META)
    with opcount.OpCounter() as c:
        ops.fused_flat_elastic_nag_update(t, p, v, g, coef, 1e-3, 0.9, rows=rows)
    assert (c.costs.flops, c.costs.bytes_accessed) == rf.b1_cost(2, n)
    with opcount.OpCounter() as c:
        assert ops.fused_flat_nag_update(t, v, g, 1e-3, 0.9) == (t, v)
    assert c.costs.ops == {"fused_flat_nag_update": 1}
    assert (c.costs.flops, c.costs.bytes_accessed) == rf.b2_cost(W, n)
    # B9: a bf16 prefill and an MLA decode over a cache with kv_len a tensor
    q = _meta(2, 16, 8, 64, dtype=torch.bfloat16)
    k = _meta(2, 16, 2, 64, dtype=torch.bfloat16)
    with opcount.OpCounter() as c:
        out = ops.attention(q, k, k, causal=True)
    assert out.shape == q.shape and out.dtype == torch.bfloat16 and out.device == META
    assert c.costs.ops == {"flash_attention": 1}
    assert (c.costs.flops, c.costs.bytes_accessed) == rf.b9_cost(2, 16, 8, 2, 64, 16)
    qd = _meta(2, 1, 4, 576)
    kc = _meta(2, 40, 1, 576)
    pos = torch.empty((), dtype=torch.int32, device=META)
    with opcount.OpCounter() as c:
        out = ops.attention(qd, kc, kc[..., :512], causal=True, q_offset=pos, kv_len=pos + 1)
    assert out.shape == (2, 1, 4, 512)
    assert c.costs.ops == {"flash_attention": 1, "add": 1}
    assert c.costs.flops == rf.b9_cost(2, 1, 4, 1, 576, 40, dv=512, size=4)[0]


@pytest.mark.parametrize("name,call", [
    ("fused_elastic_nag_update", lambda x: ops.fused_elastic_nag_update(
        x, x, x, x, 0.5, eta=1e-3, mu=0.9)),
    ("robust_flat_apply", lambda x: ops.robust_flat_apply(x, x, 1.0, 1.0)),
    ("q8_encode", lambda x: ops.q8_encode(x, _meta(4, dtype=torch.int64), block=128)),
    ("q8_decode", lambda x: ops.q8_decode(_meta(4, 1024, dtype=torch.int8), _meta(4, 8), 1000,
                                          block=128)),
    ("topk_encode", lambda x: ops.topk_encode(x, None, k=4, block=128)),
    ("topk_decode", lambda x: ops.topk_decode(x, _meta(4, 32, dtype=torch.int32), 1000, k=4,
                                              block=128)),
])
def test_other_kernels_refuse_meta(name, call):
    with pytest.raises(ValueError, match=f"kernel {name} .* CUDA tensor only and has no meta"):
        call(_meta(4, 1000))


# ---------------------------------------------------------------------------
# collectives of the counting group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "deepseek_v2_lite_16b"])
def test_counting_group_collectives(arch):
    """A tensor-parallel decode step at M = 2, bf16, batch 4: the count by
    kind is the program's own, every all-reduce a [B, 1, d] (or [B, d])
    partial and the all-gather the rank's [B, V / 2] logits."""
    cfg = get_reduced(arch)
    B, M = 4, 2
    mesh_cfg = MeshConfig(data=1, model=M, pods=1, workers_per_pod=1)
    prog = specs.serve_program(cfg, "decode", batch=B, seq=1, max_len=16, mesh_cfg=mesh_cfg)
    group = prog.serve.group
    (logits, _), costs = opcount.count(prog.fn, *prog.args)
    assert logits.shape == (B, cfg.vocab_size)
    want = prog.serve.collectives_per_decode_step()
    assert {k: group.counts()[k] for k in want} == want
    n_ar, n_ag = want["all_reduce"], want["all_gather"]
    if arch == "tinyllama_1_1b":
        assert (n_ar, n_ag) == (2 * cfg.num_layers + 1, 1)
    ar = n_ar * B * cfg.d_model * 2 * 2 * (M - 1) / M
    ag = n_ag * B * (cfg.vocab_size // M) * 2 * (M - 1)
    assert costs.collective_breakdown == {"all-reduce": ar, "all-gather": ag}
    assert costs.collective_bytes == ar + ag


def test_counting_worker_group():
    mesh_cfg = MeshConfig(data=8, model=1, pods=1, workers_per_pod=8)
    g = opcount.CountingWorkerGroup(mesh_cfg, rank=3)
    x = _meta(1, 100)
    with opcount.OpCounter() as c:
        assert g.all_reduce_sum(x).shape == (1, 100)
        assert g.all_gather(x).shape == (8, 100)
        out = g.exchange([x, _meta(1, 10, dtype=torch.bfloat16)], partner=2)
        g.exchange([x], partner=3)                      # its own partner: nothing sent
    assert [tuple(t.shape) for t in out] == [(1, 100), (1, 10)]
    assert c.costs.collective_breakdown == {
        "all-reduce": 2 * 7 / 8 * 400, "all-gather": 7 * 400, "collective-permute": 420}
    assert (g.sends, g.recvs) == (2, 2)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_dryrun_cli_single_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama_1_1b",
         "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads((tmp_path / "pod16x16" / "tinyllama_1_1b__decode_32k__decode.json")
                     .read_text())
    assert rec["status"] == "ok"
    assert rec["chips"] == 256
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
              "model_flops", "useful_flops_fraction", "memory_analysis", "count_seconds",
              "fits", "refusal", "plan", "mesh"):
        assert k in rec, k
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    assert rec["ops"]["flash_attention"] == 22            # one B9 a layer
    assert rec["fits"] is True and rec["refusal"] is None
    # a second run resumes from the record
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "tinyllama_1_1b",
         "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0 and "(cached)" in r.stdout, r.stdout + r.stderr
