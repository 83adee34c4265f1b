"""Rematerialisation in LM training (``common/remat.py``, ``cfg.remat`` in
``models/transformer.py::forward`` and the per-key-chunk checkpoint of
``models/attention.py::online_softmax_attention``), at the reduced
configs (2 layers, narrow widths), every cross gate opened to 0.5 and a
random ``cond`` (at zero gates the cross path would be invisible):

- ``remat=True`` against ``remat=False``, losses and flat gradients bit
  for bit, through the sim engine's ``vmap(grad_and_value)``
  (``SimTrainer._grads``) and the dist engine's ``_grads_and_loss`` at
  ``grad_accum`` 2, for every kind: dense, MoE + MLA, xLSTM (mLSTM +
  sLSTM), Zamba2 (a shared site), Llama-3.2-V (a cross block) and MusicGen
  (``attn_cross``). One CPU thread: under ``vmap`` the embedding's
  scatter-add backward sums duplicate tokens in an order that varies from
  run to run on several threads, with or without a checkpoint;
- the port's ``lm_loss`` gradient with ``remat=True`` against the
  reference's (whose default is ``remat=True``) from the same numpy
  parameters, rtol 1e-4 / atol 1e-5;
- the checkpoint itself on a toy: plain autograd, the first-order
  gradients it documents, ``meta``;
- the training route: a checkpointed layer's forward runs with grad mode
  off, and still never reaches ``ops.attention`` (B9 on a card);
- what autograd keeps (``saved_tensors_hooks``) with ``remat=True`` is at
  most the remat ``activation_bytes`` and below the ``remat=False``
  bytes at 3 layers; a subprocess's peak RSS under ``vmap(grad_and_value)``
  grows at least 3x less with ``remat=True`` (a backward that forgot to
  detach would keep every recomputed layer's graph and grow as much);
- on ``meta`` (``analysis/opcount.py``): a remat training program's
  counted FLOPs are the no-remat program's plus one forward of the
  layers, within 1%;
- the memory plan: TinyLlama-1.1B at train_4k's 4,096 tokens, W = 2,
  global batch 8 on an 80 GB card is refused with ``remat=False`` and
  admitted with ``remat=True`` (``step_memory``, arithmetic only)."""
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # see the module docstring

import jax  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.analysis import opcount  # noqa: E402
from repro_torch.api import GossipTrainer  # noqa: E402
from repro_torch.api.state import FlatState  # noqa: E402
from repro_torch.common import remat  # noqa: E402
from repro_torch.common.config import (MeshConfig, OptimizerConfig, ProtocolConfig,  # noqa: E402
                                       TrainConfig)
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.gossip_sim import SimTrainer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as tcli  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train.losses import lm_loss_fn  # noqa: E402
from repro_torch.train.step import DistTrainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["tinyllama_1_1b", "deepseek_v2_lite_16b", "xlstm_125m", "zamba2_2_7b",
         "llama_3_2_vision_11b", "musicgen_large"]
W, PB, SEQ = 2, 2, 16
TOL = dict(rtol=1e-4, atol=1e-5)
GATE = 0.5


def _open_gates(tree):
    """The parameter tree (numpy or torch) with every cross gate at GATE."""
    if isinstance(tree, dict):
        return {k: (v * 0 + GATE if k in ("gate", "ffn_gate") else _open_gates(v))
                for k, v in tree.items()}
    return tree


def _tokens(cfg, rng, lead):
    K = () if cfg.audio is None else (cfg.audio.num_codebooks,)
    return rng.randint(0, cfg.vocab_size, lead + K + (SEQ,)).astype(np.int32)


def _cond(cfg, rng, lead):
    if cfg.audio is not None:
        shape = (cfg.audio.num_cond_tokens, cfg.d_model)
    elif cfg.vlm is not None:
        shape = (cfg.vlm.num_image_tokens, cfg.vlm.image_embed_dim)
    else:
        return None
    return rng.randn(*(lead + shape)).astype(np.float32)


def _batch(cfg, seed=1):
    """(x, y) of W workers: x the tokens, or {"tokens", "cond"}."""
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(_tokens(cfg, rng, (W, PB)))
    labels = _tokens(cfg, rng, (W, PB))
    labels[(0, 0) + (0,) * (labels.ndim - 3) + (3,)] = -1       # a masked position
    cond = _cond(cfg, rng, (W, PB))
    x = toks if cond is None else {"tokens": toks, "cond": torch.from_numpy(cond)}
    return x, torch.from_numpy(labels)


def _params(cfg):
    gen = torch.Generator().manual_seed(0)
    return _open_gates(tr.init_lm(gen, cfg)[0])


def _cfgs(arch):
    cfg = get_reduced(arch)
    return dataclasses.replace(cfg, remat=True), dataclasses.replace(cfg, remat=False)


def _assert_bits_equal(a, b, what):
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k, float((a[k] - b[k]).abs().max()))


# ---------------------------------------------------------------------------
# remat=True against remat=False, through the engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_under_the_sim_engine(arch):
    """Losses and flat gradients bit-equal through ``SimTrainer._grads``
    (``vmap(grad_and_value)`` over W = 2 rows of a perturbed plane)."""
    x, y = _batch(get_reduced(arch))
    out = {}
    for cfg in _cfgs(arch):
        trainer = GossipTrainer(engine="sim", protocol=ProtocolConfig(comm_probability=0.5),
                                optimizer=OptimizerConfig(name="nag", learning_rate=1e-2,
                                                          momentum=0.9),
                                loss_fn=lm_loss_fn(cfg), num_workers=W, device="cpu")
        state = trainer.init_state(0, params=_params(cfg))
        rng = np.random.RandomState(5)
        theta = {k: b + torch.from_numpy(rng.randn(*b.shape).astype(np.float32)) * 1e-3
                 for k, b in state.theta.items()}
        out[cfg.remat] = trainer.sim._grads(state.replace(theta=theta), x, y)
    (l1, g1), (l0, g0) = out[True], out[False]
    assert torch.isfinite(l1).all() and l1.shape == (W,)
    assert torch.equal(l1, l0)
    _assert_bits_equal(g1, g0, arch)


class _CPUGroup:
    """The part of a worker group ``DistTrainer._grads_and_loss`` reads."""
    world, rank, device = W, 0, torch.device("cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_on_the_dist_engine_with_grad_accum(arch):
    """Rank 0's loss and flat gradient bit-equal through
    ``DistTrainer._grads_and_loss`` with ``grad_accum`` 2 (two microbatches
    of one sequence each)."""
    x, y = _batch(get_reduced(arch))
    x0 = tree_map(lambda t: t[0], x)
    mesh = MeshConfig(data=W, model=1, pods=1, workers_per_pod=W)
    tc = TrainConfig(protocol=ProtocolConfig(method="elastic_gossip", comm_probability=0.5,
                                             moving_rate=0.5),
                     optimizer=OptimizerConfig(name="nag", learning_rate=1e-2, momentum=0.9))
    out = {}
    for cfg in _cfgs(arch):
        trainer = DistTrainer(_CPUGroup(), mesh, tc, model_cfg=cfg, grad_accum=2)
        state = trainer.init_state(_params(cfg))
        out[cfg.remat] = trainer._grads_and_loss(state, x0, y[0])
    (l1, g1), (l0, g0) = out[True], out[False]
    assert torch.isfinite(l1).all()
    assert torch.equal(l1, l0)
    _assert_bits_equal(g1, g0, arch)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradient_matches_the_reference(arch):
    """The port's ``lm_loss`` and its gradient per leaf (plain autograd,
    ``remat=True``) against ``jax.grad`` of the reference's (its default
    ``remat=True``) from the same numpy parameters: rtol 1e-4 / atol
    1e-5."""
    jcfg = jget_reduced(arch)
    assert jcfg.remat
    cfg = dataclasses.replace(get_reduced(arch), remat=True)
    jp_np = _open_gates(jax.tree.map(np.asarray, jtr.init_lm(jax.random.PRNGKey(0), jcfg)[0]))
    rng = np.random.RandomState(3)
    toks, labels = _tokens(cfg, rng, (PB,)), _tokens(cfg, rng, (PB,))
    cond = _cond(cfg, rng, (PB,))

    def jloss(p):
        return jtr.lm_loss(p, jcfg, toks, labels, cond)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp_np)
    p = tr.params_from_jax(jp_np, "cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    loss, _ = tr.lm_loss(p, cfg, torch.from_numpy(toks), torch.from_numpy(labels),
                         None if cond is None else torch.from_numpy(cond))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    got, _ = tree_flatten(tree_map(lambda t: t.grad.numpy(), p))
    want, _ = tree_flatten(jax.tree.map(np.asarray, jg))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


# ---------------------------------------------------------------------------
# the checkpoint on a toy
# ---------------------------------------------------------------------------

def _toy_layer(p, x, scale):
    return {"y": torch.tanh(x @ p["w"]) * scale + x, "aux": (x * x).sum()}


def _toy_loss(params, x, use_remat):
    aux = 0.0
    for w in params["w"].unbind(0):
        o = (remat.checkpoint(_toy_layer, {"w": w}, x, 0.5) if use_remat
             else _toy_layer({"w": w}, x, 0.5))
        x, aux = o["y"], aux + o["aux"]
    return (x ** 2).mean() + 0.01 * aux


def test_checkpoint_on_a_toy_under_plain_autograd_vmap_and_meta():
    """Pytrees in and out, python constants riding along: gradients bit-equal
    to the plain stack in f64 under plain autograd and under
    ``vmap(grad_and_value)``; on ``meta`` the shapes come out."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(3, 8, 8) / 4)
    x = torch.from_numpy(rng.randn(4, 8))
    grads = {}
    for use in (False, True):
        p = {"w": w.clone().requires_grad_(True)}
        _toy_loss(p, x, use).backward()
        grads[use] = p["w"].grad
    assert torch.equal(grads[True], grads[False])
    ws, xs = w[None].repeat(2, 1, 1, 1), torch.stack([x, x + 1])
    out = {use: vmap(grad_and_value(lambda p, xi: _toy_loss(p, xi, use)))({"w": ws}, xs)
           for use in (False, True)}
    assert torch.equal(out[True][1], out[False][1])
    assert torch.equal(out[True][0]["w"], out[False][0]["w"])
    g, l = vmap(grad_and_value(lambda p, xi: _toy_loss(p, xi, True)))(
        {"w": torch.empty(2, 3, 8, 8, device="meta")}, torch.empty(2, 4, 8, device="meta"))
    assert g["w"].shape == (2, 3, 8, 8) and g["w"].device.type == "meta" and l.shape == (2,)


def test_checkpoint_gradients_are_first_order():
    """The backward's gradients do not depend on the inputs through the
    recompute (the saved inputs and the cotangents are detached): a second
    derivative through a checkpoint is zero where the plain one is not."""
    x = torch.tensor([0.3, -0.7], dtype=torch.float64, requires_grad=True)
    for use, nonzero in ((False, True), (True, False)):
        y = remat.checkpoint(torch.sin, x) if use else torch.sin(x)
        (g,) = torch.autograd.grad(y.sum(), x, create_graph=True)
        assert torch.equal(g.detach(), torch.cos(x).detach())
        second = torch.autograd.grad(g.sum(), x, allow_unused=True)[0] if g.requires_grad \
            else None
        assert (second is not None and bool((second != 0).any())) == nonzero


# ---------------------------------------------------------------------------
# the training route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "deepseek_v2_lite_16b",
                                  "llama_3_2_vision_11b", "musicgen_large"])
def test_checkpointed_layers_never_reach_the_attention_kernel(arch):
    """Plain autograd with ``remat=True``: a checkpointed layer's forward runs
    with grad mode off, where its inputs do not require grad; the route
    decided outside the checkpoint still keeps every attention (self,
    cross, MLA) off ``ops.attention`` in the forward and the backward. A
    forward under ``no_grad`` does reach it, once a layer at least."""
    cfg, _ = _cfgs(arch)
    x, y = _batch(cfg)
    x0, y0 = tree_map(lambda t: t[0], x), y[0]
    toks, cond = (x0["tokens"], x0["cond"]) if isinstance(x0, dict) else (x0, None)
    p = _params(cfg)
    for t in tree_leaves(p):
        t.requires_grad_(True)
    with mock.patch.object(ops, "attention", side_effect=AssertionError("B9 in training")):
        tr.lm_loss(p, cfg, toks, y0, cond)[0].backward()
    assert all(t.grad is not None for t in tree_leaves(p))
    with torch.no_grad(), mock.patch.object(ops, "attention", wraps=ops.attention) as spy:
        tr.lm_loss(p, cfg, toks, y0, cond)
    assert spy.call_count >= cfg.num_layers


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def _saved_bytes(cfg, p, toks, labels, cond):
    """Bytes of every storage autograd saves for ``lm_loss``'s backward
    (parameters left out, each storage once)."""
    own = {t.untyped_storage().data_ptr() for t in tree_leaves(p)}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            saved[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tr.lm_loss(p, cfg, toks, labels, cond)
    return sum(saved.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_bytes_within_the_remat_estimate(arch):
    """At 3 layers (Zamba2 at 4: one more segment, two shared sites), 4 x 32
    tokens: what autograd keeps with ``remat=True`` is at most the remat
    ``activation_bytes`` and below what it keeps with ``remat=False``."""
    layers = 4 if arch == "zamba2_2_7b" else 3
    base = dataclasses.replace(get_reduced(arch), num_layers=layers)
    rng = np.random.RandomState(7)
    K = () if base.audio is None else (base.audio.num_codebooks,)
    toks = torch.from_numpy(rng.randint(0, base.vocab_size, (4,) + K + (32,)).astype(np.int32))
    cond = _cond(base, rng, (4,))
    cond = None if cond is None else torch.from_numpy(cond)
    p = _params(base)
    for t in tree_leaves(p):
        t.requires_grad_(True)
    got = {}
    for r in (True, False):
        cfg = dataclasses.replace(base, remat=r)
        got[r] = _saved_bytes(cfg, p, toks, toks, cond)
    est = tcli.activation_bytes(dataclasses.replace(base, remat=True), 4 * 32, 32)
    assert 0 < got[True] <= est, (got, est)
    assert got[True] < got[False], got


_RSS_CHILD = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(2)
from torch.func import grad_and_value, vmap
from repro_torch.common.flat import FlatSpec
from repro_torch.configs import get_reduced
from repro_torch.models import transformer as tr

cfg = dataclasses.replace(get_reduced("tinyllama_1_1b"), num_layers=12, d_ff=512,
                          remat=sys.argv[1] == "1")
params = tr.init_lm(torch.Generator().manual_seed(0), cfg)[0]
spec = FlatSpec.build(params)
row = spec.flatten(params)
theta = {k: v[None].repeat(2, 1) for k, v in row.items()}
tokens = torch.randint(0, cfg.vocab_size, (2, 2, 256), generator=torch.Generator().manual_seed(1))
one = spec.with_lead(())

def loss(bufs, t):
    return tr.lm_loss(one.views(bufs), cfg, t, t)[0]

def hwm():
    # this process's peak RSS (VmHWM: its own address space's, where
    # ru_maxrss would carry a large parent's over the fork)
    with open("/proc/self/status") as f:
        return next(int(x.split()[1]) * 1024 for x in f if x.startswith("VmHWM:"))

vmap(grad_and_value(loss))(theta, tokens[:, :1, :32])       # warm-up, small
before = hwm()
g, l = vmap(grad_and_value(loss))(theta, tokens)
peak = hwm()
print(json.dumps({"grow": peak - before, "loss": l.tolist()}))
"""


def test_remat_peak_rss_under_vmap_grows_3x_less():
    """A subprocess each: TinyLlama reduced at 12 layers (ffn 512), W = 2
    workers of 2 x 256 tokens under ``vmap(grad_and_value)``; the peak
    RSS's growth over the step (~0.8 GB with ``remat=False``) is at least
    3x smaller with ``remat=True``, and the losses are equal."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = {}
    for r in ("0", "1"):
        res = subprocess.run([sys.executable, "-c", _RSS_CHILD, r], capture_output=True,
                             text=True, timeout=300, env=env, cwd=REPO)
        assert res.returncode == 0, res.stderr[-2000:]
        out[r] = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["0"]["loss"] == out["1"]["loss"]
    assert out["0"]["grow"] > 2e8, out
    assert 3 * out["1"]["grow"] <= out["0"]["grow"], out


# ---------------------------------------------------------------------------
# counted on meta
# ---------------------------------------------------------------------------

def test_meta_remat_flops_are_one_more_forward_of_the_layers():
    """A reduced TinyLlama (3 layers, widened to d 1024, 16 heads of 64 over
    4 kv heads, ffn 2816) through ``SimTrainer._grads`` at W = 2, B 2 x S
    128 on ``meta``: the remat program's counted FLOPs are the no-remat
    program's plus the layers' training forward (``tr.forward`` on the
    attention's training route, grad mode off), within 1%."""
    wide = dict(d_model=1024, d_ff=2816, num_heads=16, num_kv_heads=4, head_dim=64,
                num_layers=3)
    Wm, B, S = 2, 2, 128
    flops = {}
    for r in (True, False):
        cfg = dataclasses.replace(get_reduced("tinyllama_1_1b"), remat=r, **wide)
        trainer = SimTrainer(lm_loss_fn(cfg), Wm, ProtocolConfig(comm_probability=0.5),
                             OptimizerConfig(name="nag", learning_rate=0.01, momentum=0.9))
        params = tr.abstract_lm(cfg)[0]
        stack = tree_map(lambda t: t[None].expand((Wm,) + tuple(t.shape)), params)
        spec = FlatSpec.build(stack, leading=1)
        theta = {k: torch.empty(Wm, n, dtype=getattr(torch, k), device="meta")
                 for k, n in spec.totals.items()}
        toks = torch.empty(Wm, B, S, dtype=torch.int32, device="meta")
        (losses, grads), costs = opcount.count(
            trainer._grads, FlatState(spec=spec, theta=theta, opt=None), toks, toks)
        assert losses.shape == (Wm,) and grads["float32"].shape == theta["float32"].shape
        flops[r] = costs.flops
    params = tr.abstract_lm(cfg)[0]
    with torch.no_grad(), attn.train_route():
        _, fwd = opcount.count(tr.forward, params, cfg,
                               torch.empty(Wm * B, S, dtype=torch.int32, device="meta"))
    assert fwd.flops > 0 and "flash_attention" not in fwd.ops
    assert flops[True] == pytest.approx(flops[False] + fwd.flops, rel=0.01)


# ---------------------------------------------------------------------------
# the memory plan
# ---------------------------------------------------------------------------

def test_step_memory_admits_train_4k_only_with_remat():
    """TinyLlama-1.1B f32 at W = 2, global batch 8 of 4,096 tokens against
    an 80 GB card: ``remat=False`` is refused, ``remat=True`` admitted,
    and the remat estimate is the smaller."""
    cfg = get_config("tinyllama_1_1b")
    assert cfg.remat
    avail = 80 * 10 ** 9
    need = tcli.step_memory(cfg, 2, 8 * 4096, 4096, None, avail=avail)
    assert 4 * 2 * tcli.replica_bytes(cfg) < need <= avail
    with pytest.raises(ValueError, match="needs"):
        tcli.step_memory(dataclasses.replace(cfg, remat=False), 2, 8 * 4096, 4096, None,
                         avail=avail)
    assert (tcli.activation_bytes(cfg, 8 * 4096, 4096)
            < tcli.activation_bytes(dataclasses.replace(cfg, remat=False), 8 * 4096, 4096))
