"""MoE FFNs and MLA attention (``repro_torch.models.moe``, the MLA half of
``repro_torch.models.attention``) against the reference's
(``repro.models``) on the same numpy inputs and weights: routing integers
(top-k ids, the capacity C, ``dest``, ``keep``, the aux loss's counts)
bit-equal, floats within the stated tolerances; the reduced
``deepseek_v2_lite_16b`` (MLA + MoE with a shared expert, first layer
dense) and ``grok_1_314b`` (GQA + MoE) through the whole model (forward,
``lm_loss``, prefill and 12 decode steps) and through the continuous
batcher; the training entry points take both (their training is held in
tests/test_torch_moe_train.py) and refuse SSM and hybrid models, naming
ROADMAP.md 7b.4e. Attention runs B9's plain version (the tensors lie on the
CPU)."""
import dataclasses
import functools
import hashlib
from unittest import mock

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import MeshConfig  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import LiveServer as JServer  # noqa: E402
from repro.serve import SnapshotBus as JBus  # noqa: E402
from repro.serve import TrafficGen as JTraffic  # noqa: E402
from repro.serving.engine import make_serve_program as jmake  # noqa: E402
from repro_torch.common.pytree import tree_flatten  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import ContinuousBatcher, LiveServer, SnapshotBus, TrafficGen  # noqa: E402
from repro_torch.serving.engine import make_serve_program  # noqa: E402

MOE_ARCHS = ["deepseek_v2_lite_16b", "grok_1_314b"]
# one MoE layer: in f64 on both sides (the reference under jax.enable_x64;
# both route in f32, as the reference does), since in f32 the two
# frameworks' matmul sum orders differ by up to a few ulps, past atol 1e-6
# at outputs of magnitude 4
RTOL, ATOL = 1e-5, 1e-6
MLA_RTOL, MLA_ATOL = 1e-4, 1e-5  # MLA's absorbed attention in f32


def _cfgs(arch, **moe_kw):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _moe_params(jcfg, seed=0, dtype=jnp.float32):
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    return jp, tr.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, S, d, seed=1, dtype=np.float32):
    a = np.random.RandomState(seed).randn(B, S, d).astype(dtype)
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _reference_routing(jp, jx, jcfg, capacity_factor=0.0):
    """The reference's moe_forward with its C read off the buffer it builds,
    then its ids, dest and keep on the same inputs (the vmap'd
    ``_build_buffer`` of its shards)."""
    seen = {}
    real = jmoe._build_buffer

    def spy(xt, ids, w, E, k, C):
        seen["C"] = C
        return real(xt, ids, w, E, k, C)

    with mock.patch.object(jmoe, "_build_buffer", spy):
        y, aux = jmoe.moe_forward(jp, jx, jcfg, capacity_factor)
    m = jcfg.moe
    B, S, d = jx.shape
    T, ds = B * S, max(1, m.dispatch_shards)
    probs, w, ids = jmoe._route(jx.reshape(T, d) @ jp["router"], m.top_k)
    _, dest, _, _, keep = jax.vmap(
        lambda a, b, c: real(a, b, c, m.num_experts, m.top_k, seen["C"]))(
        jx.reshape(ds, T // ds, d), ids.reshape(ds, T // ds, m.top_k),
        w.reshape(ds, T // ds, m.top_k))
    counts = jnp.sum(jax.nn.one_hot(ids[:, 0], m.num_experts, dtype=jnp.int32), axis=0)
    return y, aux, dict(C=seen["C"], ids=ids, dest=dest, keep=keep, counts=counts)


def _port_routing(tp, tx, cfg, capacity_factor=0.0):
    """The port's routing integers on the same inputs, through the functions
    its moe_forward calls: the capacity, ``_route`` and each shard's
    ``_build_buffer``."""
    m = cfg.moe
    B, S, d = tx.shape
    T, ds = B * S, max(1, m.dispatch_shards)
    C = moe.capacity(cfg, T, capacity_factor)
    _, w, ids = moe._route(tx.reshape(T, d) @ tp["router"], m.top_k)
    shards = [moe._build_buffer(a, b, c, m.num_experts, m.top_k, C) for a, b, c in
              zip(tx.reshape(ds, T // ds, d), ids.reshape(ds, T // ds, m.top_k),
                  w.reshape(ds, T // ds, m.top_k))]
    return dict(C=C, ids=ids, dest=torch.stack([s[1] for s in shards]),
                keep=torch.stack([s[4] for s in shards]))


# (tag, moe overrides, capacity_factor, B, S): the config's own capacity, a
# factor that drops tokens, routing in 2 shards, and both at once
MOE_CASES = [
    ("default", {}, 0.0, 2, 12),
    ("drops tokens", {}, 0.5, 2, 12),
    ("dispatch_shards 2", {"dispatch_shards": 2}, 0.0, 2, 12),
    ("shards 2 and drops", {"dispatch_shards": 2}, 0.6, 4, 6),
]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("tag,kw,cf,B,S", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_forward_matches_reference(x64, arch, tag, kw, cf, B, S):
    """Routing ids, C, dest, keep and the aux loss's counts bit-equal; the
    output and the aux loss within rtol 1e-5 / atol 1e-6 (f64)."""
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _moe_params(jcfg, dtype=jnp.float64)
    jx, tx = _x(B, S, cfg.d_model, dtype=np.float64)
    jy, jaux, want = _reference_routing(jp, jx, jcfg, cf)
    got = _port_routing(tp, tx, cfg, cf)
    with torch.no_grad():
        ty, taux = moe.moe_forward(tp, tx, cfg, cf)
    assert got["C"] == want["C"]
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(want["ids"]))
    np.testing.assert_array_equal(got["dest"].numpy(), np.asarray(want["dest"]))
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
    counts = torch.bincount(got["ids"][:, 0], minlength=cfg.moe.num_experts)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want["counts"]))
    if tag != "default":
        assert not bool(got["keep"].all()), "the case must drop tokens"
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T,E,k,cf,ds,want", [
    (8, 64, 6, 1.25, 1, 1),          # DeepSeek at decode, 8 slots: tokens dropped
    (4096, 64, 6, 1.25, 1, 480),     # DeepSeek's prefill, 8 x 512
    (16, 8, 2, 1.25, 1, 5),          # Grok
    (24, 4, 2, 0.5, 2, 3),
])
def test_capacity_is_the_reference_arithmetic(T, E, k, cf, ds, want):
    cfg = get_config("deepseek_v2_lite_16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=E, top_k=k, capacity_factor=cf, dispatch_shards=ds))
    assert moe.capacity(cfg, T) == want == max(int(T * k / (E * ds) * cf), 1)


def test_decode_capacity_drops_the_reference_tokens(x64):
    """DeepSeek's 64 experts top-6 at 8 tokens (C = 1), at narrow widths:
    the same tokens are kept and dropped, and the outputs agree (f64)."""
    jcfg, cfg = _cfgs("deepseek_v2_lite_16b", num_experts=64, top_k=6, d_ff_expert=16)
    jp, tp = _moe_params(jcfg, seed=3, dtype=jnp.float64)
    jx, tx = _x(8, 1, cfg.d_model, seed=4, dtype=np.float64)
    jy, _, want = _reference_routing(jp, jx, jcfg)
    got = _port_routing(tp, tx, cfg)
    with torch.no_grad():
        ty, _ = moe.moe_forward(tp, tx, cfg)
    assert got["C"] == want["C"] == 1
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
    np.testing.assert_array_equal(got["dest"].numpy(), np.asarray(want["dest"]))
    assert int(got["keep"].sum()) < 8 * 6
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal probabilities: the stable sort keeps jax.lax.top_k's order."""
    logits = np.array([[0.0, 1.0, 1.0, 0.0, 1.0], [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    _, jw, jids = jmoe._route(jnp.asarray(logits), 3)
    _, tw, tids = moe._route(torch.from_numpy(logits), 3)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tids.numpy(), [[1, 2, 4], [0, 1, 2]])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-7)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_stats_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, seed=5)
    jx, tx = _x(3, 10, cfg.d_model, seed=6)
    want = jmoe.router_stats(jp, jx, jcfg)
    got = moe.router_stats(tp, tx, cfg)
    np.testing.assert_array_equal(got["expert_load"].numpy(), np.asarray(want["expert_load"]))
    np.testing.assert_allclose(float(got["router_entropy"]), float(want["router_entropy"]),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _mla_setup():
    jcfg, cfg = _cfgs("deepseek_v2_lite_16b")
    jp, _ = jattn.init_mla(jax.random.PRNGKey(7), jcfg)
    return jcfg, cfg, jp, tr.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _mla_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MLA_RTOL, atol=MLA_ATOL)


def test_mla_forward_matches_reference():
    jcfg, cfg, jp, tp = _mla_setup()
    jx, tx = _x(2, 16, cfg.d_model, seed=8)
    jy, (jc, jkr) = jattn.mla_forward(jp, jx, jcfg)
    with torch.no_grad():
        ty, (tc, tkr) = tattn.mla_forward(tp, tx, cfg)
    _mla_close(ty, jy)
    _mla_close(tc, jc)
    _mla_close(tkr, jkr)


@pytest.mark.parametrize("kv_start", [None, [0, 9]])
def test_mla_prefill_then_decode_matches_reference(kv_start):
    """A 10-token prefill padded to 24 rows, then 8 decode steps writing the
    latent cache in place (with per-row kv_start when given)."""
    jcfg, cfg, jp, tp = _mla_setup()
    jx, tx = _x(2, 18, cfg.d_model, seed=9)
    _, (jc, jkr) = jattn.mla_forward(jp, jx[:, :10], jcfg)
    with torch.no_grad():
        _, (tc, tkr) = tattn.mla_forward(tp, tx[:, :10], cfg)
    pad = ((0, 0), (0, 14), (0, 0))
    jc, jkr = jnp.pad(jc, pad), jnp.pad(jkr, pad)
    tc = torch.nn.functional.pad(tc, (0, 0, 0, 14)).contiguous()
    tkr = torch.nn.functional.pad(tkr, (0, 0, 0, 14)).contiguous()
    jks = None if kv_start is None else jnp.asarray(np.array(kv_start, np.int32))
    tks = None if kv_start is None else torch.tensor(kv_start, dtype=torch.int32)
    for t in range(10, 18):
        jy, jc, jkr = jattn.mla_decode(jp, jx[:, t:t + 1], jc, jkr, jnp.int32(t), jcfg,
                                       kv_start=jks)
        with torch.no_grad():
            ty, tc, tkr = tattn.mla_decode(tp, tx[:, t:t + 1], tc, tkr,
                                           torch.tensor(t, dtype=torch.int32), cfg,
                                           kv_start=tks)
        _mla_close(ty, jy)
    _mla_close(tc, jc)
    _mla_close(tkr, jkr)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

B, S, MAX_LEN, STEPS = 2, 12, 24, 12


@functools.lru_cache(maxsize=None)
def _lm(arch, f64=False):
    """The reference's init_lm weights (f64 ones to be used under the x64
    fixture: the whole-model comparisons run in f64 on both sides, as the
    MoE layer's do), carried across, and the tokens."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    if f64:
        with jax.enable_x64(True):
            jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg, jnp.float64)
    else:
        jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    return jcfg, cfg, jp, tr.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), toks


def _close(port, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_plan_equals_reference(arch):
    jplan, plan = jtr.make_plan(jget_reduced(arch)), tr.make_plan(get_reduced(arch))
    assert plan.segments == tuple(tr.Segment(**dataclasses.asdict(s)) for s in jplan.segments)
    assert plan.events == jplan.events
    full = tr.make_plan(get_config(arch))
    assert full.segments == tuple(tr.Segment(**dataclasses.asdict(s))
                                  for s in jtr.make_plan(jtr_cfg(arch)).segments)


def jtr_cfg(arch):
    from repro.configs import get_config as jget_config
    return jget_config(arch)


def test_deepseek_full_plan_and_shapes():
    """DeepSeek-V2-Lite-16B: seg0_attn (1 dense layer) + seg1_attn_moe (26),
    MLA 512 + 64, 64 experts of 1408 and 2 shared, 15.7e9 parameters, the
    reference's abstract tree leaf for leaf."""
    cfg = get_config("deepseek_v2_lite_16b")
    plan = tr.make_plan(cfg)
    assert [(s.name, s.count, s.use_moe) for s in plan.segments] == [
        ("seg0_attn", 1, False), ("seg1_attn_moe", 26, True)]
    ours, _ = tr.abstract_lm(cfg)
    ref = jtr.abstract_lm(jtr_cfg("deepseek_v2_lite_16b"))[0]
    leaves, _ = tree_flatten(ours)
    assert [tuple(t.shape) for t in leaves] == [tuple(x.shape) for x in jax.tree.leaves(ref)]
    seg = ours["segments"]["seg1_attn_moe"]
    assert tuple(seg["ffn"]["w_up"].shape) == (26, 64, 2048, 1408)
    assert tuple(seg["attn"]["kv_down"].shape) == (26, 2048, 576)
    assert sum(t.numel() for t in leaves) == 15_706_484_224


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_lm_flat_layout_equals_reference(arch):
    """The port's own init_lm tree has the reference's keys and shapes, so
    FlatSpec offsets and totals are equal, and the carried-across weights
    flatten to the reference's buffers element for element."""
    from repro.common.flat import FlatSpec as JFlatSpec
    from repro_torch.common.flat import FlatSpec
    jcfg, cfg, jp, tp, _ = _lm(arch)
    own, _ = tr.init_lm(torch.Generator().manual_seed(0), cfg)
    jspec, spec = JFlatSpec.build(jp, leading=0), FlatSpec.build(own, leading=0)
    assert spec.totals == dict(jspec.totals)
    assert [(s.bucket, s.offset, s.size, s.shape) for s in spec.slots] == \
        [(s.bucket, s.offset, s.size, tuple(s.shape)) for s in jspec.slots]
    jbufs, bufs = jspec.flatten(jp), FlatSpec.build(tp, leading=0).flatten(tp)
    for k in jbufs:
        np.testing.assert_array_equal(bufs[k].numpy(), np.asarray(jbufs[k]))


def test_init_lm_draws_what_it_drew_before_preallocating():
    """init_lm fills preallocated [count, ...] leaves layer by layer: the
    parameters (TinyLlama reduced, seed 0, f32 and bf16) are the bytes the
    list-then-stack init gave."""
    h = hashlib.sha256()
    for dt in (torch.float32, torch.bfloat16):
        p, _ = tr.init_lm(torch.Generator().manual_seed(0), get_reduced("tinyllama_1_1b"), dt)
        for t in tree_flatten(p)[0]:
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == "fa9381c0d4b5845fb1a050ddac746544a4f9526a215fc60d4051ba12c21626c1"


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_lm_loss_match_reference(x64, arch):
    """The training forward's hidden states and aux loss, and lm_loss's
    total, ce and aux (f64)."""
    jcfg, cfg, jp, tp, toks = _lm(arch, True)
    t = toks[:, :S]
    labels = np.roll(t, -1, axis=1)
    labels[:, -1] = -1
    jh, jaux = jtr.forward(jp, jcfg, jnp.asarray(t))
    jl, jparts = jtr.lm_loss(jp, jcfg, jnp.asarray(t), jnp.asarray(labels))
    with torch.no_grad():
        th, taux = tr.forward(tp, cfg, torch.from_numpy(t))
        tl, tparts = tr.lm_loss(tp, cfg, torch.from_numpy(t), torch.from_numpy(labels))
    _close(th, jh)
    assert float(jaux) > 0
    _close(taux, jaux)
    _close(tl, jl)
    for k in ("ce", "aux"):
        _close(tparts[k], jparts[k])


def _cache_close(tc, jc):
    for seg, c in jc["segments"].items():
        for name, want in c.items():
            got = tc["segments"][seg][name]
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("kv_start", [None, [0, 5]])
def test_prefill_and_12_decode_steps_match_reference(x64, arch, kv_start):
    """Prefill logits and cache (MLA: c_kv, k_rope), then 12 decode steps
    (per-row kv_start when given), logits and caches within rtol 1e-4 /
    atol 1e-5 (f64 weights; the caches are f32 on both sides)."""
    jcfg, cfg, jp, tp, toks = _lm(arch, True)
    jl, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks[:, :S]), max_len=MAX_LEN)
    with torch.no_grad():
        tl, tc = tr.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=MAX_LEN)
    _close(tl, jl)
    _cache_close(tc, jc)
    jks = None if kv_start is None else jnp.asarray(np.array(kv_start, np.int32))
    tks = None if kv_start is None else torch.tensor(kv_start, dtype=torch.int32)
    jstep = jax.jit(lambda p, c, t, ks: jtr.decode_step(p, jcfg, c, t, kv_start=ks))
    for t in range(S, S + STEPS):
        tok = toks[:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jks)
        with torch.no_grad():
            tl, tc = tr.decode_step(tp, cfg, tc, torch.from_numpy(tok), kv_start=tks)
        _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == S + STEPS
    _cache_close(tc, jc)


def test_mla_cache_tree_is_the_reference():
    jcfg, cfg = jget_reduced("deepseek_v2_lite_16b"), get_reduced("deepseek_v2_lite_16b")
    jc, ja = jtr.init_cache(jcfg, 3, 20)
    tc, ta = tr.init_cache(cfg, 3, 20)
    for seg, c in jc["segments"].items():
        assert {k: tuple(v.shape) for k, v in tc["segments"][seg].items()} == \
            {k: tuple(v.shape) for k, v in c.items()}
        assert set(c) == {"c_kv", "k_rope"}
    assert ta == ja


def test_mla_refuses_the_ring_buffer():
    _, cfg, _, tp, toks = _lm("deepseek_v2_lite_16b")
    cache, _ = tr.init_cache(cfg, B, MAX_LEN, window=8)
    with pytest.raises(ValueError, match="ring-buffer"):
        tr.decode_step(tp, cfg, cache, torch.from_numpy(toks[:, :1]), window=8)


def test_moe_batcher_streams_equal_reference():
    """Reduced DeepSeek through the reference's continuous batcher and the
    port's: every completed record (arrival, admit, first token, done,
    greedy tokens) and the latency summary are equal. Recycled slots zero
    their c_kv and k_rope rows in place (``_reset`` over every cache leaf)."""
    arch = "deepseek_v2_lite_16b"
    jcfg, cfg, jp, tp, _ = _lm(arch)
    kw = dict(rate=0.8, num_requests=10, vocab=cfg.vocab_size, prompt_len=(1, 3),
              max_new=(2, 5))
    jprog = jmake(make_host_mesh(1), MeshConfig(data=1, model=1, pods=1, workers_per_pod=1),
                  jcfg, batch=4, max_len=48, param_dtype=jnp.float32, cache_dtype=jnp.float32)
    jbus = JBus()
    jbus.publish_params(jp)
    jserver = JServer(jprog, jbus)
    jserver.maybe_swap()
    jbat = JBatcher(jserver, JTraffic(11, **kw).requests())
    jbat.run(46)
    prog = make_serve_program(cfg, batch=4, max_len=48, param_dtype=torch.float32,
                              cache_dtype=torch.float32, device="cpu")
    bus = SnapshotBus()
    bus.publish_params(tp)
    server = LiveServer(prog, bus)
    assert server.maybe_swap()
    bat = ContinuousBatcher(server, TrafficGen(11, **kw).requests())
    resets = []
    real = bat._reset

    def spy(keep):
        real(keep)
        for seg in bat.cache["segments"].values():
            assert set(seg) == {"c_kv", "k_rope"}
            for a in seg.values():
                resets.append(bool((a[:, ~keep] == 0).all()))

    bat._reset = spy
    bat.run(46)
    bat.check_invariants()
    assert resets and all(resets)
    assert bat.completed == jbat.completed
    assert bat.latency_summary() == jbat.latency_summary()


@pytest.mark.parametrize("arch", ["xlstm_125m", "zamba2_2_7b"])
def test_training_entry_points_refuse_ssm_and_hybrid_until_7b4e(arch):
    """launch.train and launch.serve refused SSM and hybrid models until
    ROADMAP.md 7b.4e, which lifted the refusal: both now build and take a
    step (one training step; one train-while-serve boundary) with a finite
    loss. Their parity with the reference: tests/test_torch_ssm_train.py."""
    _, hist = train_cli.run(arch, reduced=True, steps=1, method="elastic_gossip", p=0.5,
                            tau=0, alpha=0.5, lr=1e-2, workers=2, global_batch=4, seq=8,
                            engine="sim", device="cpu")
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    ts = serve_cli.build(arch, device="cpu", workers=2)
    assert ts.run(1)["boundaries"] == 1 and ts.trainer._host_steps == 1
