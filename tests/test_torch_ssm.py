"""SSM and hybrid models (``repro_torch.models.ssm``, the ``mamba`` /
``mlstm`` / ``slstm`` kinds of ``repro_torch.models.blocks``, the SSM and
hybrid plans of ``repro_torch.models.transformer``) against the
reference's (``repro.models``) on the same numpy inputs, the reference's
``init_lm`` weights carried across by ``params_from_jax``, at the reduced
``xlstm_125m`` and ``zamba2_2_7b`` configs:

- the chunked GLA core at several chunk sizes and from an initial state,
  its one-token step, the causal conv and its step; bf16 inputs against
  the reference's f32-accumulated result;
- each block's forward, and its prefill then 12 decode steps against the
  full forward over the same tokens;
- ``make_plan`` and the ``init_lm`` flat layout, the cache trees;
- the whole model's forward, ``lm_loss``, prefill and 12 decode steps
  (Zamba2 also at 4 layers, where the two shared blocks alternate over
  three sites);
- the continuous batcher's streams, with every re-admission zeroing the
  recurrent states and the shared sites' K/V.

f32 on both sides: the GLA core alone within rtol 1e-4 / atol 1e-5, the
blocks and models (outputs up to ~5 in magnitude, the chunked products
summed in other orders by the two frameworks) within rtol 1e-4 / atol
1e-4;
attention runs B9's plain version (the tensors lie on the CPU), the
recurrent blocks launch no kernel."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.config import MeshConfig  # noqa: E402
from repro.common.flat import FlatSpec as JFlatSpec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import LiveServer as JServer  # noqa: E402
from repro.serve import SnapshotBus as JBus  # noqa: E402
from repro.serve import TrafficGen as JTraffic  # noqa: E402
from repro.serving.engine import make_serve_program as jmake  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.serve_decode import plan_memory, serve_decode  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import ContinuousBatcher, LiveServer, SnapshotBus, TrafficGen  # noqa: E402
from repro_torch.serving.engine import make_serve_program  # noqa: E402

ARCHS = ["xlstm_125m", "zamba2_2_7b"]
TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, STEPS, MAX_LEN = 2, 16, 12, 40
PROMPT = 4          # a block's prefill; with the 12 steps, 16 = one Mamba2 chunk


def _close(port, want, **kw):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(want, np.float32),
                               **(kw or TOL))


def _state_close(port, want):
    """A recurrent state or cache: rtol 1e-4 and atol 1e-5 of its largest
    magnitude (Mamba2's states reach ~100 at the reduced widths; after 12
    steps the port and the reference are each as far from an f64 run)."""
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(port.detach().float().numpy(), w, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(np.abs(w).max())))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the GLA core and the causal conv
# ---------------------------------------------------------------------------

def _gla_inputs(Bq=2, Sq=32, H=3, dk=8, dv=5, seed=0):
    q, k = _rand(Bq, Sq, H, dk, seed=seed), _rand(Bq, Sq, H, dk, seed=seed + 1)
    v = _rand(Bq, Sq, H, dv, seed=seed + 2)
    log_g = -np.abs(_rand(Bq, Sq, H, seed=seed + 3, scale=0.3))
    return q, k, v, log_g


@pytest.mark.parametrize("chunk", [1, 4, 8, 32, 64])
@pytest.mark.parametrize("with_state", [False, True])
def test_gla_chunked_matches_reference(chunk, with_state):
    """Output and final state at chunk sizes 1 (one step a chunk) to 64
    (one chunk: min(chunk, S)), from zero or from an initial state."""
    q, k, v, g = _gla_inputs()
    s0 = _rand(2, 3, 8, 5, seed=9) if with_state else None
    jy, js = jssm.gla_chunked(*map(jnp.asarray, (q, k, v, g)), chunk=chunk,
                              initial_state=None if s0 is None else jnp.asarray(s0))
    ty, ts = ssm.gla_chunked(*map(torch.from_numpy, (q, k, v, g)), chunk=chunk,
                             initial_state=None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == ts.dtype == torch.float32 and tuple(ts.shape) == (2, 3, 8, 5)
    _close(ty, jy)
    _close(ts, js)


def test_gla_chunked_keeps_the_whole_chunk_assert():
    q, k, v, g = map(torch.from_numpy, _gla_inputs(Sq=12))
    with pytest.raises(AssertionError):
        ssm.gla_chunked(q, k, v, g, chunk=8)


def test_gla_chunked_equals_the_recurrence_of_gla_step():
    """The chunked core and S steps of the recurrence give the same outputs
    and state (both the port's), and each step equals the reference's."""
    q, k, v, g = _gla_inputs(Sq=16)
    ty, ts = ssm.gla_chunked(*map(torch.from_numpy, (q, k, v, g)), chunk=4)
    state_t = torch.zeros(2, 3, 8, 5)
    state_j = jnp.zeros((2, 3, 8, 5))
    for t in range(16):
        yt, state_t = ssm.gla_step(*(torch.from_numpy(a[:, t]) for a in (q, k, v, g)), state_t)
        yj, state_j = jssm.gla_step(*(jnp.asarray(a[:, t]) for a in (q, k, v, g)), state_j)
        _close(yt, yj)
        _close(yt, ty[:, t].numpy())
    _close(state_t, state_j)
    _close(state_t, ts.numpy())


def test_gla_chunked_bf16_against_the_reference_f32_accumulation():
    """bf16 q, k, v (the serving dtype): the reference keeps them in bf16
    and accumulates its products in f32 (``preferred_element_type``); XLA
    on the CPU runs no bf16 x bf16 -> f32 product, so the reference runs
    here in f32 on the bf16-rounded inputs, the same products and sums.
    The port upcasts before each product and rounds where the reference
    rounds (the scaled k and q, the chunk state before ``q S``, the
    output), which the reference's f32 run does not: its bf16 output and
    f32 state each within 2^-6 of their largest magnitude of that result
    (two bf16 ulps at the top of the range)."""
    q, k, v, g = _gla_inputs(Sq=64, dk=16, dv=16)
    rounded = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    jy, js = jssm.gla_chunked(*(jnp.asarray(t.float().numpy()) for t in rounded),
                              jnp.asarray(g), chunk=16)
    ty, ts = ssm.gla_chunked(*rounded, torch.from_numpy(g), chunk=16)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    want = np.asarray(jy)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=0, atol=2 ** -6 * scale)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=2 ** -6 * float(np.abs(np.asarray(js)).max()))


def test_gla_chunked_masks_the_exponent_before_exp():
    """Strong decay (log_g -60 a step) overflows exp(a_t - a_s) for s > t
    unless the exponent is masked first: output and gradient stay finite."""
    q, k, v, _ = _gla_inputs(Sq=8)
    g = np.full((2, 8, 3), -60.0, np.float32)
    tq = torch.from_numpy(q).requires_grad_(True)
    y, _ = ssm.gla_chunked(tq, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(g),
                           chunk=8)
    y.sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(tq.grad).all()
    jy, _ = jssm.gla_chunked(*map(jnp.asarray, (q, k, v, g)), chunk=8)
    _close(y, jy)


@pytest.mark.parametrize("cw", [1, 2, 4])
def test_causal_conv_and_its_step_match_reference(cw):
    w, x = _rand(cw, 6, seed=1), _rand(2, 10, 6, seed=2)
    _close(ssm.causal_conv(torch.from_numpy(w), torch.from_numpy(x)),
           jssm.causal_conv(jnp.asarray(w), jnp.asarray(x)))
    buf_t, buf_j = torch.zeros(2, max(cw - 1, 0), 6), jnp.zeros((2, max(cw - 1, 0), 6))
    full = ssm.causal_conv(torch.from_numpy(w), torch.from_numpy(x))
    for t in range(10):
        yt, buf_t = ssm.causal_conv_step(torch.from_numpy(w), buf_t, torch.from_numpy(x[:, t]))
        yj, buf_j = jssm.causal_conv_step(jnp.asarray(w), buf_j, jnp.asarray(x[:, t]))
        _close(yt, yj)
        _close(yt, full[:, t].numpy())
        _close(buf_t, buf_j)


def test_causal_conv_step_promotes_a_bf16_input_to_the_f32_buffer():
    """The reference's concatenate promotes: a bf16 token over the f32
    decode buffer steps in f32, and so does the port's."""
    w = torch.from_numpy(_rand(4, 6, seed=1)).to(torch.bfloat16)
    x1 = torch.from_numpy(_rand(2, 6, seed=2)).to(torch.bfloat16)
    y, buf = ssm.causal_conv_step(w, torch.zeros(2, 3, 6), x1)
    jy, jbuf = jssm.causal_conv_step(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
                                     jnp.zeros((2, 3, 6)),
                                     jnp.asarray(x1.float().numpy()).astype(jnp.bfloat16))
    assert y.dtype == buf.dtype == torch.float32 and jy.dtype == jnp.float32
    _close(y, jy)
    _close(buf, jbuf)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

KINDS = {"mamba": "zamba2_2_7b", "mlstm": "xlstm_125m", "slstm": "xlstm_125m"}


@functools.lru_cache(maxsize=None)
def _block(kind):
    arch = KINDS[kind]
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp, _ = jblocks.init_block(jax.random.PRNGKey(3), kind, jcfg)
    tp = tr.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = _rand(B, PROMPT + STEPS, cfg.d_model, seed=4)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_forward_matches_reference(kind):
    jcfg, cfg, jp, tp, x = _block(kind)
    jy, jaux = jax.jit(lambda p, x: jblocks.block_forward(kind, p, x, jcfg))(jp, jnp.asarray(x))
    ty, taux = blocks.block_forward(kind, tp, torch.from_numpy(x), cfg)
    _close(ty, jy, **MODEL_TOL)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_prefill_then_12_decode_steps_equal_the_full_forward(kind):
    """The prefill's outputs over 4 positions and its terminal cache equal
    the reference's; 12 decode steps from that cache (written in place)
    equal the last 12 positions of the full forward over all 16 inputs,
    and the reference's steps."""
    jcfg, cfg, jp, tp, x = _block(kind)
    full = blocks.block_forward(kind, tp, torch.from_numpy(x), cfg)[0]
    jy, jc = jax.jit(lambda p, x: jblocks.block_prefill(kind, p, x, jcfg))(
        jp, jnp.asarray(x[:, :PROMPT]))
    with torch.no_grad():
        ty, tc = blocks.block_prefill(kind, tp, torch.from_numpy(x[:, :PROMPT]), cfg)
    _close(ty, jy, **MODEL_TOL)
    _close(ty, full[:, :PROMPT].detach().numpy(), **MODEL_TOL)
    assert sorted(tc) == sorted(jc)
    for name in tc:
        assert tc[name].dtype == torch.float32
        _state_close(tc[name], jc[name])
    jstep = jax.jit(lambda p, x, c: jblocks.block_decode(kind, p, x, c, None, jcfg))
    for t in range(PROMPT, PROMPT + STEPS):
        jy, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        with torch.no_grad():
            ty, tc2 = blocks.block_decode(kind, tp, torch.from_numpy(x[:, t:t + 1]), tc, None,
                                          cfg)
        assert all(tc2[n] is tc[n] for n in tc)                  # written in place
        _close(ty, jy, **MODEL_TOL)
        _close(ty[:, 0], full[:, t].detach().numpy(), **MODEL_TOL)
    for name in tc:
        _state_close(tc[name], jc[name])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_cache_equals_the_reference_s(kind):
    jcfg, cfg, _, _, _ = _block(kind)
    jc, ja = jblocks.init_block_cache(kind, jcfg, 3, 20, dtype=jnp.bfloat16)
    tc, ta = blocks.init_block_cache(kind, cfg, 3, 20, dtype=torch.bfloat16)
    assert ta == ja and sorted(tc) == sorted(jc)
    for name in tc:
        assert tc[name].dtype == torch.float32                   # f32 whatever the dtype
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


@pytest.mark.parametrize("kind", ["attn_cross", "cross_blk"])
def test_cross_attention_kinds_refuse_naming_7b4d(kind):
    """The cross-attention kinds refused until ROADMAP.md 7b.4d, which
    ported them: ``init_block`` now builds the reference's tree (keys and
    shapes, the gates zero) for a vision config, and the block's cache is
    the reference's. Their numbers: tests/test_torch_cross.py."""
    jcfg, cfg = jget_reduced("llama_3_2_vision_11b"), get_reduced("llama_3_2_vision_11b")
    jp, ja = jblocks.init_block(jax.random.PRNGKey(0), kind, jcfg)
    tp, ta = blocks.init_block(torch.Generator(), kind, cfg)
    assert ta == ja
    assert jax.tree.map(lambda t: tuple(t.shape), jp) == {
        k: (jax.tree.map(lambda t: tuple(t.shape), v) if isinstance(v, dict)
            else tuple(v.shape)) for k, v in tp.items()}
    gate = tp["ffn_gate"] if kind == "cross_blk" else tp["xattn"]["gate"]
    assert not gate.any()
    jc, _ = jblocks.init_block_cache(kind, jcfg, 2, 8)
    tc, _ = blocks.init_block_cache(kind, cfg, 2, 8)
    assert sorted(tc) == sorted(jc)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _variant(arch, layers):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _lm(arch, layers=0):
    jcfg, cfg = _variant(arch, layers)
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    jp_np = jax.tree.map(np.asarray, jp)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 3] = -1
    return jcfg, cfg, jp, tr.params_from_jax(jp_np, "cpu"), toks, labels


MODELS = [("xlstm_125m", 0), ("zamba2_2_7b", 0), ("zamba2_2_7b", 4)]
MODEL_IDS = ["xlstm", "zamba2", "zamba2-4-layers"]


@pytest.mark.parametrize("arch", ARCHS + ["xlstm_125m:full", "zamba2_2_7b:full"])
def test_plan_equals_reference(arch):
    name, _, full = arch.partition(":")
    jcfg = jget_config(name) if full else jget_reduced(name)
    cfg = get_config(name) if full else get_reduced(name)
    assert dataclasses.astuple(tr.make_plan(cfg)) == dataclasses.astuple(jtr.make_plan(jcfg))


def test_full_plans_and_shapes():
    """xLSTM-125M: layers 5 and 11 sLSTM, the others mLSTM; Zamba2-2.7B: 9
    Mamba2 segments of 6 and 8 shared sites (after each segment but the
    last) over 2 shared blocks; the published widths."""
    xp = tr.make_plan(get_config("xlstm_125m"))
    assert [(s.kind, s.count) for s in xp.segments] == [("mlstm", 5), ("slstm", 1),
                                                         ("mlstm", 5), ("slstm", 1)]
    zcfg = get_config("zamba2_2_7b")
    zp = tr.make_plan(zcfg)
    assert [s.count for s in zp.segments] == [6] * 9 and {s.kind for s in zp.segments} == {
        "mamba"}
    assert (zp.num_shared_sites, zp.num_shared_blocks) == (8, 2)
    assert [e for e in zp.events if e[0] == "shared"] == [("shared", i) for i in range(8)]
    params, _ = tr.abstract_lm(zcfg, torch.bfloat16)
    assert tuple(params["shared"]["attn"]["wq"].shape) == (2, 2560, 32, 80)
    assert tuple(params["segments"]["seg0_mamba"]["mixer"]["in_proj"].shape) == (
        6, 2560, 2 * 5120 + 2 * 64 + 80)


@pytest.mark.parametrize("arch,layers", MODELS, ids=MODEL_IDS)
def test_init_lm_flat_layout_equals_reference(arch, layers):
    """Leaf paths, shapes, dtypes and FlatSpec offsets equal the
    reference's (the hybrid's ``shared`` stack included), and the port's
    own draws give the same tree."""
    jcfg, cfg, jp, tp, _, _ = _lm(arch, layers)
    js, ts = JFlatSpec.build(jp, leading=0), FlatSpec.build(tp)
    assert [(s.offset, s.size, tuple(s.shape)) for s in ts.slots] == \
        [(s.offset, s.size, tuple(s.shape)) for s in js.slots]
    own, _ = tr.init_lm(torch.Generator().manual_seed(0), cfg)
    assert [(s.offset, tuple(s.shape)) for s in FlatSpec.build(own).slots] == \
        [(s.offset, tuple(s.shape)) for s in ts.slots]
    assert ("shared" in tp) == (cfg.arch_type == "hybrid")


@pytest.mark.parametrize("arch,layers", MODELS, ids=MODEL_IDS)
def test_forward_and_lm_loss_match_reference(arch, layers):
    jcfg, cfg, jp, tp, toks, labels = _lm(arch, layers)
    jh, jaux = jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(jp, jnp.asarray(toks[:, :S]))
    jl, jparts = jax.jit(lambda p, t, y: jtr.lm_loss(p, jcfg, t, y))(
        jp, jnp.asarray(toks[:, :S]), jnp.asarray(labels))
    with torch.no_grad():
        th, taux = tr.forward(tp, cfg, torch.from_numpy(toks[:, :S]))
        tl, tparts = tr.lm_loss(tp, cfg, torch.from_numpy(toks[:, :S]),
                                torch.from_numpy(labels))
    _close(th, jh, **MODEL_TOL)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]), rtol=1e-5)


def _cache_close(tc, jc):
    assert sorted(tc) == sorted(jc)
    for group in ("segments", "shared_sites"):
        if group not in jc:
            continue
        want = jc[group] if group == "shared_sites" else None
        items = (jc[group].items() if group == "segments" else [(None, want)])
        for seg, c in items:
            got = tc[group][seg] if seg is not None else tc[group]
            assert sorted(got) == sorted(c)
            for name in c:
                assert tuple(got[name].shape) == tuple(c[name].shape)
                _state_close(got[name], c[name])


@pytest.mark.parametrize("arch,layers", MODELS, ids=MODEL_IDS)
@pytest.mark.parametrize("kv_start", [None, [0, 5]])
def test_prefill_and_12_decode_steps_match_reference(arch, layers, kv_start):
    """Prefill logits and cache (recurrent states, conv buffers, the shared
    sites' K/V), then 12 decode steps (per-row kv_start when given: it
    masks the shared attention, the recurrent blocks ignore it), logits and
    caches within rtol 1e-4 / atol 1e-4."""
    jcfg, cfg, jp, tp, toks, _ = _lm(arch, layers)
    jl, jc = jax.jit(lambda p, t: jtr.prefill(p, jcfg, t, max_len=MAX_LEN))(
        jp, jnp.asarray(toks[:, :S]))
    with torch.no_grad():
        tl, tc = tr.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=MAX_LEN)
    _close(tl, jl, **MODEL_TOL)
    _cache_close(tc, jc)
    jks = None if kv_start is None else jnp.asarray(np.array(kv_start, np.int32))
    tks = None if kv_start is None else torch.tensor(kv_start, dtype=torch.int32)
    jstep = jax.jit(lambda p, c, t, ks: jtr.decode_step(p, jcfg, c, t, kv_start=ks))
    for t in range(S, S + STEPS):
        tok = toks[:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jks)
        with torch.no_grad():
            tl, tc = tr.decode_step(tp, cfg, tc, torch.from_numpy(tok), kv_start=tks)
        _close(tl, jl, **MODEL_TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == S + STEPS
    _cache_close(tc, jc)


@pytest.mark.parametrize("arch,layers", MODELS, ids=MODEL_IDS)
def test_decode_from_an_empty_cache_matches_reference(arch, layers):
    jcfg, cfg, jp, tp, toks, _ = _lm(arch, layers)
    jc, ja = jtr.init_cache(jcfg, B, MAX_LEN)
    tc, ta = tr.init_cache(cfg, B, MAX_LEN)
    assert ta == ja
    _cache_close(tc, jc)
    jstep = jax.jit(lambda p, c, t: jtr.decode_step(p, jcfg, c, t))
    for t in range(STEPS):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        with torch.no_grad():
            tl, tc = tr.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl, **MODEL_TOL)
    _cache_close(tc, jc)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_streams_equal_reference(arch):
    """Reduced xLSTM / Zamba2 through the reference's continuous batcher and
    the port's: every completed record (arrival, admit, first token, done,
    greedy tokens) and the latency summary are equal. Every re-admission
    zeroes the recycled slots' recurrent states, conv buffers and (Zamba2)
    shared sites' K/V in place: sLSTM's m goes from -1e30 to -0.0, as the
    reference's masked multiply leaves it."""
    jcfg, cfg, jp, tp, _, _ = _lm(arch)
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
        before = {id(a): a.clone() for seg in bat.cache["segments"].values()
                  for a in seg.values()}
        real(keep)
        stacks = list(bat.cache["segments"].values()) + (
            [bat.cache["shared_sites"]] if "shared_sites" in bat.cache else [])
        for seg in stacks:
            for a in seg.values():
                resets.append(bool((a[:, ~keep] == 0).all()))
                if id(a) in before:       # kept slots untouched
                    resets.append(bool(torch.equal(a[:, keep], before[id(a)][:, keep])))

    bat._reset = spy
    bat.run(46)
    bat.check_invariants()
    assert resets and all(resets)
    assert ("shared_sites" in bat.cache) == (arch == "zamba2_2_7b")
    assert bat.completed == jbat.completed
    assert bat.latency_summary() == jbat.latency_summary()


def test_reset_masks_the_shared_sites():
    """The hybrid's shared sites' K/V of a re-admitted slot are zeroed,
    those of the other slots kept (the reference's masked reset)."""
    _, cfg, _, tp, _, _ = _lm("zamba2_2_7b")
    prog = make_serve_program(cfg, batch=3, max_len=8, param_dtype=torch.float32,
                              cache_dtype=torch.float32, device="cpu")
    bus = SnapshotBus()
    bus.publish_params(tp)
    server = LiveServer(prog, bus)
    server.maybe_swap()
    bat = ContinuousBatcher(server, [])
    for a in bat.cache["shared_sites"].values():
        a.fill_(1.0)
    bat._reset(np.array([True, False, True]))
    for a in bat.cache["shared_sites"].values():
        assert bool((a[:, 1] == 0).all()) and bool((a[:, [0, 2]] == 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_decode_runs_the_reduced_model_without_a_kernel(arch):
    """The serve_decode entry point on the CPU: prefill, 6 greedy steps and
    a mid-stream swap; no kernel counted (xLSTM has no attention, Zamba2's
    shared attention takes B9's plain version on CPU tensors); the plan
    counts the recurrent caches."""
    cfg = get_reduced(arch)
    ops.zero_launch_counts()
    r = serve_decode(cfg, batch=2, prompt_len=8, tokens=6, max_len=16,
                     param_dtype=torch.float32, cache_dtype=torch.float32, device="cpu",
                     log=lambda m: None)
    assert r["swaps"] == 2 and r["final_logits_finite"] and r["cache_pos"] == 14
    assert tuple(r["stream"].shape) == (2, 6)
    assert r["prefill_launches"] == 0 and set(r["step_launches"]) == {0}
    assert all(n == 0 for n in ops.launch_counts().values())
    cache, _ = tr.init_cache(cfg, 2, 16, device="meta")
    assert r["plan"]["cache"] == sum(t.numel() * t.element_size() for t in tree_leaves(cache))


def test_prefill_transients_count_the_gla_core():
    """The full-width plans: Zamba2's and xLSTM's prefill temporaries at 8
    x 512 include the chunked GLA's f32 [H, Q] coefficient rows (at least
    3 x 4 B x H x Q a token)."""
    for arch, H, Q in (("zamba2_2_7b", 80, 256), ("xlstm_125m", 4, 256)):
        p = plan_memory(get_config(arch), batch=8, prompt_len=512, max_len=1024,
                        device="cpu", log=lambda m: None)
        assert p["transient"] >= 8 * 512 * 3 * 4 * H * Q
