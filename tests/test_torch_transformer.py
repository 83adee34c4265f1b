"""The port's dense transformer (``repro_torch.models``) against the
reference's (``repro.models``) on the reference's ``init_lm`` weights,
carried across by ``params_from_jax``: FlatSpec layout, training forward,
prefill logits and cache, and decode steps over the full cache, with
``kv_start``, and over the ring buffer. Attention runs B9's plain version
(the tensors lie on the CPU)."""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.flat import FlatSpec as JFlatSpec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ARCHS = ["tinyllama_1_1b", "gemma2_9b"]
RTOL, ATOL = 1e-4, 1e-5   # f32 on both sides; sums in another order
B, S, MAX_LEN = 2, 12, 24


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    jp_np = jax.tree.map(np.asarray, jp)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S + 12)).astype(np.int32)
    return jcfg, cfg, jp, tr.params_from_jax(jp_np, "cpu"), toks


def _close(port, want):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_layout_of_init_lm_equals_reference(arch):
    """The port's own init_lm tree has the reference's keys and shapes, so
    FlatSpec offsets and totals are equal, and the carried-across weights
    flatten to the reference's buffers element for element."""
    jcfg, cfg, jp, tp, _ = _setup(arch)
    own, _ = tr.init_lm(torch.Generator().manual_seed(0), cfg)
    jspec, spec = JFlatSpec.build(jp, leading=0), FlatSpec.build(own, leading=0)
    assert spec.totals == dict(jspec.totals)
    assert [(s.bucket, s.offset, s.size, s.shape) for s in spec.slots] == \
        [(s.bucket, s.offset, s.size, tuple(s.shape)) for s in jspec.slots]
    jbufs, bufs = jspec.flatten(jp), FlatSpec.build(tp, leading=0).flatten(tp)
    for k in jbufs:
        np.testing.assert_array_equal(bufs[k].numpy(), np.asarray(jbufs[k]))


def test_full_tinyllama_tree_has_the_published_shapes():
    """TinyLlama-1.1B: 22 stacked layers, d 2048, 32 / 4 heads of 64, SwiGLU
    5632, vocab 32000 (shapes only, via the reference's abstract tree)."""
    shapes = jtr.abstract_lm(jget_config("tinyllama_1_1b"))[0]
    seg = shapes["segments"]["seg0_attn"]
    assert seg["attn"]["wq"].shape == (22, 2048, 32, 64)
    assert seg["attn"]["wk"].shape == (22, 2048, 4, 64)
    assert seg["ffn"]["w_gate"].shape == (22, 2048, 5632)
    cfg = get_config("tinyllama_1_1b")
    assert tr.make_plan(cfg).segments[0].count == 22
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert n == 1_100_048_384


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(arch):
    jcfg, cfg, jp, tp, toks = _setup(arch)
    jh, _ = jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(jp, jnp.asarray(toks[:, :S]))
    with torch.no_grad():
        th, aux = tr.forward(tp, cfg, torch.from_numpy(toks[:, :S]))
    _close(th, jh)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch):
    jcfg, cfg, jp, tp, toks = _setup(arch)
    jl, jc = jax.jit(lambda p, t: jtr.prefill(p, jcfg, t, max_len=MAX_LEN))(
        jp, jnp.asarray(toks[:, :S]))
    with torch.no_grad():
        tl, tc = tr.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=MAX_LEN)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    for name in ("k", "v"):
        want = jc["segments"]["seg0_attn"][name]
        got = tc["segments"]["seg0_attn"][name]
        assert tuple(got.shape) == tuple(want.shape) == (cfg.num_layers, B, MAX_LEN,
                                                         cfg.num_kv_heads,
                                                         cfg.resolved_head_dim)
        _close(got, want)


def _decode_both(arch, *, window=0, steps=8, kv_start=None, from_prefill=False):
    jcfg, cfg, jp, tp, toks = _setup(arch)
    jstep = jax.jit(lambda p, c, t, ks: jtr.decode_step(p, jcfg, c, t, window=window,
                                                        kv_start=ks))
    if from_prefill:
        _, jc = jtr.prefill(jp, jcfg, jnp.asarray(toks[:, :S]), max_len=MAX_LEN)
        with torch.no_grad():
            _, tc = tr.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=MAX_LEN)
        first = S
    else:
        jc, _ = jtr.init_cache(jcfg, B, MAX_LEN, window=window)
        tc, _ = tr.init_cache(cfg, B, MAX_LEN, window=window)
        first = 0
    jks = None if kv_start is None else jnp.asarray(kv_start)
    tks = None if kv_start is None else torch.from_numpy(np.asarray(kv_start))
    for t in range(first, first + steps):
        tok = toks[:, t:t + 1]
        jl, jc = jstep(jp, jc, jnp.asarray(tok), jks)
        with torch.no_grad():
            tl, tc = tr.decode_step(tp, cfg, tc, torch.from_numpy(tok), window=window,
                                    kv_start=tks)
        _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == first + steps
    for name in ("k", "v"):
        _close(tc["segments"]["seg0_attn"][name], jc["segments"]["seg0_attn"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_full_cache_match_reference(arch):
    _decode_both(arch, steps=8)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_with_kv_start_matches_reference(arch):
    _decode_both(arch, steps=8, kv_start=np.array([0, 5], np.int32), from_prefill=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_ring_buffer_match_reference(arch):
    """window=8: the ring buffer wraps after 8 steps (12 are run)."""
    _decode_both(arch, window=8, steps=12)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in ARCHS + [
    "granite_3_8b", "granite_20b", "deepseek_v2_lite_16b", "grok_1_314b", "xlstm_125m",
    "zamba2_2_7b"]])
def test_unported_architectures_refuse(arch):
    """Audio and vision refused until ROADMAP.md 7b.4d, which ported them:
    ``make_plan`` now gives the reference's plan for them (the cross
    models' numbers: tests/test_torch_cross.py; the MoE archs:
    tests/test_torch_moe.py; SSM and hybrid: tests/test_torch_ssm.py)."""
    plan, jplan = tr.make_plan(get_reduced(arch)), jtr.make_plan(jget_reduced(arch))
    assert plan.events == jplan.events and plan.num_cross == jplan.num_cross
    assert [(s.name, s.kind, s.count) for s in plan.segments] == \
        [(s.name, s.kind, s.count) for s in jplan.segments]


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_20b"])
def test_other_dense_configs_build_and_run(arch):
    """The dense configs beside tinyllama and gemma2 go through the same
    plan: the reduced model prefills and decodes on the CPU."""
    cfg = get_reduced(arch)
    params, _ = tr.init_lm(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, cache = tr.prefill(params, cfg, toks, max_len=10)
        logits2, cache = tr.decode_step(params, cfg, cache, toks[:, :1])
    assert logits.shape == logits2.shape == (2, cfg.vocab_size)
    assert torch.isfinite(logits2).all() and int(cache["pos"]) == 7


def test_ring_buffer_refuses_kv_start():
    _, cfg, _, tp, toks = _setup("tinyllama_1_1b")
    cache, _ = tr.init_cache(cfg, B, MAX_LEN, window=8)
    with pytest.raises(ValueError, match="ring-buffer"):
        tr.decode_step(tp, cfg, cache, torch.from_numpy(toks[:, :1]), window=8,
                       kv_start=torch.zeros(B, dtype=torch.int32))
