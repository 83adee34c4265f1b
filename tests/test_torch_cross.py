"""Cross-attention models (ROADMAP.md 7b.4d): the port's ``attn_cross`` and
``cross_blk`` kinds, the audio and vision plans, MusicGen's K codebooks in
the embedding, the heads and the loss, against the reference at the reduced
``musicgen_large`` (2 layers, K = 2, 8 conditioning tokens) and
``llama_3_2_vision_11b`` (2 layers, a cross block after layer 0, 16 image
tokens), the reference's ``init_lm`` weights carried across by
``params_from_jax``, inputs from seeded numpy (``_torch_cross_cases.py``).

Both cross gates are zero at init and the reference's training batches
carry ``cond = 0``, so a wrong or missing cross path would give the same
numbers as a right one: every comparison here sets each gate (``xattn/gate``
and the vision blocks' ``ffn_gate``) to 0.5 and uses a seeded random
``cond``, and one test shows the logits move when ``cond`` does.

- ``make_plan`` (events, segments, cross count) and the parameter tree and
  ``param_count``, also at depth cuts of the full vision config;
- ``cross_attn_forward`` and its gradient (2e-5);
- ``forward``, ``lm_loss``, prefill + 4 decode steps (logits rtol 1e-4 /
  atol 1e-5, greedy tokens equal; the audio logits ``[B, K, V]``);
- the serving program's token and cond shapes; the batcher and
  ``launch.serve`` refuse both models, as the reference's.

Training them through the engines is ``test_torch_cross_train.py``.

Attention runs B9's plain version (the tensors lie on the CPU) when no
gradient is wanted, the differentiable online softmax when one is."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_cross_cases as cc  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.common.pytree import tree_flatten  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.launch.serve_decode import open_cross_gates  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import ContinuousBatcher, LiveServer, SnapshotBus  # noqa: E402
from repro_torch.serving.engine import make_serve_program  # noqa: E402

ARCHS, TOL, W, B, PROMPT, DECODE, MAX_LEN = (cc.ARCHS, cc.TOL, cc.W, cc.B, cc.PROMPT,
                                             cc.DECODE, cc.MAX_LEN)
_setup, _port, _np, _tokens, _cond_shape = cc.setup, cc.port, cc.np_, cc.tokens, cc.cond_shape
GATE = cc.GATE


# ---------------------------------------------------------------------------
# the plan and the parameter tree
# ---------------------------------------------------------------------------

PLAN_CASES = [("musicgen_large", "reduced", 0), ("llama_3_2_vision_11b", "reduced", 0),
              ("musicgen_large", "full", 0), ("llama_3_2_vision_11b", "full", 0),
              ("llama_3_2_vision_11b", "full", 4), ("llama_3_2_vision_11b", "full", 9),
              ("musicgen_large", "full", 20)]


@pytest.mark.parametrize("arch,size,layers", PLAN_CASES)
def test_plan_equals_the_reference(arch, size, layers):
    """Events, segments (kind, count, windows) and the cross count, at the
    reduced and full configs and at depth cuts (the full vision config cut
    to 4 layers keeps its first cross block after layer 3, to 9 its
    second after layer 8)."""
    jcfg = jget_reduced(arch) if size == "reduced" else jget_config(arch)
    cfg = get_reduced(arch) if size == "reduced" else get_config(arch)
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        cfg = dataclasses.replace(cfg, num_layers=layers)
    jp, tp = jtr.make_plan(jcfg), tr.make_plan(cfg)
    assert tp.events == jp.events
    assert [(s.name, s.kind, s.count, s.use_moe, s.windows) for s in tp.segments] == \
        [(s.name, s.kind, s.count, s.use_moe, s.windows) for s in jp.segments]
    assert (tp.num_cross, tp.num_shared_blocks, tp.num_shared_sites) == \
        (jp.num_cross, jp.num_shared_blocks, jp.num_shared_sites)
    if arch.startswith("llama") and size == "full":
        assert tp.num_cross == {0: 8, 4: 1, 9: 2}[layers]


@pytest.mark.parametrize("arch,size", [(a, s) for a in ARCHS for s in ("reduced", "full")])
def test_parameter_tree_and_count_equal_the_reference(arch, size):
    """The port's ``abstract_lm`` (on the meta device) has the reference's
    keys and shapes (K-row ``embed`` and ``lm_head`` for MusicGen, the
    stacked ``cross`` blocks for vision), and the config's ``param_count``
    (an analytic count) is the reference's."""
    jcfg = jget_reduced(arch) if size == "reduced" else jget_config(arch)
    cfg = get_reduced(arch) if size == "reduced" else get_config(arch)
    jabs, _ = jtr.abstract_lm(jcfg)
    tabs, _ = tr.abstract_lm(cfg)
    jsh = [tuple(s.shape) for s in jax.tree.leaves(jabs)]
    assert [tuple(t.shape) for t in tree_flatten(tabs)[0]] == jsh
    assert sorted(tabs) == sorted(jabs)
    assert cfg.param_count() == jcfg.param_count()
    K = cfg.audio.num_codebooks if cfg.audio is not None else 1
    assert tuple(tabs["embed"].shape) == (K, cfg.vocab_size, cfg.d_model)
    if cfg.vlm is not None:
        assert tabs["cross"]["xattn"]["wk"].shape[:2] == (tr.make_plan(cfg).num_cross,
                                                          cfg.vlm.image_embed_dim)


# ---------------------------------------------------------------------------
# the cross-attention and the whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_and_its_gradient_match_the_reference(arch):
    """``cross_attn_forward`` of the first cross-attention (gate 0.5) on a
    random x [2, 12, d] and cond [2, T, e]: the output within 2e-5 of the
    reference's, and the gradients of sum(out * w) with respect to every
    leaf, x and cond within 2e-5 (of the largest where it exceeds 1)."""
    jcfg, cfg, jp, jp_np, *_ = _setup(arch)
    if cfg.vlm is not None:
        pj = jax.tree.map(lambda t: t[0], jp["cross"]["xattn"])
    else:
        pj = jax.tree.map(lambda t: t[0], jp["segments"]["seg0_attn_cross"]["xattn"])
    rng = np.random.RandomState(3)
    x = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    cond = rng.randn(*_cond_shape(cfg, 2)).astype(np.float32)
    w = rng.randn(2, 12, cfg.d_model).astype(np.float32)

    def jf(p, x, c):
        return jnp.sum(jattn.cross_attn_forward(p, x, c, jcfg) * w)

    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(pj, jnp.asarray(x), jnp.asarray(cond))
    pt = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in
          jax.tree.map(np.asarray, pj).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tc = torch.from_numpy(cond).requires_grad_(True)
    out = tattn.cross_attn_forward(pt, tx, tc, cfg)
    with torch.no_grad():
        np.testing.assert_allclose(_np(tattn.cross_attn_forward(pt, tx, tc, cfg)),
                                   np.asarray(jattn.cross_attn_forward(pj, x, cond, jcfg)),
                                   rtol=0, atol=2e-5)
    tl = torch.sum(out * torch.from_numpy(w))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    pairs = [("x", tx.grad, jg[1]), ("cond", tc.grad, jg[2])] + \
        [(k, t.grad, jg[0][k]) for k, t in pt.items()]
    for name, got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(want).max())), err_msg=name)
    assert float(np.abs(np.asarray(jg[0]["gate"])).max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_prefill_and_decode_match_the_reference(arch):
    """The training forward's hidden states and ``lm_loss`` (random cond),
    then a prefill of 12 tokens and 4 greedy decode steps (the same cond
    at every step; no cross-KV cache): logits rtol 1e-4 / atol 1e-5, the
    greedy tokens equal, the audio logits [B, K, V]."""
    jcfg, cfg, jp, jp_np, toks, labels, cond = _setup(arch)
    tp = _port(jp_np)
    x, y, c = toks[0], labels[0], cond[0]
    jh, _ = jtr.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(c))
    with torch.no_grad():
        th, _ = tr.forward(tp, cfg, torch.from_numpy(x), torch.from_numpy(c))
        tl = tr.lm_loss(tp, cfg, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(c))[0]
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    jl = jtr.lm_loss(jp, jcfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(c))[0]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)

    rng = np.random.RandomState(4)
    prompt = _tokens(cfg, rng, (B,), PROMPT)
    cb = rng.randn(*_cond_shape(cfg, B)).astype(np.float32)
    jlog, jcache = jtr.prefill(jp, jcfg, jnp.asarray(prompt), jnp.asarray(cb), max_len=MAX_LEN)
    with torch.no_grad():
        tlog, tcache = tr.prefill(tp, cfg, torch.from_numpy(prompt), torch.from_numpy(cb),
                                  max_len=MAX_LEN)
    want_shape = (B, cfg.audio.num_codebooks, cfg.vocab_size) if cfg.audio else \
        (B, cfg.vocab_size)
    assert tuple(tlog.shape) == want_shape
    for step in range(DECODE + 1):
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL, err_msg=f"step {step}")
        jn = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        tn = tlog.argmax(-1).int()
        np.testing.assert_array_equal(tn.numpy(), jn)
        if step == DECODE:
            break
        jlog, jcache = jtr.decode_step(jp, jcfg, jcache, jnp.asarray(jn[..., None]),
                                       jnp.asarray(cb))
        with torch.no_grad():
            tlog, tcache = tr.decode_step(tp, cfg, tcache, tn[..., None], torch.from_numpy(cb))
        assert tuple(tlog.shape) == want_shape


@pytest.mark.parametrize("arch", ARCHS)
def test_the_logits_depend_on_cond(arch):
    """With the gates open, two random conds give prefill logits that
    differ by more than 1e-3 of their largest; with the reference's zero
    gates, they do not differ at all (the trap a zero-gate test falls
    into)."""
    jcfg, cfg, jp, jp_np, *_ = _setup(arch)
    rng = np.random.RandomState(5)
    prompt = torch.from_numpy(_tokens(cfg, rng, (B,), PROMPT))
    c1, c2 = (torch.from_numpy(rng.randn(*_cond_shape(cfg, B)).astype(np.float32))
              for _ in range(2))
    with torch.no_grad():
        for gate, moves in ((GATE, True), (0.0, False)):
            tp = _port(jp_np)
            assert open_cross_gates(tp, gate) == (2 if cfg.vlm is not None else 1)
            a = tr.prefill(tp, cfg, prompt, c1)[0]
            b = tr.prefill(tp, cfg, prompt, c2)[0]
            gap = float((a - b).abs().max() / a.abs().max())
            assert (gap > 1e-3) if moves else gap == 0.0, (gate, gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_batcher_and_train_while_serve_refuse_cross_models(arch):
    """As the reference's: the continuous batcher drives plain token
    streams, and ``launch.serve`` (train-while-serve) asserts the same."""
    cfg = get_reduced(arch)
    prog = make_serve_program(cfg, batch=2, max_len=16, param_dtype=torch.float32,
                              cache_dtype=torch.float32, device="cpu")
    server = LiveServer(prog, SnapshotBus(), params=tr.init_lm(torch.Generator(), cfg)[0])
    with pytest.raises(AssertionError, match="plain-LM"):
        ContinuousBatcher(server, [])
    with pytest.raises(AssertionError, match="plain-LM"):
        tserve_cli.build(arch, device="cpu", workers=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_serve_program_shapes(arch):
    """``token_shapes`` ([B, K, seq] for audio) and ``cond_shapes`` (bf16
    [B, T, e]) are the reference's."""
    cfg = get_reduced(arch)
    prog = make_serve_program(cfg, batch=3, max_len=16, device="cpu")
    K = (cfg.audio.num_codebooks,) if cfg.audio is not None else ()
    assert prog.token_shapes(5) == ((3,) + K + (5,), torch.int32)
    assert prog.cond_shapes() == (_cond_shape(cfg, 3), torch.bfloat16)
    assert make_serve_program(get_reduced("tinyllama_1_1b"), batch=3, max_len=16,
                              device="cpu").cond_shapes() is None
