"""The port's LM training path against the reference on the same
numpy-seeded inputs, with the reference's ``init_lm`` weights carried
across by ``params_from_jax``: ``chunked_ce_loss`` and ``lm_loss``
(masked labels, gemma2's final softcap), the differentiable online-softmax
attention and its q/k/v gradients, the flat gradient of the LM loss, 20
sim steps from the reference's state with its draws, ``abstract_lm``,
``batch_shapes`` / ``batch_axes``, the dist trainer's default loss, and the
flat views' scatter backward against plain slice views."""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common.config import OptimizerConfig as JOpt  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.common.flat import FlatSpec as JFlatSpec  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common import flat as tflat  # noqa: E402
from repro_torch.common.config import MeshConfig, TrainConfig  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.common.pytree import tree_flatten, tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train import losses as tlosses  # noqa: E402

ARCHS = ["tinyllama_1_1b", "gemma2_9b"]
DENSE = [a for a in ARCH_IDS if get_config(a).arch_type == "dense"]
B, S = 2, 16
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    jp_np = jax.tree.map(np.asarray, jp)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 3] = labels[1, 0] = labels[1, 9] = -1          # masked positions
    return jcfg, cfg, jp, jp_np, toks, labels


def _tp(arch):
    return tr.params_from_jax(_setup(arch)[3], "cpu")


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 16, 256])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_ce_loss_matches_reference(arch, chunk):
    """The loss over given hidden states, per sequence chunk, with masked
    labels (gemma2: the final-logit softcap): rtol 1e-5."""
    jcfg, cfg, jp, _, _, labels = _setup(arch)
    h = np.random.RandomState(2).randn(B, S, cfg.d_model).astype(np.float32)
    want = jtr.chunked_ce_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(labels), chunk=chunk)
    got = tr.chunked_ce_loss(_tp(arch), cfg, torch.from_numpy(h), torch.from_numpy(labels),
                             chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_chunked_ce_loss_keeps_the_whole_chunk_assert():
    _, cfg, _, _, _, labels = _setup("tinyllama_1_1b")
    h = torch.zeros(B, S, cfg.d_model)
    with pytest.raises(AssertionError):
        tr.chunked_ce_loss(_tp("tinyllama_1_1b"), cfg, h, torch.from_numpy(labels), chunk=5)


def test_chunked_ce_loss_of_all_masked_labels_is_zero_in_both():
    jcfg, cfg, jp, _, _, _ = _setup("tinyllama_1_1b")
    h = np.random.RandomState(3).randn(B, S, cfg.d_model).astype(np.float32)
    lab = -np.ones((B, S), np.int32)
    want = float(jtr.chunked_ce_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(lab)))
    got = float(tr.chunked_ce_loss(_tp("tinyllama_1_1b"), cfg, torch.from_numpy(h),
                                   torch.from_numpy(lab)))
    assert got == want == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_reference(arch):
    """lm_loss on the reference's weights: total, ce and aux, rtol 1e-5."""
    jcfg, cfg, jp, _, toks, labels = _setup(arch)
    jt, jaux = jtr.lm_loss(jp, jcfg, jnp.asarray(toks), jnp.asarray(labels))
    with torch.no_grad():
        tt, taux = tr.lm_loss(_tp(arch), cfg, torch.from_numpy(toks), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]), rtol=1e-5)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0


def test_lm_loss_fn_takes_the_batch_and_the_engines_signature():
    jcfg, cfg, jp, _, toks, labels = _setup("tinyllama_1_1b")
    want = float(jlosses.lm_loss_fn(jcfg)(jp, {"tokens": jnp.asarray(toks),
                                               "labels": jnp.asarray(labels)}))
    fn = tlosses.lm_loss_fn(cfg)
    with torch.no_grad():
        a = float(fn(_tp("tinyllama_1_1b"), {"tokens": torch.from_numpy(toks),
                                             "labels": torch.from_numpy(labels)}))
        b = float(fn(_tp("tinyllama_1_1b"), torch.from_numpy(toks), torch.from_numpy(labels)))
    assert a == b
    np.testing.assert_allclose(a, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# the differentiable attention
# ---------------------------------------------------------------------------

# (B, Sq, Skv, H, Hkv, hd, causal, window, softcap, chunk, q_offset)
ATTN_CASES = {
    "causal_gqa": (2, 12, 12, 8, 2, 16, True, 0, 0.0, 1024, 0),
    "window_chunked_padded": (2, 20, 20, 4, 4, 8, True, 5, 0.0, 8, 0),
    "softcap_mqa": (1, 9, 9, 6, 1, 16, True, 0, 30.0, 4, 0),
    "window_softcap_gqa": (2, 16, 16, 8, 2, 8, True, 7, 50.0, 4, 0),
    "noncausal": (2, 5, 11, 4, 2, 8, False, 0, 0.0, 4, 0),
    "suffix_offset": (1, 4, 14, 4, 2, 8, True, 3, 0.0, 8, 10),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_online_attention_and_its_gradients_match_reference(case):
    """Output and q/k/v gradients (of sum(out * r)) against jax.grad of the
    reference's chunked_attention: rtol 1e-4 / atol 1e-5."""
    Bq, Sq, Skv, H, Hkv, hd, causal, window, cap, chunk, off = ATTN_CASES[case]
    rng = np.random.RandomState(4)
    q = rng.randn(Bq, Sq, H, hd).astype(np.float32)
    k = rng.randn(Bq, Skv, Hkv, hd).astype(np.float32)
    v = rng.randn(Bq, Skv, Hkv, hd).astype(np.float32)
    r = rng.randn(Bq, Sq, H, hd).astype(np.float32)
    kw = dict(causal=causal, window=window, logit_softcap=cap, chunk=chunk, q_offset=off)

    def jf(q, k, v):
        return jnp.sum(jattn.chunked_attention(q, k, v, **kw) * r)

    jo = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = tattn.online_softmax_attention(tq, tk, tv, **kw)
    (to * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_attention_routes_a_gradient_to_the_online_softmax():
    """Under no_grad (serving) the model's attention runs the op, B9's plain
    version on the CPU; with a tensor that requires grad, and inside
    vmap(grad_and_value), it runs the differentiable online softmax. The op
    itself never routes: it stays a kernel / plain-version wrapper."""
    from unittest import mock
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 6, 4, 8).astype(np.float32)) for _ in range(3))
    calls = []
    real = tattn.online_softmax_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with mock.patch.object(tattn, "online_softmax_attention", spy):
        with torch.no_grad():
            plain = tattn.chunked_attention(q, k, v)
        assert calls == []
        online = tattn.chunked_attention(q.clone().requires_grad_(True), k, v)
        assert calls == [1]
        vmap(grad_and_value(lambda qq: tattn.chunked_attention(qq, k, v).sum()))(q[None])
        assert len(calls) == 2
        # grad mode on but nothing requires grad: the plain version
        tattn.chunked_attention(q, k, v)
        assert len(calls) == 2
        ops.attention(q.clone().requires_grad_(True), k, v)
        assert len(calls) == 2
    np.testing.assert_allclose(online.detach().numpy(), plain.numpy(), **TOL)


# ---------------------------------------------------------------------------
# the flat gradient of the LM loss, and sim steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_flat_gradient_matches_reference(arch):
    """d lm_loss / d flat plane through the views (the engines' boundary)
    against jax.grad through the reference's scatter-VJP views."""
    jcfg, cfg, jp, _, toks, labels = _setup(arch)
    js = JFlatSpec.build(jp, leading=0)
    jl, jg = jax.value_and_grad(lambda b: jtr.lm_loss(js.views(b), jcfg, jnp.asarray(toks),
                                                      jnp.asarray(labels))[0])(js.flatten(jp))
    tp = _tp(arch)
    ts = tflat.FlatSpec.build(tp)
    buf = ts.flatten(tp)["float32"].requires_grad_(True)
    tl = tr.lm_loss(ts.views({"float32": buf}), cfg, torch.from_numpy(toks),
                    torch.from_numpy(labels))[0]
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(buf.grad.numpy(), np.asarray(jg["float32"]), **TOL)


SIM_W, SIM_STEPS, SIM_GB, SIM_SEQ = 4, 20, 8, 16


def test_lm_sim_steps_from_the_reference_state_match():
    """20 elastic-gossip NAG steps of tinyllama --reduced at W=4 over
    ``launch.train.lm_batches``: every port step starts from the
    reference's pre-step theta and velocity, is given its draws, and is
    held to rtol 1e-4 / atol 1e-5 with comm_* bit-equal."""
    from repro.launch.train import lm_batches as jbatches
    jcfg, cfg, jp, jp_np, _, _ = _setup("tinyllama_1_1b")
    proto = dict(method="elastic_gossip", moving_rate=0.5, comm_probability=0.5)
    opt = dict(name="nag", learning_rate=3e-3, momentum=0.9)
    jtrn = JTrainer(engine="sim", protocol=JProto(**proto), optimizer=JOpt(**opt),
                    loss_fn=lambda p, x, y: jtr.lm_loss(p, jcfg, x, y)[0], num_workers=SIM_W)
    ttrn = TTrainer(engine="sim", protocol=TProto(**proto), optimizer=TOpt(**opt),
                    loss_fn=lambda p, x, y: tr.lm_loss(p, cfg, x, y)[0], num_workers=SIM_W,
                    device="cpu")
    jstate = jtrn.init_state(0, params=jp)
    tstate = ttrn.init_state(0, params=tr.params_from_jax(jp_np, "cpu"))
    batches = jbatches(jcfg, SIM_W, SIM_GB // SIM_W, SIM_SEQ, 0)
    fired = 0
    for _ in range(SIM_STEPS):
        b = next(batches)
        for a, t in ((jstate.theta, tstate.theta), (jstate.opt.mu, tstate.opt.mu)):
            t["float32"].copy_(torch.from_numpy(np.array(a["float32"])))
        gate, peers = jtrn._backend.sim._draw_fn(jnp.array(jstate.key), jnp.array(jstate.step))
        jstate, jm = jtrn.step(jstate, (b["tokens"], b["labels"]))
        tstate, tm = ttrn.step(tstate, (torch.from_numpy(np.array(b["tokens"])),
                                        torch.from_numpy(np.array(b["labels"]))),
                               draws=(torch.from_numpy(np.array(gate)),
                                      torch.from_numpy(np.array(peers))))
        fired += int(np.sum(np.array(gate)))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tstate.theta["float32"].numpy(),
                                   np.asarray(jstate.theta["float32"]), **TOL)
        np.testing.assert_allclose(tstate.opt.mu["float32"].numpy(),
                                   np.asarray(jstate.opt.mu["float32"]), **TOL)
        for name in ("comm_rounds", "comm_units", "comm_bytes"):
            a, t = np.asarray(getattr(jstate.proto, name)), getattr(tstate.proto, name).numpy()
            assert a.dtype == t.dtype and np.array_equal(a, t), name
    assert fired > 0


# ---------------------------------------------------------------------------
# abstract_lm, batch layouts, the dist trainer's default loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_abstract_lm_allocates_nothing_and_totals_the_reference_s_bytes(arch):
    """Full-size configs: the same shapes and dtypes, so the same byte total,
    on the meta device (no storage)."""
    jshapes, _ = jtr.abstract_lm(jget_config(arch))
    tshapes, axes = tr.abstract_lm(get_config(arch))
    jl, tl = jax.tree.leaves(jshapes), tree_leaves(tshapes)
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    assert all(x.device.type == "meta" for x in tl)
    jbytes = sum(int(np.prod(x.shape)) * jnp.dtype(x.dtype).itemsize for x in jl)
    tbytes = sum(x.numel() * x.element_size() for x in tl)
    assert tbytes == jbytes
    assert tree_flatten(axes)[1] is not None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shapes_and_axes_equal_reference(arch):
    assert ARCH_IDS == JARCH_IDS
    jcfg, cfg = jget_config(arch), get_config(arch)
    js, ts = jlosses.batch_shapes(jcfg, 4, 32), tlosses.batch_shapes(cfg, 4, 32)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert tuple(ts[k][0]) == tuple(js[k][0])
        assert str(ts[k][1]).split(".")[-1] == jnp.dtype(js[k][1]).name
    assert tlosses.batch_axes(cfg) == jlosses.batch_axes(jcfg)


def test_dist_trainer_defaults_to_the_lm_loss():
    """DistTrainer(model_cfg=) takes lm_loss_fn as its loss (the
    reference's default), and the facade accepts model_cfg in place of
    loss_fn."""
    from repro_torch.launch.mesh import WorkerGroup
    from repro_torch.train.step import DistTrainer
    _, cfg, _, _, toks, labels = _setup("tinyllama_1_1b")
    mesh = MeshConfig(data=2, model=1, pods=1, workers_per_pod=2)
    group = WorkerGroup(0, mesh, "cpu")
    dt = DistTrainer(group, mesh, TrainConfig(protocol=TProto(comm_probability=0.5)),
                     model_cfg=cfg)
    with torch.no_grad():
        a = float(dt.loss_fn(_tp("tinyllama_1_1b"), torch.from_numpy(toks),
                             torch.from_numpy(labels)))
        b = float(tr.lm_loss(_tp("tinyllama_1_1b"), cfg, torch.from_numpy(toks),
                             torch.from_numpy(labels))[0])
    assert a == b
    with pytest.raises(ValueError, match="loss_fn or model_cfg"):
        DistTrainer(group, mesh, TrainConfig())
    tt = TTrainer(engine="dist", protocol=TProto(comm_probability=0.5), model_cfg=cfg,
                  group=group, device="cpu")
    assert tt.dist.model_cfg is cfg
    with pytest.raises(ValueError, match="requires loss_fn and group"):
        TTrainer(engine="dist", protocol=TProto(comm_probability=0.5), group=group,
                 device="cpu")


# ---------------------------------------------------------------------------
# the views' scatter backward
# ---------------------------------------------------------------------------

def _slice_views(spec, bufs):
    """The plain slice views the port used before the scatter backward."""
    leaves = [bufs[s.bucket][..., s.offset:s.offset + s.size]
              .reshape(spec.lead_shape + s.shape).to(s.dtype) for s in spec.slots]
    return tree_unflatten(spec.treedef, leaves)


def _mlp_case():
    params = tsimple.init_mlp(torch.Generator().manual_seed(0), 784, 64, 3, 10)[0]
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(8, 4, 784).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (8, 4)).astype(np.int64))

    def loss(p, xi, yi):
        return tsimple.xent_loss(tsimple.mlp_logits(p, xi), yi)
    return params, 8, x, y, loss


def _lm_case():
    _, cfg, _, _, toks, labels = _setup("tinyllama_1_1b")
    t = torch.from_numpy(np.stack([toks, toks[::-1].copy()]))
    lab = torch.from_numpy(np.stack([labels, labels[::-1].copy()]))

    def loss(p, xi, yi):
        return tr.lm_loss(p, cfg, xi, yi)[0]
    return _tp("tinyllama_1_1b"), 2, t, lab, loss


@pytest.mark.parametrize("case", ["mlp_w8", "lm_w2"])
def test_views_backward_equals_slice_views_bit_for_bit(case):
    """vmap(grad_and_value) over the stacked plane: the scatter backward's
    gradients are bit-equal to the slice views' (and the losses equal)."""
    params, W, x, y, loss = _mlp_case() if case == "mlp_w8" else _lm_case()
    stack = _stacked(params, W)
    spec = tflat.FlatSpec.build(stack, leading=1)
    bufs = spec.flatten(stack)
    row = spec.with_lead(())

    def grads(views):
        return vmap(grad_and_value(lambda b, xi, yi: loss(views(row, b), xi, yi)))(bufs, x, y)

    g_new, l_new = grads(lambda sp, b: sp.views(b))
    g_old, l_old = grads(_slice_views)
    assert torch.equal(l_new, l_old)
    for k in bufs:
        assert g_new[k].shape == bufs[k].shape
        assert torch.equal(g_new[k].view(torch.int32), g_old[k].view(torch.int32)), k


def _stacked(params, W):
    """W replicas of ``params``, each moved by its own small noise."""
    rng = np.random.RandomState(7)
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        torch.stack([x + 0.01 * torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
                     for _ in range(W)]) for x in leaves])


class _PlaneSized(TorchDispatchMode):
    """Counts the ops (views aside) whose output has ``numel`` elements."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.hits = numel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.numel() == self.numel:
                self.hits.append(str(func))
        return out


def test_views_backward_writes_one_plane_per_bucket():
    """The backward through the views makes ONE plane-sized tensor per
    bucket (the cat), where slice views make one zero-filled plane per leaf
    and add them."""
    params, W, x, y, loss = _lm_case()
    spec = tflat.FlatSpec.build(params)
    n = spec.totals["float32"]

    def backward_hits(views):
        buf = spec.flatten(params)["float32"].requires_grad_(True)
        out = loss(views(spec, {"float32": buf}), x[0], y[0])
        with _PlaneSized(n) as mode:
            out.backward()
        return mode.hits

    new, old = backward_hits(lambda sp, b: sp.views(b)), backward_hits(_slice_views)
    assert len(new) == 1 and "cat" in new[0], new
    assert len(old) >= len(spec.slots), old
