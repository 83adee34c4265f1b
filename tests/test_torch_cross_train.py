"""Training the cross-attention models through the engines (ROADMAP.md
7b.4d): the reduced ``musicgen_large`` and ``llama_3_2_vision_11b`` against
the reference, every cross gate set to 0.5 and ``cond`` random (the cases
of ``_torch_cross_cases.py``; at zero gates and zero cond the cross path
would be invisible):

- the loss's flat gradient under ``vmap(grad_and_value)`` at W = 2, each
  worker with its own tokens and cond, rtol 1e-4 / atol 1e-5;
- ``launch.train.lm_batches`` token for token equal to the reference's,
  its zero ``cond`` too;
- sim and async engine steps from the reference's state with its draws
  over ``lm_batches`` (whose ``cond`` is replaced by a random one; the
  engines carry ``{"tokens", "cond"}`` as x), and the CLI on the dist
  engine with 2 gloo ranks;
- ``activation_bytes`` at least what autograd keeps at a reduced shape.

Attention in the training step is the differentiable online softmax (B9
is forward-only); the tensors lie on the CPU."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

import _torch_async_cases as cases  # noqa: E402
import _torch_cross_cases as cc  # noqa: E402
from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common import config as jconf  # noqa: E402
from repro.common.flat import FlatSpec as JFlatSpec  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.train import lm_batches as jbatches  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common import config as tconf  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.scheduler import GossipSchedule  # noqa: E402
from repro_torch.launch import train as tcli  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train.losses import lm_loss_fn  # noqa: E402

ARCHS, TOL, W, PB, SEQ = cc.ARCHS, cc.TOL, cc.W, cc.PB, cc.SEQ
_setup, _port, _tokens, _cond_shape = cc.setup, cc.port, cc.tokens, cc.cond_shape


def _rows(arch):
    jcfg, cfg, jp, jp_np, *_ = _setup(arch)
    js = JFlatSpec.build(jp, leading=0)
    row = np.asarray(js.flatten(jp)["float32"])
    noise = np.random.RandomState(2).randn(row.size).astype(np.float32) * 1e-2
    return js, np.stack([row, row + noise])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_flat_gradient_under_vmap_matches_the_reference(arch):
    """Per worker (W = 2 rows, each with its own tokens and random cond),
    the loss and its gradient on the flat row through the views, the
    engines' boundary, against ``jax.value_and_grad`` per worker: rtol 1e-4
    / atol 1e-5. The cross leaves get a gradient (the gates are open)."""
    jcfg, cfg, jp, jp_np, toks, labels, cond = _setup(arch)
    js, rows = _rows(arch)
    spec = FlatSpec.build(_port(jp_np)).with_lead(())

    def loss(b, x, y):
        return tr.lm_loss(spec.views({"float32": b}), cfg, x["tokens"], y, x["cond"])[0]

    x = {"tokens": torch.from_numpy(toks), "cond": torch.from_numpy(cond)}
    g, v = vmap(grad_and_value(loss))(torch.from_numpy(rows), x, torch.from_numpy(labels))

    def jloss(b, x, y, c):
        return jtr.lm_loss(js.views({"float32": b}), jcfg, x, y, c)[0]

    vg = jax.jit(jax.value_and_grad(jloss))
    out = [vg(jnp.asarray(rows[w]), toks[w], labels[w], cond[w]) for w in range(W)]
    np.testing.assert_allclose(v.numpy(), [float(a) for a, _ in out], rtol=1e-5, atol=1e-7)
    jg = np.stack([np.asarray(b) for _, b in out])
    np.testing.assert_allclose(g.numpy(), jg, **TOL)
    full = FlatSpec.build(_port(jp_np))
    names = _leaf_names(full)
    for path, s in zip(names, full.slots):
        if "xattn/w" in path:
            assert np.abs(jg[:, s.offset:s.offset + s.size]).max() > 0, path


def _leaf_names(spec):
    from repro_torch.common.pytree import tree_unflatten
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            out.append((t, path))

    walk(tree_unflatten(spec.treedef, list(range(len(spec.slots)))), "")
    return [p for _, p in sorted(out)]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_batches_equal_the_reference(arch):
    """Three steps of ``launch.train.lm_batches`` at W = 2, 2 x 16 tokens a
    worker: tokens and labels (repeated over the K codebooks for audio)
    and the f32 zero ``cond`` equal the reference's element for element,
    with its shapes."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jb, tb = jbatches(jcfg, W, PB, SEQ, 3), tcli.lm_batches(cfg, W, PB, SEQ, 3)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert sorted(a) == sorted(b) == ["cond", "labels", "tokens"]
        for k in a:
            assert tuple(b[k].shape) == a[k].shape and str(b[k].dtype).endswith(
                str(a[k].dtype)), k
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))


PROTO = dict(method="elastic_gossip", moving_rate=0.5, comm_probability=0.5)
OPT = dict(name="nag", learning_rate=3e-3, momentum=0.9)
STEPS, GB = 3, 4


def _trainers(arch, engine):
    jcfg, cfg, *_ = _setup(arch)
    hetero = dict(time_model="lognormal", sigma=0.5) if engine == "async" else None
    out = []
    for mod, Tr, loss, extra in (
            (jconf, JTrainer,
             lambda p, x, y: jtr.lm_loss(p, jcfg, x["tokens"], y, x["cond"])[0], {}),
            (tconf, TTrainer, lm_loss_fn(cfg), {"device": "cpu"})):
        out.append(Tr(engine=engine, protocol=mod.ProtocolConfig(**PROTO),
                      optimizer=mod.OptimizerConfig(**OPT), loss_fn=loss, num_workers=W,
                      hetero=None if hetero is None else mod.HeteroConfig(**hetero), **extra))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ["sim", "async"])
def test_engine_steps_from_the_reference_state_match(arch, engine):
    """3 elastic-gossip NAG steps (async: event windows) over
    ``lm_batches`` with each batch's zero ``cond`` replaced by a seeded
    random one and the gates open: the engines carry ``{"tokens",
    "cond"}`` as x. Every port step starts from the reference's pre-step
    state (and host clocks), is given its draws and is held to rtol 1e-4 /
    atol 1e-5, counters exact (``_torch_async_cases.compare``)."""
    jcfg, cfg, jp, jp_np, *_ = _setup(arch)
    jt, tt = _trainers(arch, engine)
    jst = jt.init_state(0, params=jp)
    tst = tt.init_state(0, params=_port(jp_np))
    batches = jbatches(jcfg, W, GB // W, SEQ, 0)
    rng = np.random.RandomState(6)
    fired = 0
    for i in range(STEPS):
        b = next(batches)
        cond = rng.randn(*np.asarray(b["cond"]).shape).astype(np.float32)
        pre = cases.snap(jst)
        draws = cases.ref_draws(jt, jst)
        tst = cases.load_into_port(tt, tst, pre, jt)
        jst, jm = jt.step(jst, ({"tokens": b["tokens"], "cond": jnp.asarray(cond)},
                                b["labels"]))
        tx = {"tokens": torch.from_numpy(np.array(b["tokens"])), "cond": torch.from_numpy(cond)}
        tst, tm = tt.step(tst, (tx, torch.from_numpy(np.array(b["labels"]))),
                          draws=tuple(map(torch.from_numpy, draws)))
        cases.compare(tst, cases.snap(jst), TOL, f"{engine} step {i}")
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        fired += int(np.sum(draws[0]))
    assert fired > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cli_trains_on_the_dist_engine_with_two_gloo_ranks(arch):
    """``launch.train.run(engine="dist")`` from the reference's initial
    params on 2 gloo ranks over ``lm_batches`` (its zero cond): each
    rank's first loss is the reference's on its row of the batch with
    that cond; sends, receives and comm_bytes equal the host's replay of
    the schedule."""
    jcfg, cfg, jp, jp_np, *_ = _setup(arch)
    steps = 4
    ranks, hist = tcli.run(arch, reduced=True, steps=steps, method="elastic_gossip", p=0.5,
                           tau=0, alpha=0.5, workers=W, global_batch=GB, seq=SEQ, lr=3e-3,
                           engine="dist", device="cpu", params=jp_np, log_every=1)
    b = next(jbatches(jcfg, W, GB // W, SEQ, 0))
    want = np.mean([float(jtr.lm_loss(jp, jcfg, b["tokens"][w], b["labels"][w],
                                      b["cond"][w])[0]) for w in range(W)])
    np.testing.assert_allclose(hist[0]["loss"], want, rtol=1e-5)
    sched = GossipSchedule(tconf.ProtocolConfig(method="elastic_gossip", moving_rate=0.5,
                                                comm_probability=0.5), W, seed=1,
                           mesh_cfg=tconf.MeshConfig(data=W, model=1, pods=1,
                                                     workers_per_pod=W))
    polls = [sched.poll(i) for i in range(steps)]
    nfire = sum(bool(f) for f, _, _ in polls)
    for r in ranks:
        cb = sum(float(r["wire"]) * float(sum(a) / len(a)) for f, a, _ in polls if f)
        assert (r["sends"], r["recvs"], r["comm_bytes"]) == (nfire, nfire, cb), r["rank"]
    assert all(np.isfinite(h["loss"]) for h in hist) and len(hist) == steps


def test_activation_estimate_covers_what_autograd_keeps():
    """For both models at 4 x 32 tokens (random cond): the bytes of every
    tensor autograd saves for the backward of ``lm_loss`` (parameters left
    out, each storage once) are at most ``activation_bytes``."""
    for arch in ARCHS:
        _, cfg, _, jp_np, *_ = _setup(arch)
        p = _port(jp_np)
        for t in tree_leaves(p):
            t.requires_grad_(True)
        own = {t.untyped_storage().data_ptr() for t in tree_leaves(p)}
        saved = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in own:
                saved[st.data_ptr()] = st.nbytes()
            return t

        rng = np.random.RandomState(7)
        toks = torch.from_numpy(_tokens(cfg, rng, (4,), 32))
        cond = torch.from_numpy(rng.randn(*_cond_shape(cfg, 4)).astype(np.float32))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tr.lm_loss(p, cfg, toks, toks, cond)
        assert 0 < sum(saved.values()) <= tcli.activation_bytes(cfg, 4 * 32, 32), arch
