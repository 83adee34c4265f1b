"""Training MoE and MLA models through the engines (ROADMAP.md 7b.4b): the
port against the reference at the reduced ``deepseek_v2_lite_16b`` (MLA +
MoE with a shared expert, first layer dense) and ``grok_1_314b`` (GQA +
MoE), the reference's ``init_lm`` weights carried across by
``params_from_jax``, inputs from seeded numpy:

- ``lm_loss`` and its flat gradient through the engines' boundary,
  ``vmap(grad_and_value)`` over W = 2 workers' rows, against the
  reference's ``jax.value_and_grad`` per worker; the aux term and its
  gradient separately (rtol 1e-4 / atol 1e-5);
- the dispatch's integers (ids, C, ``dest``, ``keep``, the aux counts)
  under ``vmap`` bit-equal to the unbatched call;
- the differentiable online softmax with values narrower than the keys
  (MLA's latent values) and MLA's absorbed ``k_up`` / ``v_up`` against the
  reference's ``chunked_attention`` / ``mla_forward`` gradients;
- sim and async steps started from the reference's state and given its
  draws (theta and velocity rtol 1e-4 / atol 1e-5, counters exact), and the
  CLI on the dist engine with 2 gloo ranks (counters against the host's
  replay of the schedule);
- ``launch.serve`` training and serving both, with the summary's
  invariants;
- ``activation_bytes`` at least what autograd keeps at a reduced shape.

Attention in the training step is the online softmax on either device (B9
is forward-only); the tensors lie on the CPU."""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.func import grad_and_value, vmap  # noqa: E402

import _torch_async_cases as cases  # noqa: E402
from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common import config as jconf  # noqa: E402
from repro.common.flat import FlatSpec as JFlatSpec  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.train import lm_batches as jbatches  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common import config as tconf  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.scheduler import GossipSchedule  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.launch import train as tcli  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ARCHS = ["deepseek_v2_lite_16b", "grok_1_314b"]
TOL = dict(rtol=1e-4, atol=1e-5)
W, PB, SEQ = 2, 2, 16           # workers, sequences per worker, tokens per sequence


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp, _ = jtr.init_lm(jax.random.PRNGKey(0), jcfg)
    jp_np = jax.tree.map(np.asarray, jp)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (W, PB, SEQ)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (W, PB, SEQ)).astype(np.int32)
    labels[0, 0, 3] = -1
    return jcfg, cfg, jp, jp_np, toks, labels


def _rows(arch):
    """The W = 2 workers' flat rows: the reference's init and a perturbed
    copy (so the workers route differently)."""
    jcfg, cfg, jp, jp_np, toks, labels = _setup(arch)
    js = JFlatSpec.build(jp, leading=0)
    row = np.asarray(js.flatten(jp)["float32"])
    noise = np.random.RandomState(2).randn(row.size).astype(np.float32) * 1e-2
    return js, np.stack([row, row + noise])


def _port_grads(arch, part):
    """vmap(grad_and_value) of ``lm_loss``'s ``part`` ("total" or "aux") over
    the rows through the views, the engines' boundary."""
    jcfg, cfg, jp, jp_np, toks, labels = _setup(arch)
    _, rows = _rows(arch)
    spec = FlatSpec.build(tr.params_from_jax(jp_np, "cpu")).with_lead(())

    def loss(b, x, y):
        total, parts = tr.lm_loss(spec.views({"float32": b}), cfg, x, y)
        return total if part == "total" else parts["aux"]

    g, v = vmap(grad_and_value(loss))(torch.from_numpy(rows), torch.from_numpy(toks),
                                      torch.from_numpy(labels))
    return g.numpy(), v.numpy()


def _ref_grads(arch, part):
    jcfg, cfg, jp, jp_np, toks, labels = _setup(arch)
    js, rows = _rows(arch)

    def loss(b, x, y):
        total, parts = jtr.lm_loss(js.views({"float32": b}), jcfg, x, y)
        return total if part == "total" else parts["aux"]

    vg = jax.jit(jax.value_and_grad(loss))
    out = [vg(jnp.asarray(rows[w]), jnp.asarray(toks[w]), jnp.asarray(labels[w]))
           for w in range(W)]
    return np.stack([np.asarray(g) for _, g in out]), np.array([float(v) for v, _ in out])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("part", ["total", "aux"])
def test_lm_loss_and_flat_gradient_under_vmap_match_reference(arch, part):
    """Per worker, the loss (``ce + aux_coef * aux``) or the aux term alone,
    and its gradient on the flat row, rtol 1e-4 / atol 1e-5. The aux term's
    gradient reaches the routers (through the probabilities' mean; the
    counts carry none) and what feeds them, never the head."""
    g, v = _port_grads(arch, part)
    jg, jv = _ref_grads(arch, part)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(g, jg, **TOL)
    if part == "aux":
        spec = FlatSpec.build(tr.params_from_jax(_setup(arch)[3], "cpu"))
        for path, s in zip(_leaf_names(spec), spec.slots):
            block = g[:, s.offset:s.offset + s.size]
            if path.endswith("ffn/router"):
                assert np.all(np.abs(block).max(axis=1) > 0), path
            if path in ("lm_head", "final_norm"):
                assert not np.any(block), path


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
def test_dispatch_integers_under_vmap_equal_the_unbatched_call(arch):
    """Each worker's routing (ids), capacity, dest, source tokens, keep and
    the aux loss's counts from one vmapped call over W = 3 workers' inputs,
    bit-equal to the worker's own unbatched call; C is the host arithmetic
    over one worker's tokens."""
    _, cfg, _, jp_np, _, _ = _setup(arch)
    p = tr.params_from_jax(jp_np, "cpu")["segments"]
    seg = [k for k in p if k.endswith("_moe")][0]
    pm = {k: v[0] for k, v in p[seg]["ffn"].items() if k != "shared"}
    m = cfg.moe
    x = torch.from_numpy(np.random.RandomState(3).randn(3, 24, cfg.d_model).astype(np.float32))
    C = moe.capacity(cfg, 24)

    def route(xt):
        _, weights, ids = moe._route(xt @ pm["router"], m.top_k)
        _, dest, s_tok, _, keep = moe._build_buffer(xt, ids, weights, m.num_experts, m.top_k, C)
        return ids, dest, s_tok, keep, moe._counts(ids[:, 0], m.num_experts)

    batched = vmap(route)(x)
    for w in range(3):
        one = route(x[w])
        for a, b in zip(batched, one):
            assert a[w].dtype == b.dtype and torch.equal(a[w], b)
    assert int((~batched[3]).sum()) > 0 or C * m.num_experts >= 24 * m.top_k
    counts = batched[4]
    assert counts.dtype == torch.int64 and bool((counts.sum(-1) == 24).all())


def test_online_softmax_gradient_with_values_narrower_than_the_keys():
    """MLA's shapes (one key head of width r + rope, values its first r
    columns, a view), causal, over two key chunks: the output and the
    q / k gradients against the reference's ``chunked_attention`` (the
    value gradient is part of the key's, as the values are a view)."""
    rng = np.random.RandomState(4)
    B, S, H, hd, dv = 2, 24, 4, 40, 32
    q = rng.randn(B, S, H, hd).astype(np.float32)
    k = rng.randn(B, S, 1, hd).astype(np.float32)
    w = rng.randn(B, S, H, dv).astype(np.float32)

    def jf(q, k):
        return jnp.sum(jattn.chunked_attention(q, k, k[..., :dv], causal=True, chunk=16) * w)

    jl, (jgq, jgk) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))
    tq, tk = torch.from_numpy(q).requires_grad_(True), torch.from_numpy(k).requires_grad_(True)
    out = tattn.online_softmax_attention(tq, tk, tk[..., :dv], causal=True, chunk=16)
    assert tuple(out.shape) == (B, S, H, dv)
    tl = torch.sum(out * torch.from_numpy(w))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), **TOL)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgk), **TOL)


def test_mla_forward_gradient_through_the_absorbed_einsums():
    """The gradient of MLA's forward (the absorbed ``k_up`` / ``v_up``
    einsums around the online softmax) with respect to every leaf of the
    attention and to its input, against the reference's ``mla_forward``:
    rtol 1e-4 and atol 1e-5 of each gradient's largest magnitude (the
    leaves' gradients reach ~10 here; the two frameworks sum the absorbed
    products in other orders)."""
    jcfg, cfg, jp, jp_np, _, _ = _setup("deepseek_v2_lite_16b")
    pa_j = jax.tree.map(lambda t: t[0], jp["segments"]["seg0_attn"]["attn"])
    pa_t = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in
            jax.tree.map(np.asarray, pa_j).items()}
    x = np.random.RandomState(5).randn(2, 12, cfg.d_model).astype(np.float32)
    w = np.random.RandomState(6).randn(2, 12, cfg.d_model).astype(np.float32)

    def jf(p, x):
        return jnp.sum(jattn.mla_forward(p, x, jcfg)[0] * w)

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(pa_j, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = torch.sum(tattn.mla_forward(pa_t, tx, cfg)[0] * torch.from_numpy(w))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert sorted(pa_t) == sorted(jgp)
    for name, got, want in [("x", tx.grad, jgx)] + [(n, t.grad, jgp[n]) for n, t in pa_t.items()]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=name)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

PROTO = dict(method="elastic_gossip", moving_rate=0.5, comm_probability=0.5)
OPT = dict(name="nag", learning_rate=3e-3, momentum=0.9)
STEPS, GB = 4, 4


def _trainers(arch, engine):
    jcfg, cfg, *_ = _setup(arch)
    hetero = dict(time_model="lognormal", sigma=0.5) if engine == "async" else None
    out = []
    for mod, Tr, loss, extra in (
            (jconf, JTrainer, lambda p, x, y: jtr.lm_loss(p, jcfg, x, y)[0], {}),
            (tconf, TTrainer, lambda p, x, y: tr.lm_loss(p, cfg, x, y)[0], {"device": "cpu"})):
        out.append(Tr(engine=engine, protocol=mod.ProtocolConfig(**PROTO),
                      optimizer=mod.OptimizerConfig(**OPT), loss_fn=loss, num_workers=W,
                      hetero=None if hetero is None else mod.HeteroConfig(**hetero), **extra))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", ["sim", "async"])
def test_engine_steps_from_the_reference_state_match(arch, engine):
    """4 elastic-gossip NAG steps (async: event windows) over
    ``launch.train.lm_batches``: every port step starts from the
    reference's pre-step state (and host clocks), is given its draws and is
    held to rtol 1e-4 / atol 1e-5, its integer counters exact and its f32
    counters bit-equal (``_torch_async_cases.compare``)."""
    jcfg, cfg, jp, jp_np, _, _ = _setup(arch)
    jt, tt = _trainers(arch, engine)
    jst = jt.init_state(0, params=jp)
    tst = tt.init_state(0, params=tr.params_from_jax(jp_np, "cpu"))
    batches = jbatches(jcfg, W, GB // W, SEQ, 0)
    fired = 0
    for i in range(STEPS):
        b = next(batches)
        pre = cases.snap(jst)
        draws = cases.ref_draws(jt, jst)
        tst = cases.load_into_port(tt, tst, pre, jt)
        jst, jm = jt.step(jst, (b["tokens"], b["labels"]))
        tst, tm = tt.step(tst, (torch.from_numpy(np.array(b["tokens"])),
                                torch.from_numpy(np.array(b["labels"]))),
                          draws=tuple(map(torch.from_numpy, draws)))
        cases.compare(tst, cases.snap(jst), TOL, f"{engine} step {i}")
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        if "window_size" in jm:
            assert (tm["window_size"], tm["virtual_time"]) == (jm["window_size"],
                                                               jm["virtual_time"])
        fired += int(np.sum(draws[0]))
    assert fired > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cli_trains_on_the_dist_engine_with_two_gloo_ranks(arch):
    """``launch.train.run(engine="dist")`` from the reference's initial
    params on 2 gloo ranks: each rank's first loss is the reference's on
    its row of the batch; sends, receives and comm_bytes equal the host's
    replay of the schedule on both ranks; the losses finite."""
    jcfg, cfg, jp, jp_np, _, _ = _setup(arch)
    steps = 6
    ranks, hist = tcli.run(arch, reduced=True, steps=steps, method="elastic_gossip", p=0.5,
                           tau=0, alpha=0.5, workers=W, global_batch=GB, seq=SEQ, lr=3e-3,
                           engine="dist", device="cpu", params=jp_np, log_every=1)
    b = next(jbatches(jcfg, W, GB // W, SEQ, 0))
    want = np.mean([float(jtr.lm_loss(jp, jcfg, b["tokens"][w], b["labels"][w])[0])
                    for w in range(W)])
    np.testing.assert_allclose(hist[0]["loss"], want, rtol=1e-5)
    sched = GossipSchedule(tconf.ProtocolConfig(method="elastic_gossip", moving_rate=0.5,
                                                comm_probability=0.5), W, seed=1,
                           mesh_cfg=tconf.MeshConfig(data=W, model=1, pods=1,
                                                     workers_per_pod=W))
    polls = [sched.poll(i) for i in range(steps)]
    nfire = sum(bool(f) for f, _, _ in polls)
    for r in ranks:
        cb = 0.0
        for f, active, _ in polls:
            if f:
                cb += float(r["wire"]) * float(sum(active) / len(active))
        assert (r["sends"], r["recvs"], r["comm_bytes"]) == (nfire, nfire, cb), r["rank"]
    assert all(np.isfinite(h["loss"]) for h in hist) and len(hist) == steps


# ---------------------------------------------------------------------------
# train-while-serve, and the memory estimate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_while_serve_runs_and_keeps_its_invariants(arch):
    """``launch.serve.run`` at --reduced, W = 2, 15 boundaries, publishing
    every 3 steps: the reference's summary keys; a step a boundary; bus_seq
    = steps // publish_every, every publish swapped in (none refused),
    staleness at most publish_every; the batcher's invariants (``run``
    checks them) with admitted = completed + in flight and the swap pause
    below the mean decode boundary."""
    ts = tserve_cli.build(arch, device="cpu", workers=2, publish_every=3)
    got = ts.run(15)
    assert set(SUMMARY_KEYS) <= set(got)
    assert got["boundaries"] == 15 and got["bus_seq"] == 15 // 3
    assert got["swaps"] == got["bus_seq"] and got["rejected_swaps"] == 0
    assert 0 <= got["staleness_max_steps"] <= 3
    assert got["admitted"] == got["completed"] + ts.batcher.in_flight and got["admitted"] > 0
    assert got["swap_pause_max_s"] < got["boundary_interval_mean_s"]


# the reference's summary keys that every run has (the latency ones come
# with the first completed request)
SUMMARY_KEYS = (
    "admitted", "arch", "boundaries", "boundary_interval_mean_s", "boundary_interval_p50_s",
    "bus_seq", "completed", "engine", "publish_every", "rejected_swaps", "slots",
    "staleness_max_steps", "staleness_mean_steps", "swap_pause_max_s", "swap_pause_mean_s",
    "swaps", "workers")


@pytest.mark.parametrize("arch", ARCHS)
def test_activation_estimate_covers_what_autograd_keeps(arch):
    """At 4 x 32 tokens: the bytes of every tensor autograd saves for the
    backward of ``lm_loss`` (parameters left out, each storage once) are at
    most ``activation_bytes``."""
    _, cfg, _, jp_np, _, _ = _setup(arch)
    p = tr.params_from_jax(jp_np, "cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    own = {t.untyped_storage().data_ptr() for t in tree_leaves(p)}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in own:
            saved[st.data_ptr()] = st.nbytes()
        return t

    toks = torch.from_numpy(np.random.RandomState(7).randint(0, cfg.vocab_size, (4, 32)))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tr.lm_loss(p, cfg, toks, toks)
    assert 0 < sum(saved.values()) <= tcli.activation_bytes(cfg, 4 * 32, 32)
