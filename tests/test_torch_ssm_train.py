"""Training SSM and hybrid models through the engines (ROADMAP.md 7b.4e):
the port against the reference at the reduced ``xlstm_125m`` (1 mLSTM + 1
sLSTM layer) and ``zamba2_2_7b`` (2 Mamba2 layers, a shared attention site
between them), the reference's ``init_lm`` weights carried across by
``params_from_jax``, inputs from seeded numpy:

- ``lm_loss`` and its flat gradient through the engines' boundary,
  ``vmap(grad_and_value)`` over W = 2 workers' rows, against the
  reference's ``jax.value_and_grad`` per worker. xLSTM holds rtol 1e-4 /
  atol 1e-5 element for element. Zamba2's chunked GLA sums its f32
  products in other orders in the two frameworks (0.04% of the elements
  fall outside that bound), so both packages' f32 gradients are held to
  the port's f64 one instead, as ``PERF.md`` §2 holds LM gradients: at
  most 10% of the elements outside rtol 1e-4 / atol 1e-6 (measured: the
  port 2.48%, the reference 0.010%; relative L2 distance 8.2e-5 and
  1.2e-5). The gap is worker 1's (the perturbed row: the port 4.96%, the
  reference 0.014%; worker 0 0.0070% and 0.0069%), and it is the first
  Mamba2 mixer's f32 forward rounding, to which that parameter point's
  gradient is steeply sensitive (ROADMAP.md §C): with that one forward in
  f64 the port's share there falls to 0.0051%;
- the chunked GLA's gradient with the decay near its floor over a long
  chunk (the exponent is masked before ``exp``; unmasked, exp(+huge) gives
  inf and NaN gradients), finite and equal to the reference's;
- sim and async steps started from the reference's state and given its
  draws (theta and velocity rtol 1e-4 / atol 1e-5, counters exact), and
  the CLI on the dist engine with 2 gloo ranks (counters against the
  host's replay of the schedule);
- ``launch.serve`` training and serving both, with the summary's
  invariants;
- ``activation_bytes`` at least what autograd keeps at a reduced shape,
  for each recurrent kind (mLSTM, sLSTM, Mamba2 with a shared site).

The recurrent blocks launch no kernel; attention (Zamba2's shared sites)
is the online softmax in training; the tensors lie on the CPU."""
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
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common import config as tconf  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.scheduler import GossipSchedule  # noqa: E402
from repro_torch.launch import serve as tserve_cli  # noqa: E402
from repro_torch.launch import train as tcli  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402

ARCHS = ["xlstm_125m", "zamba2_2_7b"]
TOL = dict(rtol=1e-4, atol=1e-5)
W, PB, SEQ = 2, 2, 32            # workers, sequences per worker, tokens per sequence
F64_OUT = 0.10                   # the share allowed outside rtol 1e-4 / atol 1e-6 of f64


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


@functools.lru_cache(maxsize=None)
def _rows(arch):
    """The W = 2 workers' flat rows: the reference's init and a perturbed
    copy."""
    jcfg, cfg, jp, jp_np, toks, labels = _setup(arch)
    js = JFlatSpec.build(jp, leading=0)
    row = np.asarray(js.flatten(jp)["float32"])
    noise = np.random.RandomState(2).randn(row.size).astype(np.float32) * 1e-2
    return js, np.stack([row, row + noise])


@functools.lru_cache(maxsize=None)
def _port_grads(arch, dtype=torch.float32):
    """vmap(grad_and_value) of ``lm_loss`` over the rows through the views
    (the engines' boundary), in ``dtype``."""
    jcfg, cfg, jp, jp_np, toks, labels = _setup(arch)
    _, rows = _rows(arch)
    spec = FlatSpec.build(tr.params_from_jax(jp_np, "cpu", dtype)).with_lead(())
    name = str(dtype).split(".")[-1]

    def loss(b, x, y):
        return tr.lm_loss(spec.views({name: b}), cfg, x, y)[0]

    g, v = vmap(grad_and_value(loss))(torch.from_numpy(rows).to(dtype),
                                      torch.from_numpy(toks), torch.from_numpy(labels))
    return g.numpy(), v.numpy()


@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    jcfg, cfg, jp, jp_np, toks, labels = _setup(arch)
    js, rows = _rows(arch)

    def loss(b, x, y):
        return jtr.lm_loss(js.views({"float32": b}), jcfg, x, y)[0]

    vg = jax.jit(jax.value_and_grad(loss))
    out = [vg(jnp.asarray(rows[w]), jnp.asarray(toks[w]), jnp.asarray(labels[w]))
           for w in range(W)]
    return np.stack([np.asarray(g) for _, g in out]), np.array([float(v) for v, _ in out])


def _outside(a, want):
    return float(np.mean(~np.isclose(a, want, rtol=1e-4, atol=1e-6)))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_flat_gradient_under_vmap_match_reference(arch):
    """Per worker, the loss (rtol 1e-5) and its gradient on the flat row:
    xLSTM element for element (rtol 1e-4 / atol 1e-5); Zamba2 both
    packages' f32 gradients against the port's f64 one, at most 10% of the
    elements outside rtol 1e-4 / atol 1e-6 (the port's and the
    reference's shares measured at 2.48% and 0.010%), with the f32
    gradients' relative L2 distance to f64 below 1e-3 (measured 8.2e-5 and
    1.2e-5)."""
    g, v = _port_grads(arch)
    jg, jv = _ref_grads(arch)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-7)
    if arch == "xlstm_125m":
        np.testing.assert_allclose(g, jg, **TOL)
        return
    g64, v64 = _port_grads(arch, torch.float64)
    np.testing.assert_allclose(v, v64, rtol=1e-6)
    for name, got in (("port", g), ("reference", jg)):
        share = _outside(got, g64)
        rel = float(np.linalg.norm(got - g64) / np.linalg.norm(g64))
        assert share <= F64_OUT and rel < 1e-3, (name, share, rel)


def test_zamba2_worker1_gap_is_the_first_mamba2_forward_s_rounding(monkeypatch):
    """Worker 1's row (the init plus 1e-2 noise): the port's f32 gradient
    with the first Mamba2 mixer's output computed in f64 and rounded to
    f32 (its backward still the f32 one) is within 3x of the reference's
    share outside rtol 1e-4 / atol 1e-6 of the port's f64 gradient, and
    the plain f32 port is not: the gap is that forward's rounding (the
    CPU's sgemm and elementwise ops round it about 1.5x as far from f64
    as the reference's do), not an op of the backward."""
    from repro_torch.models import blocks
    arch = "zamba2_2_7b"
    jcfg, cfg, jp, jp_np, toks, labels = _setup(arch)
    _, rows = _rows(arch)
    g64 = _port_grads(arch, torch.float64)[0][1]
    ref_share = _outside(_ref_grads(arch)[0][1], g64)
    spec = FlatSpec.build(tr.params_from_jax(jp_np, "cpu", torch.float32)).with_lead(())
    mamba = blocks._FORWARD["mamba"]

    def grad_w1():
        b = torch.from_numpy(rows[1]).requires_grad_(True)
        loss = tr.lm_loss(spec.views({"float32": b}), cfg, torch.from_numpy(toks[1]),
                          torch.from_numpy(labels[1]))[0]
        return torch.autograd.grad(loss, b)[0].numpy()

    calls = []

    def first_in_f64(p, x, c):
        out = mamba(p, x, c)
        calls.append(1)
        if len(calls) > 1:
            return out
        exact = mamba({k: v.double() for k, v in p.items()}, x.double(), c).float()
        return out + (exact - out).detach()

    plain = _outside(grad_w1(), g64)
    monkeypatch.setitem(blocks._FORWARD, "mamba", first_in_f64)
    fixed = _outside(grad_w1(), g64)
    # the two mixers' forwards, and with cfg.remat their recomputes in the
    # backward (layer 0's last: its plain f32 forward, whose backward is the
    # one the patched forward has)
    assert len(calls) == (4 if cfg.remat else 2)
    assert fixed <= 3 * ref_share < plain, (fixed, ref_share, plain)


def test_gla_gradient_with_the_decay_near_its_floor_is_finite():
    """The chunked GLA core over one chunk of 64 with log_g = -60 (a decay
    of e^-60 a step; the cumulative exponent reaches -3840, so exp(a_t -
    a_s) for s > t would be exp(+3840) = inf without the mask before exp):
    the output and the gradients of q, k, v and log_g finite, and equal
    to the reference's (rtol 1e-4 / atol 1e-5)."""
    rng = np.random.RandomState(8)
    B, S, H, dk, dv = 2, 64, 3, 8, 6
    q, k = (rng.randn(B, S, H, dk).astype(np.float32) for _ in range(2))
    v = rng.randn(B, S, H, dv).astype(np.float32)
    log_g = np.full((B, S, H), -60.0, np.float32) + rng.uniform(-1, 0, (B, S, H)).astype(
        np.float32)
    w = rng.randn(B, S, H, dv).astype(np.float32)

    def jf(q, k, v, lg):
        return jnp.sum(jssm.gla_chunked(q, k, v, lg, chunk=S)[0] * w)

    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3))(q, k, v, log_g)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, log_g)]
    y, state = ssm.gla_chunked(*ts, chunk=S)
    tl = torch.sum(y * torch.from_numpy(w))
    tl.backward()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for t, want in zip(ts, jg):
        assert bool(torch.isfinite(t.grad).all())
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

PROTO = dict(method="elastic_gossip", moving_rate=0.5, comm_probability=0.5)
OPT = dict(name="nag", learning_rate=3e-3, momentum=0.9)
STEPS, GB = 3, 4


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
    """3 elastic-gossip NAG steps (async: event windows) over
    ``launch.train.lm_batches``: every port step starts from the
    reference's pre-step state (and host clocks), is given its draws and is
    held to rtol 1e-4 / atol 1e-5, its counters exact
    (``_torch_async_cases.compare``)."""
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
        fired += int(np.sum(draws[0]))
    assert fired > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cli_trains_on_the_dist_engine_with_two_gloo_ranks(arch):
    """``launch.train.run(engine="dist")`` from the reference's initial
    params on 2 gloo ranks: each rank's first loss is the reference's on
    its row of the batch; sends, receives and comm_bytes equal the host's
    replay of the schedule on both ranks; the losses finite."""
    jcfg, cfg, jp, jp_np, _, _ = _setup(arch)
    steps = 4
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
        cb = sum(float(r["wire"]) * float(sum(a) / len(a)) for f, a, _ in polls if f)
        assert (r["sends"], r["recvs"], r["comm_bytes"]) == (nfire, nfire, cb), r["rank"]
    assert all(np.isfinite(h["loss"]) for h in hist) and len(hist) == steps


# ---------------------------------------------------------------------------
# train-while-serve, and the memory estimate
# ---------------------------------------------------------------------------

SUMMARY_KEYS = (
    "admitted", "arch", "boundaries", "boundary_interval_mean_s", "boundary_interval_p50_s",
    "bus_seq", "completed", "engine", "publish_every", "rejected_swaps", "slots",
    "staleness_max_steps", "staleness_mean_steps", "swap_pause_max_s", "swap_pause_mean_s",
    "swaps", "workers")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_while_serve_runs_and_keeps_its_invariants(arch):
    """``launch.serve.run`` at --reduced, W = 2, 30 boundaries, publishing
    every 3 steps: the reference's summary keys; a step a boundary; bus_seq
    = steps // publish_every, every publish swapped in (none refused),
    staleness at most publish_every; the batcher's invariants (``run``
    checks them; re-admissions zero the recurrent states and the shared
    sites' K/V) with admitted = completed + in flight and requests
    completed."""
    ts = tserve_cli.build(arch, device="cpu", workers=2, publish_every=3)
    got = ts.run(30)
    assert set(SUMMARY_KEYS) <= set(got)
    assert got["boundaries"] == 30 and got["bus_seq"] == 30 // 3
    assert got["swaps"] == got["bus_seq"] and got["rejected_swaps"] == 0
    assert 0 <= got["staleness_max_steps"] <= 3
    assert got["admitted"] == got["completed"] + ts.batcher.in_flight and got["completed"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_activation_estimate_covers_what_autograd_keeps(arch):
    """At 4 x 32 and 2 x 64 tokens: the bytes of every tensor autograd
    saves for the backward of ``lm_loss`` (parameters left out, each
    storage once) are at most ``activation_bytes``; xLSTM's reduced plan
    holds an mLSTM and an sLSTM layer, Zamba2's two Mamba2 layers and a
    shared attention site."""
    _, cfg, _, jp_np, _, _ = _setup(arch)
    kinds = {s.kind for s in tr.make_plan(cfg).segments}
    assert kinds == ({"mlstm", "slstm"} if arch == "xlstm_125m" else {"mamba"})
    p = tree_map(lambda t: t.requires_grad_(True), tr.params_from_jax(jp_np, "cpu"))
    own = {t.untyped_storage().data_ptr() for t in tree_leaves(p)}
    for b, s in ((4, 32), (2, 64)):
        saved = {}

        def pack(t):
            st = t.untyped_storage()
            if st.data_ptr() not in own:
                saved[st.data_ptr()] = st.nbytes()
            return t

        toks = torch.from_numpy(np.random.RandomState(7).randint(0, cfg.vocab_size, (b, s)))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tr.lm_loss(p, cfg, toks, toks)
        assert 0 < sum(saved.values()) <= tcli.activation_bytes(cfg, b * s, s), (b, s)
