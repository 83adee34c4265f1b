"""The port's slice as a whole against the reference: data, the MLP (logits,
loss, flat gradients), and 50-step GossipTrainer(engine="sim") trajectories
with the reference's draws and initial params injected."""
import functools

import pytest

torch = pytest.importorskip("torch")
# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread each keeps torch from oversubscribing them (the tensors are small)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common import flat as jflat  # noqa: E402
from repro.common.config import OptimizerConfig as JOpt  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro.obs.schema import CORE_STEP_KEYS as J_CORE_KEYS  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common import flat as tflat  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.data import partition as tpart  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402
from repro_torch.common.pytree import tree_take_leading  # noqa: E402
from repro_torch.obs.schema import CORE_STEP_KEYS as T_CORE_KEYS  # noqa: E402
from repro_torch.serving.engine import consensus_params  # noqa: E402

IN, HID, DEPTH, NCLS, B = 784, 64, 2, 10, 16
STEPS = 50


@functools.lru_cache(maxsize=None)
def _data():
    return jsyn.load_mnist(data_dir="", num_train=1024, num_test=256)


def _jloss(p, x, y):
    return jsimple.xent_loss(jsimple.mlp_logits(p, x), y)


def _tloss(p, x, y):
    return tsimple.xent_loss(tsimple.mlp_logits(p, x), y)


@functools.lru_cache(maxsize=None)
def _jparams():
    return jsimple.init_mlp(jax.random.PRNGKey(0), IN, HID, DEPTH, NCLS)[0]


def test_data_copies_give_the_reference_arrays():
    """Pure numpy: the same seed gives the same arrays, bit for bit."""
    jtr, jte = jsyn.load_mnist(data_dir="", num_train=512, num_test=64, seed=3)
    ttr, tte = tsyn.load_mnist(num_train=512, num_test=64, seed=3)
    for a, b in ((jtr, ttr), (jte, tte)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    for W in (4, 8):
        js = jpart.partition_iid(jtr, W, 1)
        ts = tpart.partition_iid(ttr, W, 1)
        for step in (0, 7):
            for a, b in zip(jpart.batches_for_step(js, step, B),
                            tpart.batches_for_step(ts, step, B)):
                np.testing.assert_array_equal(a, b)
    jd = jpart.partition_dirichlet(jtr, 4, 0.5, 2)
    td = tpart.partition_dirichlet(ttr, 4, 0.5, 2)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(a.y, b.y)


def test_model_logits_loss_and_flat_grads_match_reference():
    """f32 on the CPU in both packages. Tolerance rtol=1e-5, atol=1e-6:
    same math, but XLA and ATen sum the 784- and 64-long dot products in
    different orders."""
    train, _ = _data()
    x, y = train.x[:B], train.y[:B]
    jp = _jparams()
    tp = tsimple.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jl = jsimple.mlp_logits(jp, jnp.asarray(x))
    tl = tsimple.mlp_logits(tp, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(_tloss(tp, torch.from_numpy(x), torch.from_numpy(y))),
                               float(_jloss(jp, jnp.asarray(x), jnp.asarray(y))), **tol)
    acc_j = float(jsimple.accuracy(jl, jnp.asarray(y)))
    acc_t = float(tsimple.accuracy(tl, torch.from_numpy(y)))
    assert acc_j == acc_t
    # gradients on the flat plane: reference through its scatter-VJP views,
    # the port through plain slice views of one leaf buffer
    js = jflat.FlatSpec.build(jp)
    jg = jax.grad(lambda b: _jloss(js.views(b), jnp.asarray(x), jnp.asarray(y)))(
        js.flatten(jp))
    ts = tflat.FlatSpec.build(tp)
    buf = ts.flatten(tp)["float32"].requires_grad_(True)
    _tloss(ts.views({"float32": buf}), torch.from_numpy(x), torch.from_numpy(y)).backward()
    np.testing.assert_allclose(buf.grad.numpy(), np.asarray(jg["float32"]), **tol)


PROTOS = {
    "elastic_gossip": dict(comm_probability=0.125, moving_rate=0.5),
    "gossiping_pull": dict(comm_probability=0.125),
    "allreduce": dict(),
    "gossiping_push": dict(comm_period=3),
    "easgd": dict(comm_probability=0.125, moving_rate=0.5),
    "none": dict(),
}
# the paper's method and the two baselines it is compared with at W = 4 and
# 8; the other three builtins at W = 4
TRAJECTORIES = ([(m, W) for m in ("elastic_gossip", "gossiping_pull", "allreduce")
                 for W in (4, 8)]
                + [(m, 4) for m in ("gossiping_push", "easgd", "none")])


@functools.lru_cache(maxsize=None)
def _ref_run(method, W):
    """50 reference steps from the shared params; returns the final state
    (as numpy), the per-step batches, gate/peer draws and metrics."""
    train, _ = _data()
    jtr = JTrainer(engine="sim", protocol=JProto(method=method, topology="uniform",
                                                 **PROTOS[method]),
                   optimizer=JOpt(name="nag", learning_rate=1e-3, momentum=0.99),
                   loss_fn=_jloss, num_workers=W)
    jstate = jtr.init_state(0, params=_jparams())
    shards = jpart.partition_iid(train, W, 0)
    batches, draws, metrics = [], [], []
    for i in range(STEPS):
        x, y = jpart.batches_for_step(shards, i, B)
        # the reference step donates its state: copy the key before it runs
        gate, peers = jtr._backend.sim._draw_fn(jnp.array(jstate.key), jnp.array(jstate.step))
        jstate, jm = jtr.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        batches.append((x, y))
        draws.append((np.array(gate), np.array(peers)))
        # read the metrics now: the next step donates their buffers
        metrics.append({k: np.asarray(v) for k, v in jm.items()})
    final = {"theta": np.asarray(jstate.theta["float32"]),
             "mu": np.asarray(jstate.opt.mu["float32"]),
             "consensus": jax.tree.map(np.asarray, JTrainer.consensus_params(None, jstate))}
    final.update({k: np.asarray(getattr(jstate.proto, k))
                  for k in ("comm_rounds", "comm_units", "comm_bytes")})
    return final, batches, draws, metrics


def _port_run(method, W, fused=True):
    """The port over the reference's batches with the reference's draws
    injected, from the same initial params."""
    _, batches, draws, _ = _ref_run(method, W)
    ttr = TTrainer(engine="sim", protocol=TProto(method=method, topology="uniform",
                                                 **PROTOS[method]),
                   optimizer=TOpt(name="nag", learning_rate=1e-3, momentum=0.99),
                   loss_fn=_tloss, num_workers=W, fused_update=fused, device="cpu")
    tstate = ttr.init_state(0, params=tsimple.params_from_jax(
        jax.tree.map(np.asarray, _jparams()), "cpu"))
    metrics = []
    for (x, y), (gate, peers) in zip(batches, draws):
        tstate, tm = ttr.step(tstate, (torch.from_numpy(x), torch.from_numpy(y)),
                              draws=(torch.from_numpy(gate), torch.from_numpy(peers)))
        metrics.append({k: np.asarray(v) for k, v in tm.items()})
    return tstate, metrics


@pytest.mark.parametrize("method,W", TRAJECTORIES)
def test_sim_trajectory_matches_reference(method, W):
    """Params and velocity after 50 NAG steps: rtol=1e-4, atol=1e-5. The
    per-step matmul sums differ in order (XLA vs ATen), and momentum 0.99
    carries each ulp forward; observed gaps are near 1e-6. Accounting is
    integer-exact and comm_bytes bit-equal."""
    ref, _, draws, jmetrics = _ref_run(method, W)
    tstate, tmetrics = _port_run(method, W)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tstate.theta["float32"].numpy(), ref["theta"], **tol)
    np.testing.assert_allclose(tstate.opt.mu["float32"].numpy(), ref["mu"], **tol)
    for name in ("comm_rounds", "comm_units", "comm_bytes"):
        b = getattr(tstate.proto, name).numpy()
        assert ref[name].dtype == b.dtype and np.array_equal(ref[name], b), (name, ref[name], b)
    assert int(tstate.step) == STEPS and int(tstate.opt.step) == STEPS
    for jm, tm, (gate, _) in zip(jmetrics, tmetrics, draws):
        assert set(tm) == set(jm) == set(T_CORE_KEYS) == set(J_CORE_KEYS)
        assert int(tm["comm_active"]) == int(jm["comm_active"]) == int(gate.sum())
        assert bool(tm["fired"]) == bool(jm["fired"])
        assert int(tm["comm_round"]) == int(jm["comm_round"])
        assert float(tm["comm_bytes"]) == float(jm["comm_bytes"])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["loss_max"]), float(jm["loss_max"]), rtol=1e-4)
    if method not in ("allreduce", "none"):
        assert int(tstate.proto.comm_rounds) > 0
    # the consensus (paper 'Aggregate') and rank-0 views
    tc = consensus_params(tstate)
    for k, v in ref["consensus"].items():
        np.testing.assert_allclose(tc[k].numpy(), v, **tol)
    r0 = tree_take_leading(tstate.params, 0)
    assert r0["w0"].shape == (IN, HID)
    assert torch.equal(r0["w0"], tstate.params["w0"][0])


@pytest.mark.parametrize("method", ["elastic_gossip", "gossiping_pull", "gossiping_push"])
def test_port_fused_and_unfused_paths_agree(method):
    """Kernel B1's path against the per-bucket path, same draws: they round
    the comm displacement differently, so rtol=1e-4, atol=1e-5."""
    t_fused, _ = _port_run(method, 4, fused=True)
    t_plain, _ = _port_run(method, 4, fused=False)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_fused.theta["float32"].numpy(),
                               t_plain.theta["float32"].numpy(), **tol)
    np.testing.assert_allclose(t_fused.opt.mu["float32"].numpy(),
                               t_plain.opt.mu["float32"].numpy(), **tol)
    assert torch.equal(t_fused.proto.comm_bytes, t_plain.proto.comm_bytes)


def test_own_draws_train_and_account():
    """Without injected draws the port draws from its own generator: the
    run is reproducible from the seed, the loss falls, and comm_units is the
    sum of the gates it drew."""
    train, _ = _data()
    shards = tpart.partition_iid(train, 4, 0)

    def run():
        ttr = TTrainer(engine="sim", protocol=TProto(comm_probability=0.5, topology="uniform"),
                       optimizer=TOpt(learning_rate=1e-3, momentum=0.9), loss_fn=_tloss,
                       num_workers=4, device="cpu",
                       init_fn=lambda g: tsimple.init_mlp(g, IN, HID, DEPTH, NCLS)[0])
        st = ttr.init_state(5)
        losses, active = [], 0
        for i in range(30):
            st, m = ttr.step(st, tpart.batches_for_step(shards, i, B))
            losses.append(float(m["loss"]))
            active += int(m["comm_active"])
        return st, losses, active

    st, losses, active = run()
    st2, losses2, _ = run()
    assert losses == losses2 and torch.equal(st.theta["float32"], st2.theta["float32"])
    assert int(st.proto.comm_units) == active > 0
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


@pytest.mark.parametrize("method", sorted(PROTOS))
def test_comm_cost_matches_reference(method):
    """Analytic egress from the live wire size: exact (python floats)."""
    jtr = JTrainer(engine="sim", protocol=JProto(method=method, **PROTOS[method]),
                   loss_fn=_jloss, num_workers=8)
    ttr = TTrainer(engine="sim", protocol=TProto(method=method, **PROTOS[method]),
                   loss_fn=_tloss, num_workers=8, device="cpu")
    jtr.init_state(0, params=_jparams())
    ttr.init_state(0, params=tsimple.params_from_jax(jax.tree.map(np.asarray, _jparams()),
                                                     "cpu"))
    for pb in (None, 1000):
        t, j = ttr.comm_cost(pb), jtr.comm_cost(pb)
        assert (t.bytes_per_event, t.events_per_step, t.bytes_per_step) == \
            (j.bytes_per_event, j.events_per_step, j.bytes_per_step)


def test_unported_features_refuse():
    # the codecs are ported (slice 2): codec="q8" now builds
    tr = TTrainer(protocol=TProto(comm_probability=0.5, codec="q8"), loss_fn=_tloss,
                  num_workers=2, device="cpu")
    assert tr.codec is not None and tr.codec.name == "q8" and tr.sim.codec is tr.codec
    # the fault plane is ported (slice 3): faults=FaultConfig(...) now builds
    from repro_torch.common.config import FaultConfig as TFault
    tr = TTrainer(protocol=TProto(method="clipped_gossip", comm_probability=0.5),
                  loss_fn=_tloss, num_workers=2, device="cpu",
                  faults=TFault(fault_model="drop", fault_rate=0.2))
    assert tr.sim.fault_model.name == "drop" and tr.sim.faults.fault_rate == 0.2
    # the dist engine is ported (slice 5): it builds on a rank's group and
    # asks for one without it
    with pytest.raises(ValueError, match="requires loss_fn and group"):
        TTrainer(engine="dist", protocol=TProto(comm_probability=0.5),
                 loss_fn=_tloss, num_workers=2, device="cpu")
    # the async engine and the fleet plane are ported (slice 4a): they build
    from repro_torch.common.config import FleetConfig as TFleet
    tr = TTrainer(engine="async", protocol=TProto(comm_probability=0.5),
                  loss_fn=_tloss, num_workers=2, device="cpu")
    assert tr.sim.time_model.name == "constant"
    tr = TTrainer(protocol=TProto(comm_probability=0.5), loss_fn=_tloss, num_workers=2,
                  device="cpu", fleet=TFleet(partition=2))
    assert tr.sim.partition == 2
    # the sharded plane (slice 4b) and the telemetry plane (slice 6) build
    from repro_torch.common.config import ObsConfig as TObs
    from repro_torch.common.config import ShardConfig as TShard
    for engine in ("sim", "async"):
        tr = TTrainer(engine=engine, protocol=TProto(comm_probability=0.5), loss_fn=_tloss,
                      num_workers=2, device="cpu", shard=TShard(n_shards=2),
                      obs=TObs(trace=True))
        assert tr.sim.shard.n_shards == 2 and tr.sim.obs is tr.observer
    # publish_every is slice 7b
    with pytest.raises(NotImplementedError, match="slice 7b"):
        TTrainer(protocol=TProto(comm_probability=0.5), loss_fn=_tloss, num_workers=2,
                 device="cpu", publish_every=3)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTrainer(protocol=TProto(comm_probability=0.5), loss_fn=_tloss, num_workers=2)


# ---------------------------------------------------------------------------
# building blocks against the reference
# ---------------------------------------------------------------------------

def test_mixing_matrices_and_mix_ops_match_reference():
    """Same peers and gates: the [W, W] matrices are exact (0/1, halves,
    1/k and alpha arithmetic in f32); the mixes within rtol 1e-6."""
    from repro.core import topology as jtop
    from repro_torch.core import topology as ttop
    rng = np.random.RandomState(4)
    for W in (5, 8):
        for _ in range(2):
            peers = rng.randint(0, W - 1, W)
            peers = np.where(peers >= np.arange(W), peers + 1, peers).astype(np.int32)
            active = rng.rand(W) < 0.5
            jp, ja = jnp.asarray(peers), jnp.asarray(active)
            tp, ta = torch.from_numpy(peers), torch.from_numpy(active)
            pairs = [(jtop.elastic_gossip_mix(jp, ja, 0.5), ttop.elastic_gossip_mix(tp, ta, 0.5)),
                     (jtop.gossip_pull_mix(jp, ja), ttop.gossip_pull_mix(tp, ta)),
                     (jtop.gossip_push_mix(jp, ja), ttop.gossip_push_mix(tp, ta)),
                     (jtop.discard_lost(jtop.elastic_gossip_mix(jp, ja, 0.5), ja),
                      ttop.discard_lost(ttop.elastic_gossip_mix(tp, ta, 0.5), ta))]
            for jm, tm in pairs:
                np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            mix = pairs[0][0]
            x = rng.randn(W, 300).astype(np.float32)
            xt = (x + 0.01 * rng.randn(W, 300)).astype(np.float32)
            jmix = jtop.apply_mix(mix, {"b": jnp.asarray(x)})["b"]
            tmix = ttop.apply_mix(pairs[0][1], {"b": torch.from_numpy(x)})["b"]
            np.testing.assert_allclose(tmix.numpy(), np.asarray(jmix), rtol=1e-6, atol=1e-6)
            jsplit = jtop.apply_mix_split(mix, {"b": jnp.asarray(x)}, {"b": jnp.asarray(xt)})["b"]
            tsplit = ttop.apply_mix_split(pairs[0][1], {"b": torch.from_numpy(x)},
                                          {"b": torch.from_numpy(xt)})["b"]
            np.testing.assert_allclose(tsplit.numpy(), np.asarray(jsplit), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("W", [2, 5, 8])
def test_own_peer_draws_are_valid(W):
    from repro_torch.core import topology as ttop
    gen = torch.Generator().manual_seed(W)
    for _ in range(20):
        peers = ttop.sample_uniform_peers(gen, W)
        assert bool(((peers >= 0) & (peers < W) & (peers != torch.arange(W))).all())
        m = ttop.sample_matching(gen, W)
        assert torch.equal(m[m], torch.arange(W))              # an involution
        assert int((m == torch.arange(W)).sum()) == W % 2      # one self-pair iff odd
    gate = ttop.participation(gen, 10000, 0.125)
    assert gate.dtype == torch.bool and abs(float(gate.float().mean()) - 0.125) < 0.02


@pytest.mark.parametrize("cfg", [dict(), dict(schedule="step", step_anneal_at=(3, 7)),
                                 dict(schedule="cosine", decay_steps=10, warmup_steps=2),
                                 dict(warmup_steps=5)])
def test_lr_schedule_matches_reference(cfg):
    """f32 scalar arithmetic in the same order: rtol 1e-6 (cos may differ by
    an ulp between XLA and ATen)."""
    from repro.optim.schedule import lr_at as jlr
    from repro_torch.optim.schedule import lr_at as tlr
    for step in range(12):
        np.testing.assert_allclose(
            float(tlr(TOpt(**cfg), torch.tensor(step, dtype=torch.int32))),
            float(jlr(JOpt(**cfg), step)), rtol=1e-6)


def test_grad_clip_matches_reference():
    from repro.optim.optimizers import _clip as jclip
    from repro_torch.optim.optimizers import _clip as tclip
    rng = np.random.RandomState(5)
    g = {"a": rng.randn(4, 256).astype(np.float32), "b": rng.randn(4, 128).astype(np.float32)}
    for clip in (0.0, 1.0, 1e6):
        j = jclip(JOpt(grad_clip=clip), {k: jnp.asarray(v) for k, v in g.items()})
        t = tclip(TOpt(grad_clip=clip), {k: torch.from_numpy(v) for k, v in g.items()})
        for k in g:
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-6, atol=1e-7)


def test_dropout_only_with_a_generator():
    gen = torch.Generator().manual_seed(0)
    params = tsimple.init_mlp(gen, 20, 16, 2, 3)[0]
    x = torch.randn(8, 20, generator=gen)
    plain = tsimple.mlp_logits(params, x)
    # keep-probability 1 reproduces the plain logits exactly
    same = tsimple.mlp_logits(params, x, dropout_gen=gen, p_in=0.0, p_hidden=0.0)
    assert torch.equal(plain, same)
    a = tsimple.mlp_logits(params, x, dropout_gen=torch.Generator().manual_seed(1))
    b = tsimple.mlp_logits(params, x, dropout_gen=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, plain)


def _bf16_weights(params, to_bf16):
    return {k: (to_bf16(v) if k.startswith("w") else v) for k, v in params.items()}


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_bucket_matches_reference(fused):
    """A plane with a bf16 bucket (the MLP's weights) and an f32 bucket (its
    biases). On the unfused path the reference promotes: its learning rate
    is a strongly typed f32 scalar, so eta * g(bf16) is f32, and the bf16
    bucket's params and velocity come out f32 after the first step (its
    loss still reads bf16 leaves: the views cast to the spec's dtypes). The
    fused path keeps the storage dtype in both packages. Dtypes must match
    after every step. Values within rtol = atol = 2**-8, one bf16 ulp
    relative: the model computes with bf16 weights, and a bf16 rounding of
    a weight or a gradient flips where the two packages' f32 values differ
    by an ulp (XLA and ATen sum in different orders)."""
    W, steps = 4, 5

    def jloss(p, x, y):
        return _jloss(jax.tree.map(lambda a: a.astype(jnp.float32), p), x, y)

    def tloss(p, x, y):
        return _tloss({k: v.float() for k, v in p.items()}, x, y)

    proto = dict(method="elastic_gossip", comm_probability=0.5, moving_rate=0.5,
                 topology="uniform")
    opt = dict(name="nag", learning_rate=1e-2, momentum=0.9)
    jtr = JTrainer(engine="sim", protocol=JProto(**proto), optimizer=JOpt(**opt),
                   loss_fn=jloss, num_workers=W, fused_update=fused)
    ttr = TTrainer(engine="sim", protocol=TProto(**proto), optimizer=TOpt(**opt),
                   loss_fn=tloss, num_workers=W, fused_update=fused, device="cpu")
    jstate = jtr.init_state(0, params=_bf16_weights(_jparams(),
                                                     lambda a: a.astype(jnp.bfloat16)))
    tstate = ttr.init_state(0, params=_bf16_weights(
        tsimple.params_from_jax(jax.tree.map(np.asarray, _jparams()), "cpu"),
        lambda t: t.to(torch.bfloat16)))
    train, _ = _data()
    shards = jpart.partition_iid(train, W, 0)
    for i in range(steps):
        x, y = jpart.batches_for_step(shards, i, B)
        gate, peers = jtr._backend.sim._draw_fn(jnp.array(jstate.key), jnp.array(jstate.step))
        draws = (torch.from_numpy(np.array(gate)), torch.from_numpy(np.array(peers)))
        jstate, _ = jtr.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, _ = ttr.step(tstate, (torch.from_numpy(x), torch.from_numpy(y)), draws=draws)
        for name, jb, tb in (("theta", jstate.theta, tstate.theta),
                             ("velocity", jstate.opt.mu, tstate.opt.mu)):
            for k in ("bfloat16", "float32"):
                assert tflat.dtype_name(tb[k].dtype) == jnp.dtype(jb[k].dtype).name, (i, name, k)
                np.testing.assert_allclose(tb[k].float().numpy(),
                                           np.asarray(jb[k].astype(jnp.float32)),
                                           rtol=2**-8, atol=2**-8, err_msg=f"{i} {name} {k}")
    if not fused:
        assert jstate.theta["bfloat16"].dtype == jnp.float32   # the reference promotes
