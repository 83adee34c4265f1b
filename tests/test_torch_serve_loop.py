"""The port's train-while-serve path (``GossipTrainer(publish_every=)``,
``repro_torch.serve.TrainServeLoop``, ``repro_torch.launch.serve``) against
the reference's, on the CPU at reduced TinyLlama (f32):

- the facade's publish hook: cadence, ``published_seq``, the refusal of a
  non-positive cadence, a NaN state's ``publish_rejected`` with the head
  left where it was and the server pinned to its last good snapshot;
- the loop on the sim and async engines, both packages from the
  reference's ``init_lm`` weights over the same ``lm_batches``, every port
  step started from the reference's pre-step state with its draws: equal
  batcher records, latency summary, bus seq, snapshot train steps and
  staleness samples; snapshots within rtol 1e-4 / atol 1e-5;
- the dist engine's publish on 2 gloo ranks: rank 0's snapshot is the mean
  of the ranks' rows, the other ranks publish nothing;
- the CLI's summary against the reference's, ``engine="dist"`` refused;
- the ported examples: the async quickstart's virtual time and window count,
  the skewed partitions' per-worker label counts."""
import functools
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_async_cases as cases  # noqa: E402
import _torch_dist_helpers as helpers  # noqa: E402
from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common import config as jcfg  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch import serve as jcli  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.train import lm_batches as jbatches  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import LiveServer as JServer  # noqa: E402
from repro.serve import TrafficGen as JTraffic  # noqa: E402
from repro.serve import TrainServeLoop as JLoop  # noqa: E402
from repro.serving.engine import make_serve_program as jmake  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.common import config as tcfg  # noqa: E402
from repro_torch.common.pytree import tree_leaves  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import quickstart, skewed_partitions  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.launch.mesh import spawn_workers  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import ContinuousBatcher, LiveServer, TrafficGen, TrainServeLoop  # noqa: E402
from repro_torch.serving.engine import consensus_params, make_serve_program  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama_1_1b"
TOL = dict(rtol=1e-4, atol=1e-5)
W = 4


# ---------------------------------------------------------------------------
# the facade's publish hook (the MLP of the reference's tests/test_serve.py)
# ---------------------------------------------------------------------------

def _mlp_trainers(publish_every):
    return cases.trainers("sim", W, dict(method="elastic_gossip", comm_probability=0.5,
                                         moving_rate=0.5, topology="uniform"),
                          publish_every=publish_every)


def test_publish_hook_cadence_equals_reference():
    """publish_every=3 over 9 steps, as the reference's
    test_publish_hook_cadence: ``published_seq`` on every third step only,
    seqs 1, 2, 3 in both packages, the last snapshot from train step 9 and
    equal to the consensus of the current state."""
    jt, tt = _mlp_trainers(3)
    x, y = cases.problem(W)
    jst, tst = cases.init_states(jt, tt)
    got = {"ref": [], "port": []}
    for i in range(1, 10):
        jst, jm = jt.step(jst, (jnp.asarray(x), jnp.asarray(y)))
        tst, tm = tt.step(tst, (torch.from_numpy(x), torch.from_numpy(y)))
        for tag, m in (("ref", jm), ("port", tm)):
            if i % 3 == 0:
                got[tag].append(m["published_seq"])
            else:
                assert "published_seq" not in m and "publish_rejected" not in m
    assert got["port"] == got["ref"] == [1, 2, 3]
    assert tt.snapshot_bus.seq == jt.snapshot_bus.seq == 3
    snap = tt.snapshot_bus.latest()
    assert snap.train_step == jt.snapshot_bus.latest().train_step == 9
    for a, b in zip(tree_leaves(snap.params), tree_leaves(consensus_params(tst))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("every", [0, -3])
def test_a_non_positive_cadence_is_refused_in_both(every):
    for Tr, extra in ((JTrainer, {}), (TTrainer, {"device": "cpu"})):
        with pytest.raises(ValueError, match="publish_every"):
            Tr(protocol=(jcfg if Tr is JTrainer else tcfg).ProtocolConfig(comm_probability=0.5),
               loss_fn=lambda p, x, y: 0.0, num_workers=2, publish_every=every, **extra)


def test_a_nan_state_is_rejected_and_the_server_keeps_its_snapshot():
    """A state gone non-finite at a publishing step: ``publish_rejected``
    in both packages, no ``published_seq``, the bus's head and seq
    unchanged, and the port's server keeps serving the last good
    snapshot."""
    jt, tt = _mlp_trainers(1)
    x, y = cases.problem(W)
    jst, tst = cases.init_states(jt, tt)
    jst, _ = jt.step(jst, (jnp.asarray(x), jnp.asarray(y)))
    tst, _ = tt.step(tst, (torch.from_numpy(x), torch.from_numpy(y)))
    good = tt.snapshot_bus.latest()
    server = LiveServer(_mlp_program(), tt.snapshot_bus)
    assert server.maybe_swap() and server.seq == 1
    jst = jst.replace(theta={k: v * jnp.nan for k, v in jst.theta.items()})
    tst.theta["float32"].mul_(float("nan"))
    with pytest.warns(RuntimeWarning, match="rejected publish"):
        jst, jm = jt.step(jst, (jnp.asarray(x), jnp.asarray(y)))
    with pytest.warns(RuntimeWarning, match="rejected publish"):
        tst, tm = tt.step(tst, (torch.from_numpy(x), torch.from_numpy(y)))
    for m in (jm, tm):
        assert m["publish_rejected"] is True and "published_seq" not in m
    assert tt.snapshot_bus.seq == jt.snapshot_bus.seq == 1
    assert tt.snapshot_bus.rejected == jt.snapshot_bus.rejected == 1
    assert tt.snapshot_bus.latest() is good
    assert not server.maybe_swap() and server.seq == 1 and server.train_step == 1


def _mlp_program():
    """A stand-in program that places the MLP's parameters (the server's
    swap only calls ``place_params``)."""
    class Program:
        device = torch.device("cpu")

        @staticmethod
        def place_params(params):
            return params
    return Program()


# ---------------------------------------------------------------------------
# the loop, sim and async, against the reference's
# ---------------------------------------------------------------------------

LOOP = dict(W=2, pw=2, seq=16, slots=4, max_len=40, boundaries=16, rate=1.0, requests=6,
            every=3)
LOGNORMAL = dict(time_model="lognormal", sigma=0.6, seed=1)


@functools.lru_cache(maxsize=None)
def _jparams():
    return jtr.init_lm(jax.random.PRNGKey(0), jget_reduced(ARCH))[0]


def _build(mod, engine):
    """Trainer, state, server, batcher of one package (the reference's
    ``launch/serve.py::run`` at LOOP's sizes; ``mod`` picks the package)."""
    ref = mod == "ref"
    c, W = LOOP, LOOP["W"]
    cm = jcfg if ref else tcfg
    cfg = jget_reduced(ARCH) if ref else get_reduced(ARCH)
    model = jtr if ref else tr
    extra = {} if ref else {"device": "cpu"}
    trainer = (JTrainer if ref else TTrainer)(
        engine=engine,
        protocol=cm.ProtocolConfig(method="elastic_gossip", comm_probability=0.5,
                                   moving_rate=0.5, topology="uniform"),
        optimizer=cm.OptimizerConfig(name="nag", learning_rate=0.01, momentum=0.9),
        loss_fn=lambda p, x, y: model.lm_loss(p, cfg, x, y)[0], num_workers=W,
        hetero=cm.HeteroConfig(**LOGNORMAL) if engine == "async" else None,
        publish_every=c["every"], **extra)
    if ref:
        state = trainer.init_state(0, params=_jparams())
        prog = jmake(make_host_mesh(1), jcfg.MeshConfig(data=1, model=1, pods=1,
                                                        workers_per_pod=1),
                     cfg, batch=c["slots"], max_len=c["max_len"], param_dtype=jnp.float32,
                     cache_dtype=jnp.float32)
        server = JServer(prog, trainer.snapshot_bus, params=trainer.consensus_params(state))
        traffic = JTraffic
    else:
        state = trainer.init_state(0, params=tr.params_from_jax(
            jax.tree.map(np.asarray, _jparams()), "cpu"))
        prog = make_serve_program(cfg, batch=c["slots"], max_len=c["max_len"],
                                  param_dtype=torch.float32, cache_dtype=torch.float32,
                                  device="cpu")
        server = LiveServer(prog, trainer.snapshot_bus, params=trainer.consensus_params(state))
        traffic = TrafficGen
    gen = traffic(1, rate=c["rate"], num_requests=c["requests"], vocab=cfg.vocab_size,
                  prompt_len=(1, 8), max_new=(4, 16))
    return trainer, state, server, (JBatcher if ref else ContinuousBatcher)(server,
                                                                             gen.requests())


def _run_reference(engine):
    """The reference's loop; every step records its pre-step state, draws
    and host clocks for the port, and every publish its snapshot."""
    c = LOOP
    trainer, state, server, batcher = _build("ref", engine)
    batches = jbatches(jget_reduced(ARCH), c["W"], c["pw"], c["seq"], 0)
    steps, snaps = [], []
    sim = trainer._backend.sim

    def train_fn(_t):
        nonlocal state
        b = next(batches)
        rec = {"pre": cases.snap(state), "draws": cases.ref_draws(trainer, state),
               "tokens": np.array(b["tokens"]), "labels": np.array(b["labels"])}
        if engine == "async":
            rec["clocks"] = (sim.clocks.copy(), sim.steps_done.copy())
        steps.append(rec)
        state, m = trainer.step(state, (b["tokens"], b["labels"]))
        if "published_seq" in m:
            s = trainer.snapshot_bus.latest()
            snaps.append((s.seq, s.train_step, np.array(s.bufs["float32"])))
        return trainer._host_steps

    loop = JLoop(server, batcher, train_fn)
    loop.run(c["boundaries"])
    batcher.check_invariants()
    return loop, steps, snaps


def _run_port(engine, steps):
    trainer, state, server, batcher = _build("port", engine)
    snaps = []
    it = iter(steps)

    def train_fn(_t):
        nonlocal state
        rec = next(it)
        state = cases.load_into_port(trainer, state, rec["pre"])
        if engine == "async":
            trainer.sim.anchor(*rec["clocks"])
        state, m = trainer.step(state, (torch.from_numpy(rec["tokens"]),
                                        torch.from_numpy(rec["labels"])),
                                draws=tuple(map(torch.from_numpy, rec["draws"])))
        if "published_seq" in m:
            s = trainer.snapshot_bus.latest()
            snaps.append((s.seq, s.train_step, s.bufs["float32"].numpy().copy()))
        return trainer._host_steps

    loop = TrainServeLoop(server, batcher, train_fn)
    loop.run(LOOP["boundaries"])
    batcher.check_invariants()
    return loop, snaps


@pytest.mark.parametrize("engine", ["sim", "async"])
def test_train_serve_loop_equals_the_reference(engine):
    """16 boundaries of one training step each, W=2, publish every 3 steps
    (async: lognormal event windows): the same completed requests (token
    for token) and latency summary, bus seq, snapshot train steps, swaps
    and staleness samples; the snapshots within rtol 1e-4 / atol 1e-5."""
    jloop, steps, jsnaps = _run_reference(engine)
    tloop, tsnaps = _run_port(engine, steps)
    jb, tb = jloop.batcher, tloop.batcher
    assert jb.completed and tb.completed == jb.completed
    assert tb.latency_summary() == jb.latency_summary()
    assert tloop.server.bus.seq == jloop.server.bus.seq == len(jsnaps) > 1
    assert [s[:2] for s in tsnaps] == [s[:2] for s in jsnaps]
    assert tloop.staleness == jloop.staleness and max(tloop.staleness) <= LOOP["every"]
    ts, js = tloop.summary(), jloop.summary()
    for k in ("boundaries", "swaps", "rejected_swaps", "staleness_max_steps",
              "staleness_mean_steps"):
        assert ts[k] == js[k], k
    for (_, _, a), (_, _, b) in zip(tsnaps, jsnaps):
        np.testing.assert_allclose(a, b, **TOL)


def test_loop_times_the_decode_boundary_and_samples_staleness_after_a_swap():
    """Frozen weights (no train_fn): one interval a boundary, no staleness
    sample; the loop stops when the cache's write head reaches max_len."""
    _, _, server, batcher = _build("port", "sim")
    loop = TrainServeLoop(server, batcher)
    loop.run(LOOP["max_len"] + 5)
    assert len(loop.boundary_times) == batcher.boundaries_run == LOOP["max_len"]
    assert loop.staleness == [] and "staleness_max_steps" not in loop.summary()


# ---------------------------------------------------------------------------
# the dist engine's publish
# ---------------------------------------------------------------------------

def test_dist_publish_on_two_ranks(tmp_path):
    """publish_every=2 over 6 steps on 2 gloo ranks: rank 0 publishes seqs
    1, 2, 3 at train steps 2, 4, 6, each snapshot within 1e-6 of the mean of
    the two ranks' rows at that step; rank 1 publishes nothing."""
    mcfg = tcfg.MeshConfig(data=2, model=1, pods=1, workers_per_pod=2)
    r0, r1 = spawn_workers(helpers.publish_rows, mcfg, "cpu", args=(6, 2), timeout_s=60,
                           join_timeout_s=180, rendezvous_dir=str(tmp_path))
    assert r0["seqs"] == [None, 1, None, 2, None, 3] and r0["bus_seq"] == 3
    assert r1["seqs"] == [None] * 6 and r1["bus_seq"] == 0 and r1["snaps"] == [None] * 3
    assert not r0["rejected"] and not r1["rejected"]
    assert not np.array_equal(r0["rows"][-1], r1["rows"][-1])   # the replicas differ
    for i, (seq, step, bufs) in enumerate(r0["snaps"]):
        assert (seq, step) == (i + 1, 2 * (i + 1))
        np.testing.assert_allclose(bufs, (r0["rows"][i] + r1["rows"][i]) / 2, rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TIMING = {"boundary_interval_mean_s", "boundary_interval_p50_s", "swap_pause_mean_s",
          "swap_pause_max_s"}


def test_cli_summary_equals_the_reference_s():
    """``run`` at --reduced, W=2, 12 boundaries: the reference's keys,
    every value but the times equal."""
    kw = dict(boundaries=12, workers=2)
    want = jcli.run(ARCH, **kw)
    got = tcli.run(ARCH, device="cpu", **kw)
    assert sorted(got) == sorted(want) and got["admitted"] > 0 and got["swaps"] > 0
    assert {k: v for k, v in got.items() if k not in TIMING} == \
        {k: v for k, v in want.items() if k not in TIMING}
    assert all(got[k] >= 0 for k in TIMING)


def test_cli_refuses_the_dist_engine_in_both():
    for run in (jcli.run, lambda *a, **k: tcli.run(*a, device="cpu", **k)):
        with pytest.raises(ValueError):
            run(ARCH, engine="dist", workers=2, boundaries=1)


def test_cli_refuses_what_does_not_fit_before_allocating():
    """The serving side counts against the device: a cache that cannot fit
    is refused, naming both sides, before any trainer exists."""
    with pytest.raises(ValueError, match="training .* serving"):
        tcli.build(ARCH, device="cpu", slots=2 ** 20, max_len=2 ** 16)


# ---------------------------------------------------------------------------
# the ported examples
# ---------------------------------------------------------------------------

def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_async_virtual_time_and_windows_equal_the_reference_s(monkeypatch):
    """The async half at a cut budget (10 steps: 40 worker-steps): the
    virtual time and the number of event windows are pure hashes of the
    lognormal time model, equal in both packages."""
    from repro.data.synthetic import load_mnist as jload
    from repro_torch.data.synthetic import load_mnist as tload
    jq = _load_example("quickstart")
    seen = []

    class Recording(jq.GossipTrainer):
        def step(self, state, batch):
            state, m = super().step(state, batch)
            seen.append(m)
            return state, m

    monkeypatch.setattr(jq, "GossipTrainer", Recording)
    monkeypatch.setattr(jq, "STEPS", 10)
    proto = dict(comm_probability=0.125, moving_rate=0.5)
    jq.train_one_async("elastic_gossip", *jload(num_train=2560, num_test=200), **proto)
    got = quickstart.train_one_async("elastic_gossip", *tload(num_train=2560, num_test=200),
                                     steps=10, device="cpu", **proto)
    assert got["windows"] == len(seen) and got["worker_steps"] >= 40
    assert got["virtual_time"] == float(seen[-1]["virtual_time"])


def test_skewed_partitions_label_counts_equal_the_reference_s():
    """Every row's per-worker label counts (Dirichlet skew 100, 0.5, 0.1 at
    W=4) equal the reference partitioner's on the reference's data; the
    rows run 2 steps."""
    from repro.data.partition import partition_dirichlet
    from repro.data.synthetic import load_mnist
    train, _ = load_mnist(num_train=12800, num_test=2000)
    rows = skewed_partitions.main(steps=2, device="cpu")
    assert len(rows) == 2 * len(skewed_partitions.SKEWS)
    for i, (r, counts) in enumerate(rows):
        skew = skewed_partitions.SKEWS[i // 2]
        want = np.stack([np.bincount(s.y, minlength=10)
                         for s in partition_dirichlet(train, 4, skew, 0)])
        assert r.steps == 2 and np.array_equal(counts, want), (skew, counts, want)
