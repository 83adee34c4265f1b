"""The paper's second experiment and its table runner on the port, against
the reference: the CIFAR CNN (logits, loss and flat gradients on the
reference's own weights, "SAME" padding at even and odd sizes), 20-step
sim trajectories of three protocols on it, adamw, the annealed moving
rate, and ``repro_torch.launch.paper_tables`` rows of every table."""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common import flat as jflat  # noqa: E402
from repro.common.config import OptimizerConfig as JOpt  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.common.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.api import registry as tregistry  # noqa: E402
from repro_torch.common import flat as tflat  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.common.config import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.core import protocols as tprotocols  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import paper_tables  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

WIDTH, W, B, STEPS = 8, 4, 4, 20
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jcnn():
    return jsimple.init_cnn(jax.random.PRNGKey(0), width=WIDTH)[0]


def _tcnn():
    return tsimple.params_from_jax(jax.tree.map(np.asarray, _jcnn()), "cpu")


def _jl(apply):
    return lambda p, x, y: jsimple.xent_loss(apply(p, x), y)


def _tl(apply):
    return lambda p, x, y: tsimple.xent_loss(apply(p, x), y)


@functools.lru_cache(maxsize=None)
def _cifar():
    return jsyn.load_cifar_like(num_train=256, num_test=32)


@functools.lru_cache(maxsize=None)
def _mnist():
    return jsyn.load_mnist(data_dir="", num_train=512, num_test=64)


# ---------------------------------------------------------------------------
# the CNN itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [32, 17])
def test_cnn_logits_loss_and_flat_grads_match_reference(size):
    """f32 on the CPU. Logits and loss within rtol 1e-5 / atol 1e-5, flat
    gradients within rtol 1e-4 / atol 1e-6: XLA and ATen sum the
    convolutions and the norm's moments in different orders, and the
    gradient goes back through three norms. 17 is odd, so stride 2 pads
    1 on each side there and (0, 1) at 32."""
    rng = np.random.RandomState(size)
    x = rng.randn(B, size, size, 3).astype(np.float32)
    y = rng.randint(0, 10, B).astype(np.int32)
    jp, tp = _jcnn(), _tcnn()
    jlog = np.asarray(jsimple.cnn_logits(jp, jnp.asarray(x)))
    tlog = tsimple.cnn_logits(tp, torch.from_numpy(x))
    np.testing.assert_allclose(tlog.numpy(), jlog, rtol=1e-5, atol=1e-5)
    jloss, tloss = _jl(jsimple.cnn_logits), _tl(tsimple.cnn_logits)
    np.testing.assert_allclose(float(tloss(tp, torch.from_numpy(x), torch.from_numpy(y))),
                               float(jloss(jp, jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5, atol=1e-5)
    js = jflat.FlatSpec.build(jp)
    jg = jax.grad(lambda b: jloss(js.views(b), jnp.asarray(x), jnp.asarray(y)))(js.flatten(jp))
    ts = tflat.FlatSpec.build(tp)
    buf = ts.flatten(tp)["float32"].requires_grad_(True)
    tloss(ts.views({"float32": buf}), torch.from_numpy(x), torch.from_numpy(y)).backward()
    np.testing.assert_allclose(buf.grad.numpy(), np.asarray(jg["float32"]), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("size", [32, 31, 17, 8])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 2)])
def test_same_convolution_and_norm_match_reference(size, k, stride):
    """The "SAME" convolution (asymmetric padding at stride 2: the low pad
    is total // 2) within 1e-5, and the norm's population std."""
    rng = np.random.RandomState(size * 10 + k)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)
    want = np.asarray(jsimple._conv2d(jnp.asarray(x), jnp.asarray(w), stride))
    got = tsimple._conv2d(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsimple._norm(torch.from_numpy(x)).numpy(),
                               np.asarray(jsimple._norm(jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_init_cnn_has_the_reference_s_layout():
    tp, taxes = tsimple.init_cnn(torch.Generator().manual_seed(0))
    jp, jaxes = jsimple.init_cnn(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    assert taxes == jaxes
    assert sum(v.numel() for v in tp.values()) == 307306
    ts, js = tflat.FlatSpec.build(tp), jflat.FlatSpec.build(jp)
    assert ts.totals == dict(js.totals)
    # Kaiming: std sqrt(2 / fan_in), fan_in = k * k * cin
    assert abs(float(tp["s2_c2"].std()) - np.sqrt(2 / (9 * 128))) < 2e-3


# ---------------------------------------------------------------------------
# sim trajectories with the reference's draws
# ---------------------------------------------------------------------------

CNN_PROTOS = {"elastic_gossip": dict(comm_probability=0.25, moving_rate=0.5),
              "gossiping_pull": dict(comm_probability=0.25),
              "allreduce": dict()}


def _lockstep(jtr, ttr, jstate, tstate, batches, restart=False):
    """Both engines over ``batches``, the reference's draws injected into
    the port. With ``restart`` every port step starts from the reference's
    pre-step theta and velocity, and the two post-step states are held to
    TOL at every step. Returns the two final states and the per-step
    losses."""
    losses = []
    for x, y in batches:
        if restart:
            for a, b in ((jstate.theta, tstate.theta), (jstate.opt.mu, tstate.opt.mu)):
                b["float32"].copy_(torch.from_numpy(np.array(a["float32"])))
        gate, peers = jtr._backend.sim._draw_fn(jnp.array(jstate.key), jnp.array(jstate.step))
        jstate, jm = jtr.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = ttr.step(tstate, (torch.from_numpy(x), torch.from_numpy(y)),
                              draws=(torch.from_numpy(np.array(gate)),
                                     torch.from_numpy(np.array(peers))))
        if restart:
            _assert_states_close(jstate, tstate)
        losses.append((float(jm["loss"]), float(tm["loss"])))
    return jstate, tstate, losses


def _assert_states_close(jstate, tstate, moments=("mu",)):
    np.testing.assert_allclose(tstate.theta["float32"].numpy(),
                               np.asarray(jstate.theta["float32"]), **TOL)
    for m in moments:
        np.testing.assert_allclose(getattr(tstate.opt, m)["float32"].numpy(),
                                   np.asarray(getattr(jstate.opt, m)["float32"]), **TOL)
    for name in ("comm_rounds", "comm_units", "comm_bytes"):
        a, b = np.asarray(getattr(jstate.proto, name)), getattr(tstate.proto, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("method", sorted(CNN_PROTOS))
def test_cnn_sim_trajectory_matches_reference(method):
    """20 NAG steps (lr 0.01, momentum 0.9, the paper's CIFAR setting) of
    the width-8 CNN at W=4, batch 4, on the CIFAR stand-in.

    Each of the 20 steps starts from the reference's pre-step theta and
    velocity and is held to rtol 1e-4 / atol 1e-5 (the gaps are <= 6e-8).
    Run free, a trajectory may leave that tolerance: at batch 4 a state an
    ulp away crosses a ReLU boundary that the other does not, and the gap
    jumps to ~2e-5 in one step and grows. The reference does the same to
    itself (:func:`test_reference_cnn_run_leaves_the_tolerance_from_one_ulp`).
    So the free run holds the counters bit-equal and the per-step losses
    to rtol 1e-4, and prints the drift of its end state."""
    train, _ = _cifar()
    shards = jpart.partition_iid(train, W, 0)
    batches = [jpart.batches_for_step(shards, i, B) for i in range(STEPS)]
    proto = dict(method=method, topology="uniform", **CNN_PROTOS[method])
    opt = dict(name="nag", learning_rate=0.01, momentum=0.9)

    def pair():
        jtr = JTrainer(engine="sim", protocol=JProto(**proto), optimizer=JOpt(**opt),
                       loss_fn=_jl(jsimple.cnn_logits), num_workers=W)
        ttr = TTrainer(engine="sim", protocol=TProto(**proto), optimizer=TOpt(**opt),
                       loss_fn=_tl(tsimple.cnn_logits), num_workers=W, device="cpu")
        return jtr, ttr, jtr.init_state(0, params=_jcnn()), ttr.init_state(0, params=_tcnn())

    jstate, tstate, _ = _lockstep(*pair(), batches, restart=True)
    assert int(tstate.step) == STEPS
    if method != "allreduce":
        assert int(tstate.proto.comm_rounds) > 0
    jstate, tstate, losses = _lockstep(*pair(), batches)
    for name in ("comm_rounds", "comm_units", "comm_bytes"):
        a, b = np.asarray(getattr(jstate.proto, name)), getattr(tstate.proto, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    np.testing.assert_allclose([t for _, t in losses], [j for j, _ in losses], rtol=1e-4)
    drift = np.abs(tstate.theta["float32"].numpy() - np.asarray(jstate.theta["float32"]))
    print(f"{method}: free-running theta max abs diff after {STEPS} steps {drift.max():.3e}")


def test_reference_cnn_run_leaves_the_tolerance_from_one_ulp():
    """Why the CNN's free-running trajectories are not held to rtol 1e-4 /
    atol 1e-5: the reference's own 20-step gossiping_pull run, started from
    its weights moved by one ulp (a random sign per element), ends outside
    that tolerance of its unperturbed run (seen: 7.1e-4 max, 29,339
    elements)."""
    train, _ = _cifar()
    shards = jpart.partition_iid(train, W, 0)
    batches = [jpart.batches_for_step(shards, i, B) for i in range(STEPS)]
    rng = np.random.RandomState(1)

    def run(params):
        jtr = JTrainer(engine="sim", protocol=JProto(method="gossiping_pull", topology="uniform",
                                                     **CNN_PROTOS["gossiping_pull"]),
                       optimizer=JOpt(name="nag", learning_rate=0.01, momentum=0.9),
                       loss_fn=_jl(jsimple.cnn_logits), num_workers=W)
        st = jtr.init_state(0, params=params)
        for x, y in batches:
            st, _ = jtr.step(st, (jnp.asarray(x), jnp.asarray(y)))
        return np.asarray(st.theta["float32"])

    moved = {k: jnp.asarray(np.nextafter(np.asarray(v), np.where(
        rng.rand(*np.shape(v)) < 0.5, np.inf, -np.inf).astype(np.float32)))
        for k, v in _jcnn().items()}
    assert all(not np.array_equal(np.asarray(moved[k]), np.asarray(v))
               for k, v in _jcnn().items())
    a, b = run(_jcnn()), run(moved)
    outside = int((~np.isclose(b, a, **TOL)).sum())
    print(f"reference vs itself from one ulp away: max abs {np.abs(a - b).max():.3e}, "
          f"{outside} elements outside rtol 1e-4 / atol 1e-5")
    assert outside > 0


def _mlp_pair(proto, opt):
    jp = jsimple.init_mlp(jax.random.PRNGKey(1), 784, 32, 2, 10)[0]
    tp = tsimple.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jtr = JTrainer(engine="sim", protocol=JProto(**proto), optimizer=JOpt(**opt),
                   loss_fn=_jl(jsimple.mlp_logits), num_workers=W)
    ttr = TTrainer(engine="sim", protocol=TProto(**proto), optimizer=TOpt(**opt),
                   loss_fn=_tl(tsimple.mlp_logits), num_workers=W, device="cpu")
    train, _ = _mnist()
    shards = jpart.partition_iid(train, W, 0)
    batches = [jpart.batches_for_step(shards, i, 8) for i in range(STEPS)]
    return jtr, ttr, jtr.init_state(0, params=jp), ttr.init_state(0, params=tp), batches


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_matches_reference(weight_decay):
    """adamw (both moments resident in opt.mu / opt.nu on the unfused path,
    bias correction at t = step + 1, decoupled weight decay scaled by eta)
    over 20 elastic-gossip steps, within rtol 1e-4 / atol 1e-5."""
    proto = dict(method="elastic_gossip", comm_probability=0.5, moving_rate=0.5,
                 topology="uniform")
    opt = dict(name="adamw", learning_rate=3e-3, weight_decay=weight_decay)
    jtr, ttr, js, ts, batches = _mlp_pair(proto, opt)
    nu0 = ts.opt.nu["float32"]
    jstate, tstate, _ = _lockstep(jtr, ttr, js, ts, batches)
    _assert_states_close(jstate, tstate, moments=("mu", "nu"))
    assert tstate.opt.nu["float32"] is nu0          # written in place
    assert int(tstate.opt.step) == STEPS and float(nu0.abs().sum()) > 0


@pytest.mark.parametrize("method", ["elastic_gossip", "gossiping_pull"])
def test_annealed_moving_rate_matches_reference(method):
    """moving_rate 0.9 annealed to 0.1 over 12 of the 20 steps (the setting
    of the reference's benchmarks/alpha_schedule.py, on a shorter clock so
    the rate also sits at its floor), within rtol 1e-4 / atol 1e-5."""
    proto = dict(method=method, comm_probability=0.5, moving_rate=0.9, moving_rate_final=0.1,
                 alpha_decay_steps=12, topology="uniform")
    opt = dict(name="nag", learning_rate=1e-3, momentum=0.9)
    jtr, ttr, js, ts, batches = _mlp_pair(proto, opt)
    jstate, tstate, _ = _lockstep(jtr, ttr, js, ts, batches)
    _assert_states_close(jstate, tstate)
    impl = ttr.impl
    for step, want in ((0, 0.9), (6, 0.5), (12, 0.1), (19, 0.1)):
        got = float(impl.alpha_at(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) < 1e-6, (step, got)


def test_train_config_fields_are_the_reference_s():
    """Every field of the port's TrainConfig is one of the reference's, in
    its order and with its default; the run fields the port has no reader
    for yet are left out, not accepted and ignored."""
    import dataclasses
    names = [f.name for f in dataclasses.fields(TTrainConfig)]
    ref = [f.name for f in dataclasses.fields(JTrainConfig)]
    assert names == [n for n in ref if n in names]
    assert set(ref) - set(names) == {"steps", "seed", "param_dtype", "compute_dtype",
                                     "checkpoint_every", "checkpoint_dir", "log_every",
                                     "data_skew"}
    t, j = dataclasses.asdict(TTrainConfig()), dataclasses.asdict(JTrainConfig())
    for n in names:
        assert t[n] == j[n], n


# ---------------------------------------------------------------------------
# the table runner
# ---------------------------------------------------------------------------

ROW_STEPS = 3


def _host_comm_mb(method, workers, kw, params):
    """comm_mb recomputed on the host: the engine's draws replayed from a
    generator seeded as the run's (seed 0), the static raw wire, and the
    f32 derivation ``f32(per_event / W) * f32(units)``."""
    cfg = TProto(method=method, moving_rate=kw.get("alpha", 0.5), topology="uniform",
                 **({} if method in ("allreduce", "none")
                    else dict(comm_probability=kw.get("p", 0.0), comm_period=kw.get("tau", 0))))
    impl = tregistry.resolve(cfg)
    wire = sum(v.numel() * v.element_size() for v in params.values())
    gen = torch.Generator().manual_seed(0)
    units = rounds = 0
    for i in range(ROW_STEPS):
        if method == "allreduce":
            units += workers
            continue
        if method == "none":
            continue
        active = tprotocols.comm_gate(cfg, gen, torch.tensor(i, dtype=torch.int32), workers)
        impl.sample_peers(gen, workers)
        units += int(active.sum())
        rounds += int(active.any())
    per_event = impl.comm_cost(wire, workers).bytes_per_event
    got = torch.full((), per_event / workers, dtype=torch.float32) * torch.tensor(
        float(units), dtype=torch.float32)
    return float(got) / 1e6, rounds


@pytest.mark.parametrize("table", ["4.1", "4.2", "4.3", "a.1", "alpha"])
def test_paper_table_rows_run_and_account(table, capsys, monkeypatch):
    """Every row of the table (quick sweeps) at 3 steps on the CPU: the
    reference's CSV, finite results, and comm_mb and comm_events equal to
    the host's recomputation."""
    monkeypatch.setenv("REPRO_BENCH_HIDDEN", "32")
    title, rows = paper_tables.table_rows(table, steps=ROW_STEPS)
    data = {"mnist": tsyn.load_mnist(num_train=512, num_test=64),
            "cifar": tsyn.load_cifar_like(num_train=512, num_test=32)}
    for label, method, workers, kw in rows:
        train, test = data[kw["task"]]
        r = paper_tables.run_config(method, workers, label=label, steps=ROW_STEPS,
                                    train=train, test=test, device="cpu", **kw)
        print(r.csv())
        assert r.label == label and r.steps == ROW_STEPS and r.workers == workers
        assert all(np.isfinite([r.rank0_acc, r.aggregate_acc, r.final_loss, r.comm_mb]))
        params, _ = paper_tables._model(kw["task"], 0, "cpu")
        mb, rounds = _host_comm_mb(method, workers, kw, params)
        assert r.comm_mb == mb, (label, r.comm_mb, mb)
        assert r.comm_events == rounds, (label, r.comm_events, rounds)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(rows)
    assert all(len(line.split(",")) == len(paper_tables.CSV_HEADER.split(",")) for line in out)
    assert paper_tables.CSV_HEADER == "label,method,workers,p,tau,alpha,rank0_acc," \
        "aggregate_acc,final_loss,steps,seconds,comm_events,comm_mb"
    assert title.startswith("# ")


def test_paper_tables_refuses_unknown_tables_and_a_missing_card():
    with pytest.raises(ValueError, match="unknown table"):
        paper_tables.table_rows("9.9")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            paper_tables.run_config("none", 4, steps=1, device="cuda")
