"""The port's fleet plane (slice 4a) against the reference on the CPU: the
partition schedule and plan bytes, flow control, partitioned and
flow-controlled sim steps and async windows started from the reference's
state with its draws, the host-resident plane against the device plane and
against the reference's host plane, the memory check's refusal, and kernel
B8's plain version on a chunk's column slice.

Inputs are made with numpy from a seed; the models are the reference
tests' Gaussian clusters and an MLP of hidden 24, depth 2."""
import pytest

torch = pytest.importorskip("torch")
# several pytest-xdist workers share a few cores: one intra-op thread each
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_async_cases as cases  # noqa: E402
from repro import comm as jcomm  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro.common import config as jcfg  # noqa: E402
from repro.common import flat as jflat  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch.common import config as tcfg  # noqa: E402
from repro_torch.common import flat as tflat  # noqa: E402
from repro_torch.common.pytree import tree_map  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

W = 8
TOL = dict(rtol=1e-5, atol=1e-6)
UNIFORM = dict(method="elastic_gossip", topology="uniform", comm_probability=0.5,
               moving_rate=0.5)
LOGNORMAL = dict(time_model="lognormal", sigma=0.6, seed=1)


# ---------------------------------------------------------------------------
# the schedule, the plan and flow control: bit-equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,P", [(0, 3), (7, 4), (123, 8)])
def test_partition_ids_are_bit_equal_to_reference(seed, P):
    for step in range(25):
        want = np.asarray(jfleet.partition_ids(seed, jnp.int32(step), W, P))
        got = tfleet.partition_ids(seed, torch.tensor(step, dtype=torch.int32), W, P)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert np.array_equal(tfleet.partition_ids_np(seed, step, W, P),
                              jfleet.partition_ids_np(seed, step, W, P))
        assert np.array_equal(tfleet.partition_ids_np(seed, step, W, P), want)


@pytest.mark.parametrize("codec", [None, "q8", "topk"])
@pytest.mark.parametrize("P", [3, 4, 7])
def test_chunk_bounds_and_plan_bytes_match_reference(codec, P):
    """Chunk bounds and per-chunk wire bytes of the plan on the MLP's flat
    plane (lane padding included), raw and through each codec; a raw
    plan's chunks sum to the full raw wire."""
    jspec = jflat.FlatSpec.build(jax.tree.map(lambda v: v[None], cases.jparams()), leading=1)
    tspec = tflat.FlatSpec.build(tree_map(lambda v: v[None], cases.tparams()), leading=1)
    jc = None if codec is None else jcomm.resolve_codec(jcfg.ProtocolConfig(codec=codec))
    tc = None if codec is None else tcomm.resolve_codec(tcfg.ProtocolConfig(codec=codec))
    jp, tp = jfleet.build_plan(jspec, P, jc), tfleet.build_plan(tspec, P, tc)
    assert jp.bounds == tp.bounds and jp.wire_bytes == tp.wire_bytes
    for b, n in tspec.totals.items():
        assert tfleet.chunk_bounds(n, P) == jfleet.chunk_bounds(n, P)
        assert np.array_equal(tp.col_chunks(b, n), jp.col_chunks(b, n))
    if codec is None:
        assert sum(tp.wire_bytes) == sum(s.size * s.dtype.itemsize for s in tspec.slots)


@pytest.mark.parametrize("name,kw", [
    ("token_account", dict(token_capacity=2.0, token_rate=0.5)),
    ("randomized_token_account", dict(token_capacity=6.0, token_rate=0.5, token_threshold=4.0,
                                      token_init=1.5, seed=9)),
])
def test_flow_control_balances_and_draws_match_reference(name, kw):
    """40 steps of random gates and windows: ``allow`` on the device (torch),
    ``allow_np`` and the balances after ``update`` equal the reference's
    jnp and numpy ones bit for bit, and so does the skip count."""
    cfgj = jcfg.FleetConfig(flow_control=name, **kw)
    cfgt = tcfg.FleetConfig(flow_control=name, **kw)
    jm, tm = jfleet.resolve_flow_control(cfgj), tfleet.resolve_flow_control(cfgt)
    rng = np.random.RandomState(2)
    tok_j = np.asarray(jm.init_tokens(W))
    tok_t = tm.init_tokens(W)
    tok_n = tok_j.copy()
    assert np.array_equal(tok_t.numpy(), tok_j)
    skipped = 0
    for step in range(40):
        gate, stepped = rng.rand(W) < 0.7, rng.rand(W) < 0.6
        aj = np.asarray(jm.allow(jnp.int32(step), jnp.asarray(tok_j)))
        at = tm.allow(torch.tensor(step, dtype=torch.int32), tok_t).numpy()
        an = tm.allow_np(step, tok_n)
        assert np.array_equal(aj, at) and np.array_equal(aj, an)
        assert np.array_equal(an, jm.allow_np(step, tok_n))
        act = gate & stepped
        skipped += int((act & ~aj).sum())
        act = act & aj
        tok_j = np.asarray(jm.update(jnp.asarray(tok_j), jnp.asarray(stepped), jnp.asarray(act)))
        tok_t = tm.update(tok_t, torch.from_numpy(stepped), torch.from_numpy(act))
        tok_n = tm.update(tok_n, stepped, act)
        assert np.array_equal(tok_t.numpy(), tok_j) and np.array_equal(tok_n, tok_j)
        assert tok_n.dtype == np.float32
    assert skipped > 0
    assert tfleet.available_flow_controls() == jfleet.available_flow_controls()


def test_fleet_refusals_and_the_inert_config():
    """The all-default FleetConfig is inert on the sim engine (bit-exact);
    partitions need a pairwise protocol, the host plane the async engine,
    and fleet= on the dist engine is slice 4b."""
    x, y = (torch.from_numpy(a) for a in cases.problem(W))
    _, a = cases.trainers("sim", W, UNIFORM)
    _, b = cases.trainers("sim", W, UNIFORM, fleet={})
    sa, sb = a.init_state(0, params=cases.tparams()), b.init_state(0, params=cases.tparams())
    for _ in range(5):
        sa, _ = a.step(sa, (x, y))
        sb, _ = b.step(sb, (x, y))
    assert torch.equal(sa.theta["float32"], sb.theta["float32"])
    assert sb.proto.tokens is None and sb.proto.chunk_units is None
    with pytest.raises(ValueError, match="pairwise"):
        cases.trainers("sim", W, dict(method="easgd", comm_period=2), fleet=dict(partition=2))
    with pytest.raises(ValueError, match="async engine"):
        cases.trainers("sim", W, UNIFORM, fleet=dict(plane="host"))
    for bad, msg in ((dict(codec="q8"), "codecs"), (dict(opt=dict(name="sgd")), "optimizer")):
        with pytest.raises(ValueError, match=msg):
            cases.trainers("async", W, UNIFORM, fleet=dict(plane="host"), **bad)
    from repro_torch.api import GossipTrainer
    with pytest.raises(NotImplementedError, match="slice 4b"):
        GossipTrainer(engine="dist", protocol=tcfg.ProtocolConfig(comm_probability=0.5),
                      loss_fn=lambda p, x, y: 0, device="cpu", fleet=tcfg.FleetConfig())


# ---------------------------------------------------------------------------
# partitioned and flow-controlled steps from the reference's state
# ---------------------------------------------------------------------------

PART_CASES = {
    "raw": (UNIFORM, None, None),
    "q8": (UNIFORM, "q8", None),
    "topk": (UNIFORM, "topk", None),
    "pull": (dict(method="gossiping_pull", topology="uniform", comm_probability=0.5), None, None),
    "clipped": (dict(UNIFORM, method="clipped_gossip", robust_clip=0.05), None, None),
    "trimmed": (dict(UNIFORM, method="trimmed_gossip", robust_trim=1.5), None, None),
    "clipped drop": (dict(UNIFORM, method="clipped_gossip", robust_clip=0.05), None,
                     dict(fault_model="drop", fault_rate=0.3, seed=3)),
}


@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_partitioned_sim_steps_match_reference(case):
    """16 sim steps with partition=4 (the MLP's 1,232-wide bucket: chunk
    offsets not multiples of 4), each from the reference's pre-step state
    with its draws: theta and velocity within rtol 1e-5 / atol 1e-6; the
    top-k residual likewise; comm_units, comm_rounds, chunk_units and the
    fault counters exact, comm_bytes (sum over chunks) bit-equal."""
    proto, codec, faults = PART_CASES[case]
    jtr, ttr = cases.trainers("sim", W, dict(proto, comm_probability=0.6), codec=codec,
                              faults=faults, fleet=dict(partition=4, seed=5))
    _, tst = cases.lockstep(jtr, ttr, W, 16, TOL)
    assert int(tst.proto.chunk_units.min()) > 0


@pytest.mark.parametrize("codec", [None, "q8"])
@pytest.mark.parametrize("flow", [{}, dict(flow_control="randomized_token_account",
                                           token_capacity=3.0, token_rate=0.4,
                                           token_threshold=2.0, seed=4)])
def test_partitioned_async_windows_match_reference(codec, flow):
    """24 lognormal windows with partition=4 (and flow control): as the sim
    steps above, plus clocks, staleness and token balances."""
    jtr, ttr = cases.trainers("async", W, dict(UNIFORM, comm_probability=0.7), codec=codec,
                              hetero=LOGNORMAL, fleet={"partition": 4, "seed": 5, **flow})
    sizes, tst = cases.lockstep(jtr, ttr, W, 24, TOL)
    assert min(sizes) < W
    if flow:
        assert int(tst.proto.flow_skipped) > 0


@pytest.mark.parametrize("engine", ["sim", "async"])
def test_flow_controlled_runs_match_reference(engine):
    """token_account with a small capacity, no partition: tokens and
    flow_skipped exact, the rest as above."""
    jtr, ttr = cases.trainers(engine, W, dict(UNIFORM, comm_probability=0.9),
                              hetero=LOGNORMAL if engine == "async" else None,
                              fleet=dict(flow_control="token_account", token_capacity=1.5,
                                         token_rate=0.3))
    _, tst = cases.lockstep(jtr, ttr, W, 16, TOL)
    assert int(tst.proto.flow_skipped) > 0


# ---------------------------------------------------------------------------
# the host-resident plane
# ---------------------------------------------------------------------------

HOST_FLEETS = [dict(plane="host"),
               dict(plane="host", partition=4, flow_control="randomized_token_account",
                    token_capacity=4.0, token_threshold=3.0, seed=2)]


@pytest.mark.parametrize("fleet", HOST_FLEETS)
@pytest.mark.parametrize("method", ["elastic_gossip", "clipped_gossip"])
def test_host_plane_matches_the_device_plane(fleet, method):
    """30 lognormal windows on the host plane and on the device plane of the
    port, free-running from the same state: theta within atol 2e-5 (the
    host exchanges round in f32 on their own), every counter, the clocks,
    the tokens and the generator's state exact."""
    proto = dict(UNIFORM, method=method, robust_clip=0.05)
    _, host = cases.trainers("async", W, proto, hetero=LOGNORMAL, fleet=fleet)
    _, dev = cases.trainers("async", W, proto, hetero=LOGNORMAL,
                            fleet=dict(fleet, plane="device"))
    x, y = (torch.from_numpy(a) for a in cases.problem(W))
    sh, sd = host.init_state(0, params=cases.tparams()), dev.init_state(0, params=cases.tparams())
    for _ in range(30):
        sh, mh = host.step(sh, (x, y))
        sd, md = dev.step(sd, (x, y))
        assert mh["window_size"] == md["window_size"]
    torch.testing.assert_close(sh.theta["float32"], sd.theta["float32"], rtol=0, atol=2e-5)
    torch.testing.assert_close(sh.opt.mu["float32"], sd.opt.mu["float32"], rtol=0, atol=2e-5)
    for f in ("comm_rounds", "comm_units", "worker_steps", "stale_steps", "stale_events",
              "clocks", "tokens", "flow_skipped", "chunk_units"):
        a, b = getattr(sh.proto, f), getattr(sd.proto, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    torch.testing.assert_close(sh.proto.comm_bytes, sd.proto.comm_bytes, rtol=1e-6, atol=0)
    torch.testing.assert_close(sh.proto.stale_time, sd.proto.stale_time, rtol=1e-6, atol=1e-6)
    assert torch.equal(sh.key.get_state(), sd.key.get_state())
    assert sh.theta["float32"].device.type == "cpu"


@pytest.mark.parametrize("fleet", HOST_FLEETS)
def test_host_plane_windows_match_reference_host_plane(fleet):
    """24 windows of the port's host plane, each from the reference host
    plane's pre-window state with its draws: theta and velocity within
    rtol 1e-5 / atol 1e-6, counters, clocks and tokens exact."""
    jtr, ttr = cases.trainers("async", W, dict(UNIFORM, method="clipped_gossip",
                                               robust_clip=0.05), hetero=LOGNORMAL, fleet=fleet)
    sizes, _ = cases.lockstep(jtr, ttr, W, 24, TOL)
    assert min(sizes) < W


def test_validate_fleet_memory_matches_reference():
    """plane_bytes with the reference's factors; the host plane's refusal is
    the reference's message word for word, the device plane's up to the
    hint (the port has no sharded plane yet)."""
    rb = 11_653_160
    for plane in ("host", "device"):
        for Wk in (8, 256, 1024):
            assert tfleet.plane_bytes(Wk, rb, plane) == jfleet.plane_bytes(Wk, rb, plane)
        assert tfleet.validate_fleet_memory(8, rb, plane, available=2 ** 40) == \
            jfleet.validate_fleet_memory(8, rb, plane, available=2 ** 40)
    msgs = {}
    for mod in (jfleet, tfleet):
        for plane in ("host", "device"):
            with pytest.raises(ValueError) as e:
                mod.validate_fleet_memory(1024, rb, plane, available=8 * 2 ** 30, what="MLP")
            msgs[(mod.__name__, plane)] = str(e.value)
    assert msgs[("repro_torch.fleet", "host")] == msgs[("repro.fleet", "host")]
    head = msgs[("repro.fleet", "device")].split("; ")[0]
    assert msgs[("repro_torch.fleet", "device")].startswith(head + "; ")
    assert "--plane host" in msgs[("repro_torch.fleet", "device")]


# ---------------------------------------------------------------------------
# kernel B8 on a chunk's columns: plain version against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 300), (301, 733), (733, 1000), (4, 516)])
def test_b8_on_column_slices_matches_reference_on_a_sliced_copy(lo, hi):
    """The plain version on the column slice ``x[:, lo:hi]`` of a [W, 1000]
    plane, written into the same slice of an output plane, is bit-equal to
    the reference's oracle on a contiguous copy of the slice; the output's
    other columns are untouched."""
    rng = np.random.RandomState(lo)
    x = rng.randn(W, 1000).astype(np.float32)
    d = (3 * rng.randn(W, hi - lo)).astype(np.float32)
    scale = rng.uniform(0.1, 1.0, W).astype(np.float32)
    thr = rng.uniform(0.5, 2.0, W).astype(np.float32)
    out = torch.full((W, 1000), 7.0)
    got = tops.robust_flat_apply(torch.from_numpy(x)[:, lo:hi], torch.from_numpy(d),
                                 torch.from_numpy(scale), torch.from_numpy(thr),
                                 out=out[:, lo:hi])
    want = np.asarray(jref.robust_flat_apply(jnp.asarray(np.ascontiguousarray(x[:, lo:hi])),
                                             jnp.asarray(d), jnp.asarray(scale),
                                             jnp.asarray(thr)))
    assert got.data_ptr() == out[:, lo:hi].data_ptr()
    assert np.array_equal(out[:, lo:hi].numpy().view(np.uint32), want.view(np.uint32))
    assert bool((out[:, :lo] == 7.0).all()) and bool((out[:, hi:] == 7.0).all())
