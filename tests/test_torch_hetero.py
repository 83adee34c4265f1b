"""The port's async engine (slice 4a) against the reference on the CPU: the
compute-time and delay models' draws bit for bit, the constant fleet
bit-exact against the port's own sim engine, event windows under lognormal
and slow_node stragglers and message-mode windows started from the
reference's pre-window state with its draws injected, the partial-window
caveat in both packages, checkpoints both ways, and the plain versions of
B1's row list and of ``robust_pair_apply``.

Inputs are made with numpy from a seed and handed to both packages; the
models are the reference tests' Gaussian clusters and an MLP of hidden 24,
depth 2."""
import dataclasses
import json
import warnings

import pytest

torch = pytest.importorskip("torch")
# several pytest-xdist workers share a few cores: one intra-op thread each
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_async_cases as cases  # noqa: E402
from repro import faults as jfaults  # noqa: E402
from repro import hetero as jhetero  # noqa: E402
from repro.api import registry as jregistry  # noqa: E402
from repro.common import config as jcfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch import hetero as thetero  # noqa: E402
from repro_torch.api import registry as tregistry  # noqa: E402
from repro_torch.common import config as tcfg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

W = 4
TOL = dict(rtol=1e-5, atol=1e-6)
UNIFORM = dict(method="elastic_gossip", topology="uniform", comm_probability=0.5,
               moving_rate=0.5)


# ---------------------------------------------------------------------------
# time and delay models: draws bit-equal to the reference's
# ---------------------------------------------------------------------------

TIME_MODELS = [
    ("constant", dict(mean_step_time=1.5)),
    ("lognormal", dict(sigma=0.6, seed=11)),
    ("slow_node", dict(slow_worker=2, slow_factor=3.0)),
    ("fail_rejoin", dict(slow_worker=1, fail_at=2.0, rejoin_at=5.0)),
    ("fail_rejoin", dict(slow_worker=-1, fail_at=2.0, rejoin_at=5.0)),
]


def test_time_model_registries_agree():
    assert thetero.available_time_models() == jhetero.available_time_models()
    assert tfaults.available_delay_models() == jfaults.available_delay_models()
    with pytest.raises(ValueError, match="unknown time model"):
        thetero.resolve_time_model(tcfg.HeteroConfig(time_model="nope"))

    @thetero.register_time_model("_test_double")
    class Double(thetero.get_time_model("constant")):
        def step_duration(self, worker, step):
            return 2.0 * super().step_duration(worker, step)
    try:
        m = thetero.resolve_time_model(tcfg.HeteroConfig(time_model="_test_double"))
        assert m.name == "_test_double"
        assert np.array_equal(m.next_completion(np.zeros(3, np.int64), np.ones(3)),
                              np.full(3, 3.0))
    finally:
        thetero.unregister_time_model("_test_double")
    assert "_test_double" not in thetero.available_time_models()


@pytest.mark.parametrize("name,kw", TIME_MODELS)
def test_time_model_draws_are_bit_equal_to_reference(name, kw):
    """step_duration over a (worker, step) grid, next_completion and
    outage_window along a run of the event loop, bit for bit (float64)."""
    jm = jhetero.resolve_time_model(jcfg.HeteroConfig(time_model=name, **kw))
    tm = thetero.resolve_time_model(tcfg.HeteroConfig(time_model=name, **kw))
    w, k = np.meshgrid(np.arange(8), np.arange(50), indexing="ij")
    a, b = jm.step_duration(w, k), tm.step_duration(w, k)
    assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)
    clocks, steps = np.zeros(6), np.zeros(6, np.int64)
    outages = 0
    for _ in range(40):
        hold = jm.outage_window(steps, clocks)
        assert hold == tm.outage_window(steps, clocks)
        if hold is not None:
            outages += 1
            clocks = np.full(6, hold)
            continue
        nxt = jm.next_completion(steps, clocks)
        assert np.array_equal(nxt, tm.next_completion(steps, clocks))
        mask = nxt <= nxt.min()
        clocks, steps = np.where(mask, nxt, clocks), steps + mask
    assert outages == (1 if kw.get("slow_worker") == -1 else 0)


@pytest.mark.parametrize("name,kw", [("none", {}), ("constant", dict(delay=0.7)),
                                     ("uniform", dict(delay=0.7, seed=3)),
                                     ("lognormal", dict(delay=0.7, delay_sigma=0.5, seed=3))])
def test_delay_model_draws_are_bit_equal_to_reference(name, kw):
    jm = jfaults.resolve_delay_model(jcfg.FaultConfig(delay_model=name, **kw))
    tm = tfaults.resolve_delay_model(tcfg.FaultConfig(delay_model=name, **kw))
    w, k = np.meshgrid(np.arange(8), np.arange(30), indexing="ij")
    for attempt in range(3):
        a, b = jm.wire_delay(w, k, attempt=attempt), tm.wire_delay(w, k, attempt=attempt)
        assert np.array_equal(np.asarray(a), np.asarray(b)), attempt
        assert np.asarray(a).shape == np.asarray(b).shape
    for cfg in (dict(delay_model=name, **kw), dict(rendezvous=True), dict(timeout=1.0), {}):
        assert tfaults.delays_active(tcfg.FaultConfig(**cfg)) == \
            jfaults.delays_active(jcfg.FaultConfig(**cfg))


@pytest.mark.parametrize("model", ["byzantine_scale", "byzantine_noise"])
def test_garble_row_is_the_plane_path_row(model):
    """What a Byzantine worker publishes on one captured wire equals its row
    of garble_bufs (the reference's contract); honest rows pass through."""
    fm = tfaults.resolve_fault_model(tcfg.FaultConfig(fault_model=model, fault_frac=0.5,
                                                      scale=10.0, seed=4))
    bufs = {"float32": torch.randn(4, 300, generator=torch.Generator().manual_seed(0))}
    step = torch.tensor(7, dtype=torch.int32)
    plane = fm.garble_bufs(bufs, step, 4)["float32"]
    for w in range(4):
        row = fm.garble_row({"float32": bufs["float32"][w]}, w, step, 4)["float32"]
        assert torch.equal(row, plane[w]), w
    assert torch.equal(plane[3], bufs["float32"][3])


# ---------------------------------------------------------------------------
# the constant fleet: bit-exact against the port's own sim engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("proto,codec", [
    (dict(method="elastic_gossip", topology="matching", comm_period=2, moving_rate=0.5), None),
    (UNIFORM, None),
    (dict(method="gossiping_pull", topology="uniform", comm_probability=0.4), None),
    (dict(UNIFORM, comm_probability=1.0), "q8"),
    (dict(UNIFORM, comm_probability=1.0), "topk"),
])
def test_constant_fleet_is_bit_exact_against_the_sim_engine(proto, codec):
    """15 windows of HeteroConfig(constant) against 15 sim steps: theta,
    velocity, every counter and the generator's state bit for bit; the
    clocks sit at 15 on every worker and the staleness sums at 0."""
    x, y = cases.problem(W)
    _, sim = cases.trainers("sim", W, proto, codec=codec)
    _, asn = cases.trainers("async", W, proto, hetero={}, codec=codec)
    s1, s2 = sim.init_state(0, params=cases.tparams()), asn.init_state(0, params=cases.tparams())
    for _ in range(15):
        s1, _ = sim.step(s1, (torch.from_numpy(x), torch.from_numpy(y)))
        s2, m2 = asn.step(s2, (torch.from_numpy(x), torch.from_numpy(y)))
    for k in s1.theta:
        assert torch.equal(s1.theta[k], s2.theta[k]) and torch.equal(s1.opt.mu[k], s2.opt.mu[k])
    for f in ("comm_rounds", "comm_units", "comm_bytes"):
        assert torch.equal(getattr(s1.proto, f), getattr(s2.proto, f)), f
    if codec == "topk":
        assert torch.equal(s1.comm.residual["float32"], s2.comm.residual["float32"])
    assert torch.equal(s1.key.get_state(), s2.key.get_state())
    assert asn.schedule_state() == {"hetero_clock": {"clocks": [15.0] * W,
                                                     "steps_done": [15] * W}}
    assert int(s2.proto.stale_events) > 0 and float(s2.proto.stale_time) == 0.0
    assert int(s2.proto.stale_steps) == 0 and m2["window_size"] == W


# ---------------------------------------------------------------------------
# event windows from the reference's state, with its draws
# ---------------------------------------------------------------------------

def _lockstep(jtr, ttr, windows, tol=TOL, check=None):
    return cases.lockstep(jtr, ttr, W, windows, tol, check)


@pytest.mark.parametrize("hetero", [dict(time_model="lognormal", sigma=0.6, seed=1),
                                    dict(time_model="slow_node", slow_worker=0,
                                         slow_factor=3.0)])
@pytest.mark.parametrize("fused", [True, False])
def test_async_windows_match_reference_from_the_same_state(hetero, fused):
    """Each of 24 windows started from the reference's pre-window state and
    host clocks, with its gate and peers: theta and velocity within rtol
    1e-5 / atol 1e-6, clocks, worker_steps, stale_steps, stale_events and
    the comm counters exact, stale_time to f32 summation order; loss_mean
    over the window and loss_max over the window. The fused path runs B1's
    row list on partial windows, the unfused one a row select."""
    jtr, ttr = cases.trainers("async", W, dict(UNIFORM, comm_probability=0.6),
                              hetero=hetero, fused=fused)
    sizes, _ = _lockstep(jtr, ttr, 24)
    assert min(sizes) < W, sizes          # partial windows were exercised


def test_async_easgd_and_fail_rejoin_outage_match_reference():
    """EASGD (center variable) under a whole-fleet outage: the empty window
    advances the clocks only, in both packages."""
    jtr, ttr = cases.trainers("async", W, dict(method="easgd", comm_period=2, moving_rate=0.1),
                              hetero=dict(time_model="fail_rejoin", slow_worker=-1,
                                          fail_at=2.5, rejoin_at=6.0))
    sizes, _ = _lockstep(jtr, ttr, 10)
    assert 0 in sizes


def test_partial_window_drops_the_passive_partner_half_in_both_packages():
    """A caveat of the reference, followed by the port: an in-window
    initiator mixes with an out-of-window partner, whose row is then kept,
    so the window does not conserve the parameter sum (elastic gossip's
    symmetric matrix would); out-of-window rows keep their bits. A zero
    learning rate and distinct rows isolate the mixing."""
    jtr, ttr = cases.trainers("async", W, dict(UNIFORM, comm_probability=1.0),
                              hetero=dict(time_model="slow_node", slow_worker=3,
                                          slow_factor=10.0),
                              opt=dict(cases.OPT, learning_rate=0.0))
    x, y = cases.problem(W)
    jst, tst = cases.init_states(jtr, ttr)
    rng = np.random.RandomState(1)
    jst = jst.replace(theta={b: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
                             for b, v in jst.theta.items()})
    moved = 0
    for _ in range(6):
        gate, peers = cases.ref_draws(jtr, jst)
        pre = cases.snap(jst)
        tst = cases.load_into_port(ttr, tst, pre, jtr)
        _, mask, _ = ttr.sim.next_window()
        assert not mask[3] and mask[:3].all()
        jst, _ = jtr.step(jst, (jnp.asarray(x), jnp.asarray(y)))
        tst, _ = ttr.step(tst, tuple(map(torch.from_numpy, (x, y))),
                          draws=(torch.from_numpy(gate), torch.from_numpy(peers)))
        post = cases.snap(jst)
        cases.compare(tst, post, TOL)
        before = pre["theta"]["float32"]
        for got in (post["theta"]["float32"], tst.theta["float32"].numpy()):
            assert np.array_equal(got[3], before[3])          # out of window: kept
        if any(gate[i] and peers[i] == 3 for i in range(3)):
            for got in (post["theta"]["float32"], tst.theta["float32"].numpy()):
                drift = np.abs(got.astype(np.float64).sum(0) - before.astype(np.float64).sum(0))
                assert drift.max() > 1e-3, drift.max()
            moved += 1
    assert moved > 0


# ---------------------------------------------------------------------------
# message mode: the pending-wire queue
# ---------------------------------------------------------------------------

def _queue_to_port(jsim, tsim):
    tsim._pending = [dict(e, wire_i={b: torch.from_numpy(np.array(v)) for b, v in
                                     e["wire_i"].items()},
                          wire_k={b: torch.from_numpy(np.array(v)) for b, v in
                                  e["wire_k"].items()})
                     for e in jsim._pending]


def _queue_equal(jsim, tsim):
    assert len(jsim._pending) == len(tsim._pending)
    for a, b in zip(jsim._pending, tsim._pending):
        for f in ("arrival", "dispatch", "attempt", "i", "k", "step", "gap"):
            assert a[f] == b[f], (f, a[f], b[f])
        assert a["coef"] == b["coef"]
        for w in ("wire_i", "wire_k"):
            for bk in a[w]:
                np.testing.assert_allclose(b[w][bk].numpy(), np.asarray(a[w][bk]), **TOL)


MESSAGE_CASES = {
    "lognormal timeout retries": (UNIFORM, dict(delay_model="lognormal", delay=0.8,
                                                delay_sigma=0.6, timeout=0.6, max_retries=2,
                                                seed=2)),
    "uniform rendezvous": (UNIFORM, dict(delay_model="uniform", delay=0.5, rendezvous=True,
                                         seed=2)),
    "constant": (UNIFORM, dict(delay_model="constant", delay=0.3)),
    "drop at dispatch": (UNIFORM, dict(fault_model="drop", fault_rate=0.3, delay_model="constant",
                                       delay=0.4, seed=5)),
    "corrupt at dispatch": (UNIFORM, dict(fault_model="corrupt", fault_rate=0.3,
                                          delay_model="uniform", delay=0.4, seed=5)),
    "clipped stale_adapt": (dict(UNIFORM, method="clipped_gossip", robust_clip=0.05,
                                 stale_adapt=0.5),
                            dict(delay_model="lognormal", delay=0.5, timeout=1.0,
                                 max_retries=1, seed=2)),
    "trimmed byzantine_scale": (dict(UNIFORM, method="trimmed_gossip", robust_trim=2.0),
                                dict(fault_model="byzantine_scale", fault_frac=0.25,
                                     scale=5.0, delay_model="constant", delay=0.2)),
}


@pytest.mark.parametrize("case", sorted(MESSAGE_CASES))
def test_message_mode_windows_match_reference(case):
    """30 lognormal windows in message mode, each from the reference's
    pre-window state, host clocks and pending queue (its wires converted),
    with its draws: theta and velocity within rtol 1e-5 / atol 1e-6, the
    queue after the window (arrival, attempt, rows, gap, step, wires) and
    every counter (comm_units/bytes/rounds, exch_timeouts/retries,
    wire_dropped/corrupt, the staleness sums) equal."""
    proto, fkw = MESSAGE_CASES[case]
    jtr, ttr = cases.trainers("async", W, proto, faults=fkw,
                              hetero=dict(time_model="lognormal", sigma=0.6, seed=1))
    jsim, tsim = jtr._backend.sim, ttr._backend.sim

    def check(when, jtr, ttr, i):
        if when == "pre":
            _queue_to_port(jsim, tsim)
        else:
            _queue_equal(jsim, tsim)
    _, tst = _lockstep(jtr, ttr, 30, check=check)
    assert int(tst.proto.comm_units) > 0
    if "timeout" in case:
        assert int(tst.proto.exch_timeouts) > 0 and int(tst.proto.exch_retries) > 0
    if "drop" in case:
        assert int(tst.proto.wire_dropped) > 0
    if "corrupt" in case:
        assert int(tst.proto.wire_corrupt) > 0


def test_message_mode_refusals_and_checks_match_reference():
    with pytest.raises(ValueError, match="codecs do not compose"):
        cases.trainers("async", W, UNIFORM, faults=dict(delay_model="constant", delay=1.0),
                       codec="q8")
    with pytest.raises(ValueError, match="does not compose"):
        cases.trainers("async", W, UNIFORM, faults=dict(delay_model="constant", delay=1.0),
                       fleet=dict(partition=2))
    with pytest.raises(ValueError, match="not pairwise"):
        cases.trainers("async", W, dict(method="easgd", comm_period=2),
                       faults=dict(timeout=1.0))
    with pytest.raises(ValueError, match="barrier"):
        cases.trainers("async", W, dict(method="allreduce"))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cases.trainers("async", W, dict(UNIFORM, alpha_decay_steps=10,
                                        moving_rate_final=0.1))
    assert sum("EVENT WINDOW" in str(r.message) for r in rec) == 2    # both packages


# ---------------------------------------------------------------------------
# robust_pair_apply and B1's row list: plain versions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,gap", [("clipped_gossip", None), ("clipped_gossip", 3),
                                        ("trimmed_gossip", 2)])
def test_robust_pair_apply_matches_reference(method, gap):
    """One applied exchange's robust transform on single rows (two
    buckets), with the staleness-adaptive rate: within rtol 1e-6 / atol
    1e-7 of the reference's (one row-norm sum order apart)."""
    kw = dict(method=method, comm_probability=0.5, robust_clip=0.05, robust_trim=1.5,
              stale_adapt=0.4)
    jimpl = jregistry.resolve(jcfg.ProtocolConfig(**kw))
    timpl = tregistry.resolve(tcfg.ProtocolConfig(**kw))
    rng = np.random.RandomState(3)
    local = {"float32": rng.randn(700).astype(np.float32),
             "bfloat16": rng.randn(130).astype(np.float32)}
    recv = {k: (v + 3 * rng.randn(*v.shape)).astype(np.float32) for k, v in local.items()}
    want = jimpl.robust_pair_apply({k: jnp.asarray(v) for k, v in local.items()},
                                   {k: jnp.asarray(v) for k, v in recv.items()}, 0.5, gap=gap)
    got = timpl.robust_pair_apply({k: torch.from_numpy(v) for k, v in local.items()},
                                  {k: torch.from_numpy(v) for k, v in recv.items()}, 0.5, gap=gap)
    rows = timpl.robust_rows_apply({k: torch.from_numpy(v)[None] for k, v in local.items()},
                                   {k: torch.from_numpy(v)[None] for k, v in recv.items()},
                                   0.5, gap=gap)
    for k in local:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
        assert torch.equal(rows[k][0], got[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [[2], [5, 0, 3], [], list(range(6))])
def test_b1_row_list_plain_version_matches_reference_full_b1_and_row_select(dtype, rows):
    """B1's plain version on a row list against the reference's oracle over
    every row followed by a row select: the listed rows within 1e-6 (f32) /
    2e-2 (bf16), every other row of theta and v bit-equal to the input;
    rows unsorted, empty, and all rows (equal to the whole-plane call)."""
    rng = np.random.RandomState(len(rows))
    Wr, n = 6, 1000
    t, p, v, g = (rng.randn(Wr, n).astype(np.float32) for _ in range(4))
    coef = rng.rand(Wr).astype(np.float32)
    tt = {k: torch.from_numpy(a).to(getattr(torch, dtype)) for k, a in
          dict(t=t, p=p, g=g).items()}
    vt = torch.from_numpy(v)
    jd = getattr(jnp, dtype)
    jt, jv = jref.fused_flat_elastic_nag_update(
        jnp.asarray(tt["t"].float().numpy()).astype(jd), jnp.asarray(tt["p"].float().numpy())
        .astype(jd), jnp.asarray(v), jnp.asarray(tt["g"].float().numpy()).astype(jd),
        jnp.asarray(coef), 1e-2, 0.9)
    r = torch.tensor(rows, dtype=torch.int32)
    got_t, got_v = tref.fused_flat_elastic_nag_update(tt["t"], tt["p"], vt, tt["g"],
                                                      torch.from_numpy(coef), 1e-2, 0.9, rows=r)
    sel = np.zeros(Wr, bool)
    sel[rows] = True
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got_t.float().numpy()[sel],
                               np.asarray(jt.astype(jnp.float32))[sel], rtol=tol, atol=tol)
    np.testing.assert_allclose(got_v.numpy()[sel], np.asarray(jv)[sel], rtol=1e-6, atol=1e-6)
    assert torch.equal(got_t[~torch.from_numpy(sel)], tt["t"][~torch.from_numpy(sel)])
    assert torch.equal(got_v[~torch.from_numpy(sel)], vt[~torch.from_numpy(sel)])
    if len(rows) == Wr:
        whole = tref.fused_flat_elastic_nag_update(tt["t"], tt["p"], vt, tt["g"],
                                                   torch.from_numpy(coef), 1e-2, 0.9)
        assert torch.equal(whole[0], got_t) and torch.equal(whole[1], got_v)
    # the in-place dispatch on the CPU: the same values, in place
    it, iv = tt["t"].clone(), vt.clone()
    out = tops.fused_flat_elastic_nag_update(it, tt["p"], iv, tt["g"], torch.from_numpy(coef),
                                             1e-2, 0.9, rows=r)
    assert out[0] is it and torch.equal(it, got_t) and torch.equal(iv, got_v)


# ---------------------------------------------------------------------------
# checkpoints: resume, and files crossing between the packages
# ---------------------------------------------------------------------------

HET = dict(time_model="lognormal", sigma=0.5, seed=11)


def test_async_checkpoint_resume_continues_clocks_exactly(tmp_path):
    """7 windows, save, load into a fresh trainer (template from another
    seed), 6 more: host clocks, theta, the staleness sums and the
    generator equal the uninterrupted 13-window run's, bit for bit."""
    x, y = (torch.from_numpy(a) for a in cases.problem(W))

    def make():
        return cases.trainers("async", W, UNIFORM, hetero=HET)[1]
    full = make()
    s_full = full.init_state(0, params=cases.tparams())
    for _ in range(13):
        s_full, _ = full.step(s_full, (x, y))
    part = make()
    s = part.init_state(0, params=cases.tparams())
    for _ in range(7):
        s, _ = part.step(s, (x, y))
    path = str(tmp_path / "ck.npz")
    part.save_checkpoint(path, s, meta={"step": 7})
    meta = json.load(open(path + ".meta.json"))
    assert meta["hetero"] == dataclasses.asdict(tcfg.HeteroConfig(**HET))
    resumed = make()
    s2, _ = resumed.load_checkpoint(path, resumed.init_state(1, params=cases.tparams()))
    assert np.array_equal(resumed.sim.clocks, part.sim.clocks)
    assert np.array_equal(resumed.sim.steps_done, part.sim.steps_done)
    for _ in range(6):
        s2, _ = resumed.step(s2, (x, y))
    assert np.array_equal(resumed.sim.clocks, full.sim.clocks)
    for k in s_full.theta:
        assert torch.equal(s_full.theta[k], s2.theta[k])
    for f in ("clocks", "worker_steps", "stale_time", "stale_events", "comm_bytes"):
        assert torch.equal(getattr(s_full.proto, f), getattr(s2.proto, f)), f
    assert torch.equal(s_full.key.get_state(), s2.key.get_state())
    # another fleet refuses, field by field
    other = cases.trainers("async", W, UNIFORM, hetero=dict(HET, sigma=0.7))[1]
    with pytest.raises(ValueError, match="sigma"):
        other.load_checkpoint(path, other.init_state(0, params=cases.tparams()))
    with pytest.raises(ValueError, match="WITHOUT a fault plane"):
        faulty = cases.trainers("async", W, UNIFORM, hetero=HET,
                                faults=dict(delay_model="constant", delay=1.0))[1]
        faulty.load_checkpoint(path, faulty.init_state(0, params=cases.tparams()))


@pytest.mark.parametrize("fleet,faults", [(None, dict(delay_model="constant", delay=0.5,
                                                      timeout=2.0)),
                                          (dict(partition=3, flow_control="token_account",
                                                token_capacity=3.0), None)])
def test_async_checkpoints_cross_between_the_packages(tmp_path, fleet, faults):
    """A reference async (message mode, or fleet) checkpoint after 9 windows
    loads in the port: theta, velocity, every virtual-time, fault and fleet
    field and the host clocks equal. The port's own file loads in the
    reference likewise."""
    x, y = cases.problem(W)
    jtr, ttr = cases.trainers("async", W, UNIFORM, hetero=HET, faults=faults, fleet=fleet)
    jst, tst = cases.init_states(jtr, ttr)
    for _ in range(9):
        jst, _ = jtr.step(jst, (jnp.asarray(x), jnp.asarray(y)))
        tst, _ = ttr.step(tst, tuple(map(torch.from_numpy, (x, y))))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jtr.save_checkpoint(jpath, jst, meta={"step": 9})
    ttr.save_checkpoint(tpath, tst, meta={"step": 9})
    jwant, twant = cases.snap(jst), tst
    jclk, tclk = jtr._backend.sim.clocks.copy(), ttr.sim.clocks.copy()

    jtr2, ttr2 = cases.trainers("async", W, UNIFORM, hetero=HET, faults=faults, fleet=fleet)
    jtmp, ttmp = cases.init_states(jtr2, ttr2)
    got_t, meta = ttr2.load_checkpoint(jpath, ttmp)
    assert np.array_equal(ttr2.sim.clocks, jclk)
    cases.compare(got_t, jwant, dict(rtol=0, atol=0), "reference file in the port")
    got_j, _ = jtr2.load_checkpoint(tpath, jtmp)
    assert np.array_equal(jtr2._backend.sim.clocks, tclk)
    for b in twant.theta:
        assert np.array_equal(np.asarray(got_j.theta[b]), twant.theta[b].numpy())
        assert np.array_equal(np.asarray(got_j.opt.mu[b]), twant.opt.mu[b].numpy())
    for f in cases.FIELDS:
        if getattr(twant.proto, f) is not None:
            assert np.array_equal(np.asarray(getattr(got_j.proto, f)),
                                  getattr(twant.proto, f).numpy()), f
