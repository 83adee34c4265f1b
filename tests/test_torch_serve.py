"""The port's serving stack (``repro_torch.serve``, ``serving.engine``)
against the contract of the reference's tests/test_serve.py at the same
sizes: kv_start isolation (bit for bit), hot-swap prefix determinism,
continuous-batching invariants, the bus's double buffer and its refusal of
bad snapshots. Beside those: TrafficGen's requests and the batcher's
completed token streams equal the reference's on the same weights, and the
snapshot manifest equals the reference's. Everything runs on the CPU
(B9's plain version)."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.common.config import MeshConfig  # noqa: E402
from repro.common.flat import FlatSpec as JFlatSpec  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import LiveServer as JServer  # noqa: E402
from repro.serve import SnapshotBus as JBus  # noqa: E402
from repro.serve import TrafficGen as JTraffic  # noqa: E402
from repro.serve.snapshot import Snapshot as JSnapshot  # noqa: E402
from repro.serving.engine import make_serve_program as jmake  # noqa: E402
from repro_torch.api import GossipTrainer, make_serve_program  # noqa: E402
from repro_torch.common.config import OptimizerConfig, ProtocolConfig  # noqa: E402
from repro_torch.common.flat import FlatSpec  # noqa: E402
from repro_torch.common.pytree import tree_leaves, tree_map  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models import simple  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.serve import (ContinuousBatcher, LiveServer, Snapshot,  # noqa: E402
                               SnapshotBus, TrafficGen, snapshot_valid)
from repro_torch.serve.snapshot import flat_spec_manifest  # noqa: E402

W = 4


@functools.lru_cache(maxsize=None)
def _jparams(seed):
    cfg = jget_reduced("tinyllama_1_1b")
    return jtr.init_lm(jax.random.PRNGKey(seed), cfg)[0]


def _params(seed):
    return tr.params_from_jax(jax.tree.map(np.asarray, _jparams(seed)), "cpu")


@pytest.fixture(scope="module")
def serve_setup():
    cfg = get_reduced("tinyllama_1_1b")
    prog = make_serve_program(cfg, batch=4, max_len=48, param_dtype=torch.float32,
                              cache_dtype=torch.float32, device="cpu")
    return cfg, prog, _params(0)


def _server(prog, params):
    bus = SnapshotBus()
    bus.publish_params(params, train_step=0)
    server = LiveServer(prog, bus)
    assert server.maybe_swap()
    return bus, server


def _copy(cache):
    """The port writes caches in place (the reference donates them), so a
    cache used twice is copied first."""
    return {"segments": tree_map(torch.clone, cache["segments"]), "pos": cache["pos"].clone()}


# ---------------------------------------------------------------------------
# kv_start isolation
# ---------------------------------------------------------------------------

def test_kv_start_masks_previous_occupant_exactly(serve_setup):
    """Rows below kv_start[b] are EXACTLY invisible: decode over a cache whose
    early rows hold garbage == decode over the same cache with those rows
    zeroed, bit for bit; kv_start = 0 reproduces decode_fn bit for bit."""
    cfg, prog, params = serve_setup
    cache = prog.init_cache()
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 1, 6)))
    for i in range(6):
        _, cache = prog.decode_fn(params, cache, toks[:, :, i])
    kv_start = torch.tensor([6, 6, 0, 3], dtype=torch.int32)

    def zero_below(c, s):
        out = _copy(c)
        for seg in out["segments"].values():
            for a in seg.values():
                pos = torch.arange(a.shape[2])
                keep = pos[None, :] >= s[:, None]
                a.mul_(keep.reshape((1,) + keep.shape + (1,) * (a.ndim - 3)).to(a.dtype))
        return out

    tok = torch.from_numpy(np.random.RandomState(2).randint(0, cfg.vocab_size, (4, 1)))
    lg_garbage, _ = prog.decode_slots_fn(params, _copy(cache), tok, None, kv_start)
    lg_zeroed, _ = prog.decode_slots_fn(params, zero_below(cache, kv_start), tok, None, kv_start)
    assert torch.equal(lg_garbage, lg_zeroed)
    lg_plain, _ = prog.decode_fn(params, _copy(cache), tok)
    lg_zero_start, _ = prog.decode_slots_fn(params, _copy(cache), tok, None,
                                            torch.zeros(4, dtype=torch.int32))
    assert torch.equal(lg_plain, lg_zero_start)


# ---------------------------------------------------------------------------
# hot swap, continuous batching
# ---------------------------------------------------------------------------

def test_hot_swap_prefix_determinism(serve_setup):
    """Tokens generated BEFORE the swap boundary are bit-identical whether or
    not a swap happens at that boundary; tokens after may differ."""
    cfg, prog, params = serve_setup
    params2 = _params(9)
    reqs = TrafficGen(3, rate=1.0, num_requests=3, vocab=cfg.vocab_size,
                      prompt_len=(2, 4), max_new=(8, 8)).requests()
    swap_at = 8

    def run(with_swap):
        bus, server = _server(prog, params)
        bat = ContinuousBatcher(server, [dataclasses.replace(r) for r in reqs])
        trace = []
        for t in range(20):
            if with_swap and t == swap_at:
                bus.publish_params(params2, train_step=50)
                assert server.maybe_swap() and server.train_step == 50
            bat.step(t)
            trace.append(np.array(bat.next_tok))
        bat.check_invariants()
        return trace

    a, b = run(False), run(True)
    for t in range(swap_at):
        np.testing.assert_array_equal(a[t], b[t])
    assert any(not np.array_equal(a[t], b[t]) for t in range(swap_at, 20))


def test_continuous_batching_invariants(serve_setup):
    """Every admitted request completes with its exact budget, slots never
    leak, and the slot assignment recycles (more requests than slots)."""
    cfg, prog, params = serve_setup
    _, server = _server(prog, params)
    reqs = TrafficGen(11, rate=0.8, num_requests=10, vocab=cfg.vocab_size,
                      prompt_len=(1, 3), max_new=(2, 5)).requests()
    bat = ContinuousBatcher(server, reqs)
    bat.run(46)
    bat.check_invariants()
    lat = bat.latency_summary()
    assert lat["admitted"] > prog.batch
    assert lat["completed"] == lat["admitted"]
    by_rid = {r.rid: r for r in reqs}
    for rec in bat.completed:
        assert len(rec["tokens"]) == by_rid[rec["rid"]].max_new


def test_batcher_streams_equal_reference(serve_setup):
    """The same weights and requests through the reference's batcher and the
    port's: every completed record (arrival, admit, first token, done,
    greedy tokens) is equal, and so is the latency summary."""
    cfg, prog, params = serve_setup
    jcfg = jget_reduced("tinyllama_1_1b")
    jprog = jmake(make_host_mesh(1), MeshConfig(data=1, model=1, pods=1, workers_per_pod=1),
                  jcfg, batch=4, max_len=48, param_dtype=jnp.float32, cache_dtype=jnp.float32)
    kw = dict(rate=0.8, num_requests=10, vocab=cfg.vocab_size, prompt_len=(1, 3),
              max_new=(2, 5))
    jbus = JBus()
    jbus.publish_params(_jparams(0))
    jserver = JServer(jprog, jbus)
    jserver.maybe_swap()
    jbat = JBatcher(jserver, JTraffic(11, **kw).requests())
    jbat.run(46)
    _, server = _server(prog, params)
    bat = ContinuousBatcher(server, TrafficGen(11, **kw).requests())
    bat.run(46)
    assert bat.completed == jbat.completed
    assert bat.latency_summary() == jbat.latency_summary()
    assert bat.pos == jbat.pos and int(bat.cache["pos"]) == int(jbat.cache["pos"])


@pytest.mark.parametrize("seed,kw", [
    (5, dict(rate=0.5, num_requests=12, vocab=256, prompt_len=(1, 6), max_new=(2, 9))),
    (1, dict(rate=0.5, num_requests=32, vocab=32000, prompt_len=(8, 64), max_new=(16, 64))),
    (5, dict(rate=0.5, num_requests=4, vocab=256, mode="staggered")),
])
def test_traffic_equals_reference_bit_for_bit(seed, kw):
    mine, ref = TrafficGen(seed, **kw).requests(), JTraffic(seed, **kw).requests()
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert (a.rid, a.arrival, a.max_new, a.prompt_len) == \
            (b.rid, b.arrival, b.max_new, b.prompt_len)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_traffic_restart_exact():
    mk = lambda seed: TrafficGen(seed, rate=0.5, num_requests=12, vocab=256,  # noqa: E731
                                 prompt_len=(1, 6), max_new=(2, 9)).requests()
    a, b, c = mk(5), mk(5), mk(6)
    for ra, rb in zip(a, b):
        assert (ra.rid, ra.arrival, ra.max_new) == (rb.rid, rb.arrival, rb.max_new)
        np.testing.assert_array_equal(ra.prompt, rb.prompt)
    assert any(ra.arrival != rc.arrival or not np.array_equal(ra.prompt, rc.prompt)
               for ra, rc in zip(a, c))
    assert [r.arrival for r in a] == sorted(r.arrival for r in a)
    stag = TrafficGen(5, rate=0.5, num_requests=4, vocab=256, mode="staggered").requests()
    assert [r.arrival for r in stag] == [2, 4, 6, 8]


# ---------------------------------------------------------------------------
# snapshot bus
# ---------------------------------------------------------------------------

def _trainer():
    return GossipTrainer(
        engine="sim",
        protocol=ProtocolConfig(method="elastic_gossip", comm_probability=0.5,
                                moving_rate=0.5, topology="uniform"),
        optimizer=OptimizerConfig(name="nag", learning_rate=0.05, momentum=0.9),
        loss_fn=lambda p, x, y: simple.xent_loss(simple.mlp_logits(p, x), y),
        num_workers=W, device="cpu",
        init_fn=lambda gen: simple.init_mlp(gen, in_dim=10, hidden=16, depth=2,
                                            num_classes=3)[0])


def _perturbed_state():
    state = _trainer().init_state(0)
    g = torch.Generator().manual_seed(0)
    theta = {k: v + torch.randn(v.shape, generator=g) for k, v in state.theta.items()}
    return state.replace(theta=theta)


def test_bus_double_buffer_holds_old_snapshot():
    """A reader's snapshot stays intact across later publishes, and a
    publish is the consensus (mean over the W rows) of the state."""
    state = _perturbed_state()
    bus = SnapshotBus()
    assert bus.latest() is None and bus.seq == 0
    s1 = bus.publish_state(state, train_step=1)
    held = bus.latest()
    assert held is s1 and held.seq == 1 and held.train_step == 1
    for k, v in state.theta.items():
        torch.testing.assert_close(held.bufs[k], v.mean(0), rtol=1e-6, atol=1e-6)
    ref = {k: v.clone() for k, v in held.bufs.items()}
    s2 = bus.publish_state(state.replace(theta={k: v + 1 for k, v in state.theta.items()}),
                           train_step=2)
    s3 = bus.publish_state(state, train_step=3)
    assert bus.latest() is s3 and bus.seq == 3 and s2.seq == 2
    for k in ref:
        assert torch.equal(held.bufs[k], ref[k])
    # the trainer updates its plane in place; the snapshot does not follow
    for v in state.theta.values():
        v.add_(1.0)
    assert all(torch.equal(s3.bufs[k], bus.latest().bufs[k]) for k in ref)
    assert not any(torch.equal(s3.bufs[k], state.theta[k].mean(0)) for k in ref)


def test_bus_and_server_refuse_bad_snapshots(serve_setup, tmp_path):
    """A non-finite or mis-shaped publish is refused and never flips the
    head; a bad snapshot that reaches the server pins the last good one.
    The last good snapshot round-trips through its checkpoint-v2 file bit
    for bit (the reference's ``Snapshot.load`` reads the same file), and a
    spec with another layout refuses it."""
    cfg, prog, params = serve_setup
    bus, server = _server(prog, params)
    spec0 = FlatSpec.build(params, leading=0)
    bufs = spec0.flatten(params)
    bad = {k: v.clone() for k, v in bufs.items()}
    next(iter(bad.values()))[3] = float("nan")
    with pytest.warns(RuntimeWarning, match="non-finite"):
        assert bus._publish(bad, spec0, 7) is None
    with pytest.warns(RuntimeWarning, match="shape"):
        assert bus._publish({k: v[:-1] for k, v in bufs.items()}, spec0, 8) is None
    assert bus.rejected == 2 and bus.seq == 1 and not server.maybe_swap()
    assert snapshot_valid(bufs, spec0) == (True, "")
    assert not snapshot_valid({"int32": bufs["float32"]}, spec0)[0]
    # a snapshot that skipped the bus's check
    bus._slots[1], bus._head = Snapshot(seq=2, train_step=9, bufs=bad, manifest={},
                                        spec=spec0), 1
    served = server.params
    with pytest.warns(RuntimeWarning, match="refused"):
        assert not server.maybe_swap()
    assert server.rejected_swaps == 1 and server.seq == 1 and server.params is served
    assert not server.maybe_swap() and server.rejected_swaps == 1   # memo: not re-checked
    good, path = bus._slots[0], str(tmp_path / "snap.npz")
    assert good.seq == 1
    good.save(path)
    back = Snapshot.load(path, FlatSpec.build(tree_map(lambda v: v[None], params), leading=1),
                         device="cpu")
    assert (back.seq, back.train_step, back.manifest) == (good.seq, good.train_step,
                                                           good.manifest)
    assert set(back.bufs) == set(good.bufs)
    assert all(torch.equal(back.bufs[k], good.bufs[k]) for k in good.bufs)
    jback = JSnapshot.load(path, JFlatSpec.build(_jparams(0), leading=0))
    assert jback.seq == good.seq
    for k, v in jback.bufs.items():
        assert np.array_equal(np.asarray(v), good.bufs[k].numpy())
    other = FlatSpec.build(dict(params, extra=torch.zeros(3)), leading=0)
    with pytest.raises(ValueError, match="manifest does not match"):
        Snapshot.load(path, other, device="cpu")


def test_swap_casts_views_of_the_snapshot_without_copying_f32(serve_setup):
    """f32 serving of an f32 snapshot serves views of its buffers; bf16
    serving casts into fresh tensors. Decode routing: no kv_start -> the
    plain program, kv_start -> the slots program."""
    cfg, prog, params = serve_setup
    bus, server = _server(prog, params)
    buf = next(iter(bus.latest().bufs.values()))
    leaves = tree_leaves(server.params)
    assert all(x.untyped_storage().data_ptr() == buf.untyped_storage().data_ptr()
               for x in leaves)
    bprog = make_serve_program(cfg, batch=4, max_len=48, device="cpu")
    bserver = LiveServer(bprog, bus)
    assert bserver.maybe_swap()
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(bserver.params))
    stats = bserver.swap_stats()
    assert stats["swaps"] == 1 and stats["swap_pause_max_s"] >= 0.0
    tok = torch.zeros((4, 1), dtype=torch.int32)
    a, _ = server.decode(prog.init_cache(), tok)
    b, _ = server.decode(prog.init_cache(), tok, kv_start=torch.zeros(4, dtype=torch.int32))
    assert torch.equal(a, b)
    assert prog.token_shapes(3) == ((4, 3), torch.int32)


def test_snapshot_manifest_equals_reference():
    jspec = JFlatSpec.build(_jparams(0), leading=0)
    spec = FlatSpec.build(_params(0), leading=0)
    assert flat_spec_manifest(spec) == jio.flat_spec_manifest(jspec)
