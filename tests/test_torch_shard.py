"""The port's sharded flat plane (slice 4b) against the reference on the CPU,
case by case after tests/test_shard.py: the layout's cover, manifest and
per-shard wires equal to the reference's (hypothesis over bucket sizes and
S); shard rows as views; the inert ShardConfig() on the sim and async
engines; sharded q8 / top-k wires bit-equal to the reference's on the same
shard rows and seeds; sharded sim steps and async windows from the
reference's state with its draws; per-device comm_bytes; partition o
shard; refusals; sharded checkpoints across the packages both ways and the
cross-layout refusals; the memory figures. The dist engine's sharded plane
is held in tests/test_torch_dist.py, inside its gloo groups.

Inputs are made with numpy from a seed; the models are small MLPs."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: fixed-seed sweep
    from _hypothesis_stub import given, settings, strategies as st

import _torch_async_cases as cases  # noqa: E402
from repro import fleet as jfleet  # noqa: E402
from repro import shard as jshard  # noqa: E402
from repro.comm import active_codec as jactive_codec  # noqa: E402
from repro.common import config as jcfg  # noqa: E402
from repro.common.flat import FlatSpec as JSpec  # noqa: E402
from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from repro_torch import shard as tshard  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.common import config as tcfg  # noqa: E402
from repro_torch.common.flat import FlatSpec as TSpec  # noqa: E402

W = 8
TOL = dict(rtol=1e-4, atol=1e-5)
UNIFORM = dict(method="elastic_gossip", topology="uniform", comm_probability=0.6,
               moving_rate=0.5)
LOGNORMAL = dict(time_model="lognormal", sigma=0.6, seed=1)


def _specs(sizes):
    """(reference, port) FlatSpecs over one f32 bucket of the given leaf
    sizes (0 -> a scalar () leaf)."""
    shapes = {f"l{i}": (1,) + ((n,) if n else ()) for i, n in enumerate(sizes)}
    js = JSpec.build({k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()},
                     leading=1)
    ts = TSpec.build({k: torch.zeros(s) for k, s in shapes.items()}, leading=1)
    return js, ts


def _codecs(name):
    if name is None:
        return None, None
    return (jactive_codec(jcfg.ProtocolConfig(codec=name)),
            tcomm.active_codec(tcfg.ProtocolConfig(codec=name)))


# ---------------------------------------------------------------------------
# the layout against the reference's
# ---------------------------------------------------------------------------

@settings(max_examples=40)
@given(n1=st.integers(min_value=0, max_value=700),
       n2=st.integers(min_value=0, max_value=5000),
       n_shards=st.integers(min_value=1, max_value=9),
       codec=st.sampled_from([None, "q8", "topk"]))
def test_layout_manifest_and_wires_equal_the_reference(n1, n2, n_shards, codec):
    """For any leaf sizes, S and codec: totals, shard sizes, bounds and the
    manifest equal the reference's; the shards tile the padded total and
    the real elements sum to the parameter count; per-shard wires and
    ``wire_per_device`` equal the reference's (raw shards sum exactly to
    the raw wire)."""
    js, ts = _specs([n1, n2, 0])
    jc, tc = _codecs(codec)
    jl = jshard.build_layout(js, jcfg.ShardConfig(n_shards=n_shards), jc)
    tl = tshard.build_layout(ts, tcfg.ShardConfig(n_shards=n_shards), tc)
    assert (tl.n_shards, tl.axes, tl.quantum) == (jl.n_shards, jl.axes, jl.quantum)
    assert tl.totals == jl.totals and tl.shard_sizes == jl.shard_sizes
    assert tl.bounds == jl.bounds
    for b, total in tl.totals.items():
        assert total == n_shards * tl.shard_sizes[b] and total >= ts.totals[b]
        assert total - ts.totals[b] < n_shards * tl.quantum
    man = tshard.shard_manifest(tl, ts)
    assert man == jshard.shard_manifest(jl, js)
    assert sum(sum(v) for v in man["real_elements"].values()) == (n1 or 1) + (n2 or 1) + 1
    per = tshard.shard_wire_bytes(tl, ts, tc)
    assert per == jshard.shard_wire_bytes(jl, js, jc)
    assert tshard.wire_per_device(tl, ts, tc) == jshard.wire_per_device(jl, js, jc)
    if tc is None:
        assert sum(per) == sum(s.size * s.dtype.itemsize for s in ts.slots)
    else:
        assert len(set(per)) == 1
    for shard in (tcfg.ShardConfig(n_shards=n_shards), tcfg.ShardConfig(n_shards, ("fsdp",))):
        jshard_cfg = jcfg.ShardConfig(shard.n_shards, shard.axes)
        assert tshard.shard_descriptor(shard, tc) == jshard.shard_descriptor(jshard_cfg, jc)


def test_pad_slice_and_shard_rows_are_views():
    """pad_bufs pads the tail only; shard_rows / unshard_rows are views of
    the padded buffers (no copy) in the reference's row order; slice_bufs
    gives the original buffers back."""
    js, ts = _specs([703, 19, 57])
    jl = jshard.build_layout(js, jcfg.ShardConfig(n_shards=4))
    tl = tshard.build_layout(ts, tcfg.ShardConfig(n_shards=4))
    bufs = {b: np.arange(3 * n, dtype=np.float32).reshape(3, n) for b, n in ts.totals.items()}
    padded = tshard.pad_bufs({b: torch.from_numpy(v) for b, v in bufs.items()}, tl)
    rows = tl.shard_rows(padded)
    want = jl.shard_rows(jshard.pad_bufs({b: jnp.asarray(v) for b, v in bufs.items()}, jl))
    for b in rows:
        assert rows[b].data_ptr() == padded[b].data_ptr()
        assert np.array_equal(rows[b].numpy(), np.asarray(want[b]))
        back = tl.unshard_rows(rows)[b]
        assert back.data_ptr() == padded[b].data_ptr()
        assert np.array_equal(tshard.slice_bufs({b: back}, ts.totals)[b].numpy(), bufs[b])
    with pytest.raises(RuntimeError):        # a column slice cannot be viewed
        tl.shard_rows({b: torch.zeros(3, tl.totals[b] + 128)[:, :tl.totals[b]]
                       for b in tl.totals})


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("codec", ["q8", "topk"])
def test_shard_row_wires_are_bit_equal_to_reference(codec, S):
    """The codec on the [W * S, shard_size] rows of a padded plane with
    seeds codec_seeds(round, arange(W * S)), as the sim engine encodes
    them: packed wire bytes, the reconstruction and the top-k residual are
    the reference's bit for bit."""
    jc, tc = _codecs(codec)
    rng = np.random.RandomState(S)
    js, ts = _specs([1000, 37, 600])
    tl = tshard.build_layout(ts, tcfg.ShardConfig(n_shards=S), tc)
    jl = jshard.build_layout(js, jcfg.ShardConfig(n_shards=S), jc)
    theta = {b: rng.randn(W, n).astype(np.float32) for b, n in ts.totals.items()}
    res = {b: (0.1 * rng.randn(W, n)).astype(np.float32) for b, n in tl.totals.items()}
    trows = tl.shard_rows(tshard.pad_bufs({b: torch.from_numpy(v) for b, v in theta.items()},
                                          tl))
    jrows = jl.shard_rows(jshard.pad_bufs({b: jnp.asarray(v) for b, v in theta.items()}, jl))
    tres = tl.shard_rows({b: torch.from_numpy(v) for b, v in res.items()})
    jres = jl.shard_rows({b: jnp.asarray(v) for b, v in res.items()})
    from repro import comm as jcomm
    for rnd in (0, 7):
        tseeds = tcomm.codec_seeds(rnd, torch.arange(W * S))
        jseeds = jcomm.codec_seeds(rnd, jnp.arange(W * S))
        assert np.array_equal(tseeds.numpy().astype(np.uint32), np.asarray(jseeds))
        for b in trows:
            r_t = tres[b] if tc.stateful else None
            r_j = jres[b] if jc.stateful else None
            twire, tr2 = tc.encode(trows[b], tseeds, r_t)
            jwire, jr2 = jc.encode(jrows[b], jseeds, r_j)
            assert np.array_equal(tc.pack(twire).numpy(), np.asarray(jc.pack(jwire)))
            n = tl.shard_sizes[b]
            assert np.array_equal(tc.decode(twire, n).numpy().view(np.uint32),
                                  np.asarray(jc.decode(jwire, n)).view(np.uint32))
            if tc.stateful:
                assert np.array_equal(tr2.numpy().view(np.uint32),
                                      np.asarray(jr2).view(np.uint32))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _free_run(trainer, steps=6):
    x, y = (torch.from_numpy(a) for a in cases.problem(W))
    state = trainer.init_state(0, params=cases.tparams())
    m = {}
    for _ in range(steps):
        state, m = trainer.step(state, (x, y))
    return state, m


@pytest.mark.parametrize("engine", ["sim", "async"])
@pytest.mark.parametrize("codec", [None, "q8"])
def test_default_shard_config_is_bit_exact(engine, codec):
    """ShardConfig() reproduces shard=None bit for bit: theta, velocity,
    counters and the generator; no layout is built."""
    het = LOGNORMAL if engine == "async" else None
    _, a = cases.trainers(engine, W, UNIFORM, codec=codec, hetero=het)
    _, b = cases.trainers(engine, W, UNIFORM, codec=codec, hetero=het, shard={})
    s0, m0 = _free_run(a)
    s1, m1 = _free_run(b)
    assert b.sim.shard_layout is None and not tcfg.ShardConfig().enabled()
    for k in s0.theta:
        assert torch.equal(s0.theta[k], s1.theta[k])
        assert torch.equal(s0.opt.mu[k], s1.opt.mu[k])
    for f in ("comm_rounds", "comm_units", "comm_bytes"):
        assert torch.equal(getattr(s0.proto, f), getattr(s1.proto, f)), f
    assert torch.equal(s0.key.get_state(), s1.key.get_state())
    assert float(m0["comm_bytes"]) == float(m1["comm_bytes"])


SHARD_CASES = {
    "raw S=4": ("sim", None, 4, None),
    "q8 S=2": ("sim", "q8", 2, None),
    "q8 S=4": ("sim", "q8", 4, None),
    "topk S=2": ("sim", "topk", 2, None),
    "topk S=4": ("sim", "topk", 4, None),
    "async q8 S=4": ("async", "q8", 4, LOGNORMAL),
    "async topk S=2": ("async", "topk", 2, LOGNORMAL),
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_sharded_steps_match_reference(case):
    """12 sharded steps (async: windows), each from the reference's pre-step
    state with its draws: theta, velocity and the top-k residual within
    rtol 1e-4 / atol 1e-5, the counters and comm_bytes exact; the facade's
    per-device wire equals the reference's."""
    engine, codec, S, het = SHARD_CASES[case]
    jtr, ttr = cases.trainers(engine, W, UNIFORM, codec=codec, hetero=het,
                              shard=dict(n_shards=S))
    sizes, tst = cases.lockstep(jtr, ttr, W, 12, TOL)
    layout = ttr.sim.shard_layout
    assert layout is not None and layout.n_shards == S
    assert tst.theta["float32"].shape == (W, layout.totals["float32"])
    assert ttr._backend.wire_bytes() == jtr._backend.wire_bytes()
    assert int(tst.proto.comm_units) > 0
    if engine == "async":
        assert min(sizes) < W


def _tanh_trainer(engine, codec, shard=None):
    """The reference test's model (37 -> 19 tanh -> 3: a 1,024-column plane,
    so 4 lane shards or 2 codec-block shards need no padding)."""
    from repro_torch.api import GossipTrainer

    def loss(p, x, y):
        return torch.mean((torch.tanh(x @ p["w1"] + p["b"]) @ p["w2"] - y) ** 2)
    het = tcfg.HeteroConfig(time_model="constant") if engine == "async" else None
    return GossipTrainer(engine=engine, protocol=tcfg.ProtocolConfig(**UNIFORM),
                         optimizer=tcfg.OptimizerConfig(**cases.OPT), loss_fn=loss,
                         num_workers=4, codec=codec, hetero=het, shard=shard, device="cpu")


def _tanh_run(trainer, steps=6):
    rng = np.random.RandomState(0)
    params = {"w1": torch.from_numpy(0.3 * rng.randn(37, 19).astype(np.float32)),
              "b": torch.zeros(19),
              "w2": torch.from_numpy(0.3 * rng.randn(19, 3).astype(np.float32))}
    state = trainer.init_state(0, params=params)
    m = {}
    for _ in range(steps):
        x = torch.from_numpy(rng.randn(4, 8, 37).astype(np.float32))
        state, m = trainer.step(state, (x, torch.zeros(4, 8, 3)))
    return state, m


@pytest.mark.parametrize("engine,codec", [("sim", None), ("sim", "q8"), ("sim", "topk"),
                                          ("async", "q8")])
def test_comm_bytes_scale_per_device(engine, codec):
    """With S shards the facade's wire and the cumulative comm_bytes are
    exactly the un-sharded account over S (S chosen so the padding is a
    no-op: 4 raw, 2 with a codec); raw, the sharded run IS the plain run."""
    S = 4 if codec is None else 2
    t0, tS = _tanh_trainer(engine, codec), _tanh_trainer(engine, codec,
                                                         tcfg.ShardConfig(n_shards=S))
    s0, m0 = _tanh_run(t0)
    sS, mS = _tanh_run(tS)
    assert t0._backend.wire_bytes() % S == 0
    assert tS._backend.wire_bytes() == t0._backend.wire_bytes() // S
    assert float(mS["comm_bytes"]) > 0
    assert float(m0["comm_bytes"]) == S * float(mS["comm_bytes"])
    if codec is None:
        w = s0.theta["float32"].shape[-1]
        assert torch.equal(s0.theta["float32"], sS.theta["float32"][..., :w])


def test_shard_refusals():
    """Non-pairwise protocols, the fault plane and the host plane refuse a
    sharded plane with the reference's messages; so does n_shards < 1."""
    with pytest.raises(ValueError, match="pairwise"):
        cases.trainers("sim", W, dict(method="allreduce"), shard=dict(n_shards=2))
    with pytest.raises(ValueError, match="fault"):
        cases.trainers("sim", W, UNIFORM, shard=dict(n_shards=2),
                       faults=dict(fault_model="drop", fault_rate=0.1))
    with pytest.raises(ValueError, match="shard"):
        cases.trainers("async", W, UNIFORM, shard=dict(n_shards=2), fleet=dict(plane="host"))
    _, ts = _specs([10])
    with pytest.raises(ValueError, match="n_shards"):
        tshard.build_layout(ts, tcfg.ShardConfig(n_shards=0))


@pytest.mark.parametrize("codec", [None, "q8"])
def test_partition_composes_with_shard(codec):
    """partition=2 with S=2: 12 steps from the reference's state with its
    draws (chunk_units and comm_bytes exact, chunks on the whole padded
    plane, each device shipping 1/S of its chunk), and the free run's bytes
    exactly 1/S of the un-sharded partitioned run's."""
    fleet = dict(partition=2, seed=5)
    jtr, ttr = cases.trainers("sim", W, UNIFORM, codec=codec, fleet=fleet,
                              shard=dict(n_shards=2))
    _, tst = cases.lockstep(jtr, ttr, W, 12, TOL)
    assert int(tst.proto.chunk_units.sum()) > 0
    assert ttr.sim._fleet_plan(tst.spec).wire_bytes == \
        jtr._backend.sim._fleet_plan(jtr.init_state(0, params=cases.jparams()).spec).wire_bytes
    _, t0 = cases.trainers("sim", W, UNIFORM, codec=codec, fleet=fleet)
    _, tS = cases.trainers("sim", W, UNIFORM, codec=codec, fleet=fleet, shard=dict(n_shards=2))
    (_, m0), (_, mS) = _free_run(t0, 8), _free_run(tS, 8)
    if codec is not None:     # raw: the padding columns change the chunk bounds
        assert float(m0["comm_bytes"]) == 2 * float(mS["comm_bytes"]) > 0


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _lockstep_states(codec, S, steps=3):
    jtr, ttr = cases.trainers("sim", W, UNIFORM, codec=codec, shard=dict(n_shards=S))
    _, tst = cases.lockstep(jtr, ttr, W, steps, TOL)
    return jtr, ttr, tst


@pytest.mark.parametrize("codec", [None, "topk"])
def test_sharded_checkpoints_cross_both_ways(codec, tmp_path):
    """A sharded reference file restores into a sharded port trainer with
    every entry bit-equal, and the port's file into the reference; the
    metadata carries the reference's shard descriptor."""
    jtr, ttr, _ = _lockstep_states(codec, 2)
    jst = jtr.init_state(0, params=cases.jparams())
    x, y = cases.problem(W)
    for _ in range(3):
        jst, _ = jtr.step(jst, (jnp.asarray(x), jnp.asarray(y)))
    jpath = str(tmp_path / "ref.npz")
    jtr.save_checkpoint(jpath, jst)
    got, meta = ttr.load_checkpoint(jpath, ttr.init_state(1, params=cases.tparams()))
    assert meta["shard"] == {"n_shards": 2, "axes": ["fsdp", "model"],
                             "quantum": 128 if codec is None else 512}
    from repro.checkpoint import io as jio
    want = {k: np.asarray(v) for k, v in jio._flatten(jst.state_dict()).items()}
    have = tio.entries(got.state_dict())
    for k in sorted(set(want) - {"key"}):
        assert have[k].dtype == want[k].dtype and have[k].tobytes() == want[k].tobytes(), k
    tpath = str(tmp_path / "port.npz")
    ttr.save_checkpoint(tpath, got)
    back, jmeta = jtr.load_checkpoint(tpath, jtr.init_state(1, params=cases.jparams()))
    assert jmeta["shard"] == meta["shard"]
    again = {k: np.asarray(v) for k, v in jio._flatten(back.state_dict()).items()}
    for k in sorted(set(want) - {"key"}):
        assert again[k].tobytes() == want[k].tobytes(), k


def test_cross_layout_restores_refuse_before_any_array_is_read(tmp_path):
    """n_shards 2 -> 4, sharded -> un-sharded and un-sharded -> sharded
    refuse with the reference's messages, even with the payload gone (the
    metadata is read first); a matching layout round-trips bit for bit."""
    _, t2 = cases.trainers("sim", W, UNIFORM, shard=dict(n_shards=2))
    s2, _ = _free_run(t2, 2)
    path = str(tmp_path / "ck.npz")
    t2.save_checkpoint(path, s2)
    _, t4 = cases.trainers("sim", W, UNIFORM, shard=dict(n_shards=4))
    _, t0 = cases.trainers("sim", W, UNIFORM)
    like4, like0 = t4.init_state(0, params=cases.tparams()), t0.init_state(0, params=cases.tparams())
    s0, _ = _free_run(t0, 2)
    path0 = str(tmp_path / "ck0.npz")
    t0.save_checkpoint(path0, s0)
    _, t2b = cases.trainers("sim", W, UNIFORM, shard=dict(n_shards=2))
    restored, _ = t2b.load_checkpoint(path, t2b.init_state(0, params=cases.tparams()))
    for k in s2.theta:
        assert torch.equal(restored.theta[k], s2.theta[k])
    like2 = t2b.init_state(0, params=cases.tparams())
    for p in (path, path0):
        with open(p, "wb") as fh:
            fh.write(b"not an npz")
    with pytest.raises(ValueError, match="n_shards: saved=2"):
        t4.load_checkpoint(path, like4)
    with pytest.raises(ValueError, match="sharded plane"):
        t0.load_checkpoint(path, like0)
    with pytest.raises(ValueError, match="WITHOUT a sharded plane"):
        t2b.load_checkpoint(path0, like2)


# ---------------------------------------------------------------------------
# memory validation
# ---------------------------------------------------------------------------

def test_memory_figures_match_reference_and_hold_the_card_to_the_whole_plane():
    """plane_bytes with n_shards and the per-device admission equal the
    reference's; the refusals carry its hints. On a CUDA device the port's
    one card holds every shard, so the card is held to the whole plane
    (S does not divide the need) and the message gives both figures."""
    gib = 1024 ** 3
    for S in (1, 4, 64):
        for plane in ("host", "device"):
            assert tfleet.plane_bytes(8, 4 * gib, plane, S) == jfleet.plane_bytes(8, 4 * gib, plane, S)
    for mod in (jfleet, tfleet):
        with pytest.raises(ValueError, match="--plane host"):
            mod.validate_fleet_memory(8, 4 * gib, "device", available=8 * gib)
        assert mod.validate_fleet_memory(8, 4 * gib, "device", available=8 * gib,
                                         n_shards=64) == 8 * 4 * gib * 6 // 64
        with pytest.raises(ValueError, match="raise --shard") as e:
            mod.validate_fleet_memory(64, 16 * gib, "device", available=8 * gib, n_shards=2)
        if mod is tfleet:
            assert str(e.value) == jmsg
        else:
            jmsg = str(e.value)
    # the card: all 64 shards on one device, so the whole plane is held
    with pytest.raises(ValueError, match="all 64 shards on this card") as e:
        tfleet.validate_fleet_memory(8, 4 * gib, "device", available=8 * gib, n_shards=64,
                                     device="cuda")
    assert "~192.0 GiB" in str(e.value) and "~3.0 GiB per shard" in str(e.value)
    need = tfleet.validate_fleet_memory(8, 4 * gib, "device", available=400 * gib, n_shards=4,
                                        device="cuda")
    assert need == tfleet.plane_bytes(8, 4 * gib, "device") == 4 * tfleet.plane_bytes(
        8, 4 * gib, "device", 4)


def test_full_width_per_device_wires_are_the_documented_ones():
    """The §4.1 MLP at full width (784 -> 3x1024 -> 10, 2,913,408 columns):
    at S = 4 the padded totals and the per-device wires are 2,913,792 /
    2,913,290 B raw, 2,914,304 / 734,268 B q8 and 2,914,304 / 295,984 B
    top-k, the reference's too."""
    dims = [784, 1024, 1024, 1024, 10]
    shapes = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        shapes[f"w{i}"], shapes[f"b{i}"] = (1, a, b), (1, b)
    js = JSpec.build({k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()},
                     leading=1)
    ts = TSpec.build({k: torch.empty(s, device="meta") for k, s in shapes.items()}, leading=1)
    assert ts.totals == js.totals == {"float32": 2913408}
    want = {None: (2913792, 2913290), "q8": (2914304, 734268), "topk": (2914304, 295984)}
    for codec, (total, wire) in want.items():
        jc, tc = _codecs(codec)
        tl = tshard.build_layout(ts, tcfg.ShardConfig(n_shards=4), tc)
        jl = jshard.build_layout(js, jcfg.ShardConfig(n_shards=4), jc)
        assert tl.totals["float32"] == jl.totals["float32"] == total
        assert tshard.wire_per_device(tl, ts, tc) == jshard.wire_per_device(jl, js, jc) == wire
