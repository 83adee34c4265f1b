"""The port's fault plane (slice 3) against the reference on the CPU: the
fault hashes and Bernoulli draws, the checksummed wire (checksum, append,
verify, corruption and the round trip, on f32 and bf16 buckets and packed
q8 wires), the fault-model registry and the Byzantine models, and the
engine's anchors (a zero-rate plane is bit-exact; a step where nobody fires
equals the reference's skipped branch; a protocol that cannot honour a
discard is refused).

Inputs are made with numpy from a seed and handed to both packages."""
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
from repro.common.config import FaultConfig as JFault  # noqa: E402
from repro.common.config import OptimizerConfig as JOpt  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.faults import models as jfm  # noqa: E402
from repro.faults import wire as jwire  # noqa: E402
from repro.hetero import models as jhet  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import comm as tcomm  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.api import get_protocol as tget_protocol  # noqa: E402
from repro_torch.api import register_protocol as tregister_protocol  # noqa: E402
from repro_torch.api.registry import _REGISTRY as T_PROTOCOLS  # noqa: E402
from repro_torch.common.config import FaultConfig as TFault  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.faults import models as tfm  # noqa: E402
from repro_torch.faults import wire as twire  # noqa: E402
from repro_torch.hetero import models as thet  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

IN, HID, DEPTH, NCLS, B = 784, 64, 2, 10, 16
SEEDS = (0, 1, 7, 12345, 0x7FFFFFFF, 0xFFFFFFFF)
STEPS_K = np.array([0, 1, 2, 49, 1000, 2**31 - 1, 2**32 - 1], np.int64)
SALTS = (0, 101, 202, 303, 404, 405, 406)


def _bits_equal(a, b):
    """Exact equality, bit for bit (so -0.0 differs from +0.0)."""
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    return np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# hashes and draws (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_fault_hash_and_hetero_hash_are_bit_equal(seed):
    workers = np.arange(256)
    steps = STEPS_K.reshape(-1, 1)
    for salt in SALTS:
        want = jhet.hetero_hash(seed, workers, steps, salt)
        assert _bits_equal(thet.hetero_hash(seed, workers, steps, salt), want)
        jtr = np.asarray(jfm.fault_hash_jnp(seed, jnp.arange(256),
                                            jnp.asarray(steps, jnp.uint32), salt))
        got = tfm.fault_hash(seed, torch.arange(256), torch.from_numpy(steps), salt)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), jtr.astype(np.int64))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # a 0-d device step counter, as the engine passes it
    step = torch.tensor(49, dtype=torch.int32)
    np.testing.assert_array_equal(
        tfm.fault_hash(seed, torch.arange(8), step, 101).numpy(),
        jhet.hetero_hash(seed, np.arange(8), 49, 101).astype(np.int64))


def test_hetero_uniform_and_normal_are_bit_equal():
    w, k = np.arange(64), np.arange(50).reshape(-1, 1)
    for seed in (0, 3, 0xFFFFFFFF):
        for fn in ("hetero_uniform", "hetero_normal"):
            assert _bits_equal(getattr(thet, fn)(seed, w, k, 303), getattr(jhet, fn)(seed, w, k, 303))


@pytest.mark.parametrize("rate", [0.0, 1e-9, 0.2, 0.5, 0.999999, 1.0])
def test_bernoulli_draws_are_bit_equal(rate):
    w = np.arange(64)
    for seed in (0, 11, 0xFFFFFFFF):
        for step in (0, 3, 10_000):
            for salt in (101, 202):
                want = jfm.bernoulli_np(seed, w, step, rate, salt)
                assert np.array_equal(tfm.bernoulli_np(seed, w, step, rate, salt), want)
                traced = np.asarray(jfm.bernoulli_jnp(seed, jnp.arange(64), jnp.int32(step),
                                                      rate, salt))
                got = tfm.bernoulli(seed, torch.arange(64), torch.tensor(step, dtype=torch.int32),
                                    rate, salt)
                assert got.dtype == torch.bool
                assert np.array_equal(got.numpy(), traced) and np.array_equal(traced, want)
    assert tfm._bernoulli_threshold(rate) == jfm._bernoulli_threshold(rate)
    if rate in (0.0, 1.0):
        m = tfm.bernoulli(5, torch.arange(64), torch.tensor(2), rate, 101)
        assert bool(m.all()) == (rate == 1.0) and bool(m.any()) == (rate == 1.0)


# ---------------------------------------------------------------------------
# the checksummed wire (exact)
# ---------------------------------------------------------------------------

def _wire_cases():
    """{name: (uint8 wire [W, L] numpy, torch)} on random f32 and bf16
    buckets (bitcast) and on a packed q8 wire."""
    rng = np.random.RandomState(0)
    f32 = rng.randn(4, 300).astype(np.float32)
    bf = torch.from_numpy(rng.randn(4, 301).astype(np.float32)).to(torch.bfloat16)
    tc = tcomm.resolve_codec(TProto(codec="q8", codec_block=128))
    seeds = tcomm.codec_seeds(2, torch.arange(4))
    q8 = tc.pack(tc.encode(torch.from_numpy(f32), seeds)[0])
    out = {"f32": tcomm.codecs._u8(torch.from_numpy(f32)), "bf16": tcomm.codecs._u8(bf),
           "q8": q8, "bytes": torch.from_numpy(rng.randint(0, 256, (3, 64)).astype(np.uint8))}
    return {k: (v.numpy(), v) for k, v in out.items()}


@pytest.mark.parametrize("name", ["f32", "bf16", "q8", "bytes"])
def test_wire_checksum_append_verify_and_corrupt_are_bit_equal(name):
    wnp, wt = _wire_cases()[name]
    jw = jnp.asarray(wnp)
    W = wnp.shape[0]
    got_c = twire.checksum_u8(wt)
    assert got_c.dtype == torch.int64
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(jwire.checksum_u8(jw)).astype(np.int64))
    text, jext = twire.append_checksum(wt), jwire.append_checksum(jw)
    assert text.dtype == torch.uint8 and _bits_equal(text.numpy(), jext)
    for step in (0, 5, 17):
        for mask in ([True] * W, [False] * W, [w % 2 == 1 for w in range(W)]):
            tm, jm = torch.tensor(mask), jnp.asarray(mask)
            tc = twire.corrupt_wire(text, tm, 9, torch.tensor(step, dtype=torch.int32), 404)
            jc = jwire.corrupt_wire(jext, jm, 9, jnp.int32(step), 404)
            assert _bits_equal(tc.numpy(), jc)
            tp, tok = twire.verify_strip(tc)
            jp, jok = jwire.verify_strip(jc)
            assert _bits_equal(tp.numpy(), jp)
            assert np.array_equal(tok.numpy(), np.asarray(jok))
            # every injected flip is detected, every clean row verifies
            assert np.array_equal(tok.numpy(), ~np.asarray(mask))
            if not any(mask):
                assert torch.equal(tc, text)
    assert torch.equal(text, twire.append_checksum(wt))       # the input was not written


def test_every_single_byte_flip_of_a_short_wire_is_detected():
    rng = np.random.RandomState(1)
    wire = torch.from_numpy(rng.randint(0, 256, (3, 64)).astype(np.uint8))
    ext = twire.append_checksum(wire)
    payload, ok = twire.verify_strip(ext)
    assert bool(ok.all()) and torch.equal(payload, wire)
    for pos in range(ext.shape[1]):              # payload and checksum tail
        for x in (0x01, 0x40, 0xFF):
            bad = ext.clone()
            bad[1, pos] ^= x
            _, ok = twire.verify_strip(bad)
            assert ok.tolist() == [True, False, True], (pos, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_corrupt_roundtrip_bufs_is_bit_equal(dtype):
    rng = np.random.RandomState(3)
    base = rng.randn(4, 257).astype(np.float32)
    t = {"float32": torch.from_numpy(base),
         "bfloat16": torch.from_numpy(base).to(torch.bfloat16),
         "int32": torch.from_numpy(rng.randint(-1000, 1000, (4, 257)).astype(np.int32))}[dtype]
    tb = {"a": t, "b": t[:, :100].contiguous()}
    jb = {k: jnp.asarray(v.float().numpy()).astype(getattr(jnp, dtype))
          if dtype == "bfloat16" else jnp.asarray(v.numpy()) for k, v in tb.items()}
    for mask in ([False] * 4, [True, False, True, False], [True] * 4):
        for step in (0, 3):
            tout, tok = twire.corrupt_roundtrip_bufs(tb, torch.tensor(mask), 7,
                                                     torch.tensor(step, dtype=torch.int32))
            jout, jok = jwire.corrupt_roundtrip_bufs(jb, jnp.asarray(mask), 7, jnp.int32(step))
            assert np.array_equal(tok.numpy(), np.asarray(jok))
            assert tok.tolist() == [not m for m in mask]
            for k in tb:
                assert tout[k].dtype == tb[k].dtype
                assert _bits_equal(tout[k].view(torch.int16 if dtype == "bfloat16"
                                                else tout[k].dtype).numpy(),
                                   np.asarray(jout[k]).view(np.int16 if dtype == "bfloat16"
                                                            else np.asarray(jout[k]).dtype))
                if not any(mask):
                    assert torch.equal(tout[k], tb[k])


# ---------------------------------------------------------------------------
# fault models
# ---------------------------------------------------------------------------

def test_fault_registry_behaves_like_the_reference():
    builtins = {"none", "drop", "corrupt", "byzantine_scale", "byzantine_noise"}
    assert builtins <= set(tfaults.available_fault_models())
    assert builtins <= set(jfm.available_fault_models())
    for name in builtins:
        t, j = tfaults.get_fault_model(name), jfm.get_fault_model(name)
        assert t.name == j.name == name
        for flag in ("injects_drop", "injects_corrupt", "injects_byzantine"):
            assert getattr(t, flag) == getattr(j, flag), (name, flag)
    with pytest.raises(ValueError, match="unknown fault model.*registered"):
        tfaults.get_fault_model("gremlins")
    with pytest.raises(ValueError, match="unknown fault model"):
        tfaults.resolve_fault_model(TFault(fault_model="gremlins"))

    @tfaults.register_fault_model("_test_null")
    class Null(tfaults.FaultModel):
        pass
    try:
        assert "_test_null" in tfaults.available_fault_models()
        fm = tfaults.resolve_fault_model(TFault(fault_model="_test_null"))
        assert not (fm.injects_drop or fm.injects_corrupt or fm.injects_byzantine)
        assert tfaults.register_fault_model("_test_null")(Null) is Null   # same class: fine
        with pytest.raises(ValueError, match="already registered"):
            @tfaults.register_fault_model("_test_null")
            class Clash(tfaults.FaultModel):
                pass
    finally:
        tfaults.unregister_fault_model("_test_null")
    assert "_test_null" not in tfaults.available_fault_models()
    tfaults.unregister_fault_model("_test_null")                        # absent: no error


def test_composite_drop_byzantine_model_composes_both_planes():
    """The composite the reference's benchmarks/faults.py registers."""
    @tfaults.register_fault_model("_test_drop_byzantine")
    class DropByzantine(tfm.ByzantineNoise, tfm.DropFault):
        pass
    try:
        cfg = TFault(fault_model="_test_drop_byzantine", fault_rate=0.2, fault_frac=1 / 8, seed=4)
        fm = tfaults.resolve_fault_model(cfg)
        assert fm.injects_drop and fm.injects_byzantine and not fm.injects_corrupt
        assert fm.num_byzantine(8) == 1 and fm.byzantine_mask(8).tolist() == [True] + [False] * 7
        jcfg = JFault(fault_model="drop", fault_rate=0.2, seed=4)
        w, k = np.arange(8), np.arange(40).reshape(-1, 1)
        assert np.array_equal(fm.drop_mask(w, k), jfm.resolve_fault_model(jcfg).drop_mask(w, k))
        for step in range(40):
            got = fm.drop_mask_dev(torch.tensor(step, dtype=torch.int32), 8)
            assert np.array_equal(got.numpy(), jfm.bernoulli_np(4, w, step, 0.2, 101))
    finally:
        tfaults.unregister_fault_model("_test_drop_byzantine")


def test_byzantine_scale_garbling_is_bit_equal():
    rng = np.random.RandomState(5)
    bufs = {"float32": rng.randn(8, 300).astype(np.float32)}
    for frac in (0.0, 1 / 8, 0.25, 1.0):
        cfg = dict(fault_model="byzantine_scale", fault_frac=frac, scale=100.0)
        t = tfaults.resolve_fault_model(TFault(**cfg)).garble_bufs(
            {k: torch.from_numpy(v) for k, v in bufs.items()}, torch.tensor(3), 8)
        j = jfm.resolve_fault_model(JFault(**cfg)).garble_bufs(
            {k: jnp.asarray(v) for k, v in bufs.items()}, jnp.int32(3), 8)
        assert _bits_equal(t["float32"].numpy(), j["float32"])


def test_byzantine_noise_rows_are_pure_in_seed_and_step():
    """The first round(frac * W) rows are replaced by noise, the others are
    bit-identical; the noise is pure in (seed, step, worker): the same
    twice, different for another step or seed. Its values differ from the
    reference's threefry draw (deliberate: threefry cannot be reproduced)."""
    rng = np.random.RandomState(6)
    theta = {"float32": torch.from_numpy(rng.randn(8, 5000).astype(np.float32)),
             "bfloat16": torch.from_numpy(rng.randn(8, 700).astype(np.float32)).to(torch.bfloat16)}
    cfg = TFault(fault_model="byzantine_noise", fault_frac=0.25, noise_std=10.0, seed=1)
    fm = tfaults.resolve_fault_model(cfg)
    k = fm.num_byzantine(8)
    assert k == 2
    step = torch.tensor(3, dtype=torch.int32)
    a = fm.garble_bufs(theta, step, 8)
    b = fm.garble_bufs(theta, torch.tensor(3, dtype=torch.int32), 8)
    c = fm.garble_bufs(theta, torch.tensor(4, dtype=torch.int32), 8)
    d = tfaults.resolve_fault_model(TFault(fault_model="byzantine_noise", fault_frac=0.25,
                                           noise_std=10.0, seed=2)).garble_bufs(theta, step, 8)
    for name, buf in theta.items():
        assert a[name].dtype == buf.dtype and a[name].shape == buf.shape
        assert torch.equal(a[name][k:], buf[k:])
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name][:k], c[name][:k])
        assert not torch.equal(a[name][:k], d[name][:k])
        assert not torch.equal(a[name][:k], buf[:k])
        assert not torch.equal(a[name][0], a[name][1])
    z = a["float32"][:k] / 10.0
    assert bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05
    # worker w's row does not depend on W (pure in (seed, step, worker, bucket))
    a16 = fm.garble_bufs({"float32": torch.zeros(16, 5000),
                          "bfloat16": torch.zeros(16, 700, dtype=torch.bfloat16)},
                         step, 16)["float32"]
    assert torch.equal(a16[:2], a["float32"][:2]) and fm.num_byzantine(16) == 4
    j = jfm.resolve_fault_model(JFault(fault_model="byzantine_noise", fault_frac=0.25,
                                       noise_std=10.0, seed=1)).garble_bufs(
        {"float32": jnp.asarray(theta["float32"].numpy())}, jnp.int32(3), 8)
    assert not np.array_equal(np.asarray(j["float32"])[:k], a["float32"][:k].numpy())
    assert np.array_equal(np.asarray(j["float32"])[k:], a["float32"][k:].numpy())
    # nobody Byzantine: the dict itself comes back
    none = tfaults.resolve_fault_model(TFault(fault_model="byzantine_noise", fault_frac=0.0))
    assert none.garble_bufs(theta, step, 8) is theta


# ---------------------------------------------------------------------------
# engine anchors
# ---------------------------------------------------------------------------

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


def _tparams():
    return tsimple.params_from_jax(jax.tree.map(np.asarray, _jparams()), "cpu")


OPT = dict(name="nag", learning_rate=1e-3, momentum=0.99)


def _ttrainer(method="elastic_gossip", codec="none", faults=None, W=4, p=0.5):
    return TTrainer(protocol=TProto(method=method, comm_probability=p, moving_rate=0.5,
                                    topology="uniform", codec=codec),
                    optimizer=TOpt(**OPT), loss_fn=_tloss, num_workers=W, device="cpu",
                    faults=faults)


@pytest.mark.parametrize("method,codec", [("elastic_gossip", "none"), ("elastic_gossip", "q8"),
                                          ("clipped_gossip", "none")])
def test_zero_rate_fault_plane_reproduces_the_fault_free_run_bit_for_bit(method, codec):
    """FaultConfig(drop, rate 0) runs the whole fault wiring (discard mask,
    counters) yet gives the fault-free run's theta, velocity and counters
    bit for bit, on the port's own draws from the same seed."""
    train, _ = _data()
    shards = jpart.partition_iid(train, 4, 0)
    out = {}
    for tag, faults in (("free", None), ("zero", TFault(fault_model="drop", fault_rate=0.0))):
        tr = _ttrainer(method, codec, faults)
        st = tr.init_state(3, params=_tparams())
        for i in range(8):
            x, y = jpart.batches_for_step(shards, i, B)
            st, _ = tr.step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        out[tag] = st
    a, b = out["free"], out["zero"]
    assert torch.equal(a.theta["float32"], b.theta["float32"])
    assert torch.equal(a.opt.mu["float32"], b.opt.mu["float32"])
    for name in ("comm_rounds", "comm_units", "comm_bytes"):
        assert torch.equal(getattr(a.proto, name), getattr(b.proto, name)), name
    assert int(a.proto.comm_units) > 0
    assert a.proto.wire_dropped is None and int(b.proto.wire_dropped) == 0
    assert int(b.proto.wire_corrupt) == 0


def _ref_state_snapshot(st):
    out = {"theta": np.array(st.theta["float32"]), "mu": np.array(st.opt.mu["float32"])}
    out.update({k: np.array(getattr(st.proto, k))
                for k in ("comm_rounds", "comm_units", "comm_bytes", "wire_dropped",
                          "wire_corrupt")})
    return out


@pytest.mark.parametrize("codec", ["none", "q8"])
def test_a_step_where_nobody_fires_equals_the_reference_skip_branch(codec):
    """Under corrupt 0.5, the reference skips its checked codec pass with
    lax.cond when no gate fires; the port runs it anyway (no host sync).
    From the reference's pre-step state, on the first such step with a
    corrupted row: theta and velocity within rtol 1e-4 / atol 1e-5 (the
    model matmuls sum in another order), the counters bit-equal, and the
    port's theta bit-equal to its own fault-free step from the same state
    (the identity mix ignores the corrupted transmit)."""
    W = 4
    faults = dict(fault_model="corrupt", fault_rate=0.5, seed=2)
    jtr = JTrainer(engine="sim", protocol=JProto(method="elastic_gossip", comm_probability=0.125,
                                                 moving_rate=0.5, topology="uniform", codec=codec),
                   optimizer=JOpt(**OPT), loss_fn=_jloss, num_workers=W, faults=JFault(**faults))
    jst = jtr.init_state(0, params=_jparams())
    shards = jpart.partition_iid(_data()[0], W, 0)
    found = False
    for i in range(40):
        x, y = jpart.batches_for_step(shards, i, B)
        gate, peers = jtr._backend.sim._draw_fn(jnp.array(jst.key), jnp.array(jst.step))
        corrupt = jfm.bernoulli_np(2, np.arange(W), i, 0.5, 202)
        pre = _ref_state_snapshot(jst)
        jst, _ = jtr.step(jst, (jnp.asarray(x), jnp.asarray(y)))
        if np.asarray(gate).any() or not corrupt.any():
            continue
        post = _ref_state_snapshot(jst)
        theta = {}
        for tag, fc in (("faults", TFault(**faults)), ("free", None)):
            tr = _ttrainer("elastic_gossip", codec, fc, W=W, p=0.125)
            ts = tr.init_state(0, params=_tparams())
            ts.theta["float32"].copy_(torch.from_numpy(pre["theta"]))
            ts.opt.mu["float32"].copy_(torch.from_numpy(pre["mu"]))
            keys = ("comm_rounds", "comm_units", "comm_bytes") + (
                ("wire_dropped", "wire_corrupt") if fc is not None else ())
            ts = ts.replace(step=torch.tensor(i, dtype=torch.int32),
                            proto=ts.proto._replace(**{k: torch.from_numpy(pre[k]) for k in keys}))
            ts, m = tr.step(ts, (torch.from_numpy(x), torch.from_numpy(y)),
                            draws=(torch.from_numpy(np.array(gate)), torch.from_numpy(np.array(peers))))
            assert int(m["comm_active"]) == 0
            theta[tag] = ts.theta["float32"]
            if fc is not None:
                np.testing.assert_allclose(ts.theta["float32"].numpy(), post["theta"],
                                           rtol=1e-4, atol=1e-5)
                np.testing.assert_allclose(ts.opt.mu["float32"].numpy(), post["mu"],
                                           rtol=1e-4, atol=1e-5)
                for k in keys:
                    assert _bits_equal(getattr(ts.proto, k).numpy(), post[k]), k
        assert torch.equal(theta["faults"], theta["free"])
        found = True
        break
    assert found, "no step without a firing gate but with a corrupted row in 40 steps"


def test_a_drop_model_on_a_protocol_without_wire_faults_is_refused():
    """As the reference's tests/test_faults.py: a pairwise protocol whose
    comm_update cannot honour the discard is refused at build time; a
    Byzantine-only model (nothing discarded) still builds."""
    Base = tget_protocol("elastic_gossip")

    @tregister_protocol("_test_nofaultkw")
    class NoFaultKw(Base):
        def comm_update(self, gen, active, theta_stack, state, step=None,
                        transmit=None, wire_bytes=None, peers=None):
            return super().comm_update(gen, active, theta_stack, state, step=step,
                                       transmit=transmit, wire_bytes=wire_bytes, peers=peers)
    try:
        for model in ("drop", "corrupt"):
            with pytest.raises(ValueError, match="wire_faults"):
                _ttrainer("_test_nofaultkw", faults=TFault(fault_model=model, fault_rate=0.5))
        tr = _ttrainer("_test_nofaultkw", faults=TFault(fault_model="byzantine_scale",
                                                        fault_frac=0.25))
        st = tr.init_state(0, params=_tparams())
        x, y = jpart.batches_for_step(jpart.partition_iid(_data()[0], 4, 0), 0, B)
        st, m = tr.step(st, (torch.from_numpy(x), torch.from_numpy(y)))
        assert bool(torch.isfinite(m["loss"]))
    finally:
        T_PROTOCOLS.pop("_test_nofaultkw", None)


def test_topk_decode_drops_out_of_range_indices_like_the_reference():
    """Only a corrupted wire carries an index outside its block. The plain
    top-k decode drops such a pair (as kernel B7 and the reference's
    one-hot sum do) instead of raising, so a top-k wire under corrupt
    faults decodes, fails its checksum and is discarded."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref
    rng = np.random.RandomState(8)
    W, nb, k, block = 2, 3, 4, 128
    vals = rng.randn(W, nb * k).astype(np.float32)
    idx = rng.randint(0, block, (W, nb * k)).astype(np.int32)
    idx[0, 1], idx[0, 5], idx[1, 2], idx[1, 11] = -5, block, 2**31 - 1, -(2**31)
    got = tref.topk_decode(torch.from_numpy(vals), torch.from_numpy(idx), nb * block - 7,
                           k=k, block=block)
    want = jref.topk_decode(jnp.asarray(vals), jnp.asarray(idx), nb * block - 7, k=k,
                            block=block)
    assert _bits_equal(got.numpy(), want)
    tr = _ttrainer(codec="topk", faults=TFault(fault_model="corrupt", fault_rate=0.5, seed=2))
    st = tr.init_state(0, params=_tparams())
    shards = jpart.partition_iid(_data()[0], 4, 0)
    for i in range(4):
        x, y = jpart.batches_for_step(shards, i, B)
        st, m = tr.step(st, (torch.from_numpy(x), torch.from_numpy(y)))
    assert int(st.proto.wire_corrupt) > 0 and bool(torch.isfinite(st.theta["float32"]).all())
