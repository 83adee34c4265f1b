"""The port's codec plane (slice 2) against the reference on the CPU: the
hash draws, the q8 and top-k plain versions against the reference's oracles
and its Pallas kernels in interpret mode, the packed wire bytes and the
wire-byte accounting, and 20-step sim trajectories with a codec on the wire
(the reference's draws and params injected). The CUDA kernels B4-B7
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py).

Inputs are made with numpy from a seed and handed to both packages."""
import functools

import pytest
from _torch_codec_cases import (ORDER_COL, corrupted_topk_wire, finite_lanes,
                                q8_nonfinite_rows)

torch = pytest.importorskip("torch")
# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread each keeps torch from oversubscribing them (the tensors are small)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import comm as jcomm  # noqa: E402
from repro.api import GossipTrainer as JTrainer  # noqa: E402
from repro.common import flat as jflat  # noqa: E402
from repro.common.config import OptimizerConfig as JOpt  # noqa: E402
from repro.common.config import ProtocolConfig as JProto  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import comm as tcomm  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.api.registry import resolve as tresolve  # noqa: E402
from repro_torch.common import flat as tflat  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.kernels import codec as tcodec_kernels  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

IN, HID, DEPTH, NCLS, B = 784, 64, 2, 10, 16
STEPS = 20


def _bits_equal(a, b):
    """Exact equality, bit for bit (so -0.0 differs from +0.0)."""
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    return np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _rows(W, n, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(W, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# hash draws
# ---------------------------------------------------------------------------

def test_stochastic_uniform_and_codec_seeds_are_bit_equal():
    rng = np.random.RandomState(0)
    idx = np.concatenate([np.arange(65536 - 4), [2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]])
    idx = idx.astype(np.uint32)
    seeds = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
                     + list(rng.randint(0, 2**32, 3, dtype=np.uint64)), np.uint32)
    for s in seeds:
        want = np.asarray(jref.stochastic_uniform(jnp.asarray(idx), jnp.uint32(s)))
        got = tref.stochastic_uniform(torch.from_numpy(idx), int(s)).numpy()
        assert _bits_equal(got, want), hex(int(s))
    workers = np.arange(64, dtype=np.int32)
    for r in (0, 1, 7, 1000, 2**31 - 1):
        want = np.asarray(jcomm.codec_seeds(jnp.int32(r), jnp.asarray(workers)))
        got = tcomm.codec_seeds(torch.tensor(r, dtype=torch.int32), torch.from_numpy(workers))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# q8 (B4/B5 plain versions)
# ---------------------------------------------------------------------------

Q8_CASES = [(W, n, block) for n in (1, 700, 1000, 3 * 35968 + 5)
            for block in (128, 512) for W in (1, 3)]


@pytest.mark.parametrize("W,n,block", Q8_CASES)
def test_q8_plain_version_is_bit_equal_to_reference(W, n, block):
    buf = _rows(W, n, seed=n + W)
    if n >= 2 * block:
        buf[:, block:2 * block] = 0.0                 # an all-zero block: scale 1
    seeds = np.array(jcomm.codec_seeds(3, jnp.arange(W)))
    tv, ts = tops.q8_encode(torch.from_numpy(buf), torch.from_numpy(seeds), block=block)
    td = tops.q8_decode(tv, ts, n, block=block)
    jb, js = jnp.asarray(buf), jnp.asarray(seeds)
    oracle_v, oracle_s = jref.q8_encode(jb, js, block=block)
    # the reference's Pallas kernel on the CPU, as its own tests run it
    kern_v, kern_s = jops.q8_encode(jb, js, block=block, use_kernel=True, interpret=True)
    for v, s in ((oracle_v, oracle_s), (kern_v, kern_s)):
        assert _bits_equal(tv.numpy(), v) and _bits_equal(ts.numpy(), s)
    assert _bits_equal(td.numpy(), jref.q8_decode(oracle_v, oracle_s, n, block=block))
    assert _bits_equal(td.numpy(), jops.q8_decode(kern_v, kern_s, n, block=block,
                                                  use_kernel=True, interpret=True))
    if n >= 2 * block:
        assert float(ts[0, 1]) == 1.0 and not tv[:, block:2 * block].any()
    # reconstruction within one quantization step of the input
    assert float((td - torch.from_numpy(buf)).abs().max()) <= float(ts.max()) + 1e-6


@pytest.mark.parametrize("block", [128, 512])
def test_q8_scales_on_nan_and_inf_blocks_are_bit_equal_to_reference(block):
    """jnp.max and torch.amax propagate NaN: a block holding a NaN gets scale
    1 (NaN > 0 is false), one holding an inf scale inf, an all -0.0 block
    scale 1. Scales bit-equal to the oracle and the Pallas kernel; int8
    values equal at every finite element (NaN -> int8 is defined by
    neither side)."""
    x = q8_nonfinite_rows(block)
    W, n = x.shape
    seeds = np.array(jcomm.codec_seeds(3, jnp.arange(W)))
    tv, ts = tops.q8_encode(torch.from_numpy(x), torch.from_numpy(seeds), block=block)
    jb, js = jnp.asarray(x), jnp.asarray(seeds)
    ok = finite_lanes(x, block)
    for v, s in (jref.q8_encode(jb, js, block=block),
                 jops.q8_encode(jb, js, block=block, use_kernel=True, interpret=True)):
        assert _bits_equal(ts.numpy(), s)
        np.testing.assert_array_equal(tv.numpy()[ok], np.asarray(v)[ok])
    assert ts[0, :5].tolist() == [1.0, float("inf"), float("inf"), ts[0, 3].item(), 1.0]
    assert 0 < ts[0, 3] < 1 and ts[1, 0] == 1.0 and ts[1, 3] == 1.0 and ts[1, -1] == 1.0


# ---------------------------------------------------------------------------
# top-k (B6/B7 plain versions)
# ---------------------------------------------------------------------------

def _topk_case(name):
    """(buf, residual, k, block) for a named case."""
    if name == "ties":
        # magnitudes tie across signs and positions: the lowest index wins
        buf = np.tile(np.array([1.0, -2.0, 2.0, -1.0, 2.0, 0.5, -2.0, 1.0], np.float32),
                      (2, 64))
        return buf, np.zeros_like(buf), 6, 256
    if name == "neg_zero":
        # a block with fewer non-zeros than k keeps -0.0 and +0.0 entries
        buf = np.zeros((2, 128), np.float32)
        buf[:, 3], buf[:, 9] = 5.0, -0.0
        res = np.zeros_like(buf)
        buf[1, 0] = res[1, 0] = -0.0                  # -0.0 + -0.0 stays -0.0
        res[:, 9] = -0.0
        return buf, res, 4, 128
    n, k, block = name
    return _rows(3, n, seed=4), _rows(3, n, seed=5, scale=0.1), k, block


TOPK_CASES = [(1000, 13, 256), (512, 1, 512), (300, 8, 128), "ties", "neg_zero"]


@pytest.mark.parametrize("case", TOPK_CASES, ids=str)
def test_topk_plain_version_is_bit_equal_to_reference(case):
    buf, res, k, block = _topk_case(case)
    n = buf.shape[1]
    tv, ti, tr = tops.topk_encode(torch.from_numpy(buf), torch.from_numpy(res),
                                  k=k, block=block)
    td = tops.topk_decode(tv, ti, n, k=k, block=block)
    jb, jr = jnp.asarray(buf), jnp.asarray(res)
    oracle = jref.topk_encode(jb, jr, k=k, block=block)
    kern = jops.topk_encode(jb, jr, k=k, block=block, use_kernel=True, interpret=True)
    for got, o, kn in zip((tv, ti, tr), oracle, kern):
        assert _bits_equal(got.numpy(), o)
        # the Pallas kernel reads a kept value out with a masked sum, which
        # turns a kept -0.0 into +0.0: against it, equal values
        np.testing.assert_array_equal(got.numpy(), kn)
    assert _bits_equal(ti.numpy(), kern[1]) and _bits_equal(tr.numpy(), kern[2])
    # decode sums from +0.0 in pair order, as the Pallas kernel: bit-equal to
    # it. The jnp oracle's one-hot sum leaves -0.0 where k = 1 and the kept
    # value is negative (0 * v, no +0.0 added), so against it: equal values.
    assert _bits_equal(td.numpy(), jops.topk_decode(*kern[:2], n, k=k, block=block,
                                                    use_kernel=True, interpret=True))
    np.testing.assert_array_equal(td.numpy(),
                                  jref.topk_decode(*oracle[:2], n, k=k, block=block))
    # error feedback: decode + residual' == buf + residual
    np.testing.assert_allclose(td.numpy() + tr.numpy(), buf + res, rtol=1e-6, atol=1e-6)
    if case == "ties":
        assert ti[0, :6].tolist() == [1, 2, 4, 6, 9, 10]
    if case == "neg_zero":
        # rows keep 5.0 first, then zeros by index; every zero decodes to +0.0
        assert ti[0].tolist() == [3, 0, 1, 2] and ti[1].tolist() == [3, 0, 1, 2]
        assert np.signbit(tv[1, 1].numpy()) and not np.signbit(td.numpy()).any()


@pytest.mark.parametrize("W,nb,k,block,cut", [(2, 3, 8, 128, 131), (3, 4, 26, 512, 0),
                                              (2, 3, 32, 128, 5), (2, 3, 40, 128, 5),
                                              (1, 2, 128, 128, 0)])
def test_topk_decode_on_a_corrupted_wire_is_bit_equal_to_reference(W, nb, k, block, cut):
    """Duplicate indices sum from +0.0 in pair order, as the Pallas kernel's
    fori_loop does ((1, 1e8, -1e8) gives 0, any other order 1); indices
    outside [0, block), -2**31 and 2**31 - 1 among them, are dropped; a lone
    -0.0 decodes to +0.0. The jnp oracle's one-hot sum runs in pair order on
    the CPU up to k = 32 only (XLA's reduction), so above that it is held
    at the columns no two pairs share (ROADMAP.md §C)."""
    vals, idx = corrupted_topk_wire(W, nb, k, block)
    n = nb * block - cut
    td = tops.topk_decode(torch.from_numpy(vals), torch.from_numpy(idx), n, k=k,
                          block=block).numpy()
    jv, ji = jnp.asarray(vals), jnp.asarray(idx)
    assert _bits_equal(td, jops.topk_decode(jv, ji, n, k=k, block=block, use_kernel=True,
                                            interpret=True))
    oracle = np.asarray(jref.topk_decode(jv, ji, n, k=k, block=block))
    if k <= 32:
        assert _bits_equal(td, oracle)
    else:
        i = idx.reshape(W, nb, k).astype(np.int64)
        hits = np.zeros((W, nb, block + 1), np.int64)
        np.add.at(hits, (np.arange(W)[:, None, None], np.arange(nb)[None, :, None],
                         np.where((i >= 0) & (i < block), i, block)), 1)
        single = (hits[..., :block] <= 1).reshape(W, nb * block)[:, :n]
        assert _bits_equal(td[single], oracle[single]) and (~single).any()
    assert td[0, ORDER_COL] == 0.0 and not np.signbit(td[td == 0]).any()
    if nb > 1 and n > block + 3:
        assert td[0, block + 3] == 0.0 and not np.signbit(td[0, block + 3])


def test_non_cpu_tensors_never_reach_the_codec_plain_versions(monkeypatch):
    """A tensor not on the CPU goes to the kernel wrappers, which launch or
    raise (here: not a CUDA tensor); the plain versions are never called."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    for name in ("q8_encode", "q8_decode", "topk_encode", "topk_decode"):
        monkeypatch.setattr(tref, name, boom)
    x = torch.empty((2, 256), device="meta")
    before = dict(tcodec_kernels.LAUNCHES)
    calls = [lambda: tops.q8_encode(x, torch.zeros(2, dtype=torch.int64), block=128),
             lambda: tops.q8_decode(x.to(torch.int8), torch.empty((2, 2), device="meta"),
                                    256, block=128),
             lambda: tops.topk_encode(x, x, k=4, block=128),
             lambda: tops.topk_decode(x, x.to(torch.int32), 256, k=128, block=128)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert tcodec_kernels.LAUNCHES == before


# ---------------------------------------------------------------------------
# registry, wire packing and accounting
# ---------------------------------------------------------------------------

def test_registry_copy_behaves_like_the_reference():
    assert set(tcomm.available_codecs()) == set(jcomm.available_codecs()) == {"none", "q8", "topk"}
    for name in tcomm.available_codecs():
        assert tcomm.get_codec(name).name == name
    with pytest.raises(ValueError, match="unknown codec"):
        tcomm.get_codec("carrier_pigeon")

    @tcomm.register_codec("_test_half")
    class Half(tcomm.Codec):
        def wire_bytes(self, n, itemsize):
            return n * itemsize // 2
    try:
        assert isinstance(tcomm.resolve_codec(TProto(codec="_test_half")), Half)
        with pytest.raises(ValueError, match="already registered"):
            @tcomm.register_codec("_test_half")
            class Clash(tcomm.Codec):
                pass
    finally:
        tcomm.unregister_codec("_test_half")
    assert "_test_half" not in tcomm.available_codecs()
    assert tcomm.active_codec(TProto()) is None
    assert tcomm.resolve_codec(TProto(codec="topk")).k == 26   # round(0.05 * 512)


def test_codec_on_a_non_pairwise_protocol_or_an_unknown_name_raises():
    for method in ("allreduce", "easgd", "none"):
        kw = dict(comm_period=2) if method == "easgd" else {}
        with pytest.raises(ValueError, match="not pairwise"):
            tresolve(TProto(method=method, codec="q8", **kw))
        with pytest.raises(ValueError, match="not pairwise"):
            TTrainer(protocol=TProto(method=method, **kw), codec="q8",
                     loss_fn=_tloss, num_workers=2, device="cpu")
    with pytest.raises(ValueError, match="unknown codec"):
        tresolve(TProto(comm_probability=0.5, codec="carrier_pigeon"))
    with pytest.raises(ValueError, match="unknown codec"):
        TTrainer(protocol=TProto(comm_probability=0.5), codec="carrier_pigeon",
                 loss_fn=_tloss, num_workers=2, device="cpu")


@pytest.mark.parametrize("name", ["q8", "topk", "none"])
def test_packed_wire_bytes_equal_the_reference(name):
    n = 1000
    jc = jcomm.resolve_codec(JProto(codec=name, codec_block=256))
    tc = tcomm.resolve_codec(TProto(codec=name, codec_block=256))
    buf, res = _rows(3, n, seed=11), _rows(3, n, seed=12, scale=0.1)
    seeds = np.array(jcomm.codec_seeds(5, jnp.arange(3)))
    jwire, _ = jc.encode(jnp.asarray(buf), jnp.asarray(seeds),
                         jnp.asarray(res) if jc.stateful else None)
    twire, _ = tc.encode(torch.from_numpy(buf), torch.from_numpy(seeds),
                         torch.from_numpy(res) if tc.stateful else None)
    jp, tp = np.asarray(jc.pack(jwire)), tc.pack(twire)
    assert tp.dtype == torch.uint8 and _bits_equal(tp.numpy(), jp)
    assert tp.shape[1] == tc.wire_bytes(n, 4) == jc.wire_bytes(n, 4)
    if name != "none":
        for a, b in zip(tc.unpack(tp, n), twire):
            assert torch.equal(a, b)
        assert torch.equal(tc.decode_wire(tp, n), tc.decode(twire, n))


@pytest.mark.parametrize("name", ["q8", "topk", "none"])
def test_wire_param_bytes_equal_the_reference(name):
    """On the small MLP, the full-width §4.1 MLP and a mixed f32/bf16 plane."""
    full = {"q8": 2936556, "topk": 1183728, "none": 11653632}
    jc, tc = (m.resolve_codec(P(codec=name)) for m, P in ((jcomm, JProto), (tcomm, TProto)))
    trees = {"small": dict(in_dim=IN, hidden=HID, depth=DEPTH, num_classes=NCLS),
             "full": dict(in_dim=784, hidden=1024, depth=3, num_classes=10)}
    for which, kw in trees.items():
        shapes = jax.eval_shape(lambda k: jsimple.init_mlp(k, **kw)[0], jax.random.PRNGKey(0))
        want = jcomm.wire_param_bytes(jc, jflat.FlatSpec.build(shapes))
        ttree = {k: torch.zeros(s.shape) for k, s in shapes.items()}
        got = tcomm.wire_param_bytes(tc, tflat.FlatSpec.build(ttree))
        assert got == want, (which, got, want)
        if which == "full":
            assert got == full[name]
    mixed = {"a": torch.zeros(300), "b": torch.zeros(7, 33, dtype=torch.bfloat16)}
    jmixed = {"a": jnp.zeros(300), "b": jnp.zeros((7, 33), jnp.bfloat16)}
    assert (tcomm.wire_param_bytes(tc, tflat.FlatSpec.build(mixed))
            == jcomm.wire_param_bytes(jc, jflat.FlatSpec.build(jmixed)))


# ---------------------------------------------------------------------------
# the sim engine with a codec on the wire
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


def _proto(P, method, codec, p=0.125):
    return P(method=method, comm_probability=p, moving_rate=0.5, topology="uniform",
             codec=codec)


OPT = dict(name="nag", learning_rate=1e-3, momentum=0.99)


def test_comm_cost_with_a_codec_matches_reference():
    for codec in ("q8", "topk"):
        jtr = JTrainer(engine="sim", protocol=_proto(JProto, "elastic_gossip", "none"),
                       codec=codec, loss_fn=_jloss, num_workers=8)
        ttr = TTrainer(engine="sim", protocol=_proto(TProto, "elastic_gossip", "none"),
                       codec=codec, loss_fn=_tloss, num_workers=8, device="cpu")
        assert ttr.protocol.codec == jtr.protocol.codec == codec
        assert ttr.codec.name == codec
        jtr.init_state(0, params=_jparams())
        ttr.init_state(0, params=tsimple.params_from_jax(
            jax.tree.map(np.asarray, _jparams()), "cpu"))
        for pb in (None, 1000):
            t, j = ttr.comm_cost(pb), jtr.comm_cost(pb)
            assert (t.bytes_per_event, t.events_per_step, t.bytes_per_step) == \
                (j.bytes_per_event, j.events_per_step, j.bytes_per_step)


def _ref_trainer(method, codec, W, p):
    jtr = JTrainer(engine="sim", protocol=_proto(JProto, method, codec, p),
                   optimizer=JOpt(**OPT), loss_fn=_jloss, num_workers=W)
    return jtr, jtr.init_state(0, params=_jparams())


def _ref_steps(method, codec, W, p):
    """Yield (batch, draws, pre-step state, post-step state) for STEPS
    reference steps; states as numpy copies (the step donates its input)."""
    train, _ = _data()
    jtr, jstate = _ref_trainer(method, codec, W, p)
    shards = jpart.partition_iid(train, W, 0)

    def snap(st):
        out = {"theta": np.array(st.theta["float32"]), "mu": np.array(st.opt.mu["float32"]),
               "residual": (None if st.comm.residual is None
                            else np.array(st.comm.residual["float32"]))}
        out.update({k: np.array(getattr(st.proto, k))
                    for k in ("comm_rounds", "comm_units", "comm_bytes")})
        return out

    for i in range(STEPS):
        x, y = jpart.batches_for_step(shards, i, B)
        gate, peers = jtr._backend.sim._draw_fn(jnp.array(jstate.key), jnp.array(jstate.step))
        pre = snap(jstate)
        jstate, _ = jtr.step(jstate, (jnp.asarray(x), jnp.asarray(y)))
        yield (x, y), (np.array(gate), np.array(peers)), pre, snap(jstate)


def _q8_scales(theta):
    return tref.q8_encode(torch.from_numpy(theta), torch.zeros(len(theta), dtype=torch.int64),
                          block=512)[1].numpy()


@functools.lru_cache(maxsize=None)
def _ref_run(method, codec, W, p=0.125):
    """STEPS reference steps: the final state (numpy), batches and draws.
    For q8 the final state also holds ``step``, the largest q8 scale (one
    int8 step) each element's block had on the wire over the run."""
    batches, draws, final, scale = [], [], None, 0.0
    for batch, draw, pre, final in _ref_steps(method, codec, W, p):
        batches.append(batch)
        draws.append(draw)
        if codec == "q8":
            scale = np.maximum(scale, _q8_scales(pre["theta"]))
    if codec == "q8":
        final["step"] = np.repeat(scale, 512, axis=1)[:, :final["theta"].shape[1]]
    return final, batches, draws


def _port_trainer(method, codec, W, fused=True, p=0.125):
    ttr = TTrainer(engine="sim", protocol=_proto(TProto, method, codec, p),
                   optimizer=TOpt(**OPT), loss_fn=_tloss, num_workers=W,
                   fused_update=fused, device="cpu")
    return ttr, ttr.init_state(0, params=tsimple.params_from_jax(
        jax.tree.map(np.asarray, _jparams()), "cpu"))


def _tstep(ttr, tstate, batch, draw):
    (x, y), (gate, peers) = batch, draw
    return ttr.step(tstate, (torch.from_numpy(x), torch.from_numpy(y)),
                    draws=(torch.from_numpy(gate), torch.from_numpy(peers)))[0]


def _port_run(method, codec, W, fused=True, steps=STEPS):
    _, batches, draws = _ref_run(method, codec, W)
    ttr, tstate = _port_trainer(method, codec, W, fused)
    for batch, draw in list(zip(batches, draws))[:steps]:
        tstate = _tstep(ttr, tstate, batch, draw)
    return tstate


TOL = dict(rtol=1e-4, atol=1e-5)
SIM_CASES = [(m, c, W) for m in ("elastic_gossip", "gossiping_pull")
             for c in ("q8", "topk") for W in (4, 8)]


def _check_counters(tstate, ref):
    for name in ("comm_rounds", "comm_units", "comm_bytes"):
        b = getattr(tstate.proto, name).numpy()
        assert ref[name].dtype == b.dtype and np.array_equal(ref[name], b), (name, ref[name], b)


@pytest.mark.parametrize("method,codec,W", SIM_CASES)
def test_sim_steps_with_a_codec_match_reference_from_the_same_state(method, codec, W):
    """Every one of 20 steps at p = 0.25, started from the reference's pre-step state
    (theta, velocity, residual, counters): the wire is encoded from equal
    theta, so it is the same bit for bit, and the post-step params, velocity
    and top-k residual agree within rtol 1e-4 / atol 1e-5 (the matmul sums
    differ in order between XLA and ATen); the counters are bit-equal."""
    ttr, tstate = _port_trainer(method, codec, W, p=0.25)
    fired = 0
    for batch, draw, pre, post in _ref_steps(method, codec, W, 0.25):
        tstate.theta["float32"].copy_(torch.from_numpy(pre["theta"]))
        tstate.opt.mu["float32"].copy_(torch.from_numpy(pre["mu"]))
        tstate = tstate.replace(proto=tstate.proto._replace(
            **{k: torch.from_numpy(pre[k]) for k in ("comm_rounds", "comm_units", "comm_bytes")}))
        if codec == "topk":
            tstate.comm.residual["float32"].copy_(torch.from_numpy(pre["residual"]))
        tstate = _tstep(ttr, tstate, batch, draw)
        fired += int(draw[0].any())
        np.testing.assert_allclose(tstate.theta["float32"].numpy(), post["theta"], **TOL)
        np.testing.assert_allclose(tstate.opt.mu["float32"].numpy(), post["mu"], **TOL)
        if codec == "topk":
            np.testing.assert_allclose(tstate.comm.residual["float32"].numpy(),
                                       post["residual"], **TOL)
        _check_counters(tstate, post)
    assert fired >= 3


@pytest.mark.parametrize("method,codec,W", SIM_CASES)
def test_sim_trajectory_with_a_codec_matches_reference(method, codec, W):
    """20 free-running NAG steps at the main path's p = 0.125 with the
    codec's reconstruction on the wire. Params, velocity and the top-k residual within rtol 1e-4 /
    atol 1e-5; the counters bit-equal.

    q8 rounds stochastically: where the ulp-level drift between the two
    packages moves some x/scale + u across an integer, one int8 value flips
    and the element then differs by a fraction of one quantization step.
    For q8 the check is therefore: every element within rtol 1e-4 /
    atol 1e-5 or within one quantization step (the largest scale its block
    had on the wire during the run), and at most 0.2% of elements outside
    rtol 1e-4 / atol 1e-5 (ROADMAP.md §C records the sizes seen)."""
    ref, _, draws = _ref_run(method, codec, W)
    tstate = _port_run(method, codec, W)
    assert sum(int(g.any()) for g, _ in draws) >= 3     # several rounds fired
    got = {"theta": tstate.theta["float32"].numpy(), "mu": tstate.opt.mu["float32"].numpy()}
    if codec == "topk":
        r = tstate.comm.residual["float32"]
        assert r.dtype == torch.float32 and float(r.abs().sum()) > 0
        got["residual"] = r.numpy()
        for k, v in got.items():
            np.testing.assert_allclose(v, ref[k], **TOL)
    else:
        assert tstate.comm == tcomm.CommState(None) and ref["residual"] is None
        for k, v in got.items():
            off = ~np.isclose(v, ref[k], **TOL)
            assert off.mean() <= 2e-3, (k, int(off.sum()))
            assert np.all(np.abs(v - ref[k])[off] <= ref["step"][off]), k
    _check_counters(tstate, ref)


@pytest.mark.parametrize("codec", ["q8", "topk"])
def test_port_fused_and_unfused_paths_agree_with_a_codec(codec):
    """Kernel B1's path against the per-bucket path on the same draws: they
    round the comm displacement differently, so rtol 1e-4, atol 1e-5."""
    a = _port_run("elastic_gossip", codec, 4, fused=True, steps=10)
    b = _port_run("elastic_gossip", codec, 4, fused=False, steps=10)
    tol = dict(rtol=1e-4, atol=1e-5)
    for x, y in ((a.theta, b.theta), (a.opt.mu, b.opt.mu)):
        np.testing.assert_allclose(x["float32"].numpy(), y["float32"].numpy(), **tol)
    if codec == "topk":
        np.testing.assert_allclose(a.comm.residual["float32"].numpy(),
                                   b.comm.residual["float32"].numpy(), **tol)
    assert torch.equal(a.proto.comm_bytes, b.proto.comm_bytes)


def test_residual_only_advances_for_rows_whose_gate_fired():
    """A row whose own gate did not fire carries its residual unchanged
    through a fired round; fired rows advance (as the reference's
    tests/test_comm.py checks for its own roundtrip_bufs)."""
    codec = tcomm.resolve_codec(TProto(codec="topk", codec_block=128, codec_topk_frac=0.1))
    W, N = 4, 256
    bufs = {"float32": torch.from_numpy(_rows(W, N, seed=9))}
    res = {"float32": torch.from_numpy(_rows(W, N, seed=10, scale=0.3))}
    fired = [True, False, True, False]
    gate = torch.tensor(fired).reshape(-1, 1)
    _, new_res = tcomm.roundtrip_bufs(codec, bufs, tcomm.codec_seeds(0, torch.arange(W)),
                                      res, gate=gate)
    jcodec = jcomm.resolve_codec(JProto(codec="topk", codec_block=128, codec_topk_frac=0.1))
    _, jres = jcomm.roundtrip_bufs(jcodec, {"float32": jnp.asarray(bufs["float32"].numpy())},
                                   jcomm.codec_seeds(0, jnp.arange(W)),
                                   {"float32": jnp.asarray(res["float32"].numpy())},
                                   gate=jnp.asarray(fired).reshape(-1, 1))
    assert _bits_equal(new_res["float32"].numpy(), jres["float32"])
    r0, r1 = res["float32"], new_res["float32"]
    for w, f in enumerate(fired):
        assert torch.equal(r1[w], r0[w]) != f, w


def test_nobody_fires_leaves_theta_to_the_gradient_step_and_the_residual_unchanged():
    """A codec run on a step where no gate fires: the encode/decode pass
    runs (no host sync decides to skip it), the identity mix ignores its
    output, and the residual is carried unchanged, as in the reference's
    skipped branch."""
    W = 4
    train, _ = _data()
    x, y = jpart.batches_for_step(jpart.partition_iid(train, W, 0), 0, B)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    draws = (torch.zeros(W, dtype=torch.bool), torch.tensor([1, 0, 3, 2]))
    params = tsimple.params_from_jax(jax.tree.map(np.asarray, _jparams()), "cpu")
    out = {}
    for codec in ("topk", "none"):
        tr = TTrainer(protocol=_proto(TProto, "elastic_gossip", codec), optimizer=TOpt(**OPT),
                      loss_fn=_tloss, num_workers=W, device="cpu")
        st = tr.init_state(0, params=params)
        if codec == "topk":
            st.comm.residual["float32"].copy_(torch.from_numpy(
                _rows(*st.theta["float32"].shape, seed=3)))
            res0 = st.comm.residual["float32"].clone()
        st, m = tr.step(st, batch, draws=draws)
        out[codec] = st
    assert torch.equal(out["topk"].theta["float32"], out["none"].theta["float32"])
    assert torch.equal(out["topk"].comm.residual["float32"], res0)
    assert int(out["topk"].proto.comm_rounds) == 0 and int(m["comm_active"]) == 0
