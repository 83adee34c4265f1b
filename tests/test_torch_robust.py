"""The port's robust mixing on the fault plane (slice 3) against the
reference on the CPU: kernel B8's plain version against the reference's
oracle and its Pallas kernel in interpret mode, the dispatch (a non-CPU
tensor never reaches the plain version), and sim steps of
``clipped_gossip``, ``trimmed_gossip`` and ``elastic_gossip`` under each
fault model, in lockstep from the reference's pre-step state with the
reference's draws injected. The CUDA kernel B8 itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Inputs are made with numpy from a seed and handed to both packages."""
import functools
import zlib

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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import simple as jsimple  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch.api import GossipTrainer as TTrainer  # noqa: E402
from repro_torch.api import available_protocols  # noqa: E402
from repro_torch.common.config import FaultConfig as TFault  # noqa: E402
from repro_torch.common.config import OptimizerConfig as TOpt  # noqa: E402
from repro_torch.common.config import ProtocolConfig as TProto  # noqa: E402
from repro_torch.faults import models as tfm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import robust as trobust  # noqa: E402
from repro_torch.models import simple as tsimple  # noqa: E402

IN, HID, DEPTH, NCLS, B = 784, 64, 2, 10, 16
STEPS = 20


def _bits_equal(a, b):
    """Exact equality, bit for bit (so -0.0 differs from +0.0)."""
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    return np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# kernel B8's plain version
# ---------------------------------------------------------------------------

def _b8_case(name, W=4, n=700):
    """(theta f32 numpy, delta f32 numpy, scale, thr) for a named case;
    scale/thr are python floats or f32 [W] numpy arrays."""
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    theta = rng.randn(W, n).astype(np.float32)
    delta = (3 * rng.randn(W, n)).astype(np.float32)
    row = rng.uniform(0.1, 1.0, W).astype(np.float32)
    thr = rng.uniform(0.5, 2.0, W).astype(np.float32)
    inf = np.full(W, np.inf, np.float32)
    if name == "clipped":                  # [W] scale, no trim
        return theta, delta, row, inf
    if name == "trimmed":                  # unit scale, [W] trim
        return theta, delta, np.ones(W, np.float32), thr
    if name == "scalar":
        return theta, delta, 0.37, 1.25
    if name == "scalar_inf":
        return theta, delta, 1.0, float("inf")
    if name == "ragged":
        t, d, s, h = _b8_case("trimmed", W=3, n=1001)
        return t, d, s, h
    if name == "specials":
        # inf, NaN and -0.0 in delta (kept and trimmed), -0.0 in theta
        theta[:, :8] = -0.0
        delta[:, 0], delta[:, 1], delta[:, 2] = np.inf, -np.inf, np.nan
        delta[:, 3], delta[:, 4], delta[:, 5] = 5.0, -0.0, 0.25
        return theta, delta, row, np.array([np.inf, 1.0, 0.1, 3.0], np.float32)
    raise KeyError(name)


B8_CASES = ["clipped", "trimmed", "scalar", "scalar_inf", "ragged", "specials"]


def _as_t(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _as_j(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _select_fma(theta, delta, scale, thr):
    """What the reference's Pallas kernel computes in interpret mode on the
    CPU, where XLA rewrites its ``d * keep`` as a select and contracts the
    multiply-add: ``t + scale * where(|d| <= thr, d, +0.0)`` with ONE
    rounding (computed in f64, then f32)."""
    W = theta.shape[0]
    s = np.broadcast_to(np.asarray(scale, np.float32).reshape(-1), (W,))[:, None]
    h = np.broadcast_to(np.asarray(thr, np.float32).reshape(-1), (W,))[:, None]
    with np.errstate(invalid="ignore"):
        dk = np.where(np.abs(delta) <= h, delta, np.float32(0.0))
        return (theta.astype(np.float64) + s.astype(np.float64) * dk.astype(np.float64)
                ).astype(np.float32)


@pytest.mark.parametrize("case", B8_CASES)
def test_b8_plain_version_is_bit_equal_to_reference_in_f32(case):
    """f32: the plain version equals the reference's oracle bit for bit
    (max abs error 0.0), NaN and the sign of zero included.

    The reference's Pallas kernel in interpret mode is not bit-equal to its
    own oracle: XLA on the CPU turns its ``d * keep`` into a select and
    contracts ``t + scale * (...)`` into one fused multiply-add, so it
    rounds once where the oracle rounds twice (scale != 1), gives theta
    where the oracle gives NaN (a trimmed inf or NaN), and +0.0 where the
    oracle gives -0.0. The plain version (and the CUDA kernel, which uses
    non-contracting intrinsics and multiplies by keep) follow the oracle.
    So against the interpret kernel the check is that it equals that
    select-and-FMA form bit for bit everywhere, and the plain version where
    scale == 1 and delta is finite (where the two forms agree)."""
    theta, delta, scale, thr = _b8_case(case)
    got = tops.robust_flat_apply(torch.from_numpy(theta), torch.from_numpy(delta),
                                 _as_t(scale), _as_t(thr))
    assert got.dtype == torch.float32
    g = got.numpy()
    oracle = np.asarray(jref.robust_flat_apply(jnp.asarray(theta), jnp.asarray(delta),
                                               _as_j(scale), _as_j(thr)))
    kern = np.asarray(jops.robust_flat_apply(jnp.asarray(theta), jnp.asarray(delta),
                                             _as_j(scale), _as_j(thr),
                                             use_kernel=True, interpret=True))
    assert _bits_equal(g, oracle)
    finite = np.isfinite(g)
    assert float(np.max(np.abs(g[finite] - oracle[finite]))) == 0.0
    assert _bits_equal(kern, _select_fma(theta, delta, scale, thr))
    if np.all(np.asarray(scale) == 1.0) and np.isfinite(delta).all():
        assert _bits_equal(g, kern)
    if case == "specials":
        # inf * keep: kept inf stays inf, trimmed inf (and any NaN) is NaN
        assert np.isposinf(g[0, 0]) and np.isnan(g[1, 0]) and np.isnan(g[:, 2]).all()
        # theta = -0.0 with a trimmed positive delta gives +0.0
        assert g[2, 3] == 0.0 and not np.signbit(g[2, 3])
    # theta itself was not written
    assert _bits_equal(theta, _b8_case(case)[0])


@pytest.mark.parametrize("case", ["clipped", "trimmed", "scalar", "ragged", "specials"])
def test_b8_plain_version_matches_reference_in_bf16(case):
    """bf16 theta with f32 delta: the output is bf16, within 2**-8 relative
    (one bf16 rounding) of the reference's oracle, NaN where it has NaN;
    and of its Pallas kernel wherever delta is finite (for a non-finite
    delta the interpret kernel selects where the oracle multiplies, see
    the f32 test)."""
    theta, delta, scale, thr = _b8_case(case)
    tb = torch.from_numpy(theta).to(torch.bfloat16)
    jb = jnp.asarray(tb.float().numpy()).astype(jnp.bfloat16)
    got = tops.robust_flat_apply(tb, torch.from_numpy(delta), _as_t(scale), _as_t(thr))
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    oracle = np.asarray(jref.robust_flat_apply(jb, jnp.asarray(delta), _as_j(scale),
                                               _as_j(thr))).astype(np.float32)
    assert np.array_equal(np.isnan(g), np.isnan(oracle))
    np.testing.assert_allclose(g, oracle, rtol=2**-8, atol=2**-8)
    kern = np.asarray(jops.robust_flat_apply(jb, jnp.asarray(delta), _as_j(scale), _as_j(thr),
                                             use_kernel=True, interpret=True)).astype(np.float32)
    fin = np.isfinite(delta)
    np.testing.assert_allclose(g[fin], kern[fin], rtol=2**-8, atol=2**-8)


def test_non_cpu_tensors_never_reach_the_b8_plain_version(monkeypatch):
    """A tensor not on the CPU goes to the kernel wrapper, which launches or
    raises (here: not a CUDA tensor); the plain version is never called."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(tref, "robust_flat_apply", boom)
    x = torch.empty((2, 256), device="meta")
    before = trobust.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.robust_flat_apply(x, x, 1.0, float("inf"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tops.robust_bufs_apply({"float32": x}, {"float32": x}, 1.0, 2.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trobust.robust_flat_apply(torch.zeros(2, 8), torch.zeros(2, 8), 1.0, 1.0)
    assert trobust.LAUNCHES == before


def test_robust_protocols_are_registered_like_the_reference():
    assert {"clipped_gossip", "trimmed_gossip"} <= set(available_protocols())
    from repro_torch.api import robust as trob
    from repro_torch.api.registry import get_protocol
    assert get_protocol("clipped_gossip") is trob.ClippedGossip
    assert get_protocol("trimmed_gossip") is trob.TrimmedGossip
    assert trob.ClippedGossip.pairwise and issubclass(trob.ClippedGossip, trob.RobustGossip)
    # no per-worker step counts on the sim engine: the staleness rate is off
    p = get_protocol("clipped_gossip")(TProto(method="clipped_gossip", comm_probability=0.5,
                                              stale_adapt=0.5))
    st = p.init_state({"float32": torch.zeros(4, 8)})
    assert p.stale_scale(torch.tensor([1, 0, 3, 2]), st) is None


# ---------------------------------------------------------------------------
# sim steps in lockstep with the reference
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


OPT = dict(name="nag", learning_rate=1e-3, momentum=0.99)
COUNTERS = ("comm_rounds", "comm_units", "comm_bytes", "wire_dropped", "wire_corrupt")


def _faults(kind, W):
    """(FaultConfig kwargs, codec) per fault case; one Byzantine worker at
    W = 4 and W = 8 (frac 1/4 and 1/8: round(W/8) is 0 at W = 4)."""
    frac = 1.0 / W
    return {
        "none": (None, "none"),
        "drop": (dict(fault_model="drop", fault_rate=0.2, seed=3), "none"),
        "byzantine_scale": (dict(fault_model="byzantine_scale", fault_frac=frac, scale=100.0,
                                 seed=3), "none"),
        "byzantine_noise": (dict(fault_model="byzantine_noise", fault_frac=frac, noise_std=1.0,
                                 seed=3), "none"),
        "corrupt": (dict(fault_model="corrupt", fault_rate=0.2, seed=3), "none"),
        "corrupt_q8": (dict(fault_model="corrupt", fault_rate=0.2, seed=3), "q8"),
    }[kind]


def _proto(P, method, codec):
    return P(method=method, comm_probability=0.5, moving_rate=0.5, topology="uniform",
             codec=codec, robust_clip=0.1)


def _ref_steps(method, kind, W):
    """Yield (batch, draws, pre-step state, post-step state, garbled rows or
    None) for STEPS reference steps; states as numpy copies (the step
    donates its input)."""
    fk, codec = _faults(kind, W)
    jtr = JTrainer(engine="sim", protocol=_proto(JProto, method, codec), optimizer=JOpt(**OPT),
                   loss_fn=_jloss, num_workers=W,
                   faults=None if fk is None else JFault(**fk))
    jst = jtr.init_state(0, params=_jparams())
    jfm = jtr._backend.sim.fault_model
    shards = jpart.partition_iid(_data()[0], W, 0)

    def snap(st):
        out = {"theta": np.array(st.theta["float32"]), "mu": np.array(st.opt.mu["float32"]),
               "step": np.array(st.step)}
        out.update({k: np.array(getattr(st.proto, k)) for k in COUNTERS
                    if getattr(st.proto, k) is not None})
        return out

    for i in range(STEPS):
        x, y = jpart.batches_for_step(shards, i, B)
        gate, peers = jtr._backend.sim._draw_fn(jnp.array(jst.key), jnp.array(jst.step))
        garbled = None
        if kind == "byzantine_noise":
            garbled = np.array(jfm.garble_bufs(jst.theta, jst.step, W)["float32"])
        pre = snap(jst)
        jst, _ = jtr.step(jst, (jnp.asarray(x), jnp.asarray(y)))
        yield (x, y), (np.array(gate), np.array(peers)), pre, snap(jst), garbled


class _InjectedNoise(tfm.ByzantineNoise):
    """Test-only fault model: publishes the reference's threefry noise rows
    (set per step), so the port's byzantine_noise wiring is held to the
    reference's outputs on the same garbage."""
    rows = None

    def garble_bufs(self, bufs, step, num_workers):
        return {"float32": torch.from_numpy(_InjectedNoise.rows)}


def _port_trainer(method, kind, W):
    fk, codec = _faults(kind, W)
    if kind == "byzantine_noise":
        fk = dict(fk, fault_model="_test_injected_noise")
    tr = TTrainer(protocol=_proto(TProto, method, codec), optimizer=TOpt(**OPT),
                  loss_fn=_tloss, num_workers=W, device="cpu",
                  faults=None if fk is None else TFault(**fk))
    return tr, tr.init_state(0, params=tsimple.params_from_jax(
        jax.tree.map(np.asarray, _jparams()), "cpu"))


@pytest.fixture
def injected_noise():
    tfaults.register_fault_model("_test_injected_noise")(_InjectedNoise)
    yield
    tfaults.unregister_fault_model("_test_injected_noise")


METHODS = ("clipped_gossip", "trimmed_gossip", "elastic_gossip")
KINDS = ("none", "drop", "byzantine_scale", "byzantine_noise", "corrupt", "corrupt_q8")
# every combination at W = 8; at W = 4 the robust protocols under the
# Byzantine and drop models and plain gossip under corruption
SIM_CASES = ([(m, k, 8) for m in METHODS for k in KINDS]
             + [(m, k, 4) for m in METHODS[:2] for k in ("drop", "byzantine_scale",
                                                         "byzantine_noise")]
             + [("elastic_gossip", k, 4) for k in ("corrupt", "corrupt_q8")])
TOL = dict(rtol=1e-4, atol=1e-5)


def _tol(kind, want):
    if kind != "byzantine_scale":
        return TOL
    finite = np.abs(want[np.isfinite(want)])
    return dict(TOL, atol=TOL["atol"] * max(1.0, float(finite.max(initial=0.0))))


@pytest.mark.parametrize("method,kind,W", SIM_CASES)
def test_sim_steps_under_faults_match_reference_from_the_same_state(method, kind, W,
                                                                    injected_noise):
    """Each of 20 steps at p = 0.5, started from the reference's pre-step
    state (theta, velocity, counters, step), with the reference's gate and
    peers injected: theta and velocity within rtol 1e-4 / atol 1e-5 (the
    model and mixing matmuls sum in another order than XLA's), and
    comm_rounds, comm_units, comm_bytes, wire_dropped and wire_corrupt bit
    for bit. Under byzantine_scale the honest rows absorb rows published at
    100x, so the state grows far past unit scale and an element can be much
    smaller than the terms the mix and the model's matmuls sum into it:
    there atol is 1e-5 times the largest finite magnitude in the compared
    array (a norm-wise relative bound), rtol stays 1e-4. Plain
    elastic_gossip there overflows f32 within 20 steps (the attack this
    fault model stands for); its params are compared up to that step, the
    counters on every step.

    Trim boundary (trimmed_gossip only): thr = robust_trim * RMS(theta_row)
    comes out of a sum over the row whose order differs between XLA and
    ATen, so a displacement coordinate within an ulp of thr may be kept in
    one package and trimmed in the other; the element then differs by that
    whole coordinate, whose size is thr itself. Such elements are counted
    (at most 2 per step are allowed) and each is bounded by 1.001 * thr of
    its row; every other element keeps the tolerance above."""
    tr, ts = _port_trainer(method, kind, W)
    fired = flips = compared = 0
    for batch, draw, pre, post, garbled in _ref_steps(method, kind, W):
        ts.theta["float32"].copy_(torch.from_numpy(pre["theta"]))
        ts.opt.mu["float32"].copy_(torch.from_numpy(pre["mu"]))
        ts = ts.replace(step=torch.from_numpy(pre["step"]), proto=ts.proto._replace(
            **{k: torch.from_numpy(v) for k, v in pre.items() if k in COUNTERS}))
        _InjectedNoise.rows = garbled
        (x, y), (gate, peers) = batch, draw
        ts, _ = tr.step(ts, (torch.from_numpy(x), torch.from_numpy(y)),
                        draws=(torch.from_numpy(gate), torch.from_numpy(peers)))
        fired += int(gate.any())
        for k in COUNTERS:
            if k in post:
                b = getattr(ts.proto, k).numpy()
                assert post[k].dtype == b.dtype and np.array_equal(post[k], b), (k, post[k], b)
            else:
                assert getattr(ts.proto, k) is None
        got, want = ts.theta["float32"].numpy(), post["theta"]
        if not np.isfinite(want).all():
            # plain gossip absorbing 100x rows overflows f32: past that
            # step both states are inf/NaN garbage, and only the counters
            # (checked above) still mean anything
            assert (method, kind) == ("elastic_gossip", "byzantine_scale")
            assert compared >= 8, compared
            break
        compared += 1
        tol = _tol(kind, want)
        off = ~np.isclose(got, want, **tol)
        if method == "trimmed_gossip" and off.any():
            rms = np.sqrt(np.sum(pre["theta"].astype(np.float32) ** 2, axis=1)
                          / pre["theta"].shape[1])
            bound = 1.001 * 6.0 * rms[:, None] + tol["atol"]
            rows, _ = np.nonzero(off)
            assert np.all(np.abs(got - want)[off] <= bound[rows, 0]), np.abs(got - want)[off]
            assert off.sum() <= 2, int(off.sum())
            flips += int(off.sum())
        else:
            np.testing.assert_allclose(got, want, **tol)
        np.testing.assert_allclose(ts.opt.mu["float32"].numpy(), post["mu"],
                                   **_tol(kind, post["mu"]))
        if kind != "byzantine_noise" and kind != "byzantine_scale":
            assert np.isfinite(got).all()
    assert fired >= 10 or compared < STEPS
    if kind in ("drop",):
        assert int(ts.proto.wire_dropped) > 0
    if kind.startswith("corrupt"):
        assert int(ts.proto.wire_corrupt) > 0
    print(f"{method} {kind} W={W}: {compared} steps compared, {flips} trim-boundary flips")
