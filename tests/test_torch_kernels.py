"""Kernel B1 (fused elastic-gossip + NAG flat update): the port's plain
version against the reference's Pallas kernel (interpret mode) and its jnp
oracle, the in-place dispatch contract, and the refusal paths. The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""
import pytest

torch = pytest.importorskip("torch")
# the suite runs several pytest-xdist workers on a few cores: one intra-op
# thread each keeps torch from oversubscribing them (the tensors are small)
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import fused_update as jfu  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import fused_update as tfu  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

ETA, MU = 0.01, 0.9
# (theta/peer/g storage, velocity storage)
DTYPES = {"f32": ("float32", "float32"), "bf16": ("bfloat16", "bfloat16"),
          "bf16_f32v": ("bfloat16", "float32")}
# f32: 1e-6 (both sides compute the same f32 formula; only the order of the
# reference's XLA fusion can differ by an ulp). bf16: 2e-2, one bf16 ulp at
# |x| ~ 4, as tests/test_kernels.py uses for the reference's own kernel.
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _inputs(W, n, dt, vdt, seed=0):
    rng = np.random.RandomState(seed)
    t, p, v, g = (rng.randn(W, n).astype(np.float32) for _ in range(4))
    coef = rng.uniform(0, 1, size=W).astype(np.float32)
    jt, jp, jg = (jnp.asarray(a, dt) for a in (t, p, g))
    jv = jnp.asarray(v, vdt)
    # the port sees exactly the reference's (rounded) storage values
    to_t = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    tt, tp, tg = (torch.from_numpy(np.array(a, np.float32)).to(to_t[dt])
                  for a in (jt, jp, jg))
    tv = torch.from_numpy(np.array(jv, np.float32)).to(to_t[vdt])
    return (jt, jp, jv, jg), (tt, tp, tv, tg), coef


def _close(a_torch, b_jax, dt):
    tol = TOL[dt]
    np.testing.assert_allclose(a_torch.float().numpy(), np.asarray(b_jax, np.float32),
                               rtol=tol, atol=tol)


# the full grid for f32 and bf16 storage; bf16 theta with f32 velocity at W=8
CASES = [(W, n, dkind, coef_kind) for W in (1, 4, 8) for n in (1000, 35968 * 3)
         for dkind in ("f32", "bf16") for coef_kind in ("scalar", "per_row", "peer_is_theta")]
CASES += [(8, n, "bf16_f32v", "per_row") for n in (1000, 35968 * 3)]


@pytest.mark.parametrize("W,n,dkind,coef_kind", CASES)
def test_plain_version_matches_reference(W, n, dkind, coef_kind):
    dt, vdt = DTYPES[dkind]
    (jt, jp, jv, jg), (tt, tp, tv, tg), coef = _inputs(W, n, dt, vdt)
    if coef_kind == "scalar":
        jc, tc = 0.5, 0.5
    else:
        jc, tc = jnp.asarray(coef), torch.from_numpy(coef)
    if coef_kind == "peer_is_theta":
        jp, tp = jt, tt
    j_out = jfu.fused_flat_elastic_nag_update(jt, jp, jv, jg, jc, ETA, MU,
                                              interpret=True)
    o_out = jax.jit(jref.fused_flat_elastic_nag_update)(jt, jp, jv, jg, jc, ETA, MU)
    # dispatch on CPU tensors: the plain version, written back in place
    t_in, v_in = tt.clone(), tv.clone()
    p_in = t_in if coef_kind == "peer_is_theta" else tp.clone()
    ptr = (t_in.data_ptr(), v_in.data_ptr())
    t_out, v_out = ops.fused_flat_elastic_nag_update(t_in, p_in, v_in, tg.clone(),
                                                     tc, torch.tensor(ETA), MU)
    assert (t_out.data_ptr(), v_out.data_ptr()) == ptr
    assert t_out.dtype == tt.dtype and v_out.dtype == tv.dtype
    for ref_t, ref_v in (j_out, o_out):
        _close(t_out, ref_t, dt)
        _close(v_out, ref_v, vdt)


def test_dispatch_in_place_equals_pure_plain_version():
    _, (tt, tp, tv, tg), coef = _inputs(4, 1000, "float32", "float32", seed=1)
    c = torch.from_numpy(coef)
    want_t, want_v = tref.fused_flat_elastic_nag_update(tt, tp, tv, tg, c, ETA, MU)
    t, v = tt.clone(), tv.clone()
    ops.fused_bufs_elastic_nag({"float32": t}, {"float32": tp}, {"float32": v},
                               {"float32": tg}, c, ETA, MU)
    assert torch.equal(t, want_t) and torch.equal(v, want_v)
    # inputs of the pure version are untouched
    assert not torch.equal(tt, want_t)


def test_non_cpu_tensors_never_reach_the_plain_version(monkeypatch):
    """Anything not on the CPU goes to the kernel wrapper, which launches or
    raises, or, on the ``meta`` device, is counted (one op under the
    kernel's name, :mod:`repro_torch.analysis.opcount`) and launches
    nothing; it never falls back to the plain version."""
    from repro_torch.analysis import opcount
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(tref, "fused_flat_elastic_nag_update", boom)
    x = torch.empty((2, 256), device="meta")
    launches = tfu.LAUNCHES
    with opcount.OpCounter() as c:
        assert ops.fused_flat_elastic_nag_update(x, x, x, x, 1.0, ETA, MU) == (x, x)
    assert c.costs.ops == {"fused_flat_elastic_nag_update": 1}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfu.fused_flat_elastic_nag_update(x, x, x, x, 1.0, ETA, MU)
    assert tfu.LAUNCHES == launches


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    x = torch.zeros((2, 256))
    launches = tfu.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfu.fused_flat_elastic_nag_update(x, x, x, x, 1.0, ETA, MU)
    assert tfu.LAUNCHES == launches


def test_failed_build_raises(monkeypatch):
    """No CUDA toolkit -> the build raises (nothing falls back)."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR.parent / "never-created")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("fused_update")
    assert not build.BUILD_DIR.exists()


# ---------------------------------------------------------------------------
# B2 (pure NAG on the flat plane, the dist engine's non-firing step) and B3
# (the per-array update): plain versions against the reference
# ---------------------------------------------------------------------------

B2_CASES = [(W, n, dkind, scalars) for W in (1, 8) for n in (1000, 35968 * 3)
            for dkind in sorted(DTYPES) for scalars in ("python", "tensor")]


@pytest.mark.parametrize("W,n,dkind,scalars", B2_CASES)
def test_b2_plain_version_matches_reference(W, n, dkind, scalars):
    """B2's plain version against the reference's Pallas kernel in
    interpret mode and its jnp oracle (TOL: 1e-6 f32, 2e-2 bf16), through
    the in-place dispatch; eta and mu as python numbers or 0-d tensors."""
    dt, vdt = DTYPES[dkind]
    (jt, _, jv, jg), (tt, _, tv, tg), _ = _inputs(W, n, dt, vdt, seed=2)
    j_out = jfu.fused_flat_nag_update(jt, jv, jg, ETA, MU, interpret=True)
    o_out = jax.jit(jref.fused_flat_nag_update)(jt, jv, jg, ETA, MU)
    eta, mu = (ETA, MU) if scalars == "python" else (torch.tensor(ETA), torch.tensor(MU))
    t_in, v_in = tt.clone(), tv.clone()
    ptr = (t_in.data_ptr(), v_in.data_ptr())
    t_out, v_out = ops.fused_flat_nag_update(t_in, v_in, tg, eta, mu)
    assert (t_out.data_ptr(), v_out.data_ptr()) == ptr
    assert t_out.dtype == tt.dtype and v_out.dtype == tv.dtype
    for ref_t, ref_v in (j_out, o_out):
        _close(t_out, ref_t, dt)
        _close(v_out, ref_v, vdt)
    # B2 is B1 with the peer stream gone: peer = theta gives the same bits
    w_t, w_v = tref.fused_flat_elastic_nag_update(tt, tt, tv, tg, 0.7, eta, mu)
    assert torch.equal(t_out, w_t) and torch.equal(v_out, w_v)


@pytest.mark.parametrize("shape", [(128,), (1000,), (33, 65), (4, 7, 130), (1,)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_b3_plain_version_matches_reference(shape, dt):
    """B3's plain version on arrays of any shape (scalar coef_gate, f32
    velocity and gradient beside a bf16 theta, as the reference's oracle
    test) against the reference's Pallas kernel in interpret mode and its
    jnp oracle; it returns new tensors and writes no input."""
    rng = np.random.RandomState(3)
    t, p, v, g = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    jt, jp = jnp.asarray(t, dt), jnp.asarray(p, dt)
    jv, jg = jnp.asarray(v), jnp.asarray(g)
    j_out = jfu.fused_elastic_nag_update(jt, jp, jv, jg, 0.5, eta=ETA, mu=MU, block=256,
                                         interpret=True)
    o_out = jref.fused_elastic_nag_update(jt, jp, jv, jg, coef_gate=0.5, eta=ETA, mu=MU)
    to_t = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    tt, tp = (torch.from_numpy(np.array(a, np.float32)).to(to_t) for a in (jt, jp))
    tv, tg = torch.from_numpy(v), torch.from_numpy(g)
    before = [x.clone() for x in (tt, tp, tv, tg)]
    t_out, v_out = ops.fused_elastic_nag_update(tt, tp, tv, tg, 0.5, eta=ETA, mu=MU)
    assert t_out.shape == shape and t_out.dtype == tt.dtype and v_out.dtype == tv.dtype
    assert all(torch.equal(a, b) for a, b in zip(before, (tt, tp, tv, tg)))
    for ref_t, ref_v in (j_out, o_out):
        _close(t_out, ref_t, dt)
        _close(v_out, ref_v, "float32")


def test_b2_b3_wrappers_refuse_cpu_tensors_and_count_nothing(monkeypatch):
    """The kernel wrappers take CUDA tensors only; a non-CPU tensor never
    reaches a plain version."""
    x = torch.zeros((2, 256))
    counts = (tfu.NAG_LAUNCHES, tfu.ARRAY_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfu.fused_flat_nag_update(x, x, x, ETA, MU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfu.fused_elastic_nag_update(x, x, x, x, 0.5, eta=ETA, mu=MU)

    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(tref, "fused_flat_nag_update", boom)
    monkeypatch.setattr(tref, "fused_elastic_nag_update", boom)
    m = torch.empty((2, 256), device="meta")
    # a meta tensor is counted, not run: B2 records one op, B3 has no meta
    # branch and raises
    from repro_torch.analysis import opcount
    with opcount.OpCounter() as c:
        ops.fused_flat_nag_update(m, m, m, ETA, MU)
    assert c.costs.ops == {"fused_flat_nag_update": 1}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfu.fused_flat_nag_update(m, m, m, ETA, MU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.fused_elastic_nag_update(m, m, m, m, 0.5, eta=ETA, mu=MU)
    assert (tfu.NAG_LAUNCHES, tfu.ARRAY_LAUNCHES) == counts
    assert ops.launch_counts()["fused_flat_nag_update"] == counts[0]
