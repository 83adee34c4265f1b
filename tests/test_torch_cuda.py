"""Tests of the port that need an NVIDIA GPU: kernels B1-B9 against their
plain versions on the card (B1 also on a row list, B8 also on column
chunks), the sim engine launching them (B1 once per step; with a codec,
its encode and decode kernels once per step; with a robust protocol, B8
once per step), the async engine (B1 once per event window on the
window's rows; B8 once per chunk on the partition plane) and the host
plane against the device plane, a 2-rank dist engine on the card
(B1 on the firing steps, B2 on the others), the serving path (B9 once
per layer in prefill and in every decode step), the CIFAR CNN's step
against the CPU's with TF32 allowed in the process, checkpoint resumes
on the card, B9 at Zamba2's head dim 80, the MoE dispatch under ``vmap``,
the SSM blocks' prefill and decode against the CPU's, B9 at the
cross-attention models' non-causal shapes, the SSM / hybrid LM gradient
under ``vmap`` against the CPU's, the cross-attention models' prefill
and decode against the CPU's, B9 at the tensor-parallel ranks' shapes of
the MLA, hybrid and vision models, those models served over 2 ranks
on the card against one device, and a rematerialised LM step against one
that is not.
They skip without a card; on one, run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the reference package, so it runs where
only the port is installed."""
import numpy as np
import pytest
from _torch_codec_cases import (ORDER_COL, corrupted_topk_wire, finite_lanes,
                                q8_nonfinite_rows)

torch = pytest.importorskip("torch")

from repro_torch.kernels import codec as tcodec  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import fused_update as tfu  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import robust as trobust  # noqa: E402

# Both sides round the same f32 formula in the same order (the kernel uses
# non-contracting _rn intrinsics), so the error is expected to be 0; the
# tolerance is the CPU tests' one.
TOL = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
DTYPES = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16_f32v": (torch.bfloat16, torch.float32)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(W, n, tdt, vdt, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    t, p, v, gr = (torch.randn(W, n, generator=g, device=dev) for _ in range(4))
    return t.to(tdt), p.to(tdt), v.to(vdt), gr.to(tdt), torch.rand(W, generator=g, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 35968 * 3 + 5])
@pytest.mark.parametrize("dkind", sorted(DTYPES))
@pytest.mark.parametrize("peer_is_theta", [False, True])
def test_kernel_matches_plain_version(cuda, n, dkind, peer_is_theta):
    tdt, vdt = DTYPES[dkind]
    t, p, v, g, coef = _inputs(8, n, tdt, vdt, cuda)
    if peer_is_theta:
        p = t
    eta = torch.full((), 0.01, device=cuda)
    want_t, want_v = tref.fused_flat_elastic_nag_update(t, p, v, g, coef, eta, 0.9)
    kt, kv = t.clone(), v.clone()
    launches = tfu.LAUNCHES
    ops.fused_flat_elastic_nag_update(kt, kt if peer_is_theta else p, kv, g, coef, eta, 0.9)
    torch.cuda.synchronize()
    assert tfu.LAUNCHES == launches + 1
    torch.testing.assert_close(kt, want_t, rtol=TOL[tdt], atol=TOL[tdt])
    torch.testing.assert_close(kv, want_v, rtol=TOL[vdt], atol=TOL[vdt])


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    t = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfu.fused_flat_elastic_nag_update(t.T.contiguous().T, t, t, t, 1.0, 0.1, 0.9)
    with pytest.raises(ValueError, match="share"):
        tfu.fused_flat_elastic_nag_update(t, t.double(), t, t, 1.0, 0.1, 0.9)
    with pytest.raises(ValueError, match="v must be"):
        tfu.fused_flat_elastic_nag_update(t, t, t.bfloat16(), t, 1.0, 0.1, 0.9)


@pytest.mark.cuda
def test_sim_fused_path_launches_b1_once_per_step(cuda):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(p, x, y):
        return simple.xent_loss(simple.mlp_logits(p, x), y)

    tr = GossipTrainer(protocol=ProtocolConfig(comm_probability=0.5, topology="uniform"),
                       loss_fn=loss_fn, num_workers=4, device=cuda,
                       init_fn=lambda g: simple.init_mlp(g, 784, 64, 2, 10)[0])
    st = tr.init_state(0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 16, 784, generator=gen, device=cuda)
    y = torch.randint(0, 10, (4, 16), generator=gen, device=cuda)
    launches = tfu.LAUNCHES
    for _ in range(5):
        st, m = tr.step(st, (x, y))
    assert tfu.LAUNCHES == launches + 5
    assert torch.isfinite(m["loss"])


# ---------------------------------------------------------------------------
# B4-B7: the codec kernels, exact against their plain versions
# ---------------------------------------------------------------------------

def _bits(t):
    """A tensor's bytes on the host, for exact (sign-of-zero) comparison."""
    return t.detach().cpu().contiguous().view(torch.uint8)


def _codec_input(W, n, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(W, n, generator=g, device=dev), 0.1 * torch.randn(W, n, generator=g,
                                                                          device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("W,n,block", [(8, 35968 * 3 + 5, 512), (4, 1000, 128), (1, 1, 128),
                                       (3, 700, 512)])
def test_q8_kernels_match_plain_versions(cuda, W, n, block):
    x, _ = _codec_input(W, n, cuda, n)
    if n >= 2 * block:
        x[:, block:2 * block] = 0.0                      # an all-zero block: scale 1
    seeds = torch.tensor([0, 1, 0xFFFFFFFF, 12345, 7, 0x80000000, 3, 99][:W],
                         dtype=torch.int64, device=cuda)
    before = dict(tcodec.LAUNCHES)
    v, s = ops.q8_encode(x, seeds, block=block)
    d = ops.q8_decode(v, s, n, block=block)
    torch.cuda.synchronize()
    assert tcodec.LAUNCHES["q8_encode"] == before["q8_encode"] + 1
    assert tcodec.LAUNCHES["q8_decode"] == before["q8_decode"] + 1
    pv, ps = tref.q8_encode(x, seeds, block=block)
    pd = tref.q8_decode(pv, ps, n, block=block)
    for got, want in ((v, pv), (s, ps), (d, pd)):
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("W,n,k,block", [(8, 35968 * 3 + 5, 26, 512), (4, 1000, 13, 128),
                                         (3, 300, 8, 128), (2, 512, 1, 512)])
def test_topk_kernels_match_plain_versions(cuda, W, n, k, block):
    x, r = _codec_input(W, n, cuda, n + k)
    x[0, :block] = torch.tensor([2.0, -2.0, 1.0, -0.0] * (block // 4), device=cuda)  # ties
    before = dict(tcodec.LAUNCHES)
    vals, idx, res = ops.topk_encode(x, r, k=k, block=block)
    d = ops.topk_decode(vals, idx, n, k=k, block=block)
    torch.cuda.synchronize()
    assert tcodec.LAUNCHES["topk_encode"] == before["topk_encode"] + 1
    assert tcodec.LAUNCHES["topk_decode"] == before["topk_decode"] + 1
    pv, pi, pr = tref.topk_encode(x, r, k=k, block=block)
    pd = tref.topk_decode(pv, pi, n, k=k, block=block)
    for got, want in ((vals, pv), (idx, pi), (res, pr), (d, pd)):
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tie straddle", "k 1", "k block", "all tied"])
def test_topk_encode_radix_select_edges_byte_equal(cuda, case):
    """B6's select where it is easiest to get wrong: 40 entries tied at the
    20th largest magnitude (k 20 keeps the 5 lowest-index ones of them, with
    -0.0 and sign mixed in), k = 1, k = block, and a block of one magnitude."""
    block = 512
    x, r = _codec_input(3, 3 * block - 100, cuda, 77)
    r.zero_()
    k = {"tie straddle": 20, "k 1": 1, "k block": block, "all tied": 26}[case]
    if case == "tie straddle":
        mag = x[:, :block].abs().sort(dim=1, descending=True).values[:, 19:20]
        g = torch.Generator(device=cuda).manual_seed(5)
        for w in range(x.shape[0]):
            pos = torch.randperm(block, generator=g, device=cuda)[:40]
            x[w, pos] = mag[w] * torch.where(torch.rand(40, generator=g, device=cuda) < 0.5,
                                             -1.0, 1.0)
        x[:, block + 7] = -0.0
    if case == "all tied":
        x[:, :block] = 0.75 * torch.where(torch.arange(block, device=cuda) % 3 == 0, -1.0, 1.0)
    vals, idx, res = ops.topk_encode(x, r, k=k, block=block)
    pv, pi, pr = tref.topk_encode(x, r, k=k, block=block)
    torch.cuda.synchronize()
    for got, want in ((vals, pv), (idx, pi), (res, pr)):
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 512, 4096])
def test_q8_encode_on_nan_and_inf_blocks_matches_plain_version(cuda, block):
    """B4 takes its amax over |x|'s bit patterns, which order NaN above inf:
    a NaN block gets scale 1 and an inf block scale inf, as the plain
    version's torch.amax gives. Scales byte-equal, int8 values equal at
    every finite element (NaN -> int8 is defined by neither side)."""
    x = torch.from_numpy(q8_nonfinite_rows(block)).to(cuda)
    seeds = torch.tensor([7, 0xFFFFFFFF], dtype=torch.int64, device=cuda)
    v, s = ops.q8_encode(x, seeds, block=block)
    pv, ps = tref.q8_encode(x, seeds, block=block)
    torch.cuda.synchronize()
    assert torch.equal(_bits(s), _bits(ps))
    ok = torch.from_numpy(finite_lanes(x.cpu().numpy(), block))
    assert torch.equal(v.cpu()[ok], pv.cpu()[ok])
    assert s[0, 0] == 1.0 and s[0, 1] == float("inf") and s[1, 0] == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("W,nb,k,block,cut", [(2, 3, 8, 128, 131), (3, 4, 26, 512, 0),
                                              (2, 3, 40, 128, 5), (1, 2, 128, 128, 0),
                                              (9, 700, 26, 512, 3), (2, 3, 205, 4096, 1)])
def test_topk_decode_on_a_corrupted_wire_matches_the_cpu_plain_version(cuda, W, nb, k, block,
                                                                        cut):
    """Duplicate indices summed in pair order and out-of-block indices
    dropped, byte for byte against the plain version on the CPU (on the card
    scatter_add_ promises no order among duplicates)."""
    vals, idx = (torch.from_numpy(a) for a in corrupted_topk_wire(W, nb, k, block))
    n = nb * block - cut
    before = tcodec.LAUNCHES["topk_decode"]
    d = ops.topk_decode(vals.to(cuda), idx.to(cuda), n, k=k, block=block)
    torch.cuda.synchronize()
    assert tcodec.LAUNCHES["topk_decode"] == before + 1
    want = tref.topk_decode(vals, idx, n, k=k, block=block)
    assert torch.equal(_bits(d), _bits(want))
    assert d[0, ORDER_COL] == 0.0


def _codec_matches_plain(x, r, seeds, k, block):
    """All four codec kernels against their plain versions, byte for byte;
    each decode reads the plain encode's wire, and B7 is held against the
    plain version on the CPU."""
    n = x.shape[1]
    v, s = ops.q8_encode(x, seeds, block=block)
    pv, ps = tref.q8_encode(x, seeds, block=block)
    d = ops.q8_decode(pv, ps, n, block=block)
    pd = tref.q8_decode(pv, ps, n, block=block)
    tv, ti, tr = ops.topk_encode(x, r, k=k, block=block)
    qv, qi, qr = tref.topk_encode(x, r, k=k, block=block)
    td = ops.topk_decode(qv, qi, n, k=k, block=block)
    qd = tref.topk_decode(qv.cpu(), qi.cpu(), n, k=k, block=block)
    torch.cuda.synchronize()
    for got, want in ((v, pv), (s, ps), (d, pd), (tv, qv), (ti, qi), (tr, qr), (td, qd)):
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256, 512, 1024, 4096])
@pytest.mark.parametrize("tail", ["n % 4 != 0", "n % 4 == 0, partial block", "unaligned rows"])
def test_codec_kernels_at_every_block_size_and_row_tail(cuda, block, tail):
    """Blocks in B4's registers (block / 128 <= 8) and past them (4096, two
    passes), rows whose length is not a multiple of 4 (the scalar paths),
    a multiple of 4 with a partial last block (the 16-byte paths), and rows
    that are not 16-byte aligned (a contiguous view one float into its
    storage: B4's scalar path)."""
    n = 3 * block + (37 if tail == "n % 4 != 0" else 64)
    W = 3
    g = torch.Generator(device=cuda).manual_seed(block + n)
    if tail == "unaligned rows":
        x = torch.randn(W * n + 1, generator=g, device=cuda)[1:].view(W, n)
        assert x.is_contiguous() and x.data_ptr() % 16
    else:
        x = torch.randn(W, n, generator=g, device=cuda)
    x[0, block:2 * block] = 0.0                          # an all-zero block: scale 1
    r = 0.1 * torch.randn(W, n, generator=g, device=cuda)
    seeds = torch.tensor([0, 0xFFFFFFFF, 12345], dtype=torch.int64, device=cuda)
    _codec_matches_plain(x, r, seeds, max(1, round(0.05 * block)), block)


@pytest.mark.cuda
def test_codec_kernels_over_many_rows(cuda):
    """W * nb codec blocks over thousands of thread blocks: W = 40 rows of
    ragged length at block 256 for all four kernels, and B4 and B7 at
    70,000 rows (more than a 2-d grid's 65,535)."""
    g = torch.Generator(device=cuda).manual_seed(40)
    x = torch.randn(40, 20011, generator=g, device=cuda)
    r = 0.1 * torch.randn(40, 20011, generator=g, device=cuda)
    seeds = torch.arange(40, dtype=torch.int64, device=cuda) * 2654435761 % 2**32
    _codec_matches_plain(x, r, seeds, 13, 256)
    W, n, k = 70000, 200, 7
    x = torch.randn(W, n, generator=g, device=cuda)
    seeds = torch.arange(W, dtype=torch.int64, device=cuda)
    v, s = ops.q8_encode(x, seeds, block=128)
    pv, ps = tref.q8_encode(x, seeds, block=128)
    vals = torch.randn(W, 2 * k, generator=g, device=cuda)
    idx = torch.randint(-3, 131, (W, 2 * k), generator=g, device=cuda, dtype=torch.int32)
    d = ops.topk_decode(vals, idx, n, k=k, block=128)
    torch.cuda.synchronize()
    assert torch.equal(_bits(v), _bits(pv)) and torch.equal(_bits(s), _bits(ps))
    assert torch.equal(_bits(d), _bits(tref.topk_decode(vals.cpu(), idx.cpu(), n, k=k,
                                                        block=128)))


@pytest.mark.cuda
def test_codec_wrappers_check_once_per_signature_and_still_refuse(cuda):
    """A signature that passed its checks skips them on the next call; a
    call that differs in shape, strides, dtype or a static argument is
    checked again and refused as before."""
    x = torch.randn(2, 256, device=cuda)
    seeds = torch.zeros(2, dtype=torch.int64, device=cuda)
    tcodec._CHECKED.clear()
    tcodec.q8_encode(x, seeds, block=128)
    tcodec.q8_encode(x, seeds, block=128)
    assert len(tcodec._CHECKED) == 1
    with pytest.raises(ValueError, match="contiguous"):
        tcodec.q8_encode(torch.randn(256, 2, device=cuda).T, seeds, block=128)
    with pytest.raises(ValueError, match="seeds has shape"):
        tcodec.q8_encode(x, torch.zeros(3, dtype=torch.int64, device=cuda), block=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tcodec.q8_encode(x, seeds, block=100)
    vals, idx, _ = tcodec.topk_encode(x, x, k=4, block=128)
    tcodec.topk_decode(vals, idx, 256, k=4, block=128)
    with pytest.raises(ValueError, match="does not hold"):
        tcodec.topk_decode(vals, idx, 257, k=4, block=128)
    with pytest.raises(ValueError, match="idx must be"):
        tcodec.topk_decode(vals, idx.long(), 256, k=4, block=128)
    # a converted input (bf16 bucket, python seeds) is checked every call
    tcodec.q8_encode(x.bfloat16(), [1, 2], block=128)
    assert len(tcodec._CHECKED) == 3


@pytest.mark.cuda
def test_codec_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        tcodec.q8_encode(x, torch.zeros(2, dtype=torch.int64, device=cuda), block=100)
    with pytest.raises(ValueError, match="k must be"):
        tcodec.topk_encode(x, x, k=0, block=128)
    with pytest.raises(ValueError, match="residual"):
        tcodec.topk_encode(x, x.double(), k=4, block=128)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["q8", "topk"])
def test_sim_codec_step_launches_its_kernels_once_per_step(cuda, codec):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(p, x, y):
        return simple.xent_loss(simple.mlp_logits(p, x), y)

    tr = GossipTrainer(protocol=ProtocolConfig(comm_probability=0.5, topology="uniform"),
                       codec=codec, loss_fn=loss_fn, num_workers=4, device=cuda,
                       init_fn=lambda g: simple.init_mlp(g, 784, 64, 2, 10)[0])
    st = tr.init_state(0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 16, 784, generator=gen, device=cuda)
    y = torch.randint(0, 10, (4, 16), generator=gen, device=cuda)
    enc, dec = (f"{codec}_encode", f"{codec}_decode")
    before, b1 = dict(tcodec.LAUNCHES), tfu.LAUNCHES
    for _ in range(5):
        st, m = tr.step(st, (x, y))
    torch.cuda.synchronize()
    assert tfu.LAUNCHES == b1 + 5
    assert tcodec.LAUNCHES[enc] == before[enc] + 5
    assert tcodec.LAUNCHES[dec] == before[dec] + 5
    assert torch.isfinite(m["loss"])
    if codec == "topk":
        assert bool(torch.isfinite(st.comm.residual["float32"]).all())


# ---------------------------------------------------------------------------
# B8: the robust apply, byte-equal to its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("W,n", [(8, 35968 * 3), (4, 1000), (3, 1001), (1, 1)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["clipped", "trimmed", "scalar"])
def test_b8_matches_plain_version_byte_for_byte(cuda, W, n, tdt, kind):
    g = torch.Generator(device=cuda).manual_seed(W * 7 + n)
    t = torch.randn(W, n, generator=g, device=cuda).to(tdt)
    d = 3 * torch.randn(W, n, generator=g, device=cuda)
    scale, thr = {"clipped": (torch.rand(W, generator=g, device=cuda),
                              torch.full((W,), float("inf"), device=cuda)),
                  "trimmed": (torch.ones(W, device=cuda),
                              0.5 + torch.rand(W, generator=g, device=cuda)),
                  "scalar": (0.37, 1.25)}[kind]
    t0 = t.clone()
    launches = trobust.LAUNCHES
    got = ops.robust_flat_apply(t, d, scale, thr)
    torch.cuda.synchronize()
    assert trobust.LAUNCHES == launches + 1
    want = tref.robust_flat_apply(t, d, scale, thr)
    assert got.dtype == tdt and torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(t), _bits(t0))


@pytest.mark.cuda
def test_b8_specials_follow_the_multiply(cuda):
    """+-inf, NaN and -0.0 in delta, -0.0 in theta: byte-equal to the plain
    version; a NaN stays NaN, a trimmed inf gives NaN, a trimmed coordinate
    on theta = -0.0 gives +0.0."""
    t = torch.randn(4, 1024, device=cuda)
    d = 3 * torch.randn(4, 1024, device=cuda)
    t[:, :8] = -0.0
    d[:, 0], d[:, 1], d[:, 2], d[:, 3] = float("inf"), float("-inf"), float("nan"), 5.0
    thr = torch.tensor([float("inf"), 1.0, 0.1, 3.0], device=cuda)
    got = trobust.robust_flat_apply(t, d, torch.full((4,), 0.5, device=cuda), thr)
    want = tref.robust_flat_apply(t, d, torch.full((4,), 0.5, device=cuda), thr)
    assert torch.equal(_bits(got), _bits(want))
    g = got.cpu()
    assert torch.isposinf(g[0, 0]) and torch.isnan(g[1, 0]) and bool(torch.isnan(g[:, 2]).all())
    assert float(g[2, 3]) == 0.0 and not bool(torch.signbit(g[2, 3]))


@pytest.mark.cuda
def test_b8_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    t = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        trobust.robust_flat_apply(t.T.contiguous().T, t, 1.0, 1.0)
    # a row-strided column slice has contiguous rows: taken since slice 4a
    # (the partitioned mixing's chunks), and byte-equal to the plain version
    wide = torch.randn((2, 512), device=cuda)
    got = trobust.robust_flat_apply(wide[:, :256], t, 1.0, 1.0)
    assert torch.equal(_bits(got), _bits(tref.robust_flat_apply(wide[:, :256], t, 1.0, 1.0)))
    with pytest.raises(ValueError, match="contiguous"):
        trobust.robust_flat_apply(t, t, 1.0, 1.0, out=torch.zeros((256, 2), device=cuda).T)
    with pytest.raises(ValueError, match="delta must be float32"):
        trobust.robust_flat_apply(t, t.bfloat16(), 1.0, 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        trobust.robust_flat_apply(t.double(), t, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trobust.robust_flat_apply(t, t.cpu(), 1.0, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["clipped_gossip", "trimmed_gossip"])
def test_sim_robust_step_launches_b8_and_b1_once_per_step(cuda, method):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import FaultConfig, ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(p, x, y):
        return simple.xent_loss(simple.mlp_logits(p, x), y)

    tr = GossipTrainer(protocol=ProtocolConfig(method=method, comm_probability=0.5,
                                               topology="uniform"),
                       loss_fn=loss_fn, num_workers=4, device=cuda,
                       faults=FaultConfig(fault_model="drop", fault_rate=0.2),
                       init_fn=lambda g: simple.init_mlp(g, 784, 64, 2, 10)[0])
    st = tr.init_state(0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 16, 784, generator=gen, device=cuda)
    y = torch.randint(0, 10, (4, 16), generator=gen, device=cuda)
    b8, b1 = trobust.LAUNCHES, tfu.LAUNCHES
    for _ in range(5):
        st, m = tr.step(st, (x, y))
    torch.cuda.synchronize()
    assert trobust.LAUNCHES == b8 + 5 and tfu.LAUNCHES == b1 + 5
    assert torch.isfinite(m["loss"]) and bool(torch.isfinite(st.theta["float32"]).all())
    assert int(st.proto.wire_dropped) >= 0 and st.proto.wire_corrupt is not None


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["none", "q8"])
def test_sim_corrupt_wire_detects_every_corruption(cuda, codec):
    """Under corrupt 0.5 with every gate open, each step's wire_corrupt
    increment is exactly the number of corrupted rows."""
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import FaultConfig, ProtocolConfig
    from repro_torch.faults.models import SALT_CORRUPT, bernoulli_np
    from repro_torch.models import simple
    import numpy as np

    def loss_fn(p, x, y):
        return simple.xent_loss(simple.mlp_logits(p, x), y)

    tr = GossipTrainer(protocol=ProtocolConfig(comm_probability=1.0, topology="uniform"),
                       codec=codec, loss_fn=loss_fn, num_workers=4, device=cuda,
                       faults=FaultConfig(fault_model="corrupt", fault_rate=0.5, seed=9),
                       init_fn=lambda g: simple.init_mlp(g, 784, 64, 2, 10)[0])
    st = tr.init_state(0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 16, 784, generator=gen, device=cuda)
    y = torch.randint(0, 10, (4, 16), generator=gen, device=cuda)
    want = 0
    for step in range(6):
        st, m = tr.step(st, (x, y))
        want += int(bernoulli_np(9, np.arange(4), step, 0.5, SALT_CORRUPT).sum())
    assert int(st.proto.wire_corrupt) == want > 0
    assert int(st.proto.comm_units) == 6 * 4 - want
    assert bool(torch.isfinite(st.theta["float32"]).all())


# ---------------------------------------------------------------------------
# B2 and B3: byte-equal to their plain versions; the dist engine on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("W,n", [(8, 35968 * 3), (4, 1000), (3, 1001), (1, 1)])
@pytest.mark.parametrize("dkind", sorted(DTYPES))
@pytest.mark.parametrize("scalars", ["python", "tensor"])
def test_b2_matches_plain_version_byte_for_byte(cuda, W, n, dkind, scalars):
    tdt, vdt = DTYPES[dkind]
    t, _, v, g, _ = _inputs(W, n, tdt, vdt, cuda, seed=5)
    eta, mu = ((0.01, 0.9) if scalars == "python"
               else (torch.full((), 0.01, device=cuda), torch.full((), 0.9, device=cuda)))
    want_t, want_v = tref.fused_flat_nag_update(t, v, g, eta, mu)
    kt, kv = t.clone(), v.clone()
    ptr = (kt.data_ptr(), kv.data_ptr())
    launches = tfu.NAG_LAUNCHES
    out = ops.fused_flat_nag_update(kt, kv, g, eta, mu)
    torch.cuda.synchronize()
    assert tfu.NAG_LAUNCHES == launches + 1
    assert (out[0].data_ptr(), out[1].data_ptr()) == ptr
    assert torch.equal(_bits(kt), _bits(want_t)) and torch.equal(_bits(kv), _bits(want_v))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1024, 1000), (33, 65), (4, 7, 130), (1,)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_b3_matches_plain_version_byte_for_byte(cuda, shape, tdt):
    g = torch.Generator(device=cuda).manual_seed(6)
    t, p, v, gr = (torch.randn(*shape, generator=g, device=cuda).to(tdt) for _ in range(4))
    before = [x.clone() for x in (t, p, v, gr)]
    coef = torch.full((), 0.5, device=cuda)
    want_t, want_v = tref.fused_elastic_nag_update(t, p, v, gr, coef, eta=0.01, mu=0.9)
    launches = tfu.ARRAY_LAUNCHES
    got_t, got_v = ops.fused_elastic_nag_update(t, p, v, gr, coef, eta=0.01, mu=0.9)
    torch.cuda.synchronize()
    assert tfu.ARRAY_LAUNCHES == launches + 1
    assert got_t.shape == shape and got_v.shape == shape
    assert torch.equal(_bits(got_t), _bits(want_t)) and torch.equal(_bits(got_v), _bits(want_v))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(before, (t, p, v, gr)))


@pytest.mark.cuda
def test_b2_b3_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    t = torch.zeros((2, 256), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tfu.fused_flat_nag_update(t.T.contiguous().T, t, t, 0.1, 0.9)
    with pytest.raises(ValueError, match="share"):
        tfu.fused_flat_nag_update(t, t, t.double(), 0.1, 0.9)
    with pytest.raises(ValueError, match="v must be"):
        tfu.fused_flat_nag_update(t, t.bfloat16(), t, 0.1, 0.9)
    with pytest.raises(ValueError, match="one shape"):
        tfu.fused_elastic_nag_update(t, t[:1], t, t, 0.5, eta=0.1, mu=0.9)
    with pytest.raises(ValueError, match="scalar"):
        tfu.fused_elastic_nag_update(t, t, t, t, torch.ones(2, device=cuda), eta=0.1, mu=0.9)


@pytest.mark.cuda
def test_dist_engine_on_the_card_launches_b1_and_b2(cuda, tmp_path):
    """2 ranks on this card: B1 once per firing step, B2 once per other
    step on each rank; one send and one recv per firing step; the two
    ranks report one fleet-mean loss."""
    import numpy as np
    from repro_torch.common.config import MeshConfig
    from repro_torch.kernels import build
    from repro_torch.launch import dist_run
    from repro_torch.models import simple
    build.build("fused_update")      # the ranks only load it
    gen = torch.Generator().manual_seed(0)
    params = {k: v.numpy() for k, v in simple.init_mlp(gen, 784, 64, 2, 10)[0].items()}
    rng = np.random.RandomState(0)
    steps = 12
    job = dict(params=params, x=rng.rand(steps, 2, 8, 784).astype(np.float32),
               y=rng.randint(0, 10, (steps, 2, 8)).astype(np.int64),
               runs=[dict(kind="train", tag="eg", steps=steps, seed=1,
                          protocol=dict(method="elastic_gossip", comm_probability=0.3,
                                        moving_rate=0.5),
                          optimizer=dict(name="nag", learning_rate=0.01, momentum=0.9))])
    res = dist_run.run_fleet(MeshConfig(data=2, model=1, pods=1, workers_per_pod=2), "cuda",
                             job, timeout_s=60, join_timeout_s=300,
                             rendezvous_dir=str(tmp_path))
    runs = [r["runs"][0] for r in res]
    fired = sum(runs[0]["fired"])
    assert 0 < fired < steps
    for run in runs:
        assert run["fired"] == runs[0]["fired"] and run["loss"] == runs[0]["loss"]
        assert run["launches"]["fused_flat_elastic_nag_update"] == fired
        assert run["launches"]["fused_flat_nag_update"] == steps - fired
        assert run["sends"] == run["recvs"] == fired
        assert len(run["exchanges"]) == fired
        assert all(np.isfinite(run["loss"]))


# ---------------------------------------------------------------------------
# B9: flash attention
# ---------------------------------------------------------------------------

# as the reference's own kernel tests (tests/test_kernels.py): f32 sums in
# another order, bf16 one rounding of the output
ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _qkv(B, Sq, Skv, H, Hkv, hd, dt, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dt),
            torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).to(dt),
            torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).to(dt))


def _check_b9(q, k, v, form=None, **kw):
    want = tref.attention(q, k, v, causal=kw.get("causal", True), window=kw.get("window", 0),
                          logit_softcap=kw.get("softcap", 0.0),
                          q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"),
                          kv_start=kw.get("kv_start"))
    n = tfa.LAUNCHES
    forms = dict(tfa.FORM_LAUNCHES)
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES == n + 1
    if form is not None:
        assert tfa.FORM_LAUNCHES[form] == forms[form] + 1, tfa.FORM_LAUNCHES
    tol = ATOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("hd", [8, 64, 128, 256])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_causal_prefill_matches_plain_version(cuda, G, hd, dt):
    q, k, v = _qkv(2, 77, 77, 2 * G, 2, hd, dt, cuda, seed=G + hd)
    _check_b9(q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scalar", ["int", "device"])
def test_b9_q_offset_is_the_suffix_of_full_attention(cuda, dt, scalar):
    q, k, v = _qkv(1, 96, 96, 8, 2, 64, dt, cuda, seed=8)
    off = 61
    full = ops.attention(q, k, v, causal=True)
    qo = off if scalar == "int" else torch.tensor(off, dtype=torch.int32, device=cuda)
    got = _check_b9(q[:, off:], k, v, causal=True, q_offset=qo)
    tol = ATOL[dt]
    torch.testing.assert_close(got.float(), full[:, off:].float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [1, 100, 256])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_decode_with_device_kv_len(cuda, kv_len, dt):
    q, k, v = _qkv(2, 1, 256, 32, 4, 64, dt, cuda, seed=5)
    _check_b9(q, k, v, causal=False,
              kv_len=torch.tensor(kv_len, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 7, 33, 4096])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_sliding_window(cuda, window, dt):
    q, k, v = _qkv(1, 130, 130, 4, 2, 64, dt, cuda, seed=window)
    _check_b9(q, k, v, causal=True, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [10.0, 50.0])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_softcap(cuda, softcap, dt):
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, dt, cuda, seed=3)
    _check_b9(q, k, v, causal=True, softcap=softcap)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_kv_start_hides_garbage_exactly(cuda, dt):
    """Keys below kv_start[b] contribute exactly nothing: a cache whose
    early rows hold garbage (inf and NaN included) gives the same bits as
    one with those rows zeroed."""
    B, L, pos = 4, 128, 70
    q, k, v = _qkv(B, 1, L, 32, 4, 64, dt, cuda, seed=11)
    start = torch.tensor([70, 3, 0, 41], dtype=torch.int32, device=cuda)
    rows = torch.arange(L, device=cuda)[None, :, None, None]
    below = rows < start.reshape(B, 1, 1, 1)
    kz, vz = k.masked_fill(below, 0), v.masked_fill(below, 0)
    kg, vg = k.clone(), v.clone()
    kg[0, :70] = float("nan")
    vg[0, :70] = float("inf")
    vg[1, :3] = float("nan")
    kw = dict(causal=True, q_offset=torch.tensor(pos, dtype=torch.int32, device=cuda),
              kv_len=torch.tensor(pos + 1, dtype=torch.int32, device=cuda), kv_start=start)
    a = _check_b9(q, kz, vz, **kw)
    b = ops.attention(q, kg, vg, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dt == torch.bfloat16 else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_reads_a_strided_cache_slice_and_bhsd_views(cuda, dt):
    """A layer's view of the stacked [count, B, max_len, Hkv, hd] cache,
    sliced to its live rows, goes in through its strides; the BHSD op
    gives the same as the BSHD one."""
    g = torch.Generator(device=cuda).manual_seed(4)
    cache = torch.randn(3, 2, 200, 4, 64, generator=g, device=cuda).to(dt)
    q = torch.randn(2, 5, 16, 64, generator=g, device=cuda).to(dt)
    k, v = cache[1, :, :150], cache[2, :, :150]
    assert not k.is_contiguous()
    got = _check_b9(q, k, v, causal=True, q_offset=145)
    bhsd = ops.flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True, q_offset=145)
    torch.cuda.synchronize()
    assert torch.equal(bhsd.transpose(1, 2), got)


def _bf16_bound(got, want):
    """bf16 outputs also within 2^-6 of the case's max |plain| (two to four
    bf16 ulps at the largest output), as chip_smoke.py holds them."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -6 * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [77, 513])
@pytest.mark.parametrize("G", [1, 8])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_prefill_off_the_tile_grid(cuda, Sq, G, dt):
    """Query counts that are not a multiple of the 128-row tile, through the
    wgmma form (bf16) and the simt form (f32)."""
    q, k, v = _qkv(2, Sq, Sq, 4 * G, 4, 64, dt, cuda, seed=Sq + G)
    got = _check_b9(q, k, v, form="wgmma" if dt == torch.bfloat16 else "simt", causal=True)
    if dt == torch.bfloat16:
        _bf16_bound(got, tref.attention(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_mqa_at_granite_shape(cuda, dt):
    """G = 48 query heads on one kv head at hd 128 (granite-20b's attention)."""
    q, k, v = _qkv(2, 100, 100, 48, 1, 128, dt, cuda, seed=48)
    _check_b9(q, k, v, form="wgmma" if dt == torch.bfloat16 else "simt", causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [7, 100])
def test_b9_mma_hd256_with_window_and_softcap(cuda, window):
    """Gemma2's hd 256 with a window and softcap, in bf16: the wgmma form
    since it took hd 256 over from the mma form (the name is the test's
    first)."""
    q, k, v = _qkv(1, 200, 200, 4, 2, 256, torch.bfloat16, cuda, seed=window)
    got = _check_b9(q, k, v, form="wgmma", causal=True, window=window, softcap=50.0)
    _bf16_bound(got, tref.attention(q, k, v, causal=True, window=window, logit_softcap=50.0))


# the wgmma form's cases: (B, Sq, H, Skv, Hkv, kwargs); "device scalars" is
# a 90-query suffix at q_offset 210 over 290 live rows of a 320-row cache,
# both scalars on the card; the layouts and garbage cases are built in the test
WGMMA_CASES = {
    "causal G 1 Sq 17": (2, 17, 2, 17, 2, dict(causal=True)),
    "causal G 4 Sq 127": (2, 127, 8, 127, 2, dict(causal=True)),
    "causal G 8 Sq 129": (2, 129, 16, 129, 2, dict(causal=True)),
    "causal G 48 Sq 300": (1, 300, 48, 300, 1, dict(causal=True)),
    "cross Sq 300 over 1601": (2, 300, 8, 1601, 2, dict(causal=False)),
    "window 100 softcap 50": (1, 300, 8, 300, 2, dict(causal=True, window=100, softcap=50.0)),
    "device scalars": (2, 90, 8, 320, 2, None),
    "strided cache slice": (2, 60, 16, 330, 4, None),
    "bhsd views": (2, 129, 8, 129, 2, None),
    "garbage outside [kv_start, kv_len)": (4, 100, 32, 320, 4, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
@pytest.mark.parametrize("hd", [64, 80, 128, 256])
def test_b9_wgmma_form_matches_plain_version(cuda, hd, case):
    """The wgmma form (bf16, values as wide as the keys) against the plain
    version at every head dim it takes: G 1 / 4 / 8 / 48, query counts off
    the 128-row item, a cross prefill over 1601 keys (a partial last tile),
    window and softcap, q_offset and kv_len as device scalars, a strided
    slice of a stacked cache, BHSD views, and NaN / inf below kv_start and
    past kv_len giving the bits of zeroed rows; 3e-2, and 2^-6 of the
    largest |plain|."""
    B, Sq, H, Skv, Hkv, kw = WGMMA_CASES[case]
    bf = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(hd + 7)
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=cuda))
    if case == "strided cache slice":
        cache = torch.randn(3, B, 400, Hkv, hd, generator=g, device=cuda).to(bf)
        q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(bf)
        k, v, kw = cache[1, :, :Skv], cache[2, :, :Skv], dict(causal=True, q_offset=i32(270))
        assert not k.is_contiguous()
    elif case == "bhsd views":
        q, k, v = (torch.randn(B, n, S, hd, generator=g, device=cuda).to(bf).transpose(1, 2)
                   for n, S in ((H, Sq), (Hkv, Skv), (Hkv, Skv)))
        kw = dict(causal=True)
    else:
        q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(bf)
        k, v = (torch.randn(B, Skv, Hkv, hd, generator=g, device=cuda).to(bf) for _ in range(2))
    if case == "device scalars":
        kw = dict(causal=True, q_offset=i32(210), kv_len=i32(290))
        q = q[:, :80]
    if case.startswith("garbage"):
        start = i32([150, 3, 0, 199])
        rows = torch.arange(Skv, device=cuda)[None, :, None, None]
        bad = (rows < start.reshape(B, 1, 1, 1)) | (rows >= 290)
        kw = dict(causal=True, q_offset=i32(200), kv_len=i32(290), kv_start=start)
        k, v = k.masked_fill(bad, 0), v.masked_fill(bad, 0)
    assert tfa._form(bf, B, q.shape[1], H, Hkv, hd, Skv, hd) == "wgmma"
    got = _check_b9(q, k, v, form="wgmma", **kw)
    _bf16_bound(got, tref.attention(q, k, v, causal=kw["causal"], window=kw.get("window", 0),
                                    logit_softcap=kw.get("softcap", 0.0),
                                    q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"),
                                    kv_start=kw.get("kv_start")))
    if case.startswith("garbage"):
        bad_out = ops.attention(q, k.masked_fill(bad, float("nan")),
                                v.masked_fill(bad, float("inf")), **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), bad_out.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 63, 64, 65, 513, 1024])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_split_decode_around_the_split_size(cuda, kv_len, dt):
    """Decode over a [8, 1024, 4, 64] cache: kv_len on and around the
    32-row splits, causal at pos = kv_len - 1, through the split form."""
    q, k, v = _qkv(8, 1, 1024, 32, 4, 64, dt, cuda, seed=kv_len)
    pos = torch.tensor(kv_len - 1, dtype=torch.int32, device=cuda)
    _check_b9(q, k, v, form="split", causal=True, q_offset=pos, kv_len=pos + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_split_kv_start_leaves_whole_splits_empty(cuda, dt):
    """kv_start rows that leave the first 2 to 31 splits without a visible key."""
    q, k, v = _qkv(4, 1, 1024, 32, 4, 64, dt, cuda, seed=17)
    start = torch.tensor([700, 64, 0, 1000], dtype=torch.int32, device=cuda)
    pos = torch.tensor(1000, dtype=torch.int32, device=cuda)
    _check_b9(q, k, v, form="split", causal=True, q_offset=pos, kv_len=pos + 1, kv_start=start)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["wgmma", "mma", "simt", "split"])
def test_b9_garbage_below_kv_start_is_invisible_in_every_form(cuda, form):
    """NaN and inf below kv_start give the bits of zeroed rows, in each form:
    a prefill-shaped suffix (q_offset 200, 100 queries) in bf16 (wgmma; mma
    at MLA's 576-wide keys over their 512-wide prefix) and f32 (simt), and a
    decode in bf16 (split)."""
    dt = torch.float32 if form == "simt" else torch.bfloat16
    Sq = 1 if form == "split" else 100
    B, L, off = 4, 320, 200
    if form == "mma":
        g = torch.Generator(device=cuda).manual_seed(23)
        q = torch.randn(B, Sq, 16, 576, generator=g, device=cuda).to(dt)
        k = torch.randn(B, L, 1, 576, generator=g, device=cuda).to(dt)
        values = (lambda kk, vv: kk[..., :512])
    else:
        q, k, v = _qkv(B, Sq, L, 32, 4, 64, dt, cuda, seed=23)
        values = (lambda kk, vv: vv)
    start = torch.tensor([150, 3, 0, 199], dtype=torch.int32, device=cuda)
    below = torch.arange(L, device=cuda)[None, :, None, None] < start.reshape(B, 1, 1, 1)
    kz, kg = k.masked_fill(below, 0), k.masked_fill(below, float("nan"))
    vz = values(kz, None if form == "mma" else v.masked_fill(below, 0))
    vg = values(kg, None if form == "mma" else v.masked_fill(below, float("inf")))
    qo = torch.tensor(off, dtype=torch.int32, device=cuda)
    kw = dict(causal=True, q_offset=qo, kv_len=qo + Sq, kv_start=start)
    a = _check_b9(q, kz, vz, form=form, **kw)
    b = ops.attention(q, kg, vg, **kw)
    torch.cuda.synchronize()
    bits = torch.int16 if dt == torch.bfloat16 else torch.int32
    assert torch.equal(a.view(bits), b.view(bits))


@pytest.mark.cuda
def test_b9_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(1, 4, 4, 2, 1, 12, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        tfa.flash_attention(q, k, v)
    q, k, v = _qkv(1, 4, 4, 2, 1, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q.cpu(), k, v)
    with pytest.raises(ValueError, match="value width"):
        tfa.flash_attention(q, k, torch.cat([v, v], dim=-1))
    with pytest.raises(ValueError, match="contiguous head dim"):
        tfa.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3), v)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_attention(q[:, :, :1].expand(1, 4, 3, 16).contiguous(),
                            k.expand(1, 4, 2, 16).contiguous(), v.expand(1, 4, 2, 16).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode 0", "decode 511", "decode 1023", "decode kv_start",
                                  "prefill", "prefill 77"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_kind", ["prefix view of k", "own tensor"])
def test_b9_at_mla_shapes_matches_plain_version(cuda, case, dt, v_kind):
    """DeepSeek-V2-Lite's absorbed MLA: 16 query heads of 576 over one kv
    head of 576-wide keys and 512-wide values, the values either the view
    kk[..., :512] (the kernel reads them from its key tiles) or a tensor of
    their own; decode over an [8, 1024] cache (the split form), prefill 8 x
    512 and 77 rows (bf16 over the prefix view: the mma form's MLA kernel;
    f32, or values of their own: the simt form); bf16 also within 2^-6 of
    the largest |plain|."""
    g = torch.Generator(device=cuda).manual_seed(41)
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=cuda))
    Skv = 1024 if case.startswith("decode") else (77 if case == "prefill 77" else 512)
    B = 2 if case == "prefill 77" else 8
    kk = torch.randn(B, Skv, 1, 576, generator=g, device=cuda).to(dt)
    v = kk[..., :512] if v_kind == "prefix view of k" else \
        torch.randn(B, Skv, 1, 512, generator=g, device=cuda).to(dt)
    if case.startswith("decode"):
        q = torch.randn(B, 1, 16, 576, generator=g, device=cuda).to(dt)
        pos = 700 if case == "decode kv_start" else int(case.split()[1])
        kw = dict(causal=True, q_offset=i32(pos), kv_len=i32(pos + 1))
        if case == "decode kv_start":
            kw["kv_start"] = i32([0, 5, 100, 700, 3, 600, 32, 64])
        form = "split"
    else:
        q = torch.randn(B, Skv, 16, 576, generator=g, device=cuda).to(dt)
        kw = dict(causal=True)
        form = "mma" if dt == torch.bfloat16 and v_kind == "prefix view of k" else "simt"
    got = _check_b9(q, kk, v, form=form, **kw)
    assert got.shape == (B, q.shape[1], 16, 512)
    if dt == torch.bfloat16:
        _bf16_bound(got, tref.attention(q, kk, v, causal=True, q_offset=kw.get("q_offset", 0),
                                        kv_len=kw.get("kv_len"), kv_start=kw.get("kv_start")))


# B9's tensor-core forms new at these shapes: (H, Hkv, hd, dv); MLA's values
# are the keys' 512-wide prefix (G = 16 whole, 8 on a tensor-parallel rank),
# head dim 80 is Zamba2's (G = 1) and a GQA twin (G = 4)
TC_SHAPES = {"MLA G 16": (16, 1, 576, 512), "MLA G 8": (8, 1, 576, 512),
             "hd 80 G 1": (32, 32, 80, 80), "hd 80 G 4": (16, 4, 80, 80)}
# (Sq, Skv, causal): 128 query positions (a whole number of every shape's
# row blocks) over 100 keys, which end inside a 32- and a 64-key tile; 77
# positions, a multiple of no row block; a 60-query suffix at q_offset 200;
# an 80-query suffix at 200 over 280 live rows whose first kv_start[b] hold
# NaN and inf
TC_CASES = {"partial key tile": (128, 100, False), "rows off the block": (77, 77, True),
            "q_offset": (60, 260, True), "garbage below kv_start": (80, 300, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TC_CASES))
@pytest.mark.parametrize("shape", sorted(TC_SHAPES))
def test_b9_tensor_core_forms_at_mla_and_hd80_match_plain_version(cuda, shape, case):
    """The tensor-core forms at MLA's 576 / 512 (mma) and at head dim 80
    (wgmma) against the plain version (3e-2, and 2^-6 of the largest
    |plain|); garbage below kv_start gives the bits of zeroed rows."""
    H, Hkv, hd, dv = TC_SHAPES[shape]
    Sq, Skv, causal = TC_CASES[case]
    B = 2
    g = torch.Generator(device=cuda).manual_seed(71)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn(B, Skv, Hkv, hd, generator=g, device=cuda).to(torch.bfloat16)
    own = None if dv < hd else torch.randn(B, Skv, Hkv, dv, generator=g,
                                           device=cuda).to(torch.bfloat16)
    values = (lambda kk, vv: kk[..., :dv]) if own is None else (lambda kk, vv: vv)
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=cuda))
    kw = dict(causal=causal)
    if Skv > Sq and causal:
        kw["q_offset"] = i32(200)
    if case == "garbage below kv_start":
        kw.update(kv_len=i32(280), kv_start=i32([150, 3]))
        below = (torch.arange(Skv, device=cuda)[None, :, None, None]
                 < kw["kv_start"].reshape(B, 1, 1, 1))
        k = k.masked_fill(below, 0)
        own = None if own is None else own.masked_fill(below, 0)
    v = values(k, own)
    form = "mma" if dv < hd else "wgmma"
    assert tfa._form(q.dtype, B, Sq, H, Hkv, hd, Skv, dv, tfa._v_in_k(k, v)) == form
    got = _check_b9(q, k, v, form=form, **kw)
    _bf16_bound(got, tref.attention(q, k, v, causal=causal, q_offset=kw.get("q_offset", 0),
                                    kv_len=kw.get("kv_len"), kv_start=kw.get("kv_start")))
    if case == "garbage below kv_start":
        kg = k.masked_fill(below, float("nan"))
        vg = values(kg, None if own is None else own.masked_fill(below, float("inf")))
        bad = ops.attention(q, kg, vg, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), bad.view(torch.int16))


@pytest.mark.cuda
def test_reduced_deepseek_through_the_batcher_launches_b9_once_per_layer(cuda):
    """Reduced DeepSeek (MLA + MoE) on the card through the continuous
    batcher: B9 once per layer and boundary, the batcher's invariants, and
    the completed streams equal to a run through B9's plain version."""
    from unittest import mock
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tr
    from repro_torch.serve import ContinuousBatcher, LiveServer, SnapshotBus, TrafficGen
    from repro_torch.serving.engine import make_serve_program
    cfg = get_reduced("deepseek_v2_lite_16b")
    prog = make_serve_program(cfg, batch=4, max_len=48, param_dtype=torch.float32,
                              cache_dtype=torch.float32, device=cuda)
    bus = SnapshotBus()
    bus.publish_params(tr.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)[0])
    kw = dict(rate=0.8, num_requests=10, vocab=cfg.vocab_size, prompt_len=(1, 3),
              max_new=(2, 5))

    def run():
        server = LiveServer(prog, bus)
        assert server.maybe_swap()
        bat = ContinuousBatcher(server, TrafficGen(11, **kw).requests())
        bat.run(46)
        bat.check_invariants()
        return bat

    ops.zero_launch_counts()
    bat = run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers * bat.boundaries_run
    assert bat.latency_summary()["completed"] == bat.admitted > prog.batch
    with mock.patch.object(ops, "attention", _plain_attention):
        want = run()
    assert bat.completed == want.completed


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "gemma2_9b"])
def test_serve_path_launches_b9_once_per_layer(cuda, arch):
    """Reduced configs on the card: prefill and every decode step launch B9
    once per layer, and the logits match the plain version's run."""
    from unittest import mock
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tr
    from repro_torch.serving.engine import make_serve_program
    cfg = get_reduced(arch)
    params = tr.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)[0]
    prog = make_serve_program(cfg, batch=2, max_len=40, param_dtype=torch.float32,
                              cache_dtype=torch.float32, with_prefill=True, device=cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda, dtype=torch.int32,
                         generator=torch.Generator(device=cuda).manual_seed(1))

    def run():
        out = []
        logits, cache = prog.prefill_fn(params, toks)
        out.append(logits)
        for t in range(4):
            logits, cache = prog.decode_fn(params, cache, toks[:, t:t + 1])
            out.append(logits)
        return torch.stack(out)

    ops.zero_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 5 * cfg.num_layers
    with mock.patch.object(ops, "attention", _plain_attention):
        want = run()
    assert ops.launch_counts()["flash_attention"] == 5 * cfg.num_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _plain_attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
                     kv_len=None, kv_start=None):
    return tref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap,
                          q_offset=q_offset, kv_len=kv_len, kv_start=kv_start)


# ---------------------------------------------------------------------------
# the CIFAR CNN and checkpoints on the card
# ---------------------------------------------------------------------------

def _cnn_trainer(dev, method="elastic_gossip", width=8, W=4):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple

    def loss(p, x, y):
        return simple.xent_loss(simple.cnn_logits(p, x), y)

    return GossipTrainer(protocol=ProtocolConfig(method=method, comm_probability=0.5,
                                                 topology="uniform"),
                         optimizer=OptimizerConfig(name="nag", learning_rate=0.01, momentum=0.9),
                         loss_fn=loss, num_workers=W, device=dev,
                         init_fn=lambda g: simple.init_cnn(g, width=width)[0])


def _cnn_batches(dev, W=4, B=8, steps=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(W, B, 32, 32, 3, generator=g).to(dev),
             torch.randint(0, 10, (W, B), generator=g).to(dev)) for _ in range(steps)]


@pytest.mark.cuda
def test_cnn_step_on_the_card_matches_the_cpu_with_tf32_allowed(cuda):
    """The process allows TF32 (cuDNN's default, and matmuls too), but the
    engine's step runs under full_f32: five CNN steps on the card and on
    the CPU, each from the card's params and velocity, on the same draws,
    gradients within rtol 1e-4 / atol 1e-6 and params within rtol 1e-5 /
    atol 1e-6 at every step. The same
    gradient computed without the context, under TF32, falls outside (so
    the check can see TF32). B1 launches once a step."""
    from torch.func import grad_and_value, vmap
    from repro_torch.core import topology
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        card, cpu = _cnn_trainer(cuda), _cnn_trainer("cpu")
        s_card = card.init_state(0)
        s_cpu = cpu.init_state(0, params={k: v[0].cpu() for k, v in s_card.params.items()})
        gen = torch.Generator().manual_seed(3)
        ops.zero_launch_counts()
        for i, (x, y) in enumerate(_cnn_batches(cuda)):
            draws = (topology.participation(gen, 4, 0.5), topology.sample_uniform_peers(gen, 4))
            # every step from the card's state: a state an ulp away may
            # cross a ReLU boundary the other does not
            s_cpu.theta["float32"].copy_(s_card.theta["float32"].cpu())
            s_cpu.opt.mu["float32"].copy_(s_card.opt.mu["float32"].cpu())
            _, g_card = card.sim._grads(s_card, x, y)
            _, g_cpu = cpu.sim._grads(s_cpu, x.cpu(), y.cpu())
            torch.testing.assert_close(g_card["float32"].cpu(), g_cpu["float32"],
                                       rtol=1e-4, atol=1e-6)
            if i == 0:
                row = s_card.spec.with_lead(())
                raw, _ = vmap(grad_and_value(lambda b, xi, yi: card.sim.loss_fn(
                    row.views(b), xi, yi)))(s_card.theta, x, y)
                with pytest.raises(AssertionError):
                    torch.testing.assert_close(raw["float32"].cpu(), g_cpu["float32"],
                                               rtol=1e-4, atol=1e-6)
            s_card, _ = card.step(s_card, (x, y), draws=(draws[0].to(cuda), draws[1].to(cuda)))
            s_cpu, _ = cpu.step(s_cpu, (x.cpu(), y.cpu()), draws=draws)
            torch.testing.assert_close(s_card.theta["float32"].cpu(), s_cpu.theta["float32"],
                                       rtol=1e-5, atol=1e-6)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_flat_elastic_nag_update"] == 5
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _mlp_ckpt_trainer(dev, codec):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import OptimizerConfig, ProtocolConfig
    from repro_torch.models import simple
    return GossipTrainer(protocol=ProtocolConfig(comm_probability=0.5, topology="uniform"),
                         optimizer=OptimizerConfig(learning_rate=1e-2, momentum=0.9),
                         loss_fn=lambda p, x, y: simple.xent_loss(simple.mlp_logits(p, x), y),
                         num_workers=4, device=dev, codec=codec,
                         init_fn=lambda g: simple.init_mlp(g, 784, 64, 2, 10)[0])


def _resume_is_exact(tr, make, batches, tmp_path):
    """Steps, save, more steps; a fresh trainer loads and repeats the second
    half: the loaded and the final entries must equal bit for bit."""
    from repro_torch.checkpoint import io
    half = len(batches) // 2
    st = tr.init_state(0)
    for xy in batches[:half]:
        st, _ = tr.step(st, xy)
    path = str(tmp_path / "ck.npz")
    tr.save_checkpoint(path, st)
    saved = io.entries(st.state_dict())
    for xy in batches[half:]:
        st, _ = tr.step(st, xy)
    tr2 = make()
    st2, _ = tr2.load_checkpoint(path, tr2.init_state(1))
    loaded = io.entries(st2.state_dict())
    for xy in batches[half:]:
        st2, _ = tr2.step(st2, xy)
    a, b = io.entries(st.state_dict()), io.entries(st2.state_dict())
    for k in saved:
        assert loaded[k].tobytes() == saved[k].tobytes(), k
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert "torch_key::cuda" in saved
    return path, st2


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "topk"])
def test_checkpoint_resume_on_the_card_is_bit_exact(cuda, codec, tmp_path):
    """MLP on the card (B1, with top-k also B6 and B7): a resume continues
    the uninterrupted run bit for bit, the generator's CUDA state included.
    The same file loaded on the CPU reseeds its generator from key and step."""
    from repro_torch.api.state import generator_from_key
    from repro_torch.checkpoint import io
    g = torch.Generator().manual_seed(0)
    batches = [(torch.randn(4, 16, 784, generator=g).to(cuda),
                torch.randint(0, 10, (4, 16), generator=g).to(cuda)) for _ in range(8)]
    path, _ = _resume_is_exact(_mlp_ckpt_trainer(cuda, codec),
                               lambda: _mlp_ckpt_trainer(cuda, codec), batches, tmp_path)
    cpu = _mlp_ckpt_trainer("cpu", codec)
    on_cpu, _ = cpu.load_checkpoint(path, cpu.init_state(1))
    payload = io.load_payload(path)
    want = generator_from_key(payload["key"], int(payload["step"]), "cpu")
    assert torch.equal(on_cpu.key.get_state(), want.get_state())
    assert on_cpu.theta["float32"].device.type == "cpu"
    assert np.array_equal(on_cpu.theta["float32"].numpy(), payload["theta::float32"])


@pytest.mark.cuda
def test_cnn_resume_on_the_card_is_bit_exact(cuda, tmp_path):
    """cuDNN runs deterministic algorithms inside the engine's gradient, so
    a CNN resume repeats the uninterrupted run bit for bit."""
    _resume_is_exact(_cnn_trainer(cuda), lambda: _cnn_trainer(cuda),
                     _cnn_batches(cuda, steps=6), tmp_path)


# ---------------------------------------------------------------------------
# slice 4a: B1 on a row list, B8 on column chunks, the async engine
# ---------------------------------------------------------------------------

B1_ROWS = {"empty": [], "one": [5], "all": list(range(8)), "unsorted": [6, 1, 3, 0]}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", sorted(B1_ROWS))
@pytest.mark.parametrize("dkind", sorted(DTYPES))
@pytest.mark.parametrize("n", [1000, 35968 * 3 + 5])
def test_b1_row_list_is_byte_equal_to_plain_version(cuda, rows, dkind, n):
    """B1 on a row list: the listed rows byte-equal to the plain version,
    every other row of theta and v left with its bits, one launch (none for
    an empty list); all rows listed equals the whole-plane launch."""
    tdt, vdt = DTYPES[dkind]
    t, p, v, g, coef = _inputs(8, n, tdt, vdt, cuda, seed=len(rows))
    eta = torch.full((), 0.01, device=cuda)
    r = torch.tensor(B1_ROWS[rows], dtype=torch.int32, device=cuda)
    want_t, want_v = tref.fused_flat_elastic_nag_update(t, p, v, g, coef, eta, 0.9, rows=r)
    kt, kv = t.clone(), v.clone()
    launches = tfu.LAUNCHES
    out = tfu.fused_flat_elastic_nag_update(kt, p, kv, g, coef, eta, 0.9, rows=r)
    torch.cuda.synchronize()
    assert out[0] is kt and out[1] is kv
    assert tfu.LAUNCHES == launches + (1 if B1_ROWS[rows] else 0)
    assert torch.equal(_bits(kt), _bits(want_t)) and torch.equal(_bits(kv), _bits(want_v))
    if rows == "all":
        wt, wv = t.clone(), v.clone()
        tfu.fused_flat_elastic_nag_update(wt, p, wv, g, coef, eta, 0.9)
        assert torch.equal(_bits(wt), _bits(kt)) and torch.equal(_bits(wv), _bits(kv))
    with pytest.raises(ValueError, match="int32"):
        tfu.fused_flat_elastic_nag_update(kt, p, kv, g, coef, eta, 0.9, rows=r.long())


@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi", [(0, 364176), (364176, 728352), (364177, 728353),
                                   (1, 1001), (2913404, 2913408)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_b8_on_column_chunks_is_byte_equal_to_plain_version(cuda, lo, hi, tdt):
    """B8 on the column chunk ``x[:, lo:hi]`` of a [8, 2913408] plane (row
    stride 2913408), written into the same chunk of an output plane: byte-
    equal to the plain version, at offsets that are (16-byte loads) and are
    not (scalar loads) multiples of four; the other columns are untouched."""
    g = torch.Generator(device=cuda).manual_seed(lo)
    x = torch.randn(8, 2913408, generator=g, device=cuda).to(tdt)
    d = 3 * torch.randn(8, hi - lo, generator=g, device=cuda)
    scale = torch.rand(8, generator=g, device=cuda)
    thr = 0.5 + torch.rand(8, generator=g, device=cuda)
    out = torch.zeros(8, 2913408, device=cuda, dtype=tdt)
    launches = trobust.LAUNCHES
    got = ops.robust_flat_apply(x[:, lo:hi], d, scale, thr, out=out[:, lo:hi])
    torch.cuda.synchronize()
    assert trobust.LAUNCHES == launches + 1 and got.data_ptr() == out[:, lo:hi].data_ptr()
    want = tref.robust_flat_apply(x[:, lo:hi], d, scale, thr)
    assert torch.equal(_bits(out[:, lo:hi]), _bits(want))
    assert not bool(out[:, :lo].any()) and not bool(out[:, hi:].any())


def _async_trainer(cuda, W=4, **kw):
    from repro_torch.api import GossipTrainer
    from repro_torch.common.config import HeteroConfig, ProtocolConfig
    from repro_torch.models import simple

    def loss_fn(p, x, y):
        return simple.xent_loss(simple.mlp_logits(p, x), y)
    proto = kw.pop("proto", {})
    return GossipTrainer(engine=kw.pop("engine", "async"),
                         protocol=ProtocolConfig(**dict(dict(comm_probability=0.5,
                                                             topology="uniform"), **proto)),
                         loss_fn=loss_fn, num_workers=W, device=cuda,
                         hetero=kw.pop("hetero", HeteroConfig(time_model="lognormal", sigma=0.6)),
                         init_fn=lambda g: simple.init_mlp(g, 784, 64, 2, 10)[0], **kw)


def _batch(cuda, W):
    gen = torch.Generator(device=cuda).manual_seed(1)
    return (torch.randn(W, 16, 784, generator=gen, device=cuda),
            torch.randint(0, 10, (W, 16), generator=gen, device=cuda))


@pytest.mark.cuda
def test_async_windows_launch_b1_once_each_on_the_window_rows(cuda):
    """Lognormal windows at W=4: B1 once a window, partial windows among
    them; rows outside a window keep their bits."""
    tr = _async_trainer(cuda)
    st = tr.init_state(0)
    xb = _batch(cuda, 4)
    launches, partial = tfu.LAUNCHES, 0
    for _ in range(12):
        before = st.theta["float32"].clone()
        _, mask, _ = tr.sim.next_window()
        st, m = tr.step(st, xb)
        out = torch.from_numpy(~mask).to(cuda)
        assert torch.equal(st.theta["float32"][out], before[out])
        partial += int(not mask.all())
    assert tfu.LAUNCHES == launches + 12 and partial > 0
    assert torch.isfinite(torch.as_tensor(m["loss"]))


@pytest.mark.cuda
def test_partitioned_clipped_step_launches_b8_once_per_chunk(cuda):
    from repro_torch.common.config import FleetConfig
    tr = _async_trainer(cuda, engine="sim", hetero=None, proto=dict(method="clipped_gossip"),
                        fleet=FleetConfig(partition=4))
    st = tr.init_state(0)
    xb = _batch(cuda, 4)
    launches = trobust.LAUNCHES
    for _ in range(3):
        st, _ = tr.step(st, xb)
    assert trobust.LAUNCHES == launches + 3 * 4
    assert int(st.proto.chunk_units.sum()) == int(st.proto.comm_units)


@pytest.mark.cuda
def test_host_plane_matches_device_plane_on_the_card(cuda):
    """20 lognormal windows, partition 4 and randomized token account: the
    host plane (pinned host theta and velocity) against the device plane,
    theta within atol 2e-5, counters and the generator exact, B1 once a
    window on both."""
    from repro_torch.common.config import FleetConfig
    fkw = dict(partition=4, flow_control="randomized_token_account", token_capacity=4.0,
               token_threshold=3.0)
    host = _async_trainer(cuda, fleet=FleetConfig(plane="host", **fkw))
    dev = _async_trainer(cuda, fleet=FleetConfig(**fkw))
    sh, sd = host.init_state(0), dev.init_state(0)
    assert sh.theta["float32"].is_pinned()
    xb = _batch(cuda, 4)
    launches = tfu.LAUNCHES
    for _ in range(20):
        sh, _ = host.step(sh, xb)
        sd, _ = dev.step(sd, xb)
    assert tfu.LAUNCHES == launches + 40
    torch.testing.assert_close(sh.theta["float32"], sd.theta["float32"].cpu(), rtol=0, atol=2e-5)
    for f in ("comm_units", "worker_steps", "stale_events", "clocks", "tokens", "chunk_units",
              "flow_skipped"):
        assert torch.equal(getattr(sh.proto, f), getattr(sd.proto, f)), f
    assert torch.equal(sh.key.get_state(), sd.key.get_state())


# ---------------------------------------------------------------------------
# the sharded plane: the kernels on shard rows and on the padded plane
# ---------------------------------------------------------------------------

def _shard_rows(cuda, codec, S, W=8, n=35968 * 3 + 5):
    """(padded [W, total'] plane, its [W * S, shard_size] shard rows, the
    residual's rows, seeds w * S + s) for a one-bucket plane of n columns."""
    from repro_torch import comm, shard as shard_plane
    from repro_torch.common.config import ProtocolConfig, ShardConfig
    from repro_torch.common.flat import FlatSpec
    spec = FlatSpec.build({"w": torch.zeros(1, n)}, leading=1)
    cd = comm.active_codec(ProtocolConfig(codec=codec))
    layout = shard_plane.build_layout(spec, ShardConfig(n_shards=S), cd)
    g = torch.Generator(device=cuda).manual_seed(S)
    x = torch.randn(W, n, generator=g, device=cuda)
    padded = shard_plane.pad_bufs({"float32": x}, layout)["float32"]
    r = 0.1 * torch.randn(padded.shape, generator=g, device=cuda)
    rows = layout.shard_rows({"float32": padded})["float32"]
    assert rows.data_ptr() == padded.data_ptr()
    res = layout.shard_rows({"float32": r})["float32"]
    return padded, rows, res, comm.codec_seeds(5, torch.arange(W * S, device=cuda)), cd


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("codec", ["q8", "topk"])
def test_codec_kernels_on_shard_rows_match_plain_versions(cuda, codec, S):
    """B4/B5 or B6/B7 on the [W * S, shard_size] shard rows of a padded
    plane, seeds w * S + s: the wire, the decode and the residual byte-equal
    to the plain versions, one launch each."""
    _, rows, res, seeds, cd = _shard_rows(cuda, codec, S)
    n = rows.shape[1]
    before = dict(tcodec.LAUNCHES)
    if codec == "q8":
        got = tcodec.q8_encode(rows, seeds, block=cd.block)
        want = tref.q8_encode(rows, seeds, block=cd.block)
        dec = tcodec.q8_decode(*want, n, block=cd.block)
        want_dec = tref.q8_decode(*want, n, block=cd.block)
    else:
        got = tcodec.topk_encode(rows, res, k=cd.k, block=cd.block)
        want = tref.topk_encode(rows, res, k=cd.k, block=cd.block)
        dec = tcodec.topk_decode(want[0], want[1], n, k=cd.k, block=cd.block)
        want_dec = tref.topk_decode(want[0], want[1], n, k=cd.k, block=cd.block)
    torch.cuda.synchronize()
    for a, b in zip(tuple(got) + (dec,), tuple(want) + (want_dec,)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    names = ("q8_encode", "q8_decode") if codec == "q8" else ("topk_encode", "topk_decode")
    assert all(tcodec.LAUNCHES[k] == before[k] + 1 for k in names)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "q8"])
def test_b1_on_the_padded_plane_matches_plain_version(cuda, codec):
    """B1 on the shard-padded [8, total'] plane (padding columns zero) is
    byte-equal to its plain version and leaves the padding at zero."""
    padded, _, _, _, _ = _shard_rows(cuda, codec or "none", 4)
    W, n = padded.shape
    g = torch.Generator(device=cuda).manual_seed(3)
    p, v, gr = (torch.randn(W, n, generator=g, device=cuda) for _ in range(3))
    for b in (p, v, gr):
        b[:, 35968 * 3 + 5:] = 0.0
    eta = torch.full((), 0.01, device=cuda)
    ones = torch.ones(W, device=cuda)
    want_t, want_v = tref.fused_flat_elastic_nag_update(padded, p, v, gr, ones, eta, 0.9)
    kt, kv = padded.clone(), v.clone()
    tfu.fused_flat_elastic_nag_update(kt, p, kv, gr, ones, eta, 0.9)
    torch.cuda.synchronize()
    assert torch.equal(kt.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(kv.view(torch.int32), want_v.view(torch.int32))
    assert bool((kt[:, 35968 * 3 + 5:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("codec", [None, "q8", "topk"])
def test_sharded_sim_step_launches_each_kernel_once(cuda, codec):
    """The sim engine with ShardConfig(n_shards=4): B1 once a step on the
    padded plane, the codec pair once a step on the shard rows; the
    per-device wire is the whole wire over 4; a recording observer changes
    nothing."""
    from repro_torch.common.config import ObsConfig, ShardConfig
    kw = dict(engine="sim", hetero=None, codec=codec)
    plain = _async_trainer(cuda, shard=ShardConfig(n_shards=4), **kw)
    rec = _async_trainer(cuda, shard=ShardConfig(n_shards=4), obs=ObsConfig(metrics=True,
                                                                           trace=True), **kw)
    s0, s1 = plain.init_state(0), rec.init_state(0)
    xb = _batch(cuda, 4)
    b1, cl = tfu.LAUNCHES, dict(tcodec.LAUNCHES)
    for _ in range(3):
        s0, _ = plain.step(s0, xb)
    assert tfu.LAUNCHES == b1 + 3
    for k, n in tcodec.LAUNCHES.items():
        assert n == cl[k] + (3 if codec and k.startswith(codec) else 0), k
    for _ in range(3):
        s1, _ = rec.step(s1, xb)
    rec.observer.flush()
    assert torch.equal(s0.theta["float32"], s1.theta["float32"])
    assert torch.equal(s0.proto.comm_bytes, s1.proto.comm_bytes)
    assert [r["step"] for r in rec.observer.sink.records] == [0, 1, 2]
    assert s0.theta["float32"].shape[1] % (4 * (512 if codec else 128)) == 0


# ---------------------------------------------------------------------------
# the LM training path (slice 7b): the differentiable attention, the views'
# scatter backward, and the LM gradient on the card
# ---------------------------------------------------------------------------

def _lm_setup(dev):
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tr
    cfg = get_reduced("tinyllama_1_1b")
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg)[0]
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 2, 16)).astype(np.int32))
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 2, 16)).astype(np.int32))
    return cfg, params, toks, labels


@pytest.mark.cuda
def test_attention_under_grad_takes_the_online_softmax_and_launches_no_b9(cuda):
    """Under torch.func.grad (and vmap) on the card, the model's attention
    runs the differentiable online softmax: B9's launch count does not
    move, and the gradient equals the CPU's."""
    from torch.func import grad, vmap

    from repro_torch.models import attention as tattn
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(2, 2, 24, 8, 16).astype(np.float32))
               for _ in range(3))
    k, v = k[:, :, :, :2], v[:, :, :, :2]

    def f(qq, kk, vv):
        return (tattn.chunked_attention(qq, kk, vv, window=7) ** 2).sum()

    n = ops.launch_counts()["flash_attention"]
    forms = dict(tfa.FORM_LAUNCHES)
    g_card = vmap(grad(f, argnums=(0, 1, 2)))(q.to(cuda), k.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n and dict(tfa.FORM_LAUNCHES) == forms
    g_cpu = vmap(grad(f, argnums=(0, 1, 2)))(q, k, v)
    for a, b in zip(g_card, g_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_attention_under_no_grad_launches_b9(cuda):
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(2, 24, 8, 64).astype(np.float32)).to(cuda)
    k, v = (torch.from_numpy(rng.randn(2, 24, 2, 64).astype(np.float32)).to(cuda)
            for _ in range(2))
    n = ops.launch_counts()["flash_attention"]
    with torch.no_grad():
        out = ops.attention(q.requires_grad_(True), k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n + 1
    want = tref.attention(q.detach().cpu(), k.cpu(), v.cpu())
    torch.testing.assert_close(out.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_lm_gradient_on_the_card_equals_the_cpu_s(cuda):
    """tinyllama --reduced, the sim engine's gradient path (vmap of
    grad_and_value over the views) at W=2, on the card and on the CPU:
    rtol 1e-4 / atol 1e-5 (the CPU parity tests' tolerance), losses rtol
    1e-5; no B9 launch."""
    from torch.func import grad_and_value, vmap
    from repro_torch.common.flat import FlatSpec
    from repro_torch.common.precision import full_f32
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import transformer as tr
    cfg, params, toks, labels = _lm_setup(cuda)
    stack = tree_map(lambda t: torch.stack([t, t * 1.01]), params)
    spec = FlatSpec.build(stack, leading=1)
    row = spec.with_lead(())

    def grads(dev):
        bufs = {k: b.to(dev) for k, b in spec.flatten(stack).items()}
        with full_f32():
            return vmap(grad_and_value(lambda b, x, y: tr.lm_loss(row.views(b), cfg, x, y)[0]))(
                bufs, toks.to(dev), labels.to(dev))

    n = ops.launch_counts()["flash_attention"]
    g_card, l_card = grads(cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n
    g_cpu, l_cpu = grads("cpu")
    gap = (g_card["float32"].cpu() - g_cpu["float32"]).abs()
    print(f"LM gradient card vs CPU: max abs diff {float(gap.max()):.3e}, losses "
          f"{l_card.tolist()} / {l_cpu.tolist()}")
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_card["float32"].cpu(), g_cpu["float32"], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_views_backward_on_the_card_equals_slice_views_and_makes_one_plane(cuda):
    """On the card: the scatter backward's gradient is bit-equal to plain
    slice views', and the backward allocates one plane-sized block per
    bucket (the cat), where slice views fill one per leaf."""
    from repro_torch.common.flat import FlatSpec
    from repro_torch.common.pytree import tree_unflatten
    from repro_torch.models import transformer as tr
    cfg, params, toks, labels = _lm_setup(cuda)
    spec = FlatSpec.build(params)
    n = spec.totals["float32"]

    def slice_views(sp, bufs):
        return tree_unflatten(sp.treedef, [bufs[s.bucket][..., s.offset:s.offset + s.size]
                                           .reshape(s.shape) for s in sp.slots])

    def backward(views):
        buf = spec.flatten(tree_map_to(params, cuda))["float32"].requires_grad_(True)
        out = tr.lm_loss(views(spec, {"float32": buf}), cfg, toks[0].to(cuda),
                         labels[0].to(cuda))[0]
        with _PlaneAllocs(n) as mode:
            out.backward()
        return buf.grad, mode.hits

    g_new, new = backward(lambda sp, b: sp.views(b))
    g_old, old = backward(slice_views)
    assert torch.equal(g_new.view(torch.int32), g_old.view(torch.int32))
    assert len(new) == 1 and "cat" in new[0], new
    assert len(old) >= len(spec.slots), old


def tree_map_to(params, dev):
    from repro_torch.common.pytree import tree_map
    return tree_map(lambda t: t.to(dev), params)


class _PlaneAllocs(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the ops (views aside) whose output has ``numel`` elements."""

    def __init__(self, numel):
        super().__init__()
        self.numel, self.hits = numel, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.numel() == self.numel:
                    self.hits.append(str(func))
        return out


# ---------------------------------------------------------------------------
# train-while-serve on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_train_serve_loop_on_the_card_launches_b1_per_step_and_b9_per_layer(cuda):
    """launch.serve at --reduced on the card, 12 boundaries of one step:
    B1 once a training step, B9 (split) once a layer in every decode
    boundary and nothing else; bus seq = steps // 3; staleness within the
    cadence."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve as cli
    ts = cli.build("tinyllama_1_1b", workers=2, publish_every=3, rate=1.0, device=cuda)
    ops.zero_launch_counts()
    out = ts.run(12)
    torch.cuda.synchronize()
    L = get_reduced("tinyllama_1_1b").num_layers
    n = ops.launch_counts()
    assert n.pop("fused_flat_elastic_nag_update") == 12
    assert n.pop("flash_attention") == L * 12 and tfa.FORM_LAUNCHES["split"] == L * 12
    assert not any(n.values()), n
    assert out["bus_seq"] == 4 and out["swaps"] >= 1 and out["rejected_swaps"] == 0
    assert out["staleness_max_steps"] <= 3


@pytest.mark.cuda
def test_full_width_decode_on_a_served_snapshot_through_b9_equals_plain(cuda):
    """TinyLlama-1.1B at full width (f32, random weights) published onto a
    bus and swapped into a LiveServer: a decode step over a cache filled by
    8 earlier steps, with per-slot kv_start, through B9 and through the
    plain version: logits within 1e-3 of the largest, greedy tokens
    equal."""
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.serve import LiveServer, SnapshotBus
    from repro_torch.serving.engine import make_serve_program
    from repro_torch.models import transformer as tr
    cfg = get_config("tinyllama_1_1b")
    bus = SnapshotBus()
    bus.publish_params(tr.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg)[0],
                       train_step=5)
    prog = make_serve_program(cfg, batch=4, max_len=16, param_dtype=torch.float32,
                              cache_dtype=torch.float32, device=cuda)
    server = LiveServer(prog, bus)
    assert server.maybe_swap() and server.train_step == 5
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 9), generator=g, device=cuda,
                         dtype=torch.int32)
    kv_start = torch.tensor([0, 2, 5, 8], dtype=torch.int32, device=cuda)
    cache = prog.init_cache()
    for t in range(8):
        _, cache = server.decode(cache, toks[:, t:t + 1], None, kv_start)

    def step():
        c = {"segments": {s: {k: a.clone() for k, a in seg.items()}
                          for s, seg in cache["segments"].items()}, "pos": cache["pos"].clone()}
        return server.decode(c, toks[:, 8:], None, kv_start)[0]

    n = ops.launch_counts()["flash_attention"]
    got = step()
    assert ops.launch_counts()["flash_attention"] == n + cfg.num_layers
    with mock.patch.object(ops, "attention", _plain_attention):
        want = step()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-3
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["decode 0", "decode 700", "decode kv_start", "prefill",
                                  "prefill 77"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_at_zamba2_head_dim_80_matches_plain_version(cuda, case, dt):
    """Zamba2-2.7B's shared attention: 32 heads of 2560 / 32 = 80 over 32 kv
    heads: bf16 prefill takes the wgmma form (f32 prefill the simt form) and
    decode the split form; decode over an [8, 1024] cache, prefill 8 x 512
    and 77 rows; bf16 also within 2^-6 of the largest |plain|."""
    g = torch.Generator(device=cuda).manual_seed(43)
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32, device=cuda))
    Skv = 1024 if case.startswith("decode") else (77 if case == "prefill 77" else 512)
    B = 2 if case == "prefill 77" else 8
    k, v = (torch.randn(B, Skv, 32, 80, generator=g, device=cuda).to(dt) for _ in range(2))
    if case.startswith("decode"):
        q = torch.randn(B, 1, 32, 80, generator=g, device=cuda).to(dt)
        pos = 700 if case == "decode kv_start" else int(case.split()[1])
        kw = dict(causal=True, q_offset=i32(pos), kv_len=i32(pos + 1))
        if case == "decode kv_start":
            kw["kv_start"] = i32([0, 5, 100, 700, 3, 600, 32, 64])
        form = "split"
    else:
        q = torch.randn(B, Skv, 32, 80, generator=g, device=cuda).to(dt)
        kw, form = dict(causal=True), "wgmma" if dt == torch.bfloat16 else "simt"
    assert tfa._form(dt, B, q.shape[1], 32, 32, 80, Skv) == form
    got = _check_b9(q, k, v, form=form, **kw)
    if dt == torch.bfloat16:
        _bf16_bound(got, tref.attention(q, k, v, causal=True, q_offset=kw.get("q_offset", 0),
                                        kv_len=kw.get("kv_len"), kv_start=kw.get("kv_start")))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "grok_1_314b"])
def test_moe_dispatch_under_vmap_on_the_card_equals_the_unbatched_call(cuda, arch):
    """The reduced MoE layer's routing under vmap over 3 workers on the
    card: ids, dest, source tokens, keep and the aux counts bit-equal to
    each worker's unbatched call, and the layer's output and aux loss
    through ``vmap(grad_and_value)`` finite with the dispatch's integers
    equal to the CPU's on the same inputs."""
    from torch.func import grad_and_value, vmap
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe
    cfg = get_reduced(arch)
    m = cfg.moe
    p, _ = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(3, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))
    C = moe.capacity(cfg, 24)

    def route(pr, xt):
        _, weights, ids = moe._route(xt @ pr, m.top_k)
        _, dest, s_tok, _, keep = moe._build_buffer(xt, ids, weights, m.num_experts, m.top_k, C)
        return ids, dest, s_tok, keep, moe._counts(ids[:, 0], m.num_experts)

    pc = {k: v.to(cuda) for k, v in p.items() if k != "shared"}
    xc = x.to(cuda)
    batched = vmap(route, in_dims=(None, 0))(pc["router"], xc)
    on_cpu = vmap(route, in_dims=(None, 0))(p["router"], x)
    for w in range(3):
        one = route(pc["router"], xc[w])
        for a, b, c in zip(batched, one, on_cpu):
            assert torch.equal(a[w], b) and torch.equal(a[w].cpu(), c[w])

    def loss(pp, xx):
        y, aux = moe.moe_forward(pp, xx[None], cfg)
        return y.square().mean() + aux

    pw = {k: v.to(cuda) for k, v in p.items() if k != "shared"}
    if "shared" in p:
        pw["shared"] = {k: v.to(cuda) for k, v in p["shared"].items()}
    g, val = vmap(grad_and_value(loss), in_dims=(None, 0))(pw, xc)
    assert torch.isfinite(val).all() and all(torch.isfinite(t).all() for t in
                                             torch.utils._pytree.tree_leaves(g))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("xlstm_125m", "mlstm"), ("xlstm_125m", "slstm"),
                                       ("zamba2_2_7b", "mamba")])
def test_ssm_block_prefill_and_decode_on_the_card_equal_the_cpu(cuda, arch, kind):
    """One reduced SSM block's prefill over 16 positions and 8 decode steps
    (the state and conv buffer written in place on the card) against the
    same on the CPU: outputs and caches within rtol 1e-4 / atol 1e-4 (TF32
    off), and no kernel launched."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import blocks
    cfg = get_reduced(arch)
    p, _ = blocks.init_block(torch.Generator().manual_seed(0), kind, cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(1))

    def run(dev):
        pd = {"ln": p["ln"].to(dev), "mixer": {k: v.to(dev) for k, v in p["mixer"].items()}}
        xd = x.to(dev)
        with torch.no_grad():
            y, cache = blocks.block_prefill(kind, pd, xd[:, :16], cfg)
            ys = [y]
            for t in range(16, 24):
                y, cache = blocks.block_decode(kind, pd, xd[:, t:t + 1], cache, None, cfg)
                ys.append(y)
        return torch.cat(ys, dim=1).cpu(), {k: v.cpu() for k, v in cache.items()}

    ops.zero_launch_counts()
    got, gc = run(cuda)
    torch.cuda.synchronize()
    assert all(n == 0 for n in ops.launch_counts().values())
    want, wc = run("cpu")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for k in wc:
        torch.testing.assert_close(gc[k], wc[k], rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(wc[k].abs().max())))


# the cross-attention shapes of the audio and vision models at full width:
# (B, Sq, H, Skv, Hkv, hd); vision self-attends over 8 kv heads and
# cross-attends over 1601 image tokens (no tile divides it), MusicGen is MHA
# over 64 conditioning tokens
CROSS_SHAPES = {"vision prefill": (8, 512, 32, 1601, 8, 128),
                "vision decode": (8, 1, 32, 1601, 8, 128),
                "musicgen prefill": (8, 512, 32, 64, 32, 64),
                "musicgen decode": (8, 1, 32, 64, 32, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CROSS_SHAPES))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_at_the_cross_attention_shapes_matches_plain_version(cuda, case, dt):
    """B9 non-causal at the cross-attention shapes, queries attending to
    every key: a prefill of 512 queries (bf16: the wgmma form; f32: simt)
    and a decode of one (the split form), over Llama-3.2-V's 1601 image
    tokens (a partial last key tile, and 51 splits of 32 rows in decode)
    and MusicGen's 64 conditioning tokens."""
    B, Sq, H, Skv, Hkv, hd = CROSS_SHAPES[case]
    g = torch.Generator(device=cuda).manual_seed(61)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, Skv, Hkv, hd, generator=g, device=cuda).to(dt) for _ in range(2))
    form = tfa._form(dt, B, Sq, H, Hkv, hd, Skv)
    assert form == ("split" if Sq == 1 else "wgmma" if dt == torch.bfloat16 else "simt")
    _check_b9(q, k, v, form=form, causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm_125m", "zamba2_2_7b"])
def test_ssm_lm_gradient_under_vmap_on_the_card_equals_the_cpu_s(cuda, arch):
    """The reduced SSM / hybrid LM through the sim engine's gradient path
    (vmap of grad_and_value over the views) at W = 2, 2 x 32 tokens a
    worker, on the card and on the CPU: losses rtol 1e-5, gradients rtol
    1e-4 / atol 1e-5 (Zamba2's chunked GLA: atol 1e-5 of the largest
    gradient); no B9 launch (Zamba2's shared sites train through the
    online softmax)."""
    from torch.func import grad_and_value, vmap
    from repro_torch.common.flat import FlatSpec
    from repro_torch.common.precision import full_f32
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tr
    cfg = get_reduced(arch)
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg)[0]
    stack = tree_map(lambda t: torch.stack([t, t * 1.01]), params)
    spec = FlatSpec.build(stack, leading=1)
    row = spec.with_lead(())
    g = torch.Generator().manual_seed(1)
    toks, labels = (torch.randint(0, cfg.vocab_size, (2, 2, 32), generator=g) for _ in range(2))

    def grads(dev):
        bufs = {k: b.to(dev) for k, b in spec.flatten(stack).items()}
        with full_f32():
            return vmap(grad_and_value(lambda b, x, y: tr.lm_loss(row.views(b), cfg, x, y)[0]))(
                bufs, toks.to(dev), labels.to(dev))

    n = ops.launch_counts()["flash_attention"]
    g_card, l_card = grads(cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n
    g_cpu, l_cpu = grads("cpu")
    want = g_cpu["float32"]
    torch.testing.assert_close(l_card.cpu(), l_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_card["float32"].cpu(), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["musicgen_large", "llama_3_2_vision_11b"])
def test_cross_attention_prefill_and_decode_on_the_card_equal_the_cpu(cuda, arch):
    """The reduced audio / vision model (its ``attn_cross`` layers or its
    ``cross_blk``), every cross gate 0.5 and a random cond, f32: a prefill
    of 12 positions and 6 greedy decode steps on the card (B9 for every
    self- and cross-attention) against the same on the CPU (B9's plain
    version): logits within rtol 1e-4 / atol 1e-4, greedy tokens equal; B9
    launched once per attention a step."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve_decode import open_cross_gates
    from repro_torch.models import transformer as tr
    cfg = get_reduced(arch)
    params = tr.init_lm(torch.Generator().manual_seed(0), cfg)[0]
    open_cross_gates(params, 0.5)
    g = torch.Generator().manual_seed(1)
    K = (cfg.audio.num_codebooks,) if cfg.audio is not None else ()
    prompt = torch.randint(0, cfg.vocab_size, (2,) + K + (12,), generator=g)
    T, e = ((cfg.audio.num_cond_tokens, cfg.d_model) if cfg.audio is not None
            else (cfg.vlm.num_image_tokens, cfg.vlm.image_embed_dim))
    cond = torch.randn(2, T, e, generator=g)
    plan = tr.make_plan(cfg)
    per_step = sum(s.count * (2 if s.kind == "attn_cross" else 1) for s in plan.segments) \
        + plan.num_cross

    def run(dev):
        p = {k: v for k, v in params.items()}
        p = torch.utils._pytree.tree_map(lambda t: t.to(dev), p)
        c = cond.to(dev)
        with torch.no_grad():
            logits, cache = tr.prefill(p, cfg, prompt.to(dev), c, max_len=24)
            out = [logits]
            for _ in range(6):
                logits, cache = tr.decode_step(p, cfg, cache,
                                               logits.argmax(-1).int()[..., None], c)
                out.append(logits)
        return torch.stack(out).cpu()

    n = ops.launch_counts()["flash_attention"]
    got = run(cuda)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] - n == per_step * 7
    want = run("cpu")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


# each rank's heads in tensor-parallel serving at M = 2: (B, Sq, H, Skv,
# Hkv, hd, dv, causal); MLA's values are the keys' 512-wide prefix
TP_LOCAL_SHAPES = {"MLA prefill": (8, 512, 8, 512, 1, 576, 512, True),
                   "MLA decode": (8, 1, 8, 1024, 1, 576, 512, True),
                   "Zamba2 prefill": (8, 512, 16, 512, 16, 80, 80, True),
                   "Zamba2 decode": (8, 1, 16, 1024, 16, 80, 80, True),
                   "vision cross prefill": (8, 512, 16, 1601, 4, 128, 128, False),
                   "vision cross decode": (8, 1, 16, 1601, 4, 128, 128, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TP_LOCAL_SHAPES))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_b9_at_the_tensor_parallel_ranks_shapes_matches_plain_version(cuda, case, dt):
    """B9 at a rank's heads of DeepSeek-V2-Lite (8 of MLA's 16, keys of 576,
    values of 512), Zamba2 (16 of 32 at head dim 80) and Llama-3.2-V's cross
    attention (16 of 32 over 4 of 8 kv heads and 1601 keys) at M = 2:
    wgmma prefill in bf16 (mma for MLA's over its keys' prefix: the MLA kernel),
    simt in f32, split decode at position 512; bf16 also within 2^-6 of the
    largest |plain|."""
    B, Sq, H, Skv, Hkv, hd, dv, causal = TP_LOCAL_SHAPES[case]
    g = torch.Generator(device=cuda).manual_seed(67)
    q = torch.randn(B, Sq, H, hd, generator=g, device=cuda).to(dt)
    k = torch.randn(B, Skv, Hkv, hd, generator=g, device=cuda).to(dt)
    v = k[..., :dv] if dv < hd else torch.randn(B, Skv, Hkv, dv, generator=g,
                                                 device=cuda).to(dt)
    kw = dict(causal=causal)
    if Sq == 1 and causal:
        p = torch.tensor(512, dtype=torch.int32, device=cuda)
        kw.update(q_offset=p, kv_len=p + 1)
    form = ("split" if Sq == 1 else "simt" if dt == torch.float32 else
            "mma" if dv < hd else "wgmma")
    got = _check_b9(q, k, v, form=form, **kw)
    assert got.shape == (B, Sq, H, dv)
    if dt == torch.bfloat16:
        want = tref.attention(q, k, v, causal=causal, q_offset=kw.get("q_offset", 0),
                              kv_len=kw.get("kv_len"))
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2.0 ** -6 * float(want.float().abs().max()), err


@pytest.mark.cuda
def test_tensor_parallel_kinds_on_the_card_equal_one_device(cuda):
    """Reduced DeepSeek (MLA + MoE), Zamba2 (Mamba2 + shared blocks),
    xLSTM (mLSTM + sLSTM) and Llama-3.2-V (a cross block, gates 0.5, a random
    cond) served in f32 over 2 ranks on this card against the one-device
    program: every step's logits within 1e-5 of the largest, greedy tokens
    equal, B9 once a rank, attention and step, every step's collectives
    exact."""
    from repro_torch.common.config import MeshConfig
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import build
    from repro_torch.launch import serve_decode as sd
    from repro_torch.launch.mesh import spawn_model_group
    from repro_torch.models import transformer as tr
    build.build("flash_attention")      # the ranks only load it
    runs = [dict(tag=a, cfg=get_reduced(a), dtype=torch.float32, batch=4, prompt_len=12,
                 tokens=6, max_len=32, seed=0, logits=True, cross_gate=0.5,
                 routes=get_reduced(a).moe is not None)
            for a in ("deepseek_v2_lite_16b", "zamba2_2_7b", "xlstm_125m",
                      "llama_3_2_vision_11b")]
    one = sd.tp_rank(sd.OneRank(cuda), dict(runs=runs))
    ranks = spawn_model_group(sd.tp_rank, MeshConfig(data=1, model=2, pods=1,
                                                     workers_per_pod=1),
                              "cuda", args=(dict(runs=runs),), join_timeout_s=600)
    for run in runs:
        tag, cfg = run["tag"], run["cfg"]
        plan = tr.make_plan(cfg)
        attn = (sum(s.count for s in plan.segments if s.kind == "attn")
                + plan.num_shared_sites + plan.num_cross)
        got, want = ranks[0][tag], one[tag]
        for a, b in zip(got["logits"], want["logits"]):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), tag
        assert torch.equal(got["stream"], want["stream"]), tag
        for r in ranks:
            assert r[tag]["launches"]["flash_attention"] == attn * (1 + run["tokens"]), tag
            exp = r[tag]["expected_per_step"]
            assert all({k: c[k] for k in exp} == exp for c in r[tag]["step_collectives"])
            if run["routes"]:
                assert all((x == y).all() for x, y in zip(r[tag]["routes"], got["routes"]))


@pytest.mark.cuda
def test_remat_step_on_the_card_equals_no_remat_and_keeps_3x_less(cuda):
    """TinyLlama reduced at 12 layers (ffn 512), the sim engine's gradient
    path (vmap of grad_and_value over the views) at W = 2 x 2 x 256 tokens
    on the card, with cfg.remat on and off: the losses equal, the growth of
    max_memory_allocated over the step at least 3x smaller with remat, no
    B9 launch; the remat gradient against the CPU's within rtol 1e-4 /
    atol 1e-5."""
    import dataclasses

    from torch.func import grad_and_value, vmap

    from repro_torch.common.flat import FlatSpec
    from repro_torch.common.precision import full_f32
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tr
    base = dataclasses.replace(get_reduced("tinyllama_1_1b"), num_layers=12, d_ff=512)
    params = tr.init_lm(torch.Generator().manual_seed(0), base)[0]
    stack = tree_map(lambda t: torch.stack([t, t * 1.01]), params)
    spec = FlatSpec.build(stack, leading=1)
    row = spec.with_lead(())
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, base.vocab_size, (2, 2, 256)).astype(np.int32))

    def grads(cfg, dev):
        bufs = {k: b.to(dev) for k, b in spec.flatten(stack).items()}
        x = toks.to(dev)
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev) if dev != "cpu" else 0
        with full_f32():
            g, l = vmap(grad_and_value(lambda b, t: tr.lm_loss(row.views(b), cfg, t, t)[0]))(
                bufs, x)
        grow = torch.cuda.max_memory_allocated(dev) - before if dev != "cpu" else 0
        return g, l, grow

    n = ops.launch_counts()["flash_attention"]
    out = {r: grads(dataclasses.replace(base, remat=r), cuda) for r in (True, False)}
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == n
    (g1, l1, grow1), (g0, l0, grow0) = out[True], out[False]
    print(f"remat on the card: losses {l1.tolist()} / {l0.tolist()}, step growth "
          f"{grow1 / 2 ** 20:.1f} / {grow0 / 2 ** 20:.1f} MiB")
    torch.testing.assert_close(l1, l0, rtol=0, atol=0)
    assert 3 * grow1 <= grow0
    g_cpu, l_cpu, _ = grads(dataclasses.replace(base, remat=True), "cpu")
    torch.testing.assert_close(l1.cpu(), l_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(g1["float32"].cpu(), g_cpu["float32"], rtol=1e-4, atol=1e-5)
