"""Kernel B9 (flash attention): the port's plain version and the model's
``chunked_attention`` against the reference's Pallas kernel (interpret
mode), its oracle ``ref.attention`` and its ``chunked_attention`` (with
``kv_start``), on the same numpy inputs. The CUDA kernel itself runs only on
the card (tests/test_torch_cuda.py and chip_smoke.py)."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # several xdist workers share a few cores

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

# the reference's own kernel tests' tolerances (tests/test_kernels.py): f32
# sums in another order; bf16 one rounding of the output
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _qkv(B, H, Hkv, Sq, Skv, hd, dtype="float32", seed=0):
    """BHSD numpy inputs, rounded to ``dtype``, as (jax, torch) pairs."""
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(B, H, Sq, hd), rng.randn(B, Hkv, Skv, hd), rng.randn(B, Hkv, Skv, hd)]
    j = [jnp.asarray(a.astype(np.float32), dtype) for a in arrs]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    t = [torch.from_numpy(np.array(x, np.float32)).to(tdt) for x in j]
    return j, t


def _ref_bhsd(q, k, v, **kw):
    o = jref.attention(jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2), **kw)
    return jnp.swapaxes(o, 1, 2)


def _close(port, want, dtype="float32", tol=None):
    tol = TOL[dtype] if tol is None else tol
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,Hkv,S,hd", [
    (1, 2, 2, 64, 16), (2, 4, 2, 128, 32), (1, 8, 1, 96, 64), (2, 4, 4, 33, 8),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_b9_causal_sweep_matches_reference_kernel_and_oracle(B, H, Hkv, S, hd, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Hkv, S, S, hd, dtype)
    port = ops.flash_attention(q, k, v, causal=True)
    assert port.dtype == q.dtype and port.shape == q.shape
    _close(port, jflash(jq, jk, jv, block_q=32, block_k=32, interpret=True), dtype)
    _close(port, _ref_bhsd(jq, jk, jv, causal=True), dtype)


@pytest.mark.parametrize("window", [1, 7, 33, 100])
def test_plain_b9_sliding_window(window):
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 2, 100, 100, 16)
    port = ops.flash_attention(q, k, v, causal=True, window=window)
    _close(port, jflash(jq, jk, jv, window=window, block_q=32, block_k=32, interpret=True))
    _close(port, _ref_bhsd(jq, jk, jv, causal=True, window=window))


@pytest.mark.parametrize("softcap", [10.0, 50.0])
def test_plain_b9_softcap(softcap):
    (jq, jk, jv), (q, k, v) = _qkv(1, 4, 2, 64, 64, 32, seed=3)
    port = ops.flash_attention(q, k, v, causal=True, softcap=softcap)
    _close(port, jflash(jq, jk, jv, softcap=softcap, block_q=32, block_k=32, interpret=True))
    _close(port, _ref_bhsd(jq, jk, jv, causal=True, logit_softcap=softcap))


@pytest.mark.parametrize("kvlen", [1, 100, 256])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_plain_b9_decode_q1_with_kv_len(kvlen, as_tensor):
    (jq, jk, jv), (q, k, v) = _qkv(2, 4, 2, 1, 256, 32, seed=5)
    kl = torch.tensor(kvlen, dtype=torch.int32) if as_tensor else kvlen
    port = ops.flash_attention(q, k, v, kl, causal=False)
    _close(port, jflash(jq, jk, jv, jnp.int32(kvlen), causal=False, block_q=8, block_k=64,
                        interpret=True), tol=3e-5)
    _close(port, _ref_bhsd(jq, jk, jv, causal=False, kv_len=kvlen), tol=3e-5)


def test_plain_b9_q_offset_matches_suffix_of_full():
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 2, 64, 64, 16, seed=8)
    off = 48
    port = ops.flash_attention(q[:, :, off:], k, v, causal=True, q_offset=off)
    _close(port, jflash(jq[:, :, off:], jk, jv, q_offset=off, causal=True, block_q=8,
                        block_k=32, interpret=True))
    _close(port, _ref_bhsd(jq, jk, jv, causal=True)[:, :, off:])


@pytest.mark.parametrize("seed,S,hd", [(0, 17, 8), (1, 64, 32), (2, 130, 8), (3, 130, 32)])
def test_plain_b9_property_sweep(seed, S, hd):
    (jq, jk, jv), (q, k, v) = _qkv(1, 2, 1, S, S, hd, seed=seed)
    port = ops.flash_attention(q, k, v, causal=True)
    _close(port, jflash(jq, jk, jv, block_q=16, block_k=16, interpret=True), tol=3e-5)


def test_bhsd_and_bshd_entries_agree():
    _, (q, k, v) = _qkv(2, 8, 2, 40, 40, 16, seed=9)
    a = ops.flash_attention(q, k, v, causal=True, window=5, softcap=20.0)
    b = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=True, window=5, softcap=20.0)
    assert torch.equal(a.transpose(1, 2), b)


@pytest.mark.parametrize("case", ["prefill", "window", "softcap", "decode", "kv_start"])
def test_chunked_attention_matches_reference(case):
    """The model's BSHD adapter against the reference's chunked_attention
    (online softmax over chunks) in the calls the serve path makes."""
    B, H, Hkv, hd = 3, 8, 2, 16
    Sq, Skv = (1, 48) if case in ("decode", "kv_start") else (40, 40)
    (jq, jk, jv), (q, k, v) = _qkv(B, H, Hkv, Sq, Skv, hd, seed=11)
    jq, jk, jv = (jnp.swapaxes(x, 1, 2) for x in (jq, jk, jv))
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    kw = dict(causal=True)
    if case == "window":
        kw["window"] = 9
    if case == "softcap":
        kw["logit_softcap"] = 30.0
    if case in ("decode", "kv_start"):
        kw.update(q_offset=30, kv_len=31)
    jkw, tkw = dict(kw), dict(kw)
    if case == "kv_start":
        start = np.array([0, 12, 30], np.int32)
        jkw["kv_start"], tkw["kv_start"] = jnp.asarray(start), torch.from_numpy(start)
    if case in ("decode", "kv_start"):
        tkw.update(q_offset=torch.tensor(30, dtype=torch.int32),
                   kv_len=torch.tensor(31, dtype=torch.int32))
    want = jattn.chunked_attention(jq, jk, jv, chunk=16, **jkw)
    port = tattn.chunked_attention(q, k, v, chunk=16, **tkw)
    _close(port, want)


def test_plain_kv_start_hides_previous_rows_exactly():
    """Rows below kv_start[b] contribute exactly nothing to the plain
    version: garbage there gives the same bits as zeros."""
    _, (q, k, v) = _qkv(3, 8, 2, 1, 48, 16, seed=12)
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    start = torch.tensor([0, 20, 47], dtype=torch.int32)
    below = torch.arange(48)[None, :, None, None] < start.reshape(3, 1, 1, 1)
    kw = dict(causal=True, q_offset=47, kv_len=48, kv_start=start)
    a = tref.attention(q, k.masked_fill(below, 0), v.masked_fill(below, 0), **kw)
    b = tref.attention(q, k + 3 * below, v - 5 * below, **kw)
    assert torch.equal(a, b)
    # kv_start = 0 changes nothing
    c = tref.attention(q, k, v, causal=True, q_offset=47, kv_len=48)
    d = tref.attention(q, k, v, causal=True, q_offset=47, kv_len=48,
                       kv_start=torch.zeros(3, dtype=torch.int32))
    assert torch.equal(c, d)


@pytest.mark.parametrize("case", ["prefill", "decode", "kv_start", "prefix view"])
def test_chunked_attention_with_narrower_values_matches_reference(case):
    """Values narrower than the keys (MLA: one kv head, keys [c_kv ; k_rope],
    values c_kv) through the model's adapter and the plain version, against
    the reference's chunked_attention, which takes dv != hd."""
    B, H, hd, dv = 2, 4, 24, 16
    Sq, Skv = (1, 40) if case in ("decode", "kv_start") else (40, 40)
    rng = np.random.RandomState(13)
    q, k, v = (rng.randn(*s).astype(np.float32) for s in
               ((B, Sq, H, hd), (B, Skv, 1, hd), (B, Skv, 1, dv)))
    if case == "prefix view":
        v = k[..., :dv]
    kw = dict(causal=True)
    jkw, tkw = dict(kw), dict(kw)
    if case in ("decode", "kv_start"):
        jkw.update(q_offset=30, kv_len=31)
        tkw.update(q_offset=torch.tensor(30, dtype=torch.int32),
                   kv_len=torch.tensor(31, dtype=torch.int32))
    if case == "kv_start":
        start = np.array([0, 17], np.int32)
        jkw["kv_start"], tkw["kv_start"] = jnp.asarray(start), torch.from_numpy(start)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=16,
                                   **jkw)
    tk = torch.from_numpy(k)
    tv = tk[..., :dv] if case == "prefix view" else torch.from_numpy(v)
    port = tattn.chunked_attention(torch.from_numpy(q), tk, tv, chunk=16, **tkw)
    assert port.shape == (B, Sq, H, dv)
    _close(port, want)
    plain = tref.attention(torch.from_numpy(q), tk, tv, **tkw)
    _close(plain, want)


# kernel B9's form by shape (kernels/flash_attention.py::_form): host-known
# ints, a dtype and whether v is a prefix view of k, so routing never reads
# a device scalar; (B, Sq, H, Hkv, hd, Skv[, dv[, v_in_k]])
@pytest.mark.parametrize("name,dtype,shape,form", [
    ("serve prefill", torch.bfloat16, (8, 512, 32, 4, 64, 512), "wgmma"),
    ("serve decode", torch.bfloat16, (8, 1, 32, 4, 64, 1024), "split"),
    ("f32 decode", torch.float32, (8, 1, 32, 4, 64, 1024), "split"),
    ("f32 prefill", torch.float32, (8, 512, 32, 4, 64, 512), "simt"),
    ("hd 8 prefill", torch.bfloat16, (2, 77, 16, 2, 8, 77), "simt"),
    ("hd 8 decode", torch.bfloat16, (2, 1, 16, 2, 8, 77), "split"),
    ("hd 32 prefill", torch.bfloat16, (1, 64, 4, 2, 32, 64), "simt"),
    ("hd 256 prefill", torch.bfloat16, (1, 128, 4, 2, 256, 128), "wgmma"),
    ("G 48 prefill", torch.bfloat16, (2, 100, 48, 1, 128, 100), "wgmma"),
    ("G 48 f32 prefill", torch.float32, (2, 100, 48, 1, 128, 100), "simt"),
    ("G 48 decode", torch.bfloat16, (2, 1, 48, 1, 128, 1024), "wgmma"),
    ("16 rows", torch.bfloat16, (1, 2, 8, 1, 64, 256), "split"),
    ("17 rows", torch.bfloat16, (1, 17, 1, 1, 64, 256), "wgmma"),
    ("MLA prefill", torch.bfloat16, (8, 512, 16, 1, 576, 512, 512, True), "mma"),
    ("MLA f32 prefill", torch.float32, (8, 512, 16, 1, 576, 512, 512, True), "simt"),
    ("MLA prefill, own values", torch.bfloat16, (8, 512, 16, 1, 576, 512, 512, False), "simt"),
    ("MLA tensor-parallel prefill, G 8", torch.bfloat16, (8, 512, 8, 1, 576, 512, 512, True),
     "mma"),
    ("MLA 77 rows", torch.bfloat16, (2, 77, 16, 1, 576, 77, 512, True), "mma"),
    ("hd 576 dv 256 in k", torch.bfloat16, (2, 100, 4, 1, 576, 100, 256, True), "simt"),
    ("hd = dv = 576", torch.bfloat16, (2, 100, 4, 1, 576, 100, 576, True), "simt"),
    ("Zamba2 hd 80 prefill", torch.bfloat16, (8, 512, 32, 32, 80, 512), "wgmma"),
    ("Zamba2 hd 80 f32 prefill", torch.float32, (8, 512, 32, 32, 80, 512), "simt"),
    ("Zamba2 hd 80 tensor-parallel prefill", torch.bfloat16, (8, 256, 16, 16, 80, 256),
     "wgmma"),
    ("Zamba2 hd 80 decode", torch.bfloat16, (8, 1, 32, 32, 80, 1024), "split"),
    ("hd 80 values narrower", torch.bfloat16, (2, 100, 8, 2, 80, 100, 64), "simt"),
    ("MLA decode", torch.bfloat16, (8, 1, 16, 1, 576, 1024, 512), "split"),
    ("values narrower at hd 128", torch.bfloat16, (2, 100, 8, 2, 128, 100, 64), "simt"),
    ("values as wide at hd 128", torch.bfloat16, (2, 100, 8, 2, 128, 100, 128), "wgmma"),
    ("hd 64 129 rows", torch.bfloat16, (1, 129, 1, 1, 64, 129), "wgmma"),
    ("hd 64 300 rows", torch.bfloat16, (1, 300, 1, 1, 64, 300), "wgmma"),
    ("hd 80 129 rows", torch.bfloat16, (1, 129, 1, 1, 80, 129), "wgmma"),
    ("hd 80 300 rows", torch.bfloat16, (1, 300, 1, 1, 80, 300), "wgmma"),
    ("hd 128 129 rows", torch.bfloat16, (1, 129, 1, 1, 128, 129), "wgmma"),
    ("hd 128 300 rows", torch.bfloat16, (1, 300, 1, 1, 128, 300), "wgmma"),
    ("hd 256 129 rows", torch.bfloat16, (1, 129, 1, 1, 256, 129), "wgmma"),
    ("hd 256 300 rows", torch.bfloat16, (1, 300, 1, 1, 256, 300), "wgmma"),
    ("hd 256 f32 300 rows", torch.float32, (1, 300, 1, 1, 256, 300), "simt"),
])
def test_b9_form_follows_the_host_known_shapes(name, dtype, shape, form):
    from repro_torch.kernels import flash_attention as tfa
    assert tfa._form(dtype, *shape) == form, name


@pytest.mark.parametrize("case,want", [
    ("prefix view", True),
    ("the whole of k", True),
    ("a view past k's first column", False),
    ("a copy of the prefix", False),
    ("a view of another tensor", False),
])
def test_b9_tells_a_prefix_view_of_k_on_the_host(case, want):
    """MLA's values reach B9 as ``kk[..., :512]``, which the mma form reads
    from its key tiles; anything else routes as values of their own."""
    from repro_torch.kernels import flash_attention as tfa
    kk = torch.zeros(2, 5, 1, 576)
    v = {"prefix view": lambda: kk[..., :512], "the whole of k": lambda: kk,
         "a view past k's first column": lambda: kk[..., 64:],
         "a copy of the prefix": lambda: kk[..., :512].clone(),
         "a view of another tensor": lambda: torch.zeros(2, 5, 1, 576)[..., :512]}[case]()
    assert tfa._v_in_k(kk, v) is want


def test_zeroing_the_launch_counts_zeroes_the_b9_forms():
    from repro_torch.kernels import flash_attention as tfa
    tfa.FORM_LAUNCHES["mma"] += 3
    tfa.FORM_LAUNCHES["wgmma"] += 2
    ops.zero_launch_counts()
    assert tfa.FORM_LAUNCHES == {"wgmma": 0, "mma": 0, "split": 0, "simt": 0}
    assert ops.launch_counts()["flash_attention"] == 0
