"""Plain PyTorch versions of the port's kernels (the allclose targets, port
of ``repro.kernels.ref``): B1-B3, B8, the codecs B4-B7 and attention (B9).
Pure functions: they return new tensors."""
from __future__ import annotations

import torch


def _per_replica(c, W: int, device) -> torch.Tensor:
    """Scalar or [W] -> [W, 1] f32 column (broadcasts over the flat axis)."""
    if not isinstance(c, torch.Tensor):
        c = torch.full((), float(c), dtype=torch.float32, device=device)
    return c.to(device=device, dtype=torch.float32).reshape(-1).expand(W)[:, None]


def fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu, rows=None):
    """Flat-plane fused update (paper Alg. 5 lines 3/7/9, simultaneous) on
    ``[W, N]`` buffers, per-replica ``coef`` (scalar or [W]), scalar
    ``eta``/``mu`` (python numbers or 0-d tensors), computed in f32:

        v'     = mu * v - eta * g
        theta' = theta - coef * (theta - peer) - eta * g + mu * v'

    ``rows`` (optional, int tensor of distinct row indices): only those rows
    are updated; the others come back with theta's and v's values.
    Returns (theta', v') in theta's / v's dtypes."""
    if rows is not None:
        rows = rows.to(device=theta.device, dtype=torch.int64)
        c = coef
        if isinstance(c, torch.Tensor) and c.numel() > 1:
            c = c.reshape(-1)[rows]
        t_r, v_r = fused_flat_elastic_nag_update(theta[rows], peer[rows], v[rows], g[rows],
                                                 c, eta, mu)
        return (theta.clone().index_copy_(0, rows, t_r),
                v.clone().index_copy_(0, rows, v_r))
    W, dev = theta.shape[0], theta.device
    c = _per_replica(coef, W, dev)
    e = _per_replica(eta, W, dev)
    m = _per_replica(mu, W, dev)
    tf, pf = theta.float(), peer.float()
    vf, gf = v.float(), g.float()
    eg = e * gf
    v_new = m * vf - eg
    theta_new = tf - c * (tf - pf) - eg + m * v_new
    return theta_new.to(theta.dtype), v_new.to(v.dtype)


def fused_flat_nag_update(theta, v, g, eta, mu):
    """Flat-plane pure NAG (Alg. 5 lines 3 and 9, no communication; B2's
    plain version) on ``[W, N]`` buffers, scalar ``eta``/``mu``, in f32:

        v'     = mu * v - eta * g
        theta' = theta - eta * g + mu * v'

    Returns (theta', v') in theta's / v's dtypes."""
    W, dev = theta.shape[0], theta.device
    e = _per_replica(eta, W, dev)
    m = _per_replica(mu, W, dev)
    eg = e * g.float()
    v_new = m * v.float() - eg
    theta_new = theta.float() - eg + m * v_new
    return theta_new.to(theta.dtype), v_new.to(v.dtype)


def fused_elastic_nag_update(theta, peer, v, g, coef_gate, *, eta, mu):
    """The per-array update (B3's plain version): B1's math on arrays of any
    shape with a scalar ``coef_gate`` (= alpha * participation gate), in f32.
    Returns (theta', v') in theta's / v's dtypes and shapes."""
    n = theta.numel()
    t, v_new = fused_flat_elastic_nag_update(
        theta.reshape(1, n), peer.reshape(1, n), v.reshape(1, n), g.reshape(1, n),
        coef_gate, eta, mu)
    return t.reshape(theta.shape), v_new.reshape(v.shape)


def robust_flat_apply(theta, delta, scale, thr):
    """Robust-gossip displacement apply on ``[W, N]`` buffers (B8's plain
    version): ``theta + scale * (delta * keep)`` in f32 with ``keep = 1.0``
    where ``|delta| <= thr`` and ``0.0`` elsewhere, MULTIPLIED (not
    selected), so a trimmed inf or NaN gives NaN and a trimmed coordinate
    adds +0.0, as in the reference. ``scale``/``thr`` are scalars or [W]
    (``thr = +inf`` turns the trim off). Returns a new tensor in theta's
    dtype."""
    W, dev = theta.shape[0], theta.device
    s, t = _per_replica(scale, W, dev), _per_replica(thr, W, dev)
    df = delta.to(torch.float32)
    keep = (torch.abs(df) <= t).to(torch.float32)
    out = theta.to(torch.float32) + s * (df * keep)
    return out.to(theta.dtype)


# ---------------------------------------------------------------------------
# Gossip-compression codecs (B4-B7; kernels in csrc/codec.cu)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): the constant is split
    into 16-bit halves so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def as_u32(seeds) -> torch.Tensor:
    """Seeds (uint32, int32 or int64 tensor, or numbers) -> int64 tensor
    holding their unsigned 32-bit values. torch has no ``>>`` for uint32 on
    the CPU, so the hash runs in int64 masked to 32 bits."""
    t = torch.as_tensor(seeds)
    return t.to(torch.int64) & _M32


def stochastic_uniform(idx, seed) -> torch.Tensor:
    """The reference's per-element uniform in [0, 1): a murmur-style hash of
    (seed, in-row element index), bit for bit. ``idx`` and ``seed`` broadcast
    against each other; any integer dtype (values taken mod 2**32)."""
    x = as_u32(idx) ^ as_u32(seed)
    x = mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = mul_u32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    # top 24 bits -> [0, 1): exact in f32, and 2**-24 is a power of two
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _pad_to_blocks(x: torch.Tensor, block: int):
    """[W, N] -> ([W, nb, block] zero-padded, nb)."""
    W, n = x.shape
    nb = max(1, -(-n // block))
    pad = nb * block - n
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(W, nb, block), nb


def q8_encode(buf, seeds, *, block: int):
    """Stochastic-rounding int8 quantization with per-block scales.

    buf: [W, N] float bucket; seeds: [W] per-row rounding seeds (uint32
    values). Returns (values int8 [W, nb*block], scales f32 [W, nb]); the
    tail of the last block is zero-padded and quantizes to 0."""
    W, n = buf.shape
    x, nb = _pad_to_blocks(buf.to(torch.float32), block)
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # the f32 rounding of the double 1/127, as jnp.float32(1.0 / 127.0)
    inv = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax * inv, torch.ones_like(amax))
    idx = torch.arange(nb * block, dtype=torch.int64, device=x.device).reshape(1, nb, block)
    u = stochastic_uniform(idx, as_u32(seeds).to(x.device)[:, None, None])
    q = torch.clamp(torch.floor(x / scale + u), -127.0, 127.0)
    return q.to(torch.int8).reshape(W, nb * block), scale.reshape(W, nb)


def q8_decode(values, scales, n: int, *, block: int):
    """Inverse of :func:`q8_encode` -> [W, n] float32."""
    W, nb = scales.shape
    x = values.to(torch.float32).reshape(W, nb, block) * scales[..., None]
    return x.reshape(W, nb * block)[:, :n]


def topk_encode(buf, residual, *, k: int, block: int):
    """Per-block magnitude top-k with error feedback.

    Within every ``block``-element block of ``acc = buf + residual`` keeps
    the ``k`` entries of largest magnitude, in descending order, ties to the
    lowest index (``lax.top_k``'s order: a stable descending sort, since
    ``torch.topk`` promises no order among ties). Returns (values f32
    [W, nb*k], in-block indices int32 [W, nb*k], residual' f32 [W, N]) with
    residual' = acc with the kept entries set to 0."""
    W, n = buf.shape
    acc = buf.to(torch.float32)
    if residual is not None:
        acc = acc + residual.to(torch.float32)
    accb, nb = _pad_to_blocks(acc, block)
    _, order = torch.sort(torch.abs(accb), dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    values = torch.gather(accb, -1, idx)
    kept = torch.zeros(accb.shape, dtype=torch.bool, device=accb.device)
    kept.scatter_(-1, idx, True)
    res = torch.where(kept, torch.zeros_like(accb), accb).reshape(W, nb * block)[:, :n]
    return values.reshape(W, nb * k), idx.to(torch.int32).reshape(W, nb * k), res


def topk_decode(values, idx, n: int, *, k: int, block: int):
    """Inverse of :func:`topk_encode`: the kept (value, index) pairs summed
    into a zero block (a kept -0.0 decodes to +0.0, as in the reference)
    -> [W, n] float32. An index outside the block (only a corrupted wire
    carries one) matches no column and is dropped, as in the kernel and the
    reference's one-hot sum."""
    W = values.shape[0]
    nb = values.shape[1] // k
    i = idx.reshape(W, nb, k).to(torch.int64)
    v = values.to(torch.float32).reshape(W, nb, k)
    valid = (i >= 0) & (i < block)
    # a dropped pair adds +0.0 to column 0, which leaves every sum as it is
    # (columns sum from +0.0, so none holds -0.0)
    i = torch.where(valid, i, torch.zeros_like(i))
    v = torch.where(valid, v, torch.zeros_like(v))
    dense = torch.zeros((W, nb, block), dtype=torch.float32, device=values.device)
    dense.scatter_add_(-1, i, v)
    return dense.reshape(W, nb * block)[:, :n]


NEG_INF = -1e30   # the reference's finite mask value


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              logit_softcap: float = 0.0, q_offset=0, kv_len=None, kv_start=None):
    """Full-softmax attention (B9's plain version; port of the reference's
    oracle ``repro.kernels.ref.attention``).

    q: [B, Sq, H, hd]; k: [B, Skv, Hkv, hd]; v: [B, Skv, Hkv, dv] (BSHD),
    H % Hkv == 0; the values may be narrower than the keys (MLA).
    Scores in f32, ``softcap * tanh(s / softcap)`` when set, then the masks
    (the finite -1e30), softmax over keys, output in q's dtype.
    ``q_offset`` (absolute position of q[:, 0]) and ``kv_len`` (count of
    valid keys) may be python ints or 0-d tensors on q's device;
    ``kv_start`` (optional [B]) is the per-row first visible key, the
    continuous-batching bound that the reference's ``chunked_attention``
    takes. Materialises [B, H, Sq, Skv]: test and check shapes only."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    kr = torch.repeat_interleave(k.float(), G, dim=2)
    vr = torch.repeat_interleave(v.float(), G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * (hd ** -0.5)
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    q_pos = q_offset + torch.arange(Sq, device=dev)[:, None]
    kv_pos = torch.arange(Skv, device=dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kv_pos <= q_pos)
    if window:
        mask = mask & ((q_pos - kv_pos) < window)
    if kv_len is not None:
        mask = mask & (kv_pos < kv_len)
    mask = mask[None, None]                                   # [1, 1, Sq, Skv]
    if kv_start is not None:
        ks = torch.as_tensor(kv_start, device=dev).reshape(B, 1, 1, 1)
        mask = mask & (kv_pos[None, None] >= ks)              # [B, 1, Sq, Skv]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
    return o.to(q.dtype)
