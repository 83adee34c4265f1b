"""Dispatch for the port's kernels (port of ``repro.kernels.ops``: the fused
updates B1-B3, the codecs B4-B7, the robust apply B8 and flash attention
B9).

A CUDA tensor always goes to the hand-written kernel, which launches or
raises. A CPU tensor goes to the plain version in :mod:`ref`, whose result
is copied back into theta and v so that both devices share one in-place
contract (the codec and robust entry points return new tensors on both
devices). A ``meta`` tensor (a program counted by
:mod:`repro_torch.analysis.opcount`) runs neither: B1, B2 and B9 shape
their outputs (in place: nothing) and record one launch with the cost of
:mod:`repro_torch.analysis.roofline`; the plain version would add its
intermediates' bytes many times over. Every other kernel raises
ValueError on ``meta``, naming itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import codec as _codec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_update as _fu
from repro_torch.kernels import ref
from repro_torch.kernels import robust as _robust


def _meta_refused(name: str, t) -> None:
    if t.device.type == "meta":
        raise ValueError(f"kernel {name} runs on a CUDA tensor only and has no meta "
                         "branch: a counted program runs B1, B2 and B9")


def _record(name: str, cost) -> None:
    from repro_torch.analysis import opcount
    opcount.record_kernel(name, *cost)


def launch_counts() -> dict:
    """{kernel: launches} of every kernel wrapper since its count was last
    set to 0 (each wrapper counts where it launches, and nowhere else)."""
    return {"fused_flat_elastic_nag_update": _fu.LAUNCHES,
            "fused_flat_nag_update": _fu.NAG_LAUNCHES,
            "fused_elastic_nag_update": _fu.ARRAY_LAUNCHES,
            **_codec.LAUNCHES, "robust_flat_apply": _robust.LAUNCHES,
            "flash_attention": _fa.LAUNCHES}


def zero_launch_counts() -> None:
    _fu.LAUNCHES = _fu.NAG_LAUNCHES = _fu.ARRAY_LAUNCHES = 0
    _robust.LAUNCHES = 0
    _fa.LAUNCHES = 0
    for form in _fa.FORM_LAUNCHES:
        _fa.FORM_LAUNCHES[form] = 0
    for name in _codec.LAUNCHES:
        _codec.LAUNCHES[name] = 0


def fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu, rows=None):
    """[W, N] flat-buffer fused update, IN PLACE on theta and v; per-replica
    coef, scalar eta/mu; ``rows`` (an int32 tensor on theta's device)
    restricts it to the listed rows. Returns (theta, v)."""
    if theta.device.type == "meta":
        from repro_torch.analysis import roofline
        W = theta.shape[0] if rows is None else rows.numel()
        _record("fused_flat_elastic_nag_update", roofline.b1_cost(
            W, theta.shape[1], theta.element_size(), v.element_size()))
        return theta, v
    if theta.device.type == "cpu":
        t_new, v_new = ref.fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu,
                                                         rows=rows)
        theta.copy_(t_new)
        v.copy_(v_new)
        return theta, v
    return _fu.fused_flat_elastic_nag_update(theta, peer, v, g, coef, eta, mu, rows=rows)


def fused_bufs_elastic_nag(theta_bufs, peer_bufs, v_bufs, g_bufs, coef, eta, mu,
                           rows=None):
    """Per-dtype-bucket dispatch of the fused update over flat-buffer dicts —
    the sim engine's hot path (``rows``: the async engine's window).
    Updates theta and v in place; returns (theta_bufs, v_bufs)."""
    for k in theta_bufs:
        fused_flat_elastic_nag_update(theta_bufs[k], peer_bufs[k], v_bufs[k],
                                      g_bufs[k], coef, eta, mu, rows=rows)
    return theta_bufs, v_bufs


def fused_flat_nag_update(theta, v, g, eta, mu):
    """[W, N] flat-buffer pure-NAG update (no peer stream), IN PLACE on theta
    and v; scalar eta/mu. Returns (theta, v)."""
    if theta.device.type == "meta":
        from repro_torch.analysis import roofline
        _record("fused_flat_nag_update", roofline.b2_cost(
            theta.shape[0], theta.shape[1], theta.element_size(), v.element_size()))
        return theta, v
    if theta.device.type == "cpu":
        t_new, v_new = ref.fused_flat_nag_update(theta, v, g, eta, mu)
        theta.copy_(t_new)
        v.copy_(v_new)
        return theta, v
    return _fu.fused_flat_nag_update(theta, v, g, eta, mu)


def fused_bufs_nag(theta_bufs, v_bufs, g_bufs, eta, mu):
    """Per-dtype-bucket pure-NAG update over flat-buffer dicts: the dist
    engine's non-firing hot path. Updates theta and v in place; returns
    (theta_bufs, v_bufs)."""
    for k in theta_bufs:
        fused_flat_nag_update(theta_bufs[k], v_bufs[k], g_bufs[k], eta, mu)
    return theta_bufs, v_bufs


def fused_elastic_nag_update(theta, peer, v, g, coef_gate, *, eta, mu):
    """The update on arrays of any shape with a scalar ``coef_gate``; returns
    NEW (theta', v') on both devices and writes no input."""
    _meta_refused("fused_elastic_nag_update (B3)", theta)
    if theta.device.type == "cpu":
        return ref.fused_elastic_nag_update(theta, peer, v, g, coef_gate, eta=eta, mu=mu)
    return _fu.fused_elastic_nag_update(theta, peer, v, g, coef_gate, eta=eta, mu=mu)


def robust_flat_apply(theta, delta, scale, thr, out=None):
    """[W, N] robust displacement apply ``theta + scale * trim(delta, thr)``
    in theta's dtype (theta is never written); ``delta`` f32,
    ``scale``/``thr`` scalars or [W]. Operands may be column slices of a
    wider plane; the result goes into ``out`` when given (such a slice too),
    else into a new tensor. Returns it."""
    _meta_refused("robust_flat_apply (B8)", theta)
    if theta.device.type == "cpu":
        res = ref.robust_flat_apply(theta, delta, scale, thr)
        return res if out is None else out.copy_(res)
    return _robust.robust_flat_apply(theta, delta, scale, thr, out=out)


def robust_bufs_apply(theta_bufs, delta_bufs, scale, thr):
    """Per-dtype-bucket dispatch of :func:`robust_flat_apply` over flat-buffer
    dicts: the robust protocols' comm hot path. Returns a new dict."""
    return {k: robust_flat_apply(theta_bufs[k], delta_bufs[k], scale, thr)
            for k in theta_bufs}


# ---------------------------------------------------------------------------
# Gossip-compression codecs (repro_torch.comm; [W, N] flat buckets)
# ---------------------------------------------------------------------------

def q8_encode(buf, seeds, *, block: int):
    """Stochastic-rounding int8 quantization -> (values, per-block scales)."""
    _meta_refused("q8_encode (B4)", buf)
    if buf.device.type == "cpu":
        return ref.q8_encode(buf, seeds, block=block)
    return _codec.q8_encode(buf, seeds, block=block)


def q8_decode(values, scales, n: int, *, block: int):
    _meta_refused("q8_decode (B5)", values)
    if values.device.type == "cpu":
        return ref.q8_decode(values, scales, n, block=block)
    return _codec.q8_decode(values, scales, n, block=block)


def topk_encode(buf, residual, *, k: int, block: int):
    """Per-block magnitude top-k with error feedback -> (values, indices,
    residual'); a ``None`` residual is zeros."""
    _meta_refused("topk_encode (B6)", buf)
    if residual is None:
        residual = torch.zeros(buf.shape, dtype=torch.float32, device=buf.device)
    if buf.device.type == "cpu":
        return ref.topk_encode(buf, residual, k=k, block=block)
    return _codec.topk_encode(buf, residual, k=k, block=block)


def topk_decode(values, idx, n: int, *, k: int, block: int):
    _meta_refused("topk_decode (B7)", values)
    if values.device.type == "cpu":
        return ref.topk_decode(values, idx, n, k=k, block=block)
    return _codec.topk_decode(values, idx, n, k=k, block=block)


# ---------------------------------------------------------------------------
# Attention (B9)
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset=0, kv_len=None, kv_start=None):
    """BSHD attention, the model's entry: q [B, Sq, H, hd]; k [B, Skv, Hkv,
    hd]; v [B, Skv, Hkv, dv], dv <= hd (MLA's latent values; any strides
    with a contiguous head dim: the cache goes in without a copy).
    ``q_offset``/``kv_len`` are ints or device scalars, ``kv_start`` None or
    [B]. Returns [B, Sq, H, dv] in q's dtype. On ``meta`` the kernel's cost
    counts every cache row where ``kv_len`` is a tensor (its value is not
    known there)."""
    if q.device.type == "meta":
        from repro_torch.analysis import roofline
        B, Sq, H, hd = q.shape
        _, Skv, Hkv, dv = v.shape
        visible = kv_len if isinstance(kv_len, int) else Skv
        _record("flash_attention", roofline.b9_cost(
            B, Sq, H, Hkv, hd, visible, dv=dv, size=q.element_size(), causal=causal,
            window=window))
        return q.new_empty((B, Sq, H, dv))
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window, logit_softcap=softcap,
                             q_offset=q_offset, kv_len=kv_len, kv_start=kv_start)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               q_offset=q_offset, kv_len=kv_len, kv_start=kv_start)


def flash_attention(q, k, v, kv_len=None, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset=0, kv_start=None):
    """q: [B, H, Sq, hd]; k, v: [B, Hkv, Skv, hd] (BHSD layout, the
    reference's ``ops.flash_attention`` signature, plus ``kv_start``).
    Returns [B, H, Sq, hd]: :func:`attention` on the BSHD views, with no
    transposing copy."""
    return attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                     window=window, softcap=softcap, q_offset=q_offset, kv_len=kv_len,
                     kv_start=kv_start).transpose(1, 2)
