"""Gossip-compression codecs over the flat parameter plane (port of
``repro.comm.codecs``).

A codec turns one flat-plane bucket (``[W, N]``) into a *wire*, the arrays
that leave the worker, and back into an approximate buffer:

- ``encode``/``decode`` are the fidelity surface: the sim engine mixes
  against ``decode(encode(theta))`` (exact self, reconstructed peers);
- ``pack``/``unpack`` flatten the wire into one uint8 buffer per row, with
  the reference's little-endian bytes;
- ``wire_bytes`` is the static per-replica size that ``comm_bytes`` and
  ``Protocol.comm_cost`` report instead of raw parameter bytes;
- rounding noise is a hash of (round, worker, element index)
  (:func:`codec_seeds`, :func:`repro_torch.kernels.ref.stochastic_uniform`),
  so the same round gives the same wire as the reference, bit for bit.

Stateful codecs (``topk``) carry an error-feedback residual in
:class:`CommState`: one f32 ``[W, total]`` buffer per bucket.

Encode and decode go through :mod:`repro_torch.kernels.ops`: kernels B4-B7
on CUDA tensors, their plain versions on CPU tensors. Seeds are int64
tensors holding unsigned 32-bit values (torch has no CPU ``>>`` for uint32).
The fleet plane's ``wire_partition_bytes`` comes with the fleet slice.
"""
from __future__ import annotations

from typing import Any, ClassVar, NamedTuple, Optional, Tuple

import torch

from repro_torch.comm.registry import register_codec, resolve_codec
from repro_torch.common.flat import FlatSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ref import as_u32, mul_u32

Wire = Tuple[torch.Tensor, ...]

_M32 = 0xFFFFFFFF


class CommState(NamedTuple):
    """Communication-plane state: ``residual`` is the error-feedback carry of
    a stateful codec (``{bucket: f32 [W, total]}``), or ``None``."""
    residual: Optional[Any]


class Codec:
    """One gossip-compression scheme: an immutable view over a frozen
    :class:`~repro_torch.common.config.ProtocolConfig` (``codec_block`` /
    ``codec_topk_frac``); evolving state lives in :class:`CommState`."""

    name: ClassVar[str] = ""          # set by @register_codec
    identity: ClassVar[bool] = False  # true -> engines skip the codec path
    stateful: ClassVar[bool] = False  # carries an error-feedback residual

    def __init__(self, cfg):
        self.cfg = cfg
        self.block = int(cfg.codec_block)
        assert self.block > 0 and self.block % 128 == 0, (
            "codec_block must be a positive lane multiple", self.block)

    def _nb(self, n: int) -> int:
        return max(1, -(-n // self.block))

    def wire_bytes(self, n: int, itemsize: int) -> int:
        """Wire bytes for one replica row of an ``n``-element bucket."""
        raise NotImplementedError

    def encode(self, buf, seeds, residual=None) -> Tuple[Wire, Optional[torch.Tensor]]:
        """[W, N] bucket (+ optional [W, N] f32 residual) -> (wire arrays,
        residual' or None). ``seeds``: [W] per-row rounding seeds."""
        raise NotImplementedError

    def decode(self, wire: Wire, n: int) -> torch.Tensor:
        """Wire arrays -> [W, n] float32 reconstruction."""
        raise NotImplementedError

    def roundtrip(self, buf, seeds, residual=None):
        """decode(encode(buf)) -> (reconstruction, residual')."""
        wire, res = self.encode(buf, seeds, residual)
        return self.decode(wire, buf.shape[1]), res

    def pack(self, wire: Wire) -> torch.Tensor:
        """Wire arrays -> ONE uint8 [W, L] buffer; L == :meth:`wire_bytes`."""
        raise NotImplementedError

    def unpack(self, packed: torch.Tensor, n: int) -> Wire:
        """Inverse of :meth:`pack` for an ``n``-element bucket."""
        raise NotImplementedError

    def decode_wire(self, packed: torch.Tensor, n: int) -> torch.Tensor:
        return self.decode(self.unpack(packed, n), n)


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Bitcast a [W, L] tensor to uint8 [W, L * itemsize] (little-endian, as
    ``jax.lax.bitcast_convert_type`` with the byte dim folded in)."""
    return x.contiguous().view(torch.uint8)


def _from_u8(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return b.contiguous().view(dtype)


# ---------------------------------------------------------------------------
# builtin codecs
# ---------------------------------------------------------------------------

@register_codec("none")
class IdentityCodec(Codec):
    """Uncompressed wire (the engines bypass the codec path; this class backs
    accounting and tests)."""
    identity = True

    def wire_bytes(self, n: int, itemsize: int) -> int:
        return n * itemsize

    def encode(self, buf, seeds, residual=None):
        return (buf,), None

    def decode(self, wire, n):
        return wire[0].to(torch.float32)

    def pack(self, wire):
        return _u8(wire[0])

    def unpack(self, packed, n):
        raise NotImplementedError("identity codec has no packed wire format")


@register_codec("q8")
class Q8Codec(Codec):
    """Stochastic-rounding int8 quantization, one f32 scale per
    ``codec_block`` elements (kernels B4/B5)."""

    def wire_bytes(self, n: int, itemsize: int) -> int:
        if n == 0:
            return 0
        nb = self._nb(n)
        return nb * self.block + 4 * nb          # int8 values + f32 scales

    def encode(self, buf, seeds, residual=None):
        W, n = buf.shape
        if n == 0:
            return (torch.zeros((W, 0), dtype=torch.int8, device=buf.device),
                    torch.zeros((W, 0), dtype=torch.float32, device=buf.device)), None
        return ops.q8_encode(buf, seeds, block=self.block), None

    def decode(self, wire, n):
        values, scales = wire
        if n == 0:
            return torch.zeros((values.shape[0], 0), dtype=torch.float32,
                               device=values.device)
        return ops.q8_decode(values, scales, n, block=self.block)

    def pack(self, wire):
        values, scales = wire
        return torch.cat([_u8(values), _u8(scales)], dim=-1)

    def unpack(self, packed, n):
        nb = self._nb(n) if n else 0
        split = nb * self.block
        return (_from_u8(packed[:, :split], torch.int8),
                _from_u8(packed[:, split:split + 4 * nb], torch.float32))


@register_codec("topk")
class TopKCodec(Codec):
    """Per-block magnitude top-k with error feedback (kernels B6/B7): the
    ``codec_topk_frac`` largest-magnitude entries of each block of
    ``acc = buf + residual`` ride the wire as (f32 value, int32 index)
    pairs; the rest carries to the next round in ``CommState.residual``."""
    stateful = True

    def __init__(self, cfg):
        super().__init__(cfg)
        # Python's round, as the reference: k = 26 at block 512, frac 0.05
        self.k = max(1, int(round(float(cfg.codec_topk_frac) * self.block)))
        assert self.k <= self.block

    def wire_bytes(self, n: int, itemsize: int) -> int:
        if n == 0:
            return 0
        return self._nb(n) * self.k * 8          # f32 value + int32 index

    def encode(self, buf, seeds, residual=None):
        W, n = buf.shape
        if n == 0:
            z = torch.zeros((W, 0), dtype=torch.float32, device=buf.device)
            return (z, torch.zeros((W, 0), dtype=torch.int32, device=buf.device)), z
        values, idx, res = ops.topk_encode(buf, residual, k=self.k, block=self.block)
        return (values, idx), res

    def decode(self, wire, n):
        values, idx = wire
        if n == 0:
            return torch.zeros((values.shape[0], 0), dtype=torch.float32,
                               device=values.device)
        return ops.topk_decode(values, idx, n, k=self.k, block=self.block)

    def pack(self, wire):
        values, idx = wire
        return torch.cat([_u8(values), _u8(idx)], dim=-1)

    def unpack(self, packed, n):
        m = (self._nb(n) * self.k) if n else 0
        return (_from_u8(packed[:, :4 * m], torch.float32),
                _from_u8(packed[:, 4 * m:8 * m], torch.int32))


# ---------------------------------------------------------------------------
# shared helpers (engine + accounting)
# ---------------------------------------------------------------------------

def codec_seeds(round_idx, worker_ids) -> torch.Tensor:
    """Per-worker rounding seeds for one gossip round, the reference's uint32
    values in an int64 tensor: ``(r + 1) * 2654435761 ^ (w * 0x9E3779B9 +
    0x85EBCA6B)`` mod 2**32. Device ops only, so a device-side round counter
    needs no host sync."""
    r, w = as_u32(round_idx), as_u32(worker_ids)
    if isinstance(round_idx, torch.Tensor):
        w = w.to(r.device)
    else:
        r = r.to(w.device)
    return mul_u32((r + 1) & _M32, 2654435761) ^ ((mul_u32(w, 0x9E3779B9) + 0x85EBCA6B) & _M32)


def wire_param_bytes(codec: Codec, spec: FlatSpec) -> int:
    """Wire bytes of ONE replica of the flat plane under ``codec``: what
    ``comm_bytes`` / ``comm_cost`` account per communication event."""
    return int(sum(codec.wire_bytes(n, getattr(torch, b).itemsize)
                   for b, n in spec.totals.items()))


def wire_partition_bytes(codec: Codec, spec: FlatSpec, bounds) -> tuple:
    """Wire bytes per partition chunk id (:mod:`repro_torch.fleet`).
    ``bounds`` is ``{bucket: ((lo, hi), ...)}``, one slice of the bucket's
    [total] dim per chunk id: chunk ``c``'s wire is every bucket's
    ``[lo_c, hi_c)`` slice through ``codec``."""
    num_chunks = len(next(iter(bounds.values())))
    out = []
    for c in range(num_chunks):
        total = 0
        for b in spec.totals:
            lo, hi = bounds[b][c]
            if hi > lo:
                total += codec.wire_bytes(int(hi - lo), getattr(torch, b).itemsize)
        out.append(int(total))
    return tuple(out)


def roundtrip_bufs(codec: Codec, bufs, seeds, res_bufs=None, gate=None):
    """decode(encode(.)) over a dict of flat-plane buckets.

    ``res_bufs``: per-bucket residuals of a stateful codec (None -> zeros).
    ``gate`` (optional, broadcastable against ``[W, N]``): a stateful codec's
    residual advances only for rows whose OWN gate fired, so mass encoded
    into a wire the receiver discards is carried, not dropped. ``gate`` may
    also be a per-bucket dict of ``[W, N]`` masks: the partition plane
    advances the residual only in the columns of the chunk a worker shipped.
    Returns (hat_bufs, new_res_bufs or None)."""
    res_bufs = res_bufs or {}
    hat, new_res = {}, {}
    for k, b in bufs.items():
        r = res_bufs.get(k)
        if r is None and codec.stateful:
            r = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        hat[k], r2 = codec.roundtrip(b, seeds, residual=r)
        if codec.stateful:
            g = gate.get(k) if isinstance(gate, dict) else gate
            if g is None:
                new_res[k] = r2
            else:
                g = torch.as_tensor(g, device=r2.device).bool()
                new_res[k] = torch.where(g, r2, r)
    return hat, (new_res if codec.stateful else None)


def init_comm_state(codec: Optional[Codec], theta) -> CommState:
    """Fresh CommState: zero f32 residual buffers shaped like ``theta`` (a
    dict of flat buffers) for a stateful codec, else an empty state."""
    if codec is None or not codec.stateful:
        return CommState(None)
    return CommState({k: torch.zeros(b.shape, dtype=torch.float32, device=b.device)
                      for k, b in theta.items()})


def active_codec(cfg) -> Optional[Codec]:
    """``cfg.codec`` as a Codec, or ``None`` when compression is off."""
    codec = resolve_codec(cfg)
    return None if codec.identity else codec
