"""Wire-level integrity: checksums and in-flight corruption (port of
``repro.faults.wire``).

The corrupt fault model flips bytes of the packed uint8 ``[W, L]`` wire;
detection is a per-bucket checksum appended to each row. Everything here is
device ops on the wire's device, with no host sync.

Checksum: ``sum_j (2j+1) * byte_j  (mod 2**32)``. The weights are odd, hence
invertible mod 2**32, so any single-byte change is detected; the fault
models flip exactly one byte per bucket. The sum runs in int64, where it
cannot overflow for any wire shorter than about 2**27 bytes per row (each
term is below 255 * 2**28), and is then masked to 32 bits; checksums are
int64 tensors holding the uint32 values (torch has no CPU ``>>`` or ``%``
for uint32).
"""
from __future__ import annotations

import torch

from repro_torch.comm.codecs import _from_u8, _u8
from repro_torch.faults.models import SALT_BYTE, fault_hash

CHECKSUM_BYTES = 4
_M32 = 0xFFFFFFFF


def checksum_u8(wire: torch.Tensor) -> torch.Tensor:
    """Checksum of each row of a packed uint8 [W, L] wire: int64 [W]
    holding uint32 values (odd position weights; see the module doc)."""
    L = wire.shape[-1]
    if L >= 1 << 27:
        raise ValueError(f"wire rows of {L} bytes could overflow the int64 checksum")
    weights = 2 * torch.arange(L, dtype=torch.int64, device=wire.device) + 1
    return torch.sum(wire.to(torch.int64) * weights, dim=-1) & _M32


def _u32_bytes(c: torch.Tensor) -> torch.Tensor:
    """int64 [W] holding uint32 values -> uint8 [W, 4], little-endian."""
    c32 = torch.where(c >= (1 << 31), c - (1 << 32), c).to(torch.int32)
    return _u8(c32[:, None])


def append_checksum(wire: torch.Tensor) -> torch.Tensor:
    """[W, L] uint8 -> [W, L+4] uint8 with the row checksum in the tail."""
    return torch.cat([wire, _u32_bytes(checksum_u8(wire))], dim=-1)


def verify_strip(wire_ext: torch.Tensor):
    """Inverse of :func:`append_checksum`: -> (wire [W, L], ok bool[W])."""
    wire = wire_ext[:, :-CHECKSUM_BYTES]
    got = _from_u8(wire_ext[:, -CHECKSUM_BYTES:], torch.int32)[:, 0].to(torch.int64) & _M32
    return wire, checksum_u8(wire) == got


def corrupt_wire(wire_ext: torch.Tensor, mask, seed: int, step,
                 salt: int = SALT_BYTE) -> torch.Tensor:
    """Flip ONE hash-chosen byte (position and xor value pure in (seed,
    worker, step, salt)) in each row where ``mask``. Returns a new tensor;
    with an all-false mask its bytes equal the input's. The reference xors a
    one-hot ``[W, L]`` plane; xoring the one byte per row by index gives the
    same bytes."""
    W, L = wire_ext.shape
    rows = torch.arange(W, device=wire_ext.device)
    h = fault_hash(seed, rows, step, salt)
    pos = h % L
    flip = (h >> 8) % 255 + 1
    flip = (flip * torch.as_tensor(mask, device=wire_ext.device).to(torch.int64)).to(torch.uint8)
    out = wire_ext.clone()
    out[rows, pos] = out[rows, pos] ^ flip
    return out


def corrupt_roundtrip_buf(buf: torch.Tensor, mask, seed: int, step, salt: int):
    """Uncompressed-wire corruption round trip for one [W, n] flat bucket:
    bitcast -> checksum -> corrupt -> verify. Returns (reconstruction, ok);
    rows that fail verification are zeroed (never applied: the mix discards
    them, and zeroing keeps flipped-to-NaN bytes out of the matmul)."""
    wire = corrupt_wire(append_checksum(_u8(buf)), mask, seed, step, salt)
    payload, ok = verify_strip(wire)
    out = _from_u8(payload, buf.dtype).reshape(buf.shape)
    return torch.where(ok[:, None], out, torch.zeros((), dtype=buf.dtype, device=buf.device)), ok


def corrupt_roundtrip_bufs(bufs: dict, mask, seed: int, step):
    """Per-bucket corruption round trip over a transmit dict (buckets in
    sorted order, salt ``SALT_BYTE + i``). Returns (bufs', ok bool[W]) with
    ok = every bucket verified for that row."""
    out = {}
    ok = None
    for i, name in enumerate(sorted(bufs)):
        out[name], ok_b = corrupt_roundtrip_buf(bufs[name], mask, seed, step, SALT_BYTE + i)
        ok = ok_b if ok is None else (ok & ok_b)
    return out, ok
