"""Flat parameter plane: one contiguous lane-aligned buffer per dtype.

The port of ``repro.common.flat``. Leaves are bucketed by dtype and laid out
in sorted-dict-key order (the order ``jax.tree.flatten`` gives), each padded
to a multiple of ``LANE`` elements, so offsets and totals equal the
reference's and buffers compare element by element across the two packages.

``leading`` dims (the stacked replica axis) pass through: a ``[W, ...]``
stacked tree flattens to ``[W, total]`` buffers. :meth:`FlatSpec.views`
returns slice + ``view`` aliases of the buffers through a custom backward
(the reference's scatter VJP): a loss computed through them differentiates
onto the flat plane as ONE new buffer per bucket, each leaf's cotangent
written once at its offset and zeros in the lane padding, where plain slice
views would fill and add a zeroed plane per leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten

PyTree = Any

LANE = 128   # every leaf offset aligns to it (the reference's TPU lane width)


def _align(n: int, a: int = LANE) -> int:
    return ((n + a - 1) // a) * a


def dtype_name(dtype: torch.dtype) -> str:
    """Canonical bucket name: ``torch.float32`` -> ``"float32"`` (the same
    names ``jnp.dtype(...).name`` gives the reference's buckets)."""
    return str(dtype).split(".")[-1]


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Static placement of one leaf inside its dtype bucket."""
    bucket: str                # dtype bucket key (canonical dtype name)
    offset: int                # element offset within the bucket (lane-aligned)
    size: int                  # elements per item (leading dims excluded)
    shape: Tuple[int, ...]     # per-item shape (leading dims excluded)
    dtype: torch.dtype         # storage dtype the leaf unflattens to


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a pytree on the flat plane (cache one per trainer)."""
    treedef: Any
    leading: int                    # number of leading (replica) dims passed through
    lead_shape: Tuple[int, ...]
    slots: Tuple[LeafSlot, ...]     # one per leaf, flatten order
    totals: Dict[str, int]          # bucket -> padded total elements
    align: int = LANE               # per-leaf padding granularity (elements)

    @staticmethod
    def build(tree: PyTree, leading: int = 0, align: int = LANE) -> "FlatSpec":
        """Layout for ``tree`` (tensors); the first ``leading`` dims of every
        leaf are shared pass-through (replica) dims."""
        leaves, treedef = tree_flatten(tree)
        assert leaves, "cannot build a FlatSpec over an empty tree"
        lead_shape = tuple(int(d) for d in leaves[0].shape[:leading])
        offsets: Dict[str, int] = {}
        slots: List[LeafSlot] = []
        for x in leaves:
            assert tuple(int(d) for d in x.shape[:leading]) == lead_shape, (
                "all leaves must share the leading dims", x.shape, lead_shape)
            shape = tuple(int(d) for d in x.shape[leading:])
            size = 1
            for d in shape:
                size *= d
            bucket = dtype_name(x.dtype)
            off = offsets.setdefault(bucket, 0)
            slots.append(LeafSlot(bucket, off, size, shape, x.dtype))
            offsets[bucket] = off + _align(size, align)
        return FlatSpec(treedef, leading, lead_shape, tuple(slots), dict(offsets), align)

    def __hash__(self):
        return hash((self.treedef, self.leading, self.lead_shape, self.slots,
                     tuple(sorted(self.totals.items())), self.align))

    def with_lead(self, lead_shape: Tuple[int, ...]) -> "FlatSpec":
        """The same layout bound to different leading (replica) dims:
        ``with_lead(())`` for one replica row, ``with_lead((W,))`` for a
        whole stacked plane."""
        return dataclasses.replace(self, leading=len(lead_shape),
                                   lead_shape=tuple(int(d) for d in lead_shape))

    # ------------------------------------------------------------------- ops
    def flatten(self, tree: PyTree) -> Dict[str, torch.Tensor]:
        """Tree -> one fresh contiguous ``[*lead, total]`` buffer per bucket
        (zeros in the lane padding). Bucketing follows the SPEC; the buffers
        carry the argument's dtypes. The result never aliases ``tree``, so
        the engines may update it in place."""
        leaves = tree_flatten(tree)[0]
        assert len(leaves) == len(self.slots), (len(leaves), len(self.slots))
        out: Dict[str, torch.Tensor] = {}
        for x, s in zip(leaves, self.slots):
            buf = out.get(s.bucket)
            if buf is None:
                buf = out[s.bucket] = torch.zeros(
                    self.lead_shape + (self.totals[s.bucket],),
                    dtype=x.dtype, device=x.device)
            buf[..., s.offset:s.offset + s.size] = x.reshape(self.lead_shape + (s.size,))
        return out

    def unflatten(self, bufs: Dict[str, torch.Tensor],
                  like: Optional[PyTree] = None) -> PyTree:
        """Buffers -> tree of slice/reshape views. ``like`` (optional)
        supplies per-leaf dtypes to cast to instead of the spec's storage
        dtypes. A leaf whose dtype already matches is a view (no copy)."""
        if like is not None:
            dts = [x.dtype for x in tree_flatten(like)[0]]
        else:
            dts = [s.dtype for s in self.slots]
        leaves = []
        for s, dt in zip(self.slots, dts):
            v = bufs[s.bucket][..., s.offset:s.offset + s.size]
            leaves.append(v.reshape(self.lead_shape + s.shape).to(dt))
        return tree_unflatten(self.treedef, leaves)

    def views(self, bufs: Dict[str, torch.Tensor]) -> PyTree:
        """Slice + view aliases of ``bufs`` — the engines' loss boundary,
        with the reference's scatter backward (:class:`_Views`). A leaf is
        cast to the spec's dtype where its buffer holds another (a bf16
        bucket the unfused path promoted to f32), as the reference's views
        are; otherwise it is a view, with no copy. The buffers' leading dims
        are their own (a row under ``vmap`` has none)."""
        names = tuple(bufs)
        index = {k: i for i, k in enumerate(names)}
        slots = tuple((index[s.bucket], s.offset, s.size, s.shape, s.dtype)
                      for s in self.slots)
        leaves = _Views.apply(slots, *(bufs[k] for k in names))
        return tree_unflatten(self.treedef, list(leaves))


class _Views(torch.autograd.Function):
    """The leaves of flat buffers (``slots``: per leaf its buffer's index,
    offset, size, shape and dtype) with the reference's scatter VJP
    (``repro.common.flat._views``): the backward builds each buffer's
    gradient as ONE ``torch.cat`` of the flattened leaf cotangents in slot
    order, zeros between slots and after the last, so a step allocates one
    plane per bucket whatever the number of leaves. ``vmap`` runs it
    through the generated rule (the engines' ``vmap(grad_and_value(...))``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(slots, *bufs):
        return tuple(bufs[b][..., off:off + size].reshape(bufs[b].shape[:-1] + shape).to(dt)
                     for b, off, size, shape, dt in slots)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.slots = inputs[0]
        ctx.bufs = [(tuple(b.shape), b.dtype, b.device) for b in inputs[1:]]

    @staticmethod
    def backward(ctx, *cts):
        parts = [[] for _ in ctx.bufs]
        ends = [0] * len(ctx.bufs)

        def zeros(b, n):
            shape, dt, dev = ctx.bufs[b]
            return torch.zeros(shape[:-1] + (n,), dtype=dt, device=dev)

        for g, (b, off, size, _shape, _dt) in zip(cts, ctx.slots):
            if size == 0:
                continue
            if off > ends[b]:
                parts[b].append(zeros(b, off - ends[b]))
            shape, dt, _ = ctx.bufs[b]
            parts[b].append(g.reshape(shape[:-1] + (size,)).to(dt))
            ends[b] = off + size
        grads = []
        for b, (shape, _dt, _dev) in enumerate(ctx.bufs):
            if shape[-1] > ends[b]:
                parts[b].append(zeros(b, shape[-1] - ends[b]))
            if not parts[b]:
                parts[b].append(zeros(b, 0))
            grads.append(parts[b][0] if len(parts[b]) == 1 else torch.cat(parts[b], dim=-1))
        return (None, *grads)
