"""Count one device's program on the ``meta`` device: FLOPs, bytes and
collectives, with nothing allocated (the port's counterpart of
``repro.analysis.hlo``, which walks XLA's optimized HLO text).

The port counts the program it runs. :class:`OpCounter` is a
``TorchDispatchMode``: run a function under it on ``meta`` tensors and
every aten op the program dispatches is seen once, after autograd and
``torch.func`` have done their work (the ops under ``vmap`` arrive
batched, so a ``[W, ...]`` plane's op counts all W workers' work).

- **flops**: the matmul-like ops (mm, bmm, addmm, baddbmm, the
  convolutions, SDPA), by the formulas of ``torch.utils.flop_counter``:
  2 x M x N x K for a product, as the reference's ``dot`` count.
  Elementwise work is not counted (the reference adds half a fusion's
  result bytes for it, "roofline noise").
- **bytes_accessed**: the operands plus the result of every op that is not
  a view (views, ``_unsafe_view``, ``detach`` and ``alias`` move nothing,
  and ``empty`` writes nothing). This is the eager counterpart of the
  reference's fusion-boundary traffic: XLA fuses elementwise chains and
  moves their intermediates through registers, eager PyTorch writes each
  op's result to memory and reads it back, so a program's counted bytes
  are at or above the reference's fused ones.
- **loops** need no trip counts: eager code unrolls them (a python loop
  over the layers dispatches each layer's ops). The reference counts the
  costliest branch of a ``lax.switch``; the port counts the branch its
  program takes (the train-gossip program takes the firing one).
- **kernels**: the port's kernels are bound through ctypes, so the
  dispatcher never sees them. :mod:`repro_torch.kernels.ops` gives them a
  ``meta`` branch that shapes their outputs and calls :func:`record_kernel`
  with the kernel's cost from :mod:`repro_torch.analysis.roofline`: one op
  under the kernel's own name, as the reference's walk sees a Pallas
  custom call as one top-level instruction.
- **collectives**: :class:`CountingWorkerGroup` and
  :class:`CountingModelGroup` stand in for
  :class:`~repro_torch.launch.mesh.WorkerGroup` and
  :class:`~repro_torch.launch.mesh.ModelGroup` (the reference's
  ``make_abstract_worker_mesh``: a mesh with no process behind it). Each
  collective returns ``meta`` results and adds the bytes one device sends
  to ``collective_bytes``, keyed by the reference's HLO names: a ring
  all-reduce of n bytes over M ranks sends 2 (M - 1) / M x n, an
  all-gather of n bytes a rank (M - 1) x n, an exchange
  (``collective-permute``) n.

    with OpCounter() as c:
        out = program(*meta_args)
    c.costs.flops, c.costs.bytes_accessed, c.costs.collective_breakdown
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.common.config import MeshConfig

aten = torch.ops.aten

# ops that move no data although their schema returns a fresh tensor
_FREE = {aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh,
         aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten._local_scalar_dense}
_ACTIVE: List["OpCounter"] = []


@dataclasses.dataclass
class Costs:
    """The reference's ``Costs`` fields, plus ``ops``: the counted ops by
    name (a kernel under its own name)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)
    ops: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add_op(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes
        self.ops[name] = self.ops.get(name, 0) + 1

    def add_collective(self, kind: str, nbytes: float) -> None:
        self.collective_bytes += nbytes
        self.collective_breakdown[kind] = self.collective_breakdown.get(kind, 0.0) + nbytes


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tree_bytes(tree) -> int:
    return sum(tensor_bytes(t) for t in tree_flatten(tree)[0])


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched inside its ``with`` block into
    :attr:`costs` (see the module docstring). Counters nest: an op or a
    kernel is added to every active one."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._flops = _flop_registry()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if func.is_view or packet in _FREE:
            return out
        flops = 0
        if packet in self._flops:
            flops = self._flops[packet](*args, **kwargs, out_val=out)
        nbytes = _tree_bytes((args, kwargs)) + _tree_bytes(out)
        self.costs.add_op(packet.__name__, flops, nbytes)
        return out


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """One launch of the port's kernel ``name`` in every active counter
    (called by the kernels' ``meta`` branch in
    :mod:`repro_torch.kernels.ops`)."""
    for c in _ACTIVE:
        c.costs.add_op(name, flops, nbytes)


def record_collective(kind: str, nbytes: float) -> None:
    for c in _ACTIVE:
        c.costs.add_collective(kind, nbytes)


def count(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its :class:`Costs`)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.costs


def meta_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    """A ``meta`` tensor of ``t``'s dtype and shape (or ``shape``)."""
    return torch.empty(t.shape if shape is None else shape, dtype=t.dtype, device="meta")


def to_meta(tree):
    """``tree`` with every tensor a :func:`meta_like` of it: dicts, lists,
    tuples, named tuples and dataclasses (a ``FlatState``) are walked, a
    generator becomes None (a counted program takes its draws as inputs)."""
    if isinstance(tree, torch.Tensor):
        return meta_like(tree)
    if isinstance(tree, torch.Generator):
        return None
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_meta(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_meta(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) and any(
            isinstance(getattr(tree, f.name), (torch.Tensor, dict, tuple, torch.Generator))
            for f in dataclasses.fields(tree)):
        return dataclasses.replace(tree, **{f.name: to_meta(getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


# ---------------------------------------------------------------------------
# counting stand-ins for the process groups
# ---------------------------------------------------------------------------

class CountingWorkerGroup:
    """A :class:`~repro_torch.launch.mesh.WorkerGroup` with no process: rank
    ``rank`` of ``mesh_cfg.num_workers`` on the ``meta`` device. Its
    collectives return ``meta`` tensors of the real results' shapes and
    record what this rank sends."""

    def __init__(self, mesh_cfg: MeshConfig, rank: int = 0):
        self.mesh_cfg = mesh_cfg
        self.world = mesh_cfg.num_workers
        self.rank = int(rank)
        self.pod, self.worker = divmod(self.rank, mesh_cfg.workers_per_pod)
        self.device = torch.device("meta")
        self.sends = self.recvs = 0

    def exchange(self, tensors: Sequence[torch.Tensor], partner: int) -> List[torch.Tensor]:
        if partner != self.rank:
            record_collective("collective-permute", sum(tensor_bytes(t) for t in tensors))
            self.sends += len(tensors)
            self.recvs += len(tensors)
        return [meta_like(t) for t in tensors]

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        M = self.world
        record_collective("all-reduce", 2 * (M - 1) / M * tensor_bytes(t))
        return meta_like(t)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        record_collective("all-gather", (self.world - 1) * tensor_bytes(t))
        return meta_like(t, (self.world * t.shape[0],) + tuple(t.shape[1:]))

    def barrier(self) -> None:
        pass


class CountingModelGroup:
    """A :class:`~repro_torch.launch.mesh.ModelGroup` with no process: rank
    ``rank`` of ``mesh_cfg.model`` on the ``meta`` device, counting its
    collectives as the real group does (``all_reduces``, ``all_gathers``)
    and recording what this rank sends."""

    def __init__(self, mesh_cfg: MeshConfig, rank: int = 0):
        if mesh_cfg.model < 2:
            raise ValueError(f"a model group needs MeshConfig(model >= 2), got "
                             f"{mesh_cfg.model}")
        self.mesh_cfg = mesh_cfg
        self.world = mesh_cfg.model
        self.rank = int(rank)
        self.device = torch.device("meta")
        self.all_reduces = self.all_gathers = 0
        self.collective_s = 0.0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        M = self.world
        record_collective("all-reduce", 2 * (M - 1) / M * tensor_bytes(t))
        self.all_reduces += 1
        return meta_like(t)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        record_collective("all-gather", (self.world - 1) * tensor_bytes(t))
        self.all_gathers += 1
        shape = list(t.shape)
        shape[dim] *= self.world
        return meta_like(t, tuple(shape))

    def counts(self) -> Dict[str, float]:
        return {"all_reduce": self.all_reduces, "all_gather": self.all_gathers,
                "host_s": self.collective_s}

    def reset_counts(self) -> None:
        self.all_reduces = self.all_gathers = 0

    def barrier(self) -> None:
        pass
