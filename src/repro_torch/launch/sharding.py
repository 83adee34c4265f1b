"""Logical-axis -> mesh-axis sharding rules (port of
``repro.launch.sharding``).

Model init functions return a parallel tree of *logical axis tuples*, one
entry per array dim (e.g. ``("embed", "ffn")`` for an MLP kernel). This
module maps the logical names onto the worker mesh's axes ``(pod, worker,
fsdp, model)``, dropping any assignment that is not divisible or whose mesh
axis an earlier dim of the same leaf already took (a leaf uses each mesh
axis at most once). The mesh's sizes come from a
:class:`~repro_torch.common.config.MeshConfig`; no device is needed.

A spec is a plain tuple with one entry per dim: ``None`` (replicated), an
axis name, or a tuple of names (the reference's ``PartitionSpec``
entries). The port's tensor-parallel serving
(:mod:`repro_torch.serving.tensor_parallel`) slices each leaf by its
spec's ``model`` entry.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.common.config import MeshConfig

PyTree = Any
Spec = Tuple[Any, ...]

# default rule table: logical axis -> mesh axes, the reference's
DEFAULT_RULES: Dict[Optional[str], Tuple[str, ...]] = {
    "worker": ("pod", "worker"),   # leading replica dim of stacked params
    "embed": ("fsdp",),            # d_model dims
    "ffn": ("model",),             # hidden / ffn dims (tensor parallel)
    "heads": ("model",),           # attention head dims
    "kv_heads": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "dispatch": ("pod", "worker", "fsdp"),   # local-dispatch shard dim (MoE)
    "inner": ("model",),           # ssm / xlstm inner dims
    "batch": ("pod", "worker", "fsdp"),
    "act_embed": (),               # activation d_model: replicated
    "seq": (),
    None: (),
}


def mesh_sizes(mesh_cfg: MeshConfig) -> Dict[str, int]:
    """The worker mesh's axis sizes, the reference's ``make_worker_mesh``
    shape ``(pods, workers_per_pod, fsdp, model)``."""
    return {"pod": mesh_cfg.pods, "worker": mesh_cfg.workers_per_pod,
            "fsdp": mesh_cfg.fsdp, "model": mesh_cfg.model}


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh_cfg: MeshConfig,
             rules: Optional[dict] = None) -> Spec:
    """The spec of one leaf, honouring divisibility and one use of each mesh
    axis per leaf."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_sizes(mesh_cfg)
    used = set()
    out = []
    assert len(shape) == len(axes), (shape, axes)
    for dim, name in zip(shape, axes):
        picked: Tuple[str, ...] = ()
        total = 1
        for m in rules.get(name, ()):
            if m not in sizes or m in used or dim % (total * sizes[m]) != 0:
                continue
            picked = picked + (m,)
            used.add(m)
            total *= sizes[m]
        out.append(None if not picked else picked[0] if len(picked) == 1 else picked)
    return tuple(out)


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None))) for i in x)


def _axes_map(fn, axes: PyTree, *rest: PyTree) -> PyTree:
    """``fn(axes_leaf, *rest_leaves)`` over an axes tree, whose tuple leaves
    are not traversed; ``rest`` trees share its dict structure."""
    if is_axes_leaf(axes):
        return fn(axes, *rest)
    if isinstance(axes, dict):
        return {k: _axes_map(fn, axes[k], *(r[k] for r in rest)) for k in axes}
    raise TypeError(f"not an axes tree node: {axes!r}")


def tree_specs(shapes: PyTree, axes: PyTree, mesh_cfg: MeshConfig,
               rules: Optional[dict] = None) -> PyTree:
    """:func:`spec_for` over parallel (shape, logical axes) trees; ``shapes``
    leaves are tensors (e.g. on the ``meta`` device) or shape tuples."""
    return _axes_map(lambda a, s: spec_for(tuple(getattr(s, "shape", s)), a, mesh_cfg, rules),
                     axes, shapes)


def with_worker_dim(axes: PyTree) -> PyTree:
    """Prepend the ``worker`` logical axis to every leaf's axes (stacked
    per-replica params)."""
    return _axes_map(lambda a: ("worker",) + tuple(a), axes)


def model_dim(spec: Spec) -> Optional[int]:
    """The dim a spec splits over ``model``, or None (replicated there)."""
    for i, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i
    return None
