"""Minimal pytree utilities over nested dicts / lists / tuples of tensors.

Dict keys flatten in SORTED order, as ``jax.tree.flatten`` does, so leaf
order (and with it every flat-plane offset) equals the reference's.
``torch.utils._pytree`` keeps insertion order instead, which would put
``w0`` before ``b0`` for ``init_mlp`` and shift every offset.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

PyTree = Any


def tree_flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """(leaves, treedef); ``treedef`` is a hashable nested description."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, defs = [], []
        for k in keys:
            lv, d = tree_flatten(tree[k])
            leaves.extend(lv)
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for x in tree:
            lv, d = tree_flatten(x)
            leaves.extend(lv)
            defs.append(d)
        return leaves, (type(tree).__name__, len(tree), tuple(defs))
    if tree is None:
        return [], ("none",)
    return [tree], ("leaf",)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> PyTree:
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(d[1], d[2])}
        items = [build(sub) for sub in d[2]]
        return items if kind == "list" else tuple(items)

    out = build(treedef)
    assert next(it, None) is None, "too many leaves for treedef"
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_zeros_like(a: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, a)


def global_norm(a: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x*x), in f32."""
    sq = [torch.sum(x.float() * x.float()) for x in tree_leaves(a)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def tree_take_leading(tree: PyTree, i) -> PyTree:
    """Select worker ``i``'s replica from stacked params (paper 'Rank-0')."""
    return tree_map(lambda x: x[i], tree)
