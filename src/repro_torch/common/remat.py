"""Rematerialisation: the port's counterpart of ``jax.checkpoint``.

:func:`checkpoint` runs ``fn(*args)`` and keeps only its tensor inputs for
the backward, which runs ``fn`` again on them and differentiates that
recompute. The training forward checkpoints each layer when ``cfg.remat``
is set (``models/transformer.py``) and each key chunk of the online
softmax always (``models/attention.py``), as the reference does.

``torch.utils.checkpoint`` refuses under ``torch.func`` transforms (the
engines' ``vmap(grad_and_value(...))``): it needs saved-tensor hooks, and
its reentrant form has no ``setup_context``. :class:`_Checkpoint` is a
``torch.autograd.Function`` with ``setup_context`` and
``generate_vmap_rule``, which runs under them, under plain autograd and on
``meta`` alike.

Its backward detaches the saved inputs and the incoming cotangents before
it recomputes ``fn`` under ``torch.func.vjp``: ``torch.func.grad`` runs the
backward with ``create_graph``, and without the detach each recomputed
layer's graph stays reachable from the returned gradients until the
transform returns, so nothing would be saved. The gradients are therefore
first-order only: differentiating them again gives zero through a
checkpoint, which no engine of the port does.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.obs import spans


def checkpoint(fn: Callable, *args, label: Optional[str] = "remat recompute"):
    """``fn(*args)``, recomputed in the backward instead of kept.

    ``args`` may be pytrees (a layer's parameter views, ``cond``); their
    tensor leaves are the Function's inputs, every other leaf (a kind, a
    window, the config) rides as a constant. Floating-point leaves that
    need a gradient are differentiated; the others (integer positions,
    data) are only saved. ``fn`` returns a pytree of tensors. ``label``
    names the span (:mod:`repro_torch.obs.spans`) around the recompute;
    None opens none."""
    leaves, treedef = tree_flatten(args)
    is_t = tuple(isinstance(t, torch.Tensor) for t in leaves)
    call = _Call(fn, treedef, is_t, tuple(None if t else x for t, x in zip(is_t, leaves)),
                 label)
    outs = _Checkpoint.apply(call, *(x for t, x in zip(is_t, leaves) if t))
    return tree_unflatten(call.out_def, list(outs))


class _Call:
    """``fn`` and how to rebuild its arguments from the tensor inputs, as
    ONE opaque constant of the Function (``vmap`` flattens the Function's
    inputs on every call: a tuple of the leaves' placeholders would be
    walked leaf by leaf). The forward leaves the output's treedef here."""

    def __init__(self, fn, treedef, is_t, consts, label):
        self.fn, self.treedef, self.is_t, self.consts, self.label = (fn, treedef, is_t,
                                                                     consts, label)
        self.out_def = None

    def __call__(self, tensors: Sequence[torch.Tensor]):
        it = iter(tensors)
        leaves = [next(it) if t else c for t, c in zip(self.is_t, self.consts)]
        outs, self.out_def = tree_flatten(self.fn(*tree_unflatten(self.treedef, leaves)))
        return tuple(outs)


class _Checkpoint(torch.autograd.Function):
    """``fn`` over flat tensor inputs, saving only those inputs; the
    backward recomputes ``fn`` (see the module docstring)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(call, *tensors):
        return call(tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.call = inputs[0]
        ctx.diff = tuple(n and t.is_floating_point()
                         for n, t in zip(ctx.needs_input_grad[1:], inputs[1:]))
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cts) -> Tuple[Any, ...]:
        call, diff = ctx.call, ctx.diff
        saved = [t.detach() for t in ctx.saved_tensors]

        def recompute(*ps):
            it = iter(ps)
            return call([next(it) if d else t for t, d in zip(saved, diff)])

        with spans.span(call.label) if call.label is not None else contextlib.nullcontext():
            outs, vjp_fn = torch.func.vjp(recompute, *(t for t, d in zip(saved, diff) if d))
        cts = tuple(c.detach() if c is not None else torch.zeros_like(o)
                    for c, o in zip(cts, outs))
        grads = iter(vjp_fn(cts))
        return (None,) + tuple(next(grads) if d else None for d in diff)
