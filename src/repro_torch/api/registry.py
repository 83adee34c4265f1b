"""Protocol registry: the single place protocol *names* resolve to code
(port of ``repro.api.registry``, the protocol half).

    from repro_torch.api.registry import register_protocol
    from repro_torch.api.protocols import PairwiseGossip

    @register_protocol("my_gossip")
    class MyGossip(PairwiseGossip):
        ...

The engine registry of the reference is the plain dict ``ENGINES`` in
:mod:`repro_torch.api.trainer` ("sim", "dist" and "async").
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, type] = {}


def register_protocol(name: str) -> Callable[[type], type]:
    """Class decorator: register a Protocol subclass under ``name``."""
    def deco(cls: type) -> type:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"protocol {name!r} already registered "
                             f"({_REGISTRY[name].__qualname__})")
        cls.name = name
        _REGISTRY[name] = cls
        _resolve_cached.cache_clear()
        return cls
    return deco


def _ensure_builtins() -> None:
    # the built-in protocol classes register themselves on import
    from repro_torch.api import protocols, robust  # noqa: F401


def available_protocols() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_protocol(name: str) -> type:
    """Resolve a protocol name to its class; unknown names raise ValueError."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown protocol {name!r}; registered: {sorted(_REGISTRY)}") from None


@functools.lru_cache(maxsize=None)
def _resolve_cached(name: str, cfg):
    return get_protocol(name)(cfg)


def resolve(cfg):
    """ProtocolConfig -> cached (stateless) Protocol instance for ``cfg.method``."""
    return _resolve_cached(cfg.method, cfg)
