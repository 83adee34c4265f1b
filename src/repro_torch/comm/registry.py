"""Codec registry: the single place codec *names* resolve to code (a copy of
``repro.comm.registry``, which the port may not import).

Every gossip-compression codec is a :class:`repro_torch.comm.codecs.Codec`
subclass registered under a string name:

    from repro_torch.comm import Codec, register_codec

    @register_codec("my_codec")
    class MyCodec(Codec):
        ...

    ProtocolConfig(codec="my_codec")   # usable by the sim engine at once

Import-light (no torch at module top), so config-level code can depend on it
without cycles.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

_REGISTRY: Dict[str, type] = {}


def register_codec(name: str) -> Callable[[type], type]:
    """Class decorator: register a Codec subclass under ``name``."""
    def deco(cls: type) -> type:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"codec {name!r} already registered "
                             f"({_REGISTRY[name].__qualname__})")
        cls.name = name
        _REGISTRY[name] = cls
        _resolve_cached.cache_clear()
        return cls
    return deco


def _ensure_builtins() -> None:
    from repro_torch.comm import codecs  # noqa: F401  (registers none/q8/topk)


def available_codecs() -> Tuple[str, ...]:
    """All registered codec names."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_codec(name: str) -> type:
    """Resolve a codec name to its class; unknown names raise ValueError."""
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {sorted(_REGISTRY)}") from None


def unregister_codec(name: str) -> None:
    """Remove a registered codec (for tests and plugins)."""
    _REGISTRY.pop(name, None)
    _resolve_cached.cache_clear()


@functools.lru_cache(maxsize=None)
def _resolve_cached(name: str, cfg):
    return get_codec(name)(cfg)


def resolve_codec(cfg):
    """ProtocolConfig -> cached Codec instance for ``cfg.codec``. Instances
    are stateless views over the frozen config (the error-feedback residual
    lives in ``CommState``), so caching on the config is safe."""
    return _resolve_cached(cfg.codec, cfg)
