"""Runtime algorithm registry.

The reference selects one algorithm variant per call site at compile
time (``#define``s, ``Communication/src/main.cc:8-10``). Here every
variant is a runtime-selectable strategy registered under a
(family, name) key, so one program can run and compare all of them.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_algorithm(family: str, name: str):
    """Decorator: register ``fn`` as implementation ``name`` of ``family``."""

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(family, {})
        if name in _REGISTRY[family]:
            raise ValueError(f"duplicate registration: {family}/{name}")
        _REGISTRY[family][name] = fn
        return fn

    return deco


def get_algorithm(family: str, name: str) -> Callable:
    try:
        return _REGISTRY[family][name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY.get(family, {})))
        raise KeyError(
            f"unknown algorithm {name!r} for family {family!r}"
            f" (known: {known or 'none'})") from None


def list_algorithms(family: str | None = None):
    """List registered families, or the variant names of one family."""
    if family is None:
        return sorted(_REGISTRY)
    return sorted(_REGISTRY.get(family, {}))
