"""Message registry.

Counterpart of ``dragonfly2_tpu/idl/base.py`` without the msgpack codec
(this slice has no wire): ``@message`` makes a class a dataclass and
registers it under its class name, which must be unique.
"""

from __future__ import annotations

import dataclasses
from typing import Type, TypeVar

T = TypeVar("T")

_REGISTRY: dict[str, type] = {}


def message(cls: Type[T]) -> Type[T]:
    """Class decorator: make a dataclass a wire message."""
    cls = dataclasses.dataclass(cls)  # type: ignore[call-overload]
    name = cls.__name__
    if name in _REGISTRY and _REGISTRY[name] is not cls:
        raise ValueError(f"duplicate message name {name}")
    _REGISTRY[name] = cls
    return cls
