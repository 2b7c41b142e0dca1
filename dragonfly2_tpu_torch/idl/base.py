"""Message registry + wire codec.

Counterpart of ``dragonfly2_tpu/idl/base.py``. ``@message`` registers a
dataclass under its class name; ``encode``/``decode`` turn a message tree
into plain lists, dicts and scalars and back; ``dumps``/``loads`` move that
structure through msgpack. The card's machine has no ``msgpack`` package,
so the packer and unpacker here are written on the standard library and
cover the subset ``encode`` emits (nil, bool, int, float64, str, bin,
array, map). ``dumps`` gives the bytes ``msgpack.packb(..., use_bin_type=
True)`` gives: the smallest encoding of each integer and length, floats
as float64. Unknown fields arriving on the wire are dropped, the
reference's forward-compatibility rule.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import types
import typing
from typing import Any, Type, TypeVar

_UNION_TYPES = (typing.Union, types.UnionType)

T = TypeVar("T")

_REGISTRY: dict[str, type] = {}
_HINTS: dict[type, dict[str, Any]] = {}


def message(cls: Type[T]) -> Type[T]:
    """Class decorator: make a dataclass a wire message."""
    cls = dataclasses.dataclass(cls)  # type: ignore[call-overload]
    name = cls.__name__
    if name in _REGISTRY and _REGISTRY[name] is not cls:
        raise ValueError(f"duplicate message name {name}")
    _REGISTRY[name] = cls
    return cls


def _hints(cls: type) -> dict[str, Any]:
    h = _HINTS.get(cls)
    if h is None:
        h = typing.get_type_hints(cls)
        _HINTS[cls] = h
    return h


def encode(obj: Any) -> Any:
    """Message tree -> plain structure."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: dict[str, Any] = {"__t": type(obj).__name__}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            out[f.name] = encode(v)
        return out
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    return obj


def decode(data: Any, expect: Any = None) -> Any:
    """Plain structure -> message tree. ``expect`` narrows typed coercion."""
    if isinstance(data, dict) and "__t" in data:
        cls = _REGISTRY.get(data["__t"])
        if cls is None:
            raise ValueError(f"unknown message type {data['__t']!r}")
        hints = _hints(cls)
        kwargs: dict[str, Any] = {}
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in data.items():
            if k == "__t" or k not in names:
                continue
            kwargs[k] = _coerce(hints.get(k), v)
        return cls(**kwargs)
    if expect is not None:
        return _coerce(expect, data)
    if isinstance(data, list):
        return [decode(v) for v in data]
    if isinstance(data, dict):
        return {k: decode(v) for k, v in data.items()}
    return data


def _coerce(ftype: Any, value: Any) -> Any:
    if value is None:
        return None
    if ftype is None or ftype is Any:
        return decode(value)
    origin = typing.get_origin(ftype)
    if origin in _UNION_TYPES:
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if len(args) == 1:
            return _coerce(args[0], value)
        return decode(value)
    if isinstance(ftype, type) and issubclass(ftype, enum.Enum):
        return ftype(value)
    if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
        return decode(value)
    if origin in (list, tuple) or ftype in (list, tuple):
        container = origin or ftype
        elem = (typing.get_args(ftype) or (Any,))[0]
        seq = [_coerce(elem, v) for v in value]
        return tuple(seq) if container is tuple else seq
    if origin is dict:
        _kt, vt = (typing.get_args(ftype) or (Any, Any))[:2]
        return {k: _coerce(vt, v) for k, v in value.items()}
    if ftype is float and isinstance(value, int):
        return float(value)
    return value


# ---------------------------------------------------------------- packer

def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              c8: int | None, c16: int, c32: int) -> None:
    """Length header: fix form when it fits, else the 8/16/32-bit form."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif c8 is not None and n <= 0xFF:
        out += bytes((c8, n))
    elif n <= 0xFFFF:
        out.append(c16)
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(c32)
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"object of length {n} too large to pack")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif 0x80 <= v <= 0xFF:
        out += bytes((0xCC, v))
    elif -0x80 <= v < 0:
        out.append(0xD0)
        out += struct.pack(">b", v)
    elif 0xFF < v <= 0xFFFF:
        out.append(0xCD)
        out += struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out.append(0xD1)
        out += struct.pack(">h", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(0xCE)
        out += struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out.append(0xD2)
        out += struct.pack(">i", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(0xCF)
        out += struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(0xD3)
        out += struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} out of msgpack range")


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, -1, 0xC4, 0xC5, 0xC6)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, None, 0xDC, 0xDD)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, None, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# ---------------------------------------------------------------- unpacker

_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",     # str
        0xC4: ">B", 0xC5: ">H", 0xC6: ">I",     # bin
        0xDC: ">H", 0xDD: ">I",                 # array
        0xDE: ">H", 0xDF: ">I"}                 # map


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf) -> None:
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _unpack(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    fmt = _FIXED.get(b)
    if fmt is not None:
        return r.unpack(fmt)
    fmt = _LEN.get(b)
    if fmt is None:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    n = r.unpack(fmt)
    if b in (0xD9, 0xDA, 0xDB):
        return str(r.take(n), "utf-8")
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(n))
    if b in (0xDC, 0xDD):
        return [_unpack(r) for _ in range(n)]
    return _unpack_map(r, n)


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if isinstance(k, list):
            k = tuple(k)        # hashable, as msgpack's use_list keys are
        out[k] = _unpack(r)
    return out


def unpackb(raw) -> Any:
    r = _Reader(raw)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError("extra bytes after msgpack object")
    return obj


def dumps(obj: Any) -> bytes:
    return packb(encode(obj))


def loads(raw) -> Any:
    return decode(unpackb(raw))
