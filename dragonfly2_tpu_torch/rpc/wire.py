"""Frames and addresses shared by the RPC client and server.

A call rides one connection. Every frame is a 4-byte big-endian payload
length, a 1-byte kind and the payload:

* ``HEADER``  — msgpack map: service, method, call kind, timeout (s, 0 =
  none) and metadata; opens a call;
* ``MESSAGE`` — one ``idl`` message (``idl.dumps``);
* ``END``     — the sender has no more messages (half-close);
* ``STATUS``  — server -> client, last frame of a call: ``{"ok": bool,
  "details": str}``; a ``DFError`` travels as ``DF:<code>:<text>``.

A frame larger than ``MAX_FRAME_BYTES`` (64 MiB, the reference's grpc
message cap) is refused: the reader raises and the connection closes.
"""

from __future__ import annotations

import asyncio
import struct

from ..common.errors import Code, DFError
from ..idl.base import packb, unpackb

HEADER, MESSAGE, END, STATUS = 1, 2, 3, 4
MAX_FRAME_BYTES = 64 * 1024 * 1024
_HEAD = struct.Struct(">IB")

UNARY_UNARY = "unary_unary"
UNARY_STREAM = "unary_stream"
STREAM_UNARY = "stream_unary"
STREAM_STREAM = "stream_stream"
KINDS = (UNARY_UNARY, UNARY_STREAM, STREAM_UNARY, STREAM_STREAM)


def frame(kind: int, payload: bytes = b"") -> bytes:
    if len(payload) > MAX_FRAME_BYTES:
        raise DFError(Code.RESOURCE_EXHAUSTED,
                      f"message of {len(payload)} bytes exceeds the "
                      f"{MAX_FRAME_BYTES}-byte cap")
    return _HEAD.pack(len(payload), kind) + payload


async def read_frame(reader: asyncio.StreamReader
                     ) -> tuple[int, bytes] | None:
    """Next frame, or None on a clean end of stream between frames.
    Raises ConnectionResetError on a frame cut short, DFError
    RESOURCE_EXHAUSTED on an oversized one."""
    try:
        head = await reader.readexactly(_HEAD.size)
    except asyncio.IncompleteReadError as exc:
        if not exc.partial:
            return None
        raise ConnectionResetError("connection closed inside a frame") \
            from None
    n, kind = _HEAD.unpack(head)
    if n > MAX_FRAME_BYTES:
        raise DFError(Code.RESOURCE_EXHAUSTED,
                      f"incoming frame of {n} bytes exceeds the "
                      f"{MAX_FRAME_BYTES}-byte cap")
    try:
        return kind, await reader.readexactly(n)
    except asyncio.IncompleteReadError:
        raise ConnectionResetError("connection closed inside a frame") \
            from None


def pack_map(d: dict) -> bytes:
    return packb(d)


def unpack_map(raw: bytes) -> dict:
    out = unpackb(raw)
    if not isinstance(out, dict):
        raise ValueError("frame payload is not a map")
    return out


def status_details(exc: BaseException) -> str:
    err = DFError.wrap(exc)
    return f"DF:{int(err.code)}:{err.message}"


def split_address(address: str) -> tuple[str, str, int]:
    """("unix", path, 0) or ("tcp", host, port)."""
    if address.startswith("unix:"):
        return "unix", address[len("unix:"):], 0
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad address {address!r}; want ip:port or "
                         "unix:/path")
    return "tcp", host.strip("[]"), int(port)
