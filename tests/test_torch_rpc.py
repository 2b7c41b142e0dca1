"""The port's wire: codec bytes against the reference's, and the RPC
transport's contract.

Codec: for seeded instances of every message of the slice, the port's
``dumps`` gives the reference's bytes, and the reference's bytes come back
through the port's ``loads`` as the same message. RPC: the four call kinds
over TCP and a unix socket, a DFError keeping its code, deadlines, a
refused connection (UNAVAILABLE, retried), a cancelled bidi call or
server stream ending the handler, the frame cap, the channel pool's limit and the hash ring
against the reference's. Every server test runs under ``asyncio.wait_for``
with a limit of a few seconds.
"""

import asyncio
import dataclasses
import enum
import shutil
import tempfile
import types
import typing

import msgpack
import numpy as np
import pytest

import dragonfly2_tpu.idl.messages as ref_msg
from dragonfly2_tpu.idl import base as ref_base
from dragonfly2_tpu.rpc.balancer import HashRing as RefHashRing
import dragonfly2_tpu_torch.idl.messages as port_msg
from dragonfly2_tpu_torch.common.errors import Code, DFError
from dragonfly2_tpu_torch.idl import base as port_base
from dragonfly2_tpu_torch.rpc import (Channel, ChannelPool, HashRing,
                                      RPCServer, ServiceClient, ServiceDef)
from dragonfly2_tpu_torch.rpc import client as client_mod
from dragonfly2_tpu_torch.rpc import wire

LIMIT_S = 8.0

SLICE_MESSAGES = sorted(
    name for name, obj in vars(port_msg).items()
    if dataclasses.is_dataclass(obj) and obj.__module__ == port_msg.__name__)


def _plain(rng: np.random.Generator, ftype, depth: int = 0):
    """A seeded plain value (what ``encode`` emits) for a field type."""
    origin = typing.get_origin(ftype)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(ftype) if a is not type(None)]
        if rng.random() < 0.25 or depth > 2:
            return None
        return _plain(rng, args[0], depth)
    if isinstance(ftype, type) and issubclass(ftype, enum.Enum):
        return int(rng.choice([m.value for m in ftype]))
    if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
        return _message(rng, ftype, depth + 1)
    if ftype is bool:
        return bool(rng.integers(2))
    if ftype is int:
        return int(rng.choice([0, 1, -1, 127, 128, -33, 70000, 1 << 33,
                               -(1 << 40), int(rng.integers(-1e9, 1e9))]))
    if ftype is float:
        return float(rng.normal() * 1e3)
    if ftype is str:
        n = int(rng.choice([0, 5, 31, 32, 300]))
        return "".join(chr(c) for c in rng.integers(97, 123, n))
    if ftype is bytes:
        return rng.integers(0, 256, int(rng.integers(0, 300)),
                            dtype=np.uint8).tobytes()
    if ftype is tuple:
        return [int(x) for x in rng.integers(0, 16, 3)]
    if ftype is dict:
        return {f"k{i}": int(rng.integers(100)) for i in range(3)}
    if ftype is list:       # an untyped row, as ModelInferRequest.features
        return [float(x) for x in rng.normal(size=int(rng.integers(0, 9)))]
    if origin is list:
        (elem,) = typing.get_args(ftype)
        return [_plain(rng, elem, depth + 1)
                for _ in range(int(rng.integers(0, 18)))]
    raise TypeError(ftype)


def _message(rng, cls, depth: int = 0) -> dict:
    hints = typing.get_type_hints(cls)
    out = {"__t": cls.__name__}
    for f in dataclasses.fields(cls):
        v = _plain(rng, hints[f.name], depth)
        if v is not None:
            out[f.name] = v
    return out


@pytest.mark.parametrize("name", SLICE_MESSAGES)
def test_codec_bytes_match_reference(name):
    """Seeded instances: same bytes both ways, and reference bytes load
    into the port as the port's message."""
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(8):
        plain = _message(rng, getattr(ref_msg, name))
        ref_obj = ref_base.decode(plain)
        port_obj = port_base.decode(plain)
        assert type(port_obj) is getattr(port_msg, name)
        raw = ref_base.dumps(ref_obj)
        assert port_base.dumps(port_obj) == raw
        assert port_base.loads(raw) == port_obj
        assert port_base.unpackb(raw) == msgpack.unpackb(
            raw, raw=False, strict_map_key=False)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
    (1 << 64) - 1, -1, -32, -33, -128, -129, -32768, -32769, -(1 << 31),
    -(1 << 31) - 1, -(1 << 63), 0.5, -0.0, "", "x" * 31, "x" * 32,
    "y" * 255, "y" * 256, "z" * 70000, "é€", b"", b"b" * 255, b"b" * 256,
    b"c" * 70000, [1] * 15, [1] * 16, [2] * 70000, True, False, None,
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {1: [None, 2.5]}])
def test_packer_matches_msgpack(value):
    raw = msgpack.packb(value, use_bin_type=True)
    assert port_base.packb(value) == raw
    assert port_base.unpackb(raw) == msgpack.unpackb(
        raw, raw=False, strict_map_key=False)


def test_unpacker_refuses_truncated_and_trailing_bytes():
    raw = port_base.dumps(port_msg.PieceInfo(piece_num=3, digest="crc32:1"))
    with pytest.raises(ValueError):
        port_base.unpackb(raw[:-1])
    with pytest.raises(ValueError):
        port_base.unpackb(raw + b"\x00")


# ---------------------------------------------------------------- RPC

def _service(ended: asyncio.Event) -> ServiceDef:
    svc = ServiceDef("test.Echo")

    async def unary(req, ctx):
        if req.piece_num < 0:
            raise DFError(Code.NOT_FOUND, "negative piece")
        return port_msg.PieceInfo(piece_num=req.piece_num + 1)

    async def server_stream(req, ctx):
        for i in range(req.piece_num):
            yield port_msg.PieceInfo(piece_num=i)

    async def client_stream(it, ctx):
        total = 0
        async for r in it:
            total += r.piece_num
        return port_msg.PieceInfo(piece_num=total)

    async def bidi(it, ctx):
        try:
            async for r in it:
                yield port_msg.PieceInfo(piece_num=2 * r.piece_num)
        finally:
            ended.set()

    async def slow(req, ctx):
        await asyncio.sleep(30)
        return port_msg.Empty()

    async def endless(req, ctx):
        try:
            n = 0
            while True:
                yield port_msg.PieceInfo(piece_num=n)
                n += 1
                await asyncio.sleep(0.01)
        finally:
            ended.set()

    svc.unary_unary("Unary", unary)
    svc.unary_stream("ServerStream", server_stream)
    svc.stream_unary("ClientStream", client_stream)
    svc.stream_stream("Bidi", bidi)
    svc.unary_unary("Slow", slow)
    svc.unary_stream("Endless", endless)
    return svc


async def _serve(address: str, ended: asyncio.Event):
    srv = RPCServer(address)
    srv.register(_service(ended))
    await srv.start()
    dial = address if address.startswith("unix:") \
        else f"127.0.0.1:{srv.port}"
    return srv, dial


@pytest.mark.parametrize("transport", ["tcp", "unix"])
def test_four_call_kinds_and_error_codes(transport):
    # a short socket directory: a unix socket path is capped at ~100 bytes
    sock_dir = tempfile.mkdtemp(prefix="rpc-")

    async def main():
        ended = asyncio.Event()
        addr = ("127.0.0.1:0" if transport == "tcp"
                else f"unix:{sock_dir}/rpc.sock")
        srv, dial = await _serve(addr, ended)
        ch = Channel(dial)
        c = ServiceClient(ch, "test.Echo")
        try:
            got = await c.unary("Unary", port_msg.PieceInfo(piece_num=4))
            assert got.piece_num == 5
            # a clean unary call leaves its connection reusable
            await c.unary("Unary", port_msg.PieceInfo(piece_num=1))
            assert len(ch._idle) == 1
            with pytest.raises(DFError) as err:
                await c.unary("Unary", port_msg.PieceInfo(piece_num=-1))
            assert err.value.code == Code.NOT_FOUND
            nums = [p.piece_num async for p in c.unary_stream(
                "ServerStream", port_msg.PieceInfo(piece_num=3))]
            assert nums == [0, 1, 2]

            async def reqs():
                for i in range(5):
                    yield port_msg.PieceInfo(piece_num=i)
            got = await c.stream_unary("ClientStream", reqs())
            assert got.piece_num == 10
            call = c.stream_stream("Bidi")
            for i in (1, 2):
                await call.write(port_msg.PieceInfo(piece_num=i))
                assert (await call.read()).piece_num == 2 * i
            await call.done_writing()
            assert await call.read() is None
            await asyncio.wait_for(ended.wait(), 2)
        finally:
            await ch.close()
            await srv.stop()
    try:
        asyncio.run(asyncio.wait_for(main(), LIMIT_S))
    finally:
        shutil.rmtree(sock_dir, ignore_errors=True)


def test_unary_request_and_its_end_leave_in_one_write(monkeypatch):
    """A server that has answered a unary call before the caller's END
    arrived closes the connection; an END written after the request
    then failed the call with "Connection lost" (seen as ``dfget``'s
    health check failing against a live daemon). The request and its END
    leave in one write, for unary and server-stream calls."""
    writes: list[bytes] = []
    opened = Channel._open

    async def recording_open(self):
        conn = await opened(self)
        write = conn.writer.write

        def record(data):
            writes.append(bytes(data))
            return write(data)
        conn.writer.write = record
        return conn

    monkeypatch.setattr(Channel, "_open", recording_open)
    end = wire.frame(wire.END)

    async def main():
        ended = asyncio.Event()
        srv, dial = await _serve("127.0.0.1:0", ended)
        ch = Channel(dial)
        c = ServiceClient(ch, "test.Echo", max_attempts=1)
        try:
            for _ in range(3):
                writes.clear()
                got = await c.unary("Unary", port_msg.PieceInfo(piece_num=4))
                assert got.piece_num == 5
                assert writes[-1].endswith(end) and len(writes[-1]) > len(end)
            writes.clear()
            assert [p.piece_num async for p in c.unary_stream(
                "ServerStream", port_msg.PieceInfo(piece_num=2))] == [0, 1]
            assert writes[-1].endswith(end) and len(writes[-1]) > len(end)
        finally:
            await ch.close()
            await srv.stop()
    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_cancelled_server_stream_ends_the_handler():
    """A caller that half-closed and then goes away mid-stream (the
    scheduler dropping a seed trigger) ends the server's generator."""
    async def main():
        ended = asyncio.Event()
        srv, dial = await _serve("127.0.0.1:0", ended)
        ch = Channel(dial)
        try:
            stream = ServiceClient(ch, "test.Echo").unary_stream(
                "Endless", port_msg.Empty())
            assert (await stream.read()).piece_num == 0
            stream.cancel()
            await asyncio.wait_for(ended.wait(), 2)
        finally:
            await ch.close()
            await srv.stop()
    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_cancelled_bidi_ends_the_handler():
    async def main():
        ended = asyncio.Event()
        srv, dial = await _serve("127.0.0.1:0", ended)
        ch = Channel(dial)
        try:
            call = ServiceClient(ch, "test.Echo").stream_stream("Bidi")
            await call.write(port_msg.PieceInfo(piece_num=7))
            assert (await call.read()).piece_num == 14
            call.cancel()
            await asyncio.wait_for(ended.wait(), 2)
            with pytest.raises(DFError) as err:
                await call.read()
            assert err.value.code == Code.CLIENT_CONTEXT_CANCELED
        finally:
            await ch.close()
            await srv.stop()
    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_deadline_raises_deadline_exceeded():
    async def main():
        srv, dial = await _serve("127.0.0.1:0", asyncio.Event())
        ch = Channel(dial)
        try:
            c = ServiceClient(ch, "test.Echo", max_attempts=1)
            with pytest.raises(DFError) as err:
                await c.unary("Slow", port_msg.Empty(), timeout=0.2)
            assert err.value.code == Code.DEADLINE_EXCEEDED
            stream = c.unary_stream("ServerStream",
                                    port_msg.PieceInfo(piece_num=2),
                                    timeout=5.0)
            assert (await stream.read()).piece_num == 0
        finally:
            await ch.close()
            await srv.stop()
    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_refused_connection_is_unavailable_and_retried(monkeypatch):
    opens = []
    real_open = Channel._open

    async def counting_open(self):
        opens.append(self.address)
        return await real_open(self)

    monkeypatch.setattr(Channel, "_open", counting_open)

    async def main():
        # a port nobody listens on: bind, note it, close
        probe = await asyncio.start_server(lambda r, w: None,
                                           "127.0.0.1", 0)
        port = probe.sockets[0].getsockname()[1]
        probe.close()
        await probe.wait_closed()
        c = ServiceClient(Channel(f"127.0.0.1:{port}"), "test.Echo",
                          max_attempts=3, base_backoff=0.01)
        with pytest.raises(DFError) as err:
            await c.unary("Unary", port_msg.PieceInfo())
        assert err.value.code == Code.UNAVAILABLE
    asyncio.run(asyncio.wait_for(main(), LIMIT_S))
    assert len(opens) == 3
    assert client_mod._transient_rpc(DFError(Code.UNAVAILABLE))
    assert not client_mod._transient_rpc(DFError(Code.NOT_FOUND))


def test_unknown_method_and_oversized_frame(monkeypatch):
    async def main():
        srv, dial = await _serve("127.0.0.1:0", asyncio.Event())
        ch = Channel(dial)
        try:
            with pytest.raises(client_mod.RPCError) as err:
                await ServiceClient(ch, "test.Echo").unary(
                    "Missing", port_msg.Empty())
            assert err.value.code == "UNIMPLEMENTED"
            monkeypatch.setattr(wire, "MAX_FRAME_BYTES", 64)
            with pytest.raises(DFError) as err:
                await ServiceClient(ch, "test.Echo").unary(
                    "Unary", port_msg.PieceInfo(digest="d" * 100))
            assert err.value.code == Code.RESOURCE_EXHAUSTED
        finally:
            await ch.close()
            await srv.stop()
    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_channel_pool_limit_and_eviction():
    async def main():
        pool = ChannelPool(limit=2, evict_grace_s=0.05)
        a = pool.get("127.0.0.1:1")
        pool.get("127.0.0.1:2")
        assert pool.get("127.0.0.1:1") is a        # LRU refresh
        pool.get("127.0.0.1:3")                    # evicts :2
        assert set(pool._channels) == {"127.0.0.1:1", "127.0.0.1:3"}
        assert len(pool._evicted) == 1
        await asyncio.sleep(0.2)
        assert not pool._evicted                   # closed after the grace
        await pool.close()
    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_hash_ring_matches_reference():
    rng = np.random.default_rng(5)
    nodes = [f"10.0.0.{i}:8002" for i in range(5)]
    ref, port = RefHashRing(nodes), HashRing(nodes)
    for key in (f"{int(k):x}" for k in rng.integers(0, 1 << 62, 64)):
        assert port.pick(key) == ref.pick(key)
        assert port.pick_n(key, 3) == ref.pick_n(key, 3)
    ref.remove(nodes[2])
    port.remove(nodes[2])
    assert port.pick_n("task", 5) == ref.pick_n("task", 5)
